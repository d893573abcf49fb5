"""The port's analysis tools (``repro_torch.launch.dryrun``, ``roofline``,
``hlo_stats`` and ``substrate.CostCounter``) against the reference's and
against hand counts, on fake fleets of 4 and 8 ranks.

Every fake fleet is a ``"fake"`` default process group, one a process, so
each runs in a subprocess; the reference's runs under
``REPRO_DRYRUN_DEVICES=8``, as its own tests run it.  The records of both
packages come from one module fixture each, and the tests read them.

What is held, and how closely:

* the collective inventory: the reference's HLO test's collectives, issued
  on a group of 4, give its expected per-device bytes exactly;
* the counter: per device below ``DTensor``; its transcendentals and its
  live and peak bytes on small programs counted by hand;
* the dry-run: the structural fields of every record equal the
  reference's; the collective bytes and executions of every case equal a
  hand count from the specs; the train cell's product FLOPs, under both
  profiles, equal a hand count of the step's products; each temp figure
  holds at least the state the step gathers whole.  The reference's
  figures count a ``scan`` body once (one layer), so its whole-step FLOPs
  are no yardstick;
* the roofline: probe names, trips, chips, mesh shape and model FLOPs
  equal; each probe's fusion-ideal bytes within rel 1e-12; each probe's
  per-device product FLOPs and collective bytes equal to a hand count on
  this rank's shards; the three terms equal those counts over the H100's
  peaks; the cell's FLOPs and collective bytes pinned to their ratios to
  the reference's.  The port runs a probe as its ZeRO-3 sharded step runs a
  layer (parameters gathered, activations on their shards), so where XLA
  splits a product over ``model`` and the port does not, its FLOPs exceed
  the reference's HLO FLOPs: those probes are pinned above the reference
  (ROADMAP Queue 3), the others at or below it.
"""
import json
import math
import os
import re
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from conftest import REPO, run_isolated_script  # noqa: E402

CASES = [  # the reference's tests/test_dryrun.py cases
    ("granite-3-8b", "train_4k", "single"),
    ("mixtral-8x22b", "decode_32k", "multi"),
    ("mamba2-2.7b", "long_500k", "multi"),
    ("whisper-tiny", "prefill_32k", "single"),
]
PROFILES = ("baseline", "serve")
SMOKE_MESH = {"data": 4, "model": 2}


def _run(body: str, env: dict | None = None, timeout: int = 400):
    full = dict(os.environ, PYTHONPATH=str(REPO / "src"), **(env or {}))
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(body)], env=full,
                       capture_output=True, text=True, timeout=timeout)
    assert r.returncode == 0, r.stdout + r.stderr
    return r


@pytest.fixture(scope="module")
def dry(tmp_path_factory):
    """Both packages' dry-run records of the four cases on 8 fake ranks."""
    out = tmp_path_factory.mktemp("dry")
    cases = repr(CASES)
    _run(f"""
        from pathlib import Path
        from repro.launch.dryrun import run_cell
        for arch, cell, mesh in {cases}:
            assert run_cell(arch, cell, mesh, True, Path({str(out / 'ref')!r}))
    """, env={"REPRO_DRYRUN_DEVICES": "8", "JAX_PLATFORMS": "cpu"})
    _run(f"""
        from pathlib import Path
        from repro_torch.launch.dryrun import run_cell
        for arch, cell, mesh in {cases}:
            assert run_cell(arch, cell, mesh, True, Path({str(out / 'port')!r}),
                            device="cpu", devices=8)
        assert run_cell(*{CASES[0]!r}, True, Path({str(out / 'port')!r}), profile="serve",
                        device="cpu", devices=8)
    """)

    def load(pkg, arch, cell, mesh, tag=""):
        return json.loads((out / pkg / f"{arch}__{cell}__{mesh}{tag}.json").read_text())
    recs = {case: (load("ref", *case), load("port", *case)) for case in CASES}
    recs["serve"] = load("port", *CASES[0], "__serve")
    return recs


@pytest.fixture(scope="module")
def roof(tmp_path_factory):
    """Both packages' roofline records of granite-3-8b train_4k at smoke
    size on the (4, 2) mesh, under each profile."""
    out = tmp_path_factory.mktemp("roof")
    _run(f"""
        import json
        import repro.configs as C
        from repro.launch.dryrun import make_mesh
        from repro.launch.roofline import analyze_cell
        mesh = make_mesh("single", smoke=True)
        for prof in {PROFILES!r}:
            rec = analyze_cell(C.get("granite-3-8b", smoke=True), C.smoke_cell("train_4k"),
                               mesh, profile=prof)
            open({str(out)!r} + f"/ref_{{prof}}.json", "w").write(json.dumps(rec, default=float))
    """, env={"REPRO_DRYRUN_DEVICES": "8", "JAX_PLATFORMS": "cpu"})
    _run(f"""
        import json
        import torch.distributed as dist
        import repro_torch.configs as C
        from repro_torch.launch.dryrun import make_mesh
        from repro_torch.launch.roofline import analyze_cell
        from repro_torch.substrate import fake_store, init_group
        init_group("fake", 0, 8, store=fake_store())
        mesh = make_mesh("single", smoke=True, device_type="cpu")
        for prof in {PROFILES!r}:
            rec = analyze_cell(C.get("granite-3-8b", smoke=True), C.smoke_cell("train_4k"),
                               mesh, profile=prof, device="cpu")
            open({str(out)!r} + f"/port_{{prof}}.json", "w").write(json.dumps(rec, default=float))
        dist.destroy_process_group()
    """)
    return {prof: tuple(json.loads((out / f"{pkg}_{prof}.json").read_text())
                        for pkg in ("ref", "port")) for prof in PROFILES}


# ------------------------------------------------------------- collectives
def test_collective_stats_matches_reference_hlo():
    """The collectives of the reference's HLO test (tests/test_launch.py),
    issued on a fake group of 4 under the counter: 7 times an f32[128, 64]
    all-gather and an f32[128] all-reduce, once a bf16[256] all-gather.  The
    per-device bytes equal that test's ``expect``; ``op_counts`` counts
    executions (8 all-gathers, 7 all-reduces), where the reference counts
    the HLO's ops (2 and 1)."""
    run_isolated_script("""
        import torch
        import torch.distributed as dist
        from repro_torch.launch.hlo_stats import collective_stats
        from repro_torch.substrate import CostCounter, fake_store, init_group
        init_group("fake", 0, 4, store=fake_store())
        counter = CostCounter()
        with counter:
            for _ in range(7):
                out = torch.empty(128, 64)
                dist.all_gather_into_tensor(out, torch.zeros(32, 64))
                dist.all_reduce(torch.zeros(128))
            dist.all_gather_into_tensor(torch.empty(256, dtype=torch.bfloat16),
                                        torch.zeros(64, dtype=torch.bfloat16))
        st = collective_stats(counter.collectives, n_devices=4)
        expect = 7 * (128 * 64 * 4 + 2 * 128 * 4) + 256 * 2
        assert st["collective_bytes_per_device"] == expect, st
        assert st["collective_bytes"] == 4 * expect, st
        assert st["op_counts"] == {"all-gather": 8, "all-reduce": 7}, st
        dist.destroy_process_group()
        print("COLL-OK")
    """, marker="COLL-OK", timeout=120)


def test_cost_counter_counts_one_device():
    """The trap of counting above ``DTensor``: a (64, 32) x (32, 16) product
    with its rows split over 8 fake ranks is 1/8 of the global product on
    each rank; ``FlopCounterMode`` entered above the ``DTensor``s counts all
    of it.  The counter also sees the all-gather ``full_tensor`` issues."""
    run_isolated_script("""
        import torch
        import torch.distributed as dist
        from torch._subclasses.fake_tensor import FakeTensorMode
        from torch.distributed.tensor import DTensor, Replicate, Shard
        from torch.utils.flop_counter import FlopCounterMode
        from repro_torch.substrate import CostCounter, fake_store, init_group, make_mesh
        init_group("fake", 0, 8, store=fake_store())
        mesh = make_mesh((8,), ("data",), device_type="cpu")
        with FakeTensorMode():
            x = DTensor.from_local(torch.empty(8, 32), mesh, [Shard(0)], run_check=False,
                                   shape=(64, 32), stride=(32, 1))
            w = DTensor.from_local(torch.empty(32, 16), mesh, [Replicate()], run_check=False)
        glob = FlopCounterMode(display=False)
        with glob:
            x @ w
        counter = CostCounter()
        with counter:
            y = x @ w
            y.full_tensor()
        assert glob.get_total_flops() == 2 * 64 * 32 * 16
        assert counter.flops == 2 * 64 * 32 * 16 // 8, counter.flops
        assert [(k, n) for k, _, n in counter.collectives] == [("all-gather", 64 * 16)]
        dist.destroy_process_group()
        print("COUNT-OK")
    """, marker="COUNT-OK", timeout=120)


def test_cost_counter_transcendentals():
    """One transcendental an element for each op XLA counts one for (exp,
    log, logistic, tanh, sqrt, rsqrt, erf), the activations and softmaxes
    built on them, and the backward ops that recompute one; a logsumexp an
    exp an input element; products, squares and sums none."""
    import torch.nn.functional as F
    from repro_torch.substrate import CostCounter
    x = torch.randn(4, 6, requires_grad=True)
    cases = [  # (calls, transcendentals: 24 a (4, 6) op)
        (lambda: (torch.exp(x), torch.tanh(x), torch.rsqrt(x.abs() + 1), torch.erf(x),
                  torch.sqrt(x.abs())), 5 * 24),
        (lambda: (F.silu(x), torch.sigmoid(x), F.gelu(x), F.gelu(x, approximate="tanh")), 4 * 24),
        (lambda: (torch.softmax(x, -1), torch.log_softmax(x, -1), torch.logsumexp(x, -1)),
         3 * 24),
        (lambda: (x * x, x.square(), x.pow(2), x @ x.T, x.sum()), 0),
        # forward and backward: silu's sigmoid again, log_softmax's exp again;
        # softmax's backward reads its output
        (lambda: torch.autograd.grad(F.silu(x).sum(), x), 2 * 24),
        (lambda: torch.autograd.grad(torch.log_softmax(x, -1).sum(), x), 2 * 24),
        (lambda: torch.autograd.grad(torch.softmax(x, -1).sum(), x), 24),
    ]
    for i, (calls, want) in enumerate(cases):
        counter = CostCounter()
        with counter:
            calls()
        assert counter.transcendentals == want, (i, counter.transcendentals)


def test_cost_counter_live_and_peak_bytes():
    """Live and peak bytes of fake storages, each counted once whatever its
    views, from its birth (or ``hold``) to its death; an in-place op adds
    nothing."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.substrate import CostCounter
    with FakeTensorMode():
        a = torch.empty(1000)                     # 4000 bytes, an argument
        counter = CostCounter()
        assert counter.hold([a, a.view(10, 100)]) == 4000
        with counter:
            b = a * 2                             # 8000 live
            v = b.view(100, 10)
            b.add_(1)
            del b                                 # its view keeps the storage
            assert (counter.live, counter.peak) == (8000, 8000)
            d = v + 1                             # 12000
            del v                                 # b's storage dies: 8000
            assert (counter.live, counter.peak) == (8000, 12000)
            d.sum()                               # a 4-byte scalar, dropped
        assert (counter.live, counter.peak) == (8000, 12000)
        assert d.shape == (100, 10)


# ------------------------------------------------------------------ dry-run
@pytest.mark.parametrize("case", CASES, ids=["-".join(c) for c in CASES])
def test_dryrun_matches_reference(dry, case):
    ref, port = dry[case]
    assert ref["ok"], ref.get("error")
    assert port["ok"], port.get("error")
    for key in ("state_bytes_per_device", "n_params", "n_active_params", "mesh_shape",
                "seq_len", "global_batch", "kind"):
        assert port[key] == ref[key], key
    assert port["state_bytes_laid_out"] == port["state_bytes_per_device"]
    assert port["memory_analysis"]["argument_size_in_bytes"] > 0
    assert port["cost_analysis"]["flops"] > 0
    assert port["collectives"]["collective_bytes"] > 0
    assert port["collectives"]["collective_bytes_per_device"] > 0
    # keys without a counterpart are left out, not written as 0
    assert "generated_code_size_in_bytes" not in port["memory_analysis"]
    assert "compile_s" not in port and "collective_bytes_flat" not in port["collectives"]


def test_dryrun_train_arguments_equal_reference(dry):
    """The train cell's arguments (parameters, moments, count, tokens and
    labels on one device) are the reference's bytes exactly."""
    ref, port = dry[CASES[0]]
    assert (port["memory_analysis"]["argument_size_in_bytes"]
            == ref["memory_analysis"]["argument_size_in_bytes"])


def _entries(spec) -> list[tuple[str, ...]]:
    return [() if e is None else e if isinstance(e, tuple) else (e,) for e in spec]


def _gathers(numel: int, spec, sizes: dict, keep=()) -> list[int]:
    """Elements of each all-gather's result when a tensor of ``numel``
    elements laid out by ``spec`` is gathered whole but for the axes in
    ``keep``.  ``DTensor`` gathers one mesh axis at a time, from the last
    mesh axis to the first, and the axes of a tuple on one dimension from
    the last-named (the minor) to the first; each result holds the axes
    gathered so far whole."""
    split = [ax for e in _entries(spec) for ax in e]
    n = numel // math.prod(sizes[ax] for ax in split)
    order = []
    for ax in reversed(list(sizes)):
        if ax in split and ax not in order:
            tup = next(e for e in _entries(spec) if ax in e)
            order += [a for a in reversed(tup) if a not in order]
    out = []
    for ax in order:
        if ax not in keep:
            n *= sizes[ax]
            out.append(n)
    return out


def _reduction(numel: int, spec, over, sizes: dict) -> list[tuple[str, int]]:
    """(kind, elements on the wire) of laying out the sum over the mesh axes
    ``over`` of a whole gradient of ``numel`` elements by ``spec``: mesh axis
    by mesh axis, a reduce-scatter where a summed axis splits the tensor,
    an all-reduce (twice its result) where it does not, a local slice where
    an axis splits without a sum."""
    split = {ax for e in _entries(spec) for ax in e}
    out = []
    for ax in sizes:
        if ax in over and ax in split:
            numel //= sizes[ax]
            out.append(("reduce-scatter", numel))
        elif ax in over:
            out.append(("all-reduce", 2 * numel))
        elif ax in split:
            numel //= sizes[ax]
    return out


def _pspecs(tree) -> list:
    from repro_torch.models.common import tree_map_pspec
    out = []
    tree_map_pspec(lambda _, p: out.append(p), tree)
    return out


def _itemsize(dtype) -> int:
    from repro_torch.models.common import torch_dtype
    return torch.empty((), dtype=torch_dtype(dtype)).element_size()


def _hand_collectives(arch: str, cell_name: str, mesh_kind: str, profile: str):
    """Per-device collective bytes and executions of a smoke cell's step,
    from the specs: every parameter (and the decode cache, and the inputs)
    gathered whole; the train step's inputs only across their batch rows,
    each gradient summed over the batch axes into its parameter's layout,
    the valid-label count and the loss summed over each batch axis, and
    the per-leaf squared norms over each mesh axis."""
    from repro_torch import configs as C
    from repro_torch.launch.dryrun import mesh_shape
    from repro_torch.launch.steps import INPUT_LOGICAL
    from repro_torch.models import build
    from repro_torch.models.common import resolve_spec
    cfg, cell = C.get(arch, smoke=True), C.smoke_cell(cell_name)
    shape, axes = mesh_shape(mesh_kind, True)
    sizes = dict(zip(axes, shape))
    model = build(cfg)

    def spec(shape, logical):
        return resolve_spec(tuple(shape), logical, sizes, profile=profile)
    wire = []   # (kind, bytes)
    params = _pspecs(model.specs())
    for p in params:
        wire += [("all-gather", n * _itemsize(cfg.param_dtype))
                 for n in _gathers(math.prod(p.shape), spec(p.shape, p.logical), sizes)]
    batch_axes = ()
    for k, v in model.input_specs(cell).items():
        if k == "pos":
            continue
        sp, logical, keep = spec(v.shape, INPUT_LOGICAL[k]), INPUT_LOGICAL[k], ()
        if cell.kind == "train" and "batch" in logical:
            keep = _entries(sp)[logical.index("batch")]
            batch_axes = keep if k == "labels" else batch_axes
        wire += [("all-gather", n * v.element_size())
                 for n in _gathers(v.numel(), sp, sizes, keep)]
    if cell.kind == "decode":
        for p in _pspecs(model.cache_specs(cell.global_batch, cell.seq_len)):
            wire += [("all-gather", n * _itemsize(p.dtype))
                     for n in _gathers(math.prod(p.shape), spec(p.shape, p.logical), sizes)]
    if cell.kind == "train":
        for p in params:
            wire += [(kind, n * _itemsize(cfg.param_dtype)) for kind, n in
                     _reduction(math.prod(p.shape), spec(p.shape, p.logical), batch_axes, sizes)]
        wire += [("all-reduce", 2 * 4)] * (2 * len(batch_axes))
        wire += [("all-reduce", 2 * 4 * len(params))] * len(sizes)
    counts: dict = {}
    for kind, _ in wire:
        counts[kind] = counts.get(kind, 0) + 1
    return sum(b for _, b in wire), counts, math.prod(sizes.values())


DRY_KEYS = [*CASES, "serve"]


@pytest.mark.parametrize("key", DRY_KEYS, ids=["-".join(c) for c in CASES] + ["serve-train"])
def test_dryrun_collectives_hand_count(dry, key):
    """Each case's collective bytes a device and its executions of each
    kind equal the hand count from the specs (the ZeRO-3 train step under
    both profiles; the prefill and decode steps gather everything)."""
    rec = dry[key] if key == "serve" else dry[key][1]
    want, counts, n = _hand_collectives(rec["arch"], rec["cell"], rec["mesh"], rec["profile"])
    assert rec["collectives"]["collective_bytes_per_device"] == want
    assert rec["collectives"]["collective_bytes"] == want * n
    assert rec["collectives"]["op_counts"] == counts


def _batch_rows_per_rank(shape, logical, profile) -> int:
    """Rows of a batch-first input one rank computes on the smoke mesh."""
    from repro_torch.models.common import resolve_spec
    entry = _entries(resolve_spec(shape, logical, SMOKE_MESH, profile=profile))[0]
    return shape[0] // math.prod(SMOKE_MESH[ax] for ax in entry)


def _hand_train_flops(profile: str) -> int:
    """Product FLOPs of one granite smoke ``train_4k`` step on one rank of
    the (4, 2) mesh: every layer's projections and the unembedding on this
    rank's rows, and every (q, k) tile of the chunked attention (masked
    tiles included); 4 times the forward (the forward, ``remat = "full"``'s
    recompute and the chunked loss's, and the backward's two products a
    product), less each layer's down projection, which the recompute skips:
    the non-reentrant checkpoint stops once the tensors the backward needs
    are back, and the block's last product saves none."""
    from repro_torch import configs as C
    cfg, cell = C.get("granite-3-8b", smoke=True), C.smoke_cell("train_4k")
    S, D, L, F = cell.seq_len, cfg.d_model, cfg.n_layers, cfg.d_ff
    rows = _batch_rows_per_rank((cell.global_batch, S), ("batch", "seq"), profile)
    T = rows * S
    per_layer = D * cfg.hd * (2 * cfg.n_heads + 2 * cfg.n_kv_heads) + 3 * D * F
    qc, kc = min(512, S), min(1024, S)
    Sq, Sk = -(-S // qc) * qc, -(-S // kc) * kc
    fwd = 2 * T * (L * per_layer + D * cfg.vocab) + 4 * rows * L * cfg.n_heads * cfg.hd * Sq * Sk
    return 4 * fwd - L * 2 * T * D * F


@pytest.mark.parametrize("profile", PROFILES)
def test_dryrun_train_flops_hand_count(dry, profile):
    """The train cell's per-device product FLOPs equal the hand count (the
    ``serve`` profile computes the whole batch on every rank: 4 times
    ``baseline``'s)."""
    rec = dry["serve"] if profile == "serve" else dry[CASES[0]][1]
    assert rec["profile"] == profile
    assert rec["cost_analysis"]["flops"] == _hand_train_flops(profile)


@pytest.mark.parametrize("case", CASES, ids=["-".join(c) for c in CASES])
def test_dryrun_temp_holds_gathered_state(dry, case):
    """Every step gathers its parameters whole (the decode step its cache
    too) before the model runs, and the train step holds their whole
    gradients beside them when autograd returns: the temp figure is at
    least those bytes, and the arguments are this rank's shards."""
    from repro_torch import configs as C
    from repro_torch.models import build
    port = dry[case][1]
    cfg, cell = C.get(case[0], smoke=True), C.smoke_cell(case[1])
    model = build(cfg)
    whole = sum(math.prod(p.shape) for p in _pspecs(model.specs())) * _itemsize(cfg.param_dtype)
    need = 2 * whole if cell.kind == "train" else whole
    if cell.kind == "decode":
        need += sum(math.prod(p.shape) * _itemsize(p.dtype)
                    for p in _pspecs(model.cache_specs(cell.global_batch, cell.seq_len)))
    mem = port["memory_analysis"]
    assert mem["temp_size_in_bytes"] >= need, (mem, need)
    assert mem["argument_size_in_bytes"] < whole


def test_dryrun_cli(tmp_path):
    """The command line writes an ``ok`` record and exits 0."""
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "granite-3-8b",
         "--cell", "train_4k", "--mesh", "single", "--smoke", "--devices", "8",
         "--device", "cpu", "--out", str(tmp_path)],
        env=dict(os.environ, PYTHONPATH=str(REPO / "src")), capture_output=True, text=True,
        timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    rec = json.loads((tmp_path / "granite-3-8b__train_4k__single.json").read_text())
    assert rec["ok"] and "error" not in rec and rec["device"] == "cpu"


# ----------------------------------------------------------------- roofline
@pytest.mark.parametrize("profile", PROFILES)
def test_roofline_structure_matches_reference(roof, profile):
    ref, port = roof[profile]
    assert "error" not in port, port.get("error")
    assert port["profile"] == ref["profile"] == profile
    for key in ("chips", "mesh_shape", "model_flops"):
        assert port[key] == ref[key], key
    assert list(port["components"]) == list(ref["components"])
    for name, got in port["components"].items():
        want = ref["components"][name]
        assert got["trips"] == want["trips"] and got["grad"] == want["grad"], name
        assert got["bytes"] == pytest.approx(want["bytes"], rel=1e-12), name
    for term in ("compute_s", "memory_s", "collective_s"):
        assert port["terms"][term] > 0


def _local(shape, logical, profile) -> int:
    """Elements of one device's shard of ``shape`` on the smoke mesh."""
    from repro_torch.models.common import resolve_spec
    n = math.prod(shape)
    for entry in resolve_spec(shape, logical, SMOKE_MESH, profile=profile):
        for ax in (() if entry is None else entry if isinstance(entry, tuple) else (entry,)):
            n //= SMOKE_MESH[ax]
    return n


def _hand_flops(name: str, profile: str) -> int:
    """Per-device product FLOPs of a granite smoke train_4k probe on this
    rank's shards (forward and gradients; a product's backward is two of
    its size)."""
    from repro_torch import configs as C
    cfg, cell = C.get("granite-3-8b", smoke=True), C.smoke_cell("train_4k")
    B, S, D = cell.global_batch, cell.seq_len, cfg.d_model
    q, kv = cfg.n_heads * cfg.hd, cfg.n_kv_heads * cfg.hd
    T = _local((B, S, D), ("batch", "seq", "none"), profile) // D   # this rank's tokens
    if name == "attn_proj":
        # forward: q, k, v, o; the output reaches only v and o, so only
        # their backward runs
        return 2 * T * D * (2 * q + 2 * kv) + 2 * (2 * T * D * q + 2 * T * D * kv)
    if name == "mlp_block":   # swiglu: three products
        return 3 * 3 * 2 * T * D * cfg.d_ff
    if name == "loss_chunk":
        c = min(cfg.loss_chunk, S)
        Tc = _local((B, c, D), ("batch", "none", "none"), profile) // D
        return 3 * 2 * Tc * D * cfg.vocab
    if name == "attn_tile":   # two products forward, four backward
        tile = _local((B, cfg.n_heads, 512, cfg.hd), ("batch", "heads", "tile_q", "none"),
                      profile)
        return 6 * 2 * tile * 1024
    return 0                  # embed and adamw: no products


#: (profile, probe) whose per-device FLOPs exceed the reference's HLO FLOPs
#: (ROADMAP Queue 3): attn_proj computes q and k, which XLA drops as dead;
#: the ZeRO-3 probe gathers the unembedding and, under ``serve``, every
#: weight, where XLA splits the products over ``model``
ABOVE_REFERENCE = {("baseline", "attn_proj"), ("baseline", "loss_chunk"),
                   ("serve", "attn_proj"), ("serve", "mlp_block"), ("serve", "loss_chunk")}
PROBES = ("attn_proj", "attn_tile", "mlp_block", "loss_chunk", "embed", "adamw")


@pytest.mark.parametrize("name", PROBES)
@pytest.mark.parametrize("profile", PROFILES)
def test_roofline_probe_flops(roof, profile, name):
    """Each probe's per-device product FLOPs equal their hand count on this
    rank's shards, and sit at or below the reference's HLO FLOPs (which
    also count elementwise work), or above it where ``ABOVE_REFERENCE``
    pins the divergence."""
    ref, port = roof[profile]
    got, want = port["components"][name]["flops"], ref["components"][name]["flops"]
    assert got == _hand_flops(name, profile)
    if (profile, name) in ABOVE_REFERENCE:
        assert got > want
    else:
        assert got <= want


def _hand_probe_collectives(name: str, profile: str) -> int:
    """Per-device collective bytes of a granite smoke train_4k probe, run
    as the ZeRO-3 step runs a layer: each parameter gathered whole, each
    gradient summed over the mesh axes that split the probe's activations
    into its parameter's layout (:func:`_gathers`, :func:`_reduction`)."""
    from repro_torch import configs as C
    from repro_torch.models.common import PSpec, resolve_spec
    from repro_torch.models.layers import attn_specs, mlp_specs, rmsnorm_spec
    cfg, cell = C.get("granite-3-8b", smoke=True), C.smoke_cell("train_4k")
    B, S, D, V = cell.global_batch, cell.seq_len, cfg.d_model, cfg.vocab
    c = min(cfg.loss_chunk, S)
    x = [((B, S, D), ("batch", "seq", "none"))]
    params, acts = {
        "attn_proj": ({"norm": rmsnorm_spec(D), **attn_specs(cfg)}, x),
        "mlp_block": ({"norm": rmsnorm_spec(D), **mlp_specs(cfg)}, x),
        "loss_chunk": ({"unembed": PSpec((D, V), ("embed_d", "vocab"))},
                       [((B, c, D), ("batch", "none", "none")), ((B, c), ("batch", "none"))]),
        "embed": ({"embed": PSpec((V, D), ("vocab", "embed_d"))}, [((B, S), ("batch", "seq"))]),
    }.get(name, ({}, []))

    def spec(shape, logical):
        return resolve_spec(tuple(shape), logical, SMOKE_MESH, profile=profile)
    over = {ax for shape, logical in acts for e in _entries(spec(shape, logical)) for ax in e}
    elements = 0
    for p in _pspecs(params):
        sp, n = spec(p.shape, p.logical), math.prod(p.shape)
        elements += sum(_gathers(n, sp, SMOKE_MESH))
        elements += sum(k for _, k in _reduction(n, sp, over, SMOKE_MESH))
    return 4 * elements   # float32 parameters and gradients


@pytest.mark.parametrize("name", PROBES)
@pytest.mark.parametrize("profile", PROFILES)
def test_roofline_probe_collectives(roof, profile, name):
    """Each probe's per-device collective bytes equal their hand count."""
    _, port = roof[profile]
    assert port["components"][name]["coll"] == _hand_probe_collectives(name, profile)


@pytest.mark.parametrize("profile", PROFILES)
def test_roofline_terms_from_hand_counts(roof, profile):
    """The cell's three terms and its global FLOPs are the hand counts of
    its probes times their trips (a gradient probe's FLOPs and bytes once
    more a third for ``remat = "full"``, the reference's approximation, but
    the loss chunk) over the H100's peaks; the bytes are the reference's."""
    from repro_torch import configs as C
    ref, port = roof[profile]
    remat = C.get("granite-3-8b", smoke=True).remat == "full"
    flops = nbytes = coll = 0.0
    for name, comp in port["components"].items():
        again = 1 + (1 / 3 if comp["grad"] and remat and name != "loss_chunk" else 0)
        flops += _hand_flops(name, profile) * comp["trips"] * again
        nbytes += ref["components"][name]["bytes"] * comp["trips"] * again
        coll += _hand_probe_collectives(name, profile) * comp["trips"]
    assert port["terms"]["compute_s"] == pytest.approx(flops / 989e12, rel=1e-12)
    assert port["terms"]["memory_s"] == pytest.approx(nbytes / 3.35e12, rel=1e-12)
    assert port["terms"]["collective_s"] == pytest.approx(coll / 450e9, rel=1e-12)
    assert port["hlo_flops_global"] == pytest.approx(flops * port["chips"], rel=1e-12)
    assert port["step_time_lower_bound_s"] == max(port["terms"].values())


#: the cell's port / reference ratios of its global FLOPs and its collective
#: bytes (ROADMAP Queue 3): the ZeRO-3 probes gather what XLA splits over
#: ``model``, so under ``serve`` they compute more and move less
CELL_RATIOS = {"baseline": (0.8673081813481304, 1.0211068638856573),
               "serve": (0.9138441228263895, 0.39999652780791833)}


@pytest.mark.parametrize("profile", PROFILES)
def test_roofline_cell_ratios_to_reference(roof, profile):
    """The cell's global FLOPs and collective bytes stay at their recorded
    ratios to the reference's."""
    ref, port = roof[profile]

    def coll(rec):
        return sum(c["coll"] * c["trips"] for c in rec["components"].values())
    got = (port["hlo_flops_global"] / ref["hlo_flops_global"], coll(port) / coll(ref))
    assert got == pytest.approx(CELL_RATIOS[profile], rel=1e-9)


def test_roofline_cli(tmp_path):
    """``roofline_main`` writes a record without an error and exits 0."""
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.roofline_main", "--arch", "granite-3-8b",
         "--cell", "train_4k", "--smoke", "--device", "cpu", "--out", str(tmp_path)],
        env=dict(os.environ, PYTHONPATH=str(REPO / "src")), capture_output=True, text=True,
        timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    rec = json.loads((tmp_path / "granite-3-8b__train_4k__single.json").read_text())
    assert "error" not in rec and rec["chips"] == 8 and rec["components"]


def test_hw_holds_the_h100_peaks():
    """The roofline's peaks are the H100's, and no v5e figure is left in
    the port but on the lines marked as quoted fleet data: the reference's
    fleet description in ``sched/layer_dag.py``, the partitioner's planning
    input, held equal to the reference's (ROADMAP Queue 3)."""
    from repro_torch.launch.roofline import HW
    assert HW == {"peak_flops": 989e12, "hbm_bw": 3.35e12, "link_bw": 450e9}
    quoted = []
    for path in (REPO / "src" / "repro_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            if "# quoted fleet data" in line:
                quoted.append(path.name)
                continue
            for figure in ("197e12", "819e9", "50e9"):
                assert not re.search(rf"(?<![\d.]){figure}", line), (path, figure)
    assert quoted == ["layer_dag.py"] * 3


# -------------------------------------------------------------- abstract state
@pytest.mark.parametrize("arch", ["granite-3-8b", "llama3-405b", "whisper-tiny"])
def test_abstract_state_and_cache_match_reference(arch):
    """``abstract_state`` and ``abstract_cache`` give the reference's shapes
    and dtypes, leaf for leaf (llama3-405b keeps bf16 moments)."""
    import jax.numpy as jnp
    import repro.configs as JC
    from repro.launch.steps import abstract_cache as j_cache
    from repro.launch.steps import abstract_state as j_state
    from repro.launch.steps import make_optimizer as j_opt
    from repro.models.model import build as j_build
    import jax

    from repro_torch import configs as C
    from repro_torch.launch.steps import abstract_cache, abstract_state, make_optimizer
    from repro_torch.models import build
    from repro_torch.models.common import sorted_leaves

    cell = C.smoke_cell("decode_32k")
    jm, tm = j_build(JC.get(arch, smoke=True)), build(C.get(arch, smoke=True))
    jp, jo = j_state(jm, j_opt(jm.cfg))
    tp, to = abstract_state(tm, make_optimizer(tm.cfg))
    pairs = [(jax.tree.leaves(jp), sorted_leaves(tp)), (jax.tree.leaves(jo.m), sorted_leaves(to.m)),
             (jax.tree.leaves(jo.v), sorted_leaves(to.v)),
             (jax.tree.leaves(j_cache(jm, JC.smoke_cell("decode_32k"))),
              sorted_leaves(abstract_cache(tm, cell)))]
    for want, got in pairs:
        assert len(want) == len(got) > 0
        for w, g in zip(want, got):
            assert tuple(w.shape) == tuple(g.shape) and g.device.type == "meta"
            assert jnp.dtype(w.dtype).name == str(g.dtype).replace("torch.", "")
    assert to.count.shape == () and to.count.dtype == torch.int32
    assert jnp.dtype(jo.count.dtype) == jnp.int32
