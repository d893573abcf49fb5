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
  hand count from the specs (the dense train step's tensor-parallel
  collectives, the MoE and SSM decode steps' sharded ones, the other
  prefill and decode steps' gathers); the train cell's product FLOPs,
  under both profiles, equal a hand count of the tensor-parallel step's
  products; each gathering prefill and decode temp figure holds at least
  the state the step gathers whole (the sharded MoE and SSM decode steps
  their working layouts), and the train step's
  its working state and less than the ZeRO-3 step's on the same case.  The
  reference's figures count a ``scan`` body once (one layer), so its
  whole-step FLOPs are no yardstick;
* the roofline: probe names, trips, chips, mesh shape and model FLOPs
  equal; each probe's fusion-ideal bytes within rel 1e-12; each probe's
  per-device product FLOPs and collective bytes equal to a hand count on
  this rank's shards; the three terms equal those counts over the H100's
  peaks; the cell's FLOPs below the reference's and its collective bytes
  within a stated multiple of them.  The port runs a dense train probe as its
  tensor-parallel step runs a layer (parameters gathered over their embed
  axes, products on this rank's heads, columns and vocabulary), so its
  FLOPs sit at or below the reference's HLO FLOPs, but ``attn_proj``'s: it
  counts the q and k products that XLA drops as dead code (ROADMAP
  Queue 3);
* the dense family's sharded prefill and decode (granite smoke
  ``prefill_32k`` and ``decode_32k`` on 8 fake ranks): the dry-run's product
  FLOPs equal ``hand_prefill_flops`` / ``hand_decode_flops``, its collective
  bytes and executions a hand count from the specs, its temp at most twice
  the reference's; the roofline's serving probes run the sharded layer code,
  their FLOPs at or below the reference's but where ``ABOVE_REFERENCE``
  says why, the cells' collective bytes within ``COLL_OVER_REFERENCE``;
* the MoE family's sharded steps (dbrx smoke on (4, 2), mixtral smoke under
  ``moe_ep`` on (2, 2, 2)): the dry-run's product FLOPs equal the hand
  counts with the MoE block's, and the roofline's ``moe_block`` probe runs
  the planned layer code, its FLOPs the block's hand count;
* the dense train step where the q heads do not split the model axis
  (``QSLICE``: minicpm smoke with 3 heads on the smoke mesh's 2, each rank
  attending with every head of its query slice): the dry-run's product
  FLOPs, collective bytes and executions (each layer's all-to-all, again in
  the recompute, and its adjoint) and the roofline's attention probes equal
  hand counts, and the step's temp about halves each time the model axis
  doubles.
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
from test_torch_distributed import decode_ends  # noqa: E402
from test_torch_hybrid_vlm_parallel import _smoke_plan as _hv_plan  # noqa: E402

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
    """Both packages' dry-run records of the four cases on 8 fake ranks, the
    port's train case under ``serve`` too, and that case through the ZeRO-3
    step (``zero3``)."""
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
        # the same dense train case through the ZeRO-3 step the other families run
        from repro_torch.launch.steps import ShardedTrainStep
        ShardedTrainStep.loss_and_grads = ShardedTrainStep._zero3
        assert run_cell(*{CASES[0]!r}, True, Path({str(out / 'zero3')!r}), device="cpu",
                        devices=8)
    """)

    def load(pkg, arch, cell, mesh, tag=""):
        return json.loads((out / pkg / f"{arch}__{cell}__{mesh}{tag}.json").read_text())
    recs = {case: (load("ref", *case), load("port", *case)) for case in CASES}
    recs["serve"] = load("port", *CASES[0], "__serve")
    recs["zero3"] = load("zero3", *CASES[0])
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
SERVE_CELLS = ("prefill_32k", "decode_32k")


@pytest.fixture(scope="module")
def serve_dry(tmp_path_factory):
    """Both packages' dry-run records of granite smoke's serving cells on
    the (4, 2) mesh of 8 fake ranks."""
    out = tmp_path_factory.mktemp("serve_dry")
    _run(f"""
        from pathlib import Path
        from repro.launch.dryrun import run_cell
        for cell in {SERVE_CELLS!r}:
            assert run_cell("granite-3-8b", cell, "single", True, Path({str(out / 'ref')!r}))
    """, env={"REPRO_DRYRUN_DEVICES": "8", "JAX_PLATFORMS": "cpu"})
    _run(f"""
        from pathlib import Path
        from repro_torch.launch.dryrun import run_cell
        for cell in {SERVE_CELLS!r}:
            assert run_cell("granite-3-8b", cell, "single", True, Path({str(out / 'port')!r}),
                            device="cpu", devices=8)
    """)
    return {cell: tuple(json.loads((out / pkg / f"granite-3-8b__{cell}__single.json")
                                   .read_text()) for pkg in ("ref", "port"))
            for cell in SERVE_CELLS}


@pytest.fixture(scope="module")
def roof_serve(tmp_path_factory):
    """Both packages' roofline records of granite smoke's serving cells on
    the (4, 2) mesh, under each profile."""
    out = tmp_path_factory.mktemp("roof_serve")
    cases = repr([(c, p) for c in SERVE_CELLS for p in PROFILES])
    _run(f"""
        import json
        import repro.configs as C
        from repro.launch.dryrun import make_mesh
        from repro.launch.roofline import analyze_cell
        mesh = make_mesh("single", smoke=True)
        for cell, prof in {cases}:
            rec = analyze_cell(C.get("granite-3-8b", smoke=True), C.smoke_cell(cell), mesh,
                               profile=prof)
            open({str(out)!r} + f"/ref_{{cell}}_{{prof}}.json", "w").write(
                json.dumps(rec, default=float))
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
        for cell, prof in {cases}:
            rec = analyze_cell(C.get("granite-3-8b", smoke=True), C.smoke_cell(cell), mesh,
                               profile=prof, device="cpu")
            open({str(out)!r} + f"/port_{{cell}}_{{prof}}.json", "w").write(
                json.dumps(rec, default=float))
        dist.destroy_process_group()
    """)
    return {(cell, prof): tuple(json.loads((out / f"{pkg}_{cell}_{prof}.json").read_text())
                                for pkg in ("ref", "port"))
            for cell in SERVE_CELLS for prof in PROFILES}


def test_collective_stats_matches_reference_hlo():
    """The collectives of the reference's HLO test (tests/test_launch.py),
    issued on a fake group of 4 under the counter: 7 times an f32[128, 64]
    all-gather and an f32[128] all-reduce, once a bf16[256] all-gather.  The
    per-device bytes equal that test's ``expect`` (and split by kind);
    ``op_counts`` counts
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
        assert st["collective_bytes_per_device_by_kind"] == {
            "all-gather": 7 * 128 * 64 * 4 + 256 * 2, "all-reduce": 7 * 2 * 128 * 4}, st
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


def _pspecs(tree) -> list:
    from repro_torch.models.common import tree_map_pspec
    out = []
    tree_map_pspec(lambda _, p: out.append(p), tree)
    return out


def _itemsize(dtype) -> int:
    from repro_torch.models.common import torch_dtype
    return torch.empty((), dtype=torch_dtype(dtype)).element_size()


def _pspec_paths(tree) -> list:
    from repro_torch.models.common import tree_map_pspec
    out = []
    tree_map_pspec(lambda path, p: out.append((path, p)), tree)
    return out


def _plan(profile: str, arch: str = "granite-3-8b", **overrides):
    """The tensor-parallel layout of a dense smoke model's ``train_4k``
    (granite's by default; its config with ``overrides``) on the smoke
    mesh, by hand from the resolved specs: the stream's batch and sequence
    axes, the axes of the heads, the MLP's hidden layer and the vocabulary,
    whether the q heads (and the kv heads) split whole (the port's
    ``head_split``, the rule's one statement), and where they do not, the
    axes the queries' sequence splits over (the heads')."""
    import dataclasses
    from repro_torch import configs as C
    from repro_torch.models.common import resolve_spec
    from repro_torch.models.tensor_parallel import head_split
    cfg = dataclasses.replace(C.get(arch, smoke=True), **overrides)
    cell = C.smoke_cell("train_4k")
    B, S, D = cell.global_batch, cell.seq_len, cfg.d_model

    def axes(shape, logical, d):
        return _entries(resolve_spec(shape, logical, SMOKE_MESH, profile=profile))[d]
    plan = dict(batch=axes((B, S), ("batch", "seq"), 0), seq=axes((B, S), ("batch", "seq"), 1),
                qkv=axes((D, cfg.n_heads * cfg.hd), ("embed", "qkv"), 1),
                kv=axes((D, cfg.n_kv_heads * cfg.hd), ("embed", "qkv"), 1),
                ffn=axes((D, cfg.d_ff), ("embed", "ffn"), 1),
                vocab=axes((cfg.vocab, D), ("vocab", "embed_d"), 0),
                embed_d=axes((cfg.vocab, D), ("vocab", "embed_d"), 1))
    plan["q_local"], plan["kv_local"] = head_split(cfg.n_heads, cfg.n_kv_heads,
                                                   _parts(plan["qkv"]))
    plan["q_slice"] = () if plan["q_local"] else plan["qkv"]
    return cfg, cell, plan


def _parts(axes) -> int:
    return math.prod(SMOKE_MESH[ax] for ax in axes)


def _working_keep(path: str, p, spec, plan, decode: bool = False) -> tuple[str, ...]:
    """The mesh axes a parameter's working layout keeps: none for a q / k / v
    weight whose heads do not split (but in ``decode``: its columns), else
    all but its embed axes (FSDP); in ``decode`` the tables keep those of
    their embed axes that split the stream's rows (``plan["batch"]``)."""
    name = path.rsplit("/", 1)[-1]
    if not decode and ((name == "wq" and not plan["q_local"])
                       or (name in ("wk", "wv") and not plan["kv_local"])):
        return ()
    kept = plan["batch"] if decode and path in ("/embed", "/unembed") else ()
    return tuple(ax for entry, lname in zip(_entries(spec), p.logical) for ax in entry
                 if lname not in ("embed", "embed_d") or ax in kept)


def _tp_reduction(numel: int, spec, keep, sizes: dict) -> list[tuple[str, int]]:
    """(kind, elements on the wire) of summing a working gradient (split over
    ``keep``) over every other mesh axis into its parameter's layout: a
    reduce-scatter for each summed axis the layout splits, in the spec's
    order (a tuple's major axis first: the reverse of :func:`_gathers`),
    then an all-reduce (twice its result) for each summed axis it does not
    split, in mesh order."""
    split = [ax for e in _entries(spec) for ax in e if ax not in keep]
    n = numel // math.prod(sizes[ax] for ax in keep)
    out = []
    for ax in split:
        n //= sizes[ax]
        out.append(("reduce-scatter", n))
    return out + [("all-reduce", 2 * n) for ax in sizes if ax not in keep and ax not in split]


STACKED = ("blocks", "enc_blocks", "dec_blocks")


def _periods(path: str, p) -> int:
    """How many times a step moves a leaf's weights: once a period for a
    leaf of the stacked blocks (its leading ``layers`` dimension; each
    period gathered at its use and its gradient summed as the backward
    leaves it), once for the others (gathered before the model runs, their
    gradients summed after the backward)."""
    return p.shape[0] if path.split("/")[1] in STACKED else 1


def _per_period(ops, k: int) -> list:
    """A whole leaf's collectives ``ops`` ((kind, elements)) as ``k``
    periods' each, every one a ``k``-th of it: the same bytes, ``k`` times
    the executions."""
    return [(kind, n // k) for _ in range(k) for kind, n in ops]


def _weight_gathers(path: str, p, spec, sizes: dict, keep, train: bool = False) -> list:
    """A leaf's weight all-gathers in a planned step (:func:`_gathers` a
    period, :func:`_per_period`): a stacked leaf's again in each period's
    recompute where the step trains (the non-reentrant checkpoint of a
    period gathers its weights first)."""
    k = _periods(path, p)
    ops = _per_period([("all-gather", n) for n in _gathers(math.prod(p.shape), spec, sizes,
                                                           keep)], k)
    return ops * 2 if train and path.split("/")[1] in STACKED else ops


class _Stream:
    """Elements on the wire of the stream's collectives under a plan: the
    sequence gathered (an all-gather a sequence axis) and a partial sum
    brought back into the slice (a reduce-scatter where the sum's axes are
    the sequence's, else an all-reduce an axis), and their backwards."""

    def __init__(self, plan):
        self.seq = plan["seq"]

    def gather(self, n: int) -> list:
        out = []
        for ax in reversed(self.seq):
            n *= SMOKE_MESH[ax]
            out.append(("all-gather", n))
        return out

    def scatter(self, n: int) -> list:
        out = []
        for ax in self.seq:
            n //= SMOKE_MESH[ax]
            out.append(("reduce-scatter", n))
        return out

    @staticmethod
    def sum(n: int, axes) -> list:
        return [("all-reduce", 2 * n)] * len(axes)

    def to_stream(self, n: int, axes) -> list:
        return self.scatter(n) if axes and tuple(axes) == self.seq else self.sum(n, axes)

    def to_stream_back(self, n: int, axes) -> list:
        if axes and tuple(axes) == self.seq:
            return self.gather(n // _parts(self.seq))
        return self.sum(n, axes)


def _hand_tp_collectives(profile: str, arch: str = "granite-3-8b", **overrides):
    """Per-device collective bytes and executions of granite smoke
    ``train_4k``'s tensor-parallel step (or ``arch``'s with ``overrides``),
    from the specs (the collectives in the order they run):

    * each parameter gathered over the axes its working layout drops: a
      leaf outside the stacked blocks once, a block leaf a period at a time,
      in the period's forward and again in its recompute
      (:func:`_weight_gathers`);
    * the embedding, where the vocabulary splits: the tokens' sequence
      gathered (int32), the partial rows into the stream (backward: back);
    * each layer: the attention's and the MLP's input gathered and output
      brought into the stream, in the forward; where the q heads do not
      split, the attention's output of this rank's query slice brought to
      the columns ``wo``'s rows hold by an all-to-all an axis; the recompute
      again but for the MLP's output (the non-reentrant checkpoint stops at
      the down projection, whose saved inputs are then back); in the
      backward, each collective's adjoint (the all-to-all's: the inverse
      all-to-all);
    * the loss, where the vocabulary splits: the hidden states and labels
      gathered (the hidden states' adjoint in the backward), then per loss
      chunk the max, the sum of exponentials and the gold logit summed over
      the vocab axes, all three again in the chunk's recompute, the two
      differentiable sums' adjoints in the backward (float32);
    * the valid-label count and the loss summed over each mesh axis, each
      working gradient summed into its parameter's layout (a block leaf's a
      period at a time, :func:`_per_period`), the per-leaf squared norms
      summed over each mesh axis."""
    from repro_torch.models import build
    from repro_torch.models.common import resolve_spec
    cfg, cell, plan = _plan(profile, arch, **overrides)
    sizes = SMOKE_MESH
    B, S, D = cell.global_batch, cell.seq_len, cfg.d_model
    R, Sl = B // _parts(plan["batch"]), S // _parts(plan["seq"])
    # the attention's output of this rank's query slice, every head
    sliced = [("all-to-all", R * -(-S // _parts(plan["q_slice"])) * cfg.n_heads * cfg.hd)
              for _ in plan["q_slice"]]
    st = _Stream(plan)
    full, own = R * S * D, R * Sl * D
    bf, f32 = 2, 4
    wire = []

    def add(ops, itemsize):
        wire.extend((kind, n * itemsize) for kind, n in ops)
    leaves = _pspec_paths(build(cfg).specs())
    keeps = []
    for path, p in leaves:
        spec = resolve_spec(p.shape, p.logical, sizes, profile=profile)
        keeps.append((path, p, spec, _working_keep(path, p, spec, plan)))
        add(_weight_gathers(path, p, spec, sizes, keeps[-1][3], train=True), f32)
    vocab = plan["vocab"]
    if vocab:
        add(st.gather(R * Sl), 4)
        add(st.to_stream(full, vocab) + st.to_stream_back(full, vocab), bf)
    for _ in range(cfg.n_layers):
        fwd = st.gather(own) + sliced + st.to_stream(full, plan["qkv"]) + st.gather(own)
        add(fwd + st.to_stream(full, plan["ffn"]) + fwd, bf)
        add(st.to_stream_back(full, plan["ffn"]) + st.scatter(full)
            + st.to_stream_back(full, plan["qkv"]) + sliced + st.scatter(full), bf)
    if vocab:
        add(st.gather(own) + st.scatter(full), bf)
        add(st.gather(R * Sl), 4)
        c = min(cfg.loss_chunk, S)
        add(st.sum(R * c, vocab) * 8 * (-(-S // c)), f32)
    every = tuple(sizes)
    add(st.sum(1, every) * 2 + st.sum(len(leaves), every), f32)
    for path, p, spec, keep in keeps:
        add(_per_period(_tp_reduction(math.prod(p.shape), spec, keep, sizes),
                        _periods(path, p)), f32)
    counts: dict = {}
    for kind, _ in wire:
        counts[kind] = counts.get(kind, 0) + 1
    return sum(b for _, b in wire), counts, math.prod(sizes.values())


def _moe_working(arch: str, mesh_kind: str):
    """Per parameter leaf of a MoE smoke model on a smoke mesh: its path,
    PSpec, resolved spec, the mesh axes its working layout keeps in a decode
    step (none for the router, which every rank holds whole; else all but
    its embed axes, the tables' that split the rows kept: the smoke heads
    split whole on the model axis) and whether it moves; and the mesh's axis
    sizes."""
    from repro_torch import configs as C
    from repro_torch.launch.dryrun import mesh_shape
    from repro_torch.models import build
    from repro_torch.models.common import resolve_spec
    from repro_torch.models.tensor_parallel import head_split
    cfg = C.get(arch, smoke=True)
    shape, axes = mesh_shape(mesh_kind, True)
    sizes = dict(zip(axes, shape))
    assert head_split(cfg.n_heads, cfg.n_kv_heads, sizes["model"]) == (True, True)
    out = []
    for path, p in _pspec_paths(build(cfg).specs()):
        spec = resolve_spec(p.shape, p.logical, sizes)
        rows = ("pod", "data") if path in ("/embed", "/unembed") else ()
        keep = () if path.endswith("/router") else tuple(
            ax for entry, lname in zip(_entries(spec), p.logical) for ax in entry
            if lname not in ("embed", "embed_d") or ax in rows)
        moves = set(keep) != {ax for e in _entries(spec) for ax in e}
        out.append((path, p, spec, keep, moves))
    return cfg, sizes, out


def _hand_encdec_prefill_collectives(cell_name: str):
    """Per-device collective bytes and executions of whisper smoke's planned
    prefill on the (data 4, model 2) smoke mesh, from the specs (its 64
    frames, 4 heads and vocabulary of 256 all split on ``model``, as its
    prompt's sequence does; a product's weights and the streams in bf16,
    the logits in float32):

    * each parameter the working layout moves gathered over its embed axes
      (a block's where its period runs, :func:`_weight_gathers`);
    * the embedding over the split vocabulary: the tokens' sequence
      gathered (int32), the partial rows into the stream;
    * each encoder block: its attention's and its MLP's input gathered over
      the frames' sequence and their outputs reduce-scattered back;
    * the encoder's output gathered over the frames' sequence, once;
    * each decoder block: the self-attention's, the cross-attention's and
      the MLP's input gathered over the sequence and their outputs
      reduce-scattered back; the self and the cross cache's k and v traded
      from heads to their sequence by an all-to-all each;
    * the last token gathered over the sequence (the logits stay on this
      rank's rows and vocabulary columns)."""
    from repro_torch.models import build
    from repro_torch.models.common import resolve_spec
    cfg, cell, plan = _serve_plan(cell_name, "whisper-tiny")
    B, S, T, D, V, hd = (cell.global_batch, cell.seq_len, cfg.enc_seq, cfg.d_model, cfg.vocab,
                         cfg.hd)
    R, n = B // _parts(plan["batch"]), _parts(plan["qkv"])
    enc_seq = _entries(resolve_spec((B, T), ("batch", "seq"), SMOKE_MESH))[1]
    assert plan["kv_local"] and plan["seq"] == enc_seq == plan["qkv"] == plan["vocab"] \
        == plan["cache_seq"]
    st = _Stream(plan)
    full, own = R * S * D, R * S // _parts(plan["seq"]) * D
    enc_full, enc_own = R * T * D, R * T // _parts(enc_seq) * D
    bf, i32, f32 = 2, 4, 4
    wire = []

    def add(ops, itemsize):
        wire.extend((kind, k * itemsize) for kind, k in ops)
    for path, p in _pspec_paths(build(cfg).specs()):
        spec = resolve_spec(p.shape, p.logical, SMOKE_MESH)
        add(_weight_gathers(path, p, spec, SMOKE_MESH, _working_keep(path, p, spec, plan)), bf)
    add(st.gather(R * S // _parts(plan["seq"])), i32)
    add(st.to_stream(full, plan["vocab"]), bf)
    for _ in range(cfg.enc_layers):
        add((st.gather(enc_own) + st.to_stream(enc_full, plan["qkv"])) * 2, bf)
    add(st.gather(enc_own), bf)
    for _ in range(cfg.n_layers):
        add((st.gather(own) + st.to_stream(full, plan["qkv"])) * 3, bf)
        add([("all-to-all", R * L * cfg.n_kv_heads // n * hd) for L in (S, S, T, T)], bf)
    add(st.gather(R * D), bf)
    counts: dict = {}
    for kind, _ in wire:
        counts[kind] = counts.get(kind, 0) + 1
    return sum(b for _, b in wire), counts, math.prod(SMOKE_MESH.values())


def _hand_moe_decode_collectives(arch: str, cell_name: str, mesh_kind: str):
    """Per-device collective bytes and executions of a MoE smoke model's
    sharded decode step on the (pod, data, model) smoke mesh, from the
    specs: each parameter the working layout moves gathered over its embed
    axes (the router whole; the tables stay on their ``data`` shards) in
    bf16, a block's where its period runs; each layer's q, k and v gathered
    over the heads' axis, the partial softmax's max, sum and weighted sum
    summed over the cache's sequence axis (float32), ``wo``'s partial sums
    and the experts' outputs (each rank its own experts of the same tokens)
    summed over the model axis; the embedding, the unembedding and the
    greedy token as ``decode_ends`` gives them (the rows traded for the
    tables' columns over ``data``)."""
    from repro_torch import configs as C
    cfg, sizes, leaves = _moe_working(arch, mesh_kind)
    cell = C.smoke_cell(cell_name)
    batch = ("pod", "data")
    R, D, V, hd = cell.global_batch // math.prod(sizes[a] for a in batch), cfg.d_model, \
        cfg.vocab, cfg.hd
    m = sizes["model"]
    bf, f32 = 2, 4
    wire = []
    for path, p, spec, keep, moves in leaves:
        if moves:
            wire += [(kind, n * bf) for kind, n in _weight_gathers(path, p, spec, sizes, keep)]
    emb, ends = decode_ends(R, D, V, sizes, batch, ("model",), table=("data",))
    wire += emb
    for _ in range(cfg.n_layers):
        wire += [("all-gather", R * h * hd * bf)
                 for h in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads)]
        wire += [("all-reduce", 2 * R * cfg.n_heads * f32)] * 2
        wire.append(("all-reduce", 2 * R * cfg.n_heads * hd * f32))
        wire += [("all-reduce", 2 * R * D * bf)] * 2
    wire += ends
    counts: dict = {}
    for kind, _ in wire:
        counts[kind] = counts.get(kind, 0) + 1
    return sum(b for _, b in wire), counts, math.prod(sizes.values())


DRY_KEYS = [*CASES, "serve"]


@pytest.mark.parametrize("key", DRY_KEYS, ids=["-".join(c) for c in CASES] + ["serve-train"])
def test_dryrun_collectives_hand_count(dry, key):
    """Each case's collective bytes a device and its executions of each
    kind equal the hand count from the specs (the tensor-parallel train step
    under both profiles; the MoE and SSM families' sharded decode steps; the
    encoder-decoder's planned prefill)."""
    rec = dry[key] if key == "serve" else dry[key][1]
    if rec["kind"] == "train":
        want, counts, n = _hand_tp_collectives(rec["profile"])
    elif rec["arch"] == "mamba2-2.7b":
        # the SSM family's planned decode step (tests/test_torch_ssm_parallel.py)
        from test_torch_ssm_parallel import _hand_ssm_collectives
        want, counts = _hand_ssm_collectives(rec["cell"], rec["mesh"])
        n = math.prod(rec["mesh_shape"].values())
    elif rec["arch"] == "mixtral-8x22b":
        want, counts, n = _hand_moe_decode_collectives(rec["arch"], rec["cell"], rec["mesh"])
    else:
        want, counts, n = _hand_encdec_prefill_collectives(rec["cell"])
    assert rec["collectives"]["collective_bytes_per_device"] == want
    assert rec["collectives"]["collective_bytes"] == want * n
    assert rec["collectives"]["op_counts"] == counts


def _hand_train_flops(profile: str) -> int:
    """Product FLOPs of one granite smoke ``train_4k`` tensor-parallel step on
    one rank of the (4, 2) mesh: ``hand_train_flops`` (the one hand count of
    the design, which ``chip_smoke.py`` holds the production cell to) with
    the ranks each logical axis splits over under ``profile``."""
    from repro_torch.models.tensor_parallel import hand_train_flops
    cfg, cell, plan = _plan(profile)
    parts = {k: _parts(plan[k]) for k in ("batch", "seq", "qkv", "ffn", "vocab")}
    return hand_train_flops(cfg, cell.global_batch, cell.seq_len, parts)


@pytest.mark.parametrize("profile", PROFILES)
def test_dryrun_train_flops_hand_count(dry, profile):
    """The train cell's per-device product FLOPs equal the hand count of the
    tensor-parallel step (``serve`` computes the whole batch on every rank,
    on an eighth of the columns)."""
    rec = dry["serve"] if profile == "serve" else dry[CASES[0]][1]
    assert rec["profile"] == profile
    assert rec["cost_analysis"]["flops"] == _hand_train_flops(profile)


# a dense smoke cell whose q heads do not split the model axis: minicpm smoke
# with 3 heads on the smoke mesh's 2 (1.5 a rank, as minicpm-2b's 36 heads on
# the production mesh's 16), each rank every head of its query slice; and the
# same model's train step of (2, QSLICE_S) tokens on (1, n) meshes
QSLICE = ("minicpm-2b", {"n_heads": 3, "n_kv_heads": 3})
QSLICE_S, QSLICE_N = 512, (2, 4, 8)


@pytest.fixture(scope="module")
def qslice_dry():
    """The port's dry-run record and roofline record of ``QSLICE``'s
    ``train_4k`` on the smoke mesh of 8 fake ranks, and the temp of its
    train step at QSLICE_S tokens on (1, n) meshes of n fake ranks."""
    r = _run(f"""
        import dataclasses, json
        import torch.distributed as dist
        import repro_torch.configs as C
        from repro_torch.configs.base import ShapeCell
        from repro_torch.launch.dryrun import make_mesh, trace_step
        from repro_torch.launch.roofline import analyze_cell
        from repro_torch.substrate import fake_store, init_group, make_mesh as mesh_of
        arch, over = {QSLICE!r}
        cfg = dataclasses.replace(C.get(arch, smoke=True), **over)
        out = {{}}
        init_group("fake", 0, 8, store=fake_store())
        mesh = make_mesh("single", smoke=True, device_type="cpu")
        out["train"] = trace_step(cfg, C.smoke_cell("train_4k"), mesh, "cpu")
        out["roof"] = analyze_cell(cfg, C.smoke_cell("train_4k"), mesh, device="cpu")
        dist.destroy_process_group()
        for n in {QSLICE_N!r}:
            init_group("fake", 0, n, store=fake_store())
            rec = trace_step(cfg, ShapeCell("long", {QSLICE_S}, 2, "train"),
                             mesh_of((1, n), ("data", "model"), device_type="cpu"), "cpu")
            out[f"temp{{n}}"] = rec["memory_analysis"]["temp_size_in_bytes"]
            dist.destroy_process_group()
        print("RESULT" + json.dumps(out, default=float))
    """)
    return json.loads(r.stdout.split("RESULT", 1)[1])


def test_dryrun_query_slice_flops_hand_count(qslice_dry):
    """Where the q heads do not split, the train step's per-device product
    FLOPs equal ``hand_train_flops``: q, every (q, k) tile and the cross
    products on this rank's query slice, k and v over the whole sequence."""
    from repro_torch.models.tensor_parallel import hand_train_flops
    cfg, cell, plan = _plan("baseline", QSLICE[0], **QSLICE[1])
    assert not plan["q_local"] and plan["q_slice"] == ("model",)
    parts = {k: _parts(plan[k]) for k in ("batch", "seq", "qkv", "ffn", "vocab")}
    assert qslice_dry["train"]["cost_analysis"]["flops"] == hand_train_flops(
        cfg, cell.global_batch, cell.seq_len, parts)


def test_dryrun_query_slice_collectives_hand_count(qslice_dry):
    """Its collective bytes and executions equal the hand count: each
    layer's all-to-all of its query slice's output to ``wo``'s columns in
    the forward and the recompute, the inverse all-to-all in the backward."""
    want, counts, n = _hand_tp_collectives("baseline", QSLICE[0], **QSLICE[1])
    coll = qslice_dry["train"]["collectives"]
    assert counts["all-to-all"] == 3 * 2   # three a layer, two layers
    assert coll["collective_bytes_per_device"] == want
    assert coll["collective_bytes"] == want * n
    assert coll["op_counts"] == counts


@pytest.mark.parametrize("name", ("attn_proj", "attn_tile"))
def test_roofline_query_slice_probes(qslice_dry, name):
    """The roofline's attention probes on that plan: ``attn_proj``'s
    per-device FLOPs and collective bytes equal their hand counts (q on the
    query slice, the all-to-all and its adjoint); ``attn_tile``'s tiles take
    the query chunk's rows over the model axis, as the step's query slice."""
    comp = qslice_dry["roof"]["components"][name]
    assert comp["flops"] == _hand_flops(name, "baseline", QSLICE[0], **QSLICE[1])
    if name == "attn_proj":
        assert comp["coll"] == _hand_probe_collectives(name, "baseline", QSLICE[0],
                                                       **QSLICE[1])


def test_query_slice_score_tiles_fall_with_n(qslice_dry):
    """The step's temp (its recompute holds the chunked attention's float32
    score tiles) about halves each time the model axis doubles: each rank
    attends with its query slice only.  Every rank ran every head over the
    whole sequence before, and a parent tree's trace of the same step held
    26,230,168 / 26,029,848 / 25,929,688 bytes at n = 2 / 4 / 8."""
    temps = [qslice_dry[f"temp{n}"] for n in QSLICE_N]
    print(dict(zip(QSLICE_N, temps)))
    for a, b in zip(temps, temps[1:]):
        assert b <= 0.55 * a


# each case's temp a device in a parent's trace (torch 2.13 on the CPU, the
# smoke cases on 8 fake ranks): of the steps that gathered every period's
# working weights before the model ran, and for the one-row long_500k cases
# of the step that gathered each period's weights over ``data`` where it ran
PARENT_TEMP = {("granite-3-8b", "train_4k", "single"): 926_620,
               ("mixtral-8x22b", "decode_32k", "multi"): 320_512,
               ("mamba2-2.7b", "long_500k", "multi"): 60_192,
               ("whisper-tiny", "prefill_32k", "single"): 727_040,
               ("jamba-v0.1-52b", "train_4k", "single"): 5_799_532,
               ("jamba-v0.1-52b", "long_500k", "multi"): 427_088,
               ("qwen2-vl-72b", "decode_32k", "single"): 146_144}
# the one-row cases' collective bytes a device in that step's trace, which
# gathered every weight over ``data``; mixtral's in the trace of the step that
# kept every weight on its data shard and gathered the logits whole
ONE_ROW = {("mamba2-2.7b", "long_500k", "multi"): 80_288,
           ("jamba-v0.1-52b", "long_500k", "multi"): 741_216,
           ("mixtral-8x22b", "long_500k", "multi"): 11_168}


@pytest.fixture(scope="module")
def moe_one_row_dry(tmp_path_factory):
    """The port's dry-run record of mixtral smoke's ``long_500k`` on the
    (pod 2, data 2, model 2) smoke mesh of 8 fake ranks."""
    out = tmp_path_factory.mktemp("moe_one_row")
    _run(f"""
        from pathlib import Path
        from repro_torch.launch.dryrun import run_cell
        assert run_cell("mixtral-8x22b", "long_500k", "multi", True, Path({str(out)!r}),
                        device="cpu", devices=8)
    """)
    return json.loads((out / "mixtral-8x22b__long_500k__multi.json").read_text())


def _held_at_once(leaves) -> int:
    """``leaves``: (path, PSpec, working bytes) -> the working bytes a
    planned step holds at once at least: one period's share of each
    stacked block leaf and each other leaf whole (:func:`_periods`)."""
    return sum(b // _periods(path, p) for path, p, b in leaves)


@pytest.mark.parametrize("case", CASES, ids=["-".join(c) for c in CASES])
def test_dryrun_temp_holds_gathered_state(dry, case):
    """Each planned step gathers a period's blocks where the period runs:
    its temp holds at least one period's working weights and every other
    leaf's (the tables, the final norms), and is below the parent's temp
    on the same case (:data:`PARENT_TEMP`), which held every period's at
    once.  The MoE and SSM families' sharded decode steps and the
    encoder-decoder's planned prefill hold the leaves their working layouts
    move in bf16 (each gathered over its embed axes, the router and the
    conv weights whole); the dense train step its working weights and their
    gradients (float32), and less than the ZeRO-3 step on the same case,
    which gathers every parameter and holds every gradient whole.  The
    arguments are this rank's shards."""
    from repro_torch import configs as C
    from repro_torch.models import build
    from repro_torch.models.common import resolve_spec
    port = dry[case][1]
    cfg, cell = C.get(case[0], smoke=True), C.smoke_cell(case[1])
    model = build(cfg)
    whole = sum(math.prod(p.shape) for p in _pspecs(model.specs())) * _itemsize(cfg.param_dtype)
    mem = port["memory_analysis"]
    temp = mem["temp_size_in_bytes"]
    assert mem["argument_size_in_bytes"] < whole
    assert temp < PARENT_TEMP[case], (temp, PARENT_TEMP[case])
    if cell.kind == "train":
        _, _, plan = _plan("baseline")
        working = []
        for path, p in _pspec_paths(model.specs()):
            spec = resolve_spec(p.shape, p.logical, SMOKE_MESH)
            keep = _working_keep(path, p, spec, plan)
            working.append((path, p, math.prod(p.shape) // _parts(keep)
                            * _itemsize(cfg.param_dtype)))
        zero3 = dry["zero3"]["memory_analysis"]["temp_size_in_bytes"]
        ref = dry[case][0]["memory_analysis"]["temp_size_in_bytes"]
        print(f"temp {temp}: {temp / ref:.4f} x the reference's {ref}; ZeRO-3 {zero3} "
              f"({zero3 / ref:.4f} x); the parent's {PARENT_TEMP[case]}")
        assert 2 * _held_at_once(working) <= temp < zero3
        assert zero3 >= 2 * whole
        return
    if cfg.family == "moe":
        _, sizes, leaves = _moe_working(*case[::2])
        moved = [(path, p, math.prod(p.shape) // math.prod(sizes[ax] for ax in keep) * 2)
                 for path, p, _, keep, moves in leaves if moves]
    elif cfg.family == "ssm":
        # the planned decode step: its weights' working layouts in bf16 (the
        # conv weights whole, the rest gathered over their embed axes)
        from test_torch_ssm_parallel import _smoke_plan, _ssm_keep
        plan = _smoke_plan(case[1], "baseline", case[2])
        sizes = plan["sizes"]
        moved = []
        for path, p in _pspec_paths(model.specs()):
            spec = resolve_spec(p.shape, p.logical, sizes)
            keep = _ssm_keep(path, p, spec, plan)
            if set(keep) != {ax for e in _entries(spec) for ax in e}:
                moved.append((path, p, math.prod(p.shape) // math.prod(sizes[ax] for ax in keep)
                              * 2))
    else:
        # the encoder-decoder's planned prefill: its weights' working layouts
        # in bf16 (each gathered over its embed axes)
        _, _, plan = _serve_plan(case[1], case[0])
        moved = []
        for path, p in _pspec_paths(model.specs()):
            spec = resolve_spec(p.shape, p.logical, SMOKE_MESH)
            keep = _working_keep(path, p, spec, plan)
            if set(keep) != {ax for e in _entries(spec) for ax in e}:
                moved.append((path, p, math.prod(p.shape) // _parts(keep) * 2))
    print(case, temp, _held_at_once(moved), PARENT_TEMP[case], whole)
    # the encoder-decoder's prefill holds its rows' frames, under the whole
    # parameters; the decode steps under half of them
    bound = whole if cfg.family == "encdec" else whole // 2
    assert _held_at_once(moved) <= temp < bound, (mem, moved, whole)


@pytest.mark.parametrize("case", list(ONE_ROW), ids=["-".join(c) for c in ONE_ROW])
def test_dryrun_one_row_decode_moves_no_weight(dry, hv_dry, moe_one_row_dry, case):
    """mamba2's, jamba's and mixtral's smoke ``long_500k`` on (pod 2, data 2, model 2):
    two rows split over ``pod``, so the rows leave the weights' ``data``
    (embed) axis whole and the plan keeps every weight on its embed shard
    there (``stationary_axes``).  No all-gather moves a weight leaf: the
    hand count's weight gathers are none, and the record's all-gather bytes
    and executions are the hand count's activation gathers
    (:func:`_stationary_decode_wire`); its collective bytes below the
    gathering step's (:data:`ONE_ROW`) and its product FLOPs equal to
    ``hand_decode_flops`` with ``d_model`` split over ``data``."""
    from repro_torch.models.tensor_parallel import hand_decode_flops
    if case[0] == "mamba2-2.7b":
        from test_torch_ssm_parallel import _smoke_plan
        rec, plan = dry[case][1], _smoke_plan(case[1], "baseline", case[2])
    else:
        rec = moe_one_row_dry if case[0] == "mixtral-8x22b" else hv_dry[case][0]
        plan = _hv_plan(case[0], case[1], "baseline", case[2])
    assert plan["batch"] == ("pod",) and plan["stationary"] == ("data",)
    assert _stationary_weight_gathers(plan) == []
    gathers = [b for kind, b in _stationary_decode_wire(plan) if kind == "all-gather"]
    coll = rec["collectives"]
    print(case, coll["collective_bytes_per_device"], ONE_ROW[case], coll["op_counts"])
    assert coll["collective_bytes_per_device_by_kind"]["all-gather"] == sum(gathers)
    assert coll["op_counts"]["all-gather"] == len(gathers)
    assert coll["collective_bytes_per_device"] < ONE_ROW[case]
    c = plan["cell"]
    assert plan["parts"]["embed"] == 2
    assert rec["cost_analysis"]["flops"] == hand_decode_flops(plan["cfg"], c.global_batch,
                                                              c.seq_len, plan["parts"])


# smoke decode_32k steps on the (data 4, model 2) mesh under the baseline:
# (arch, config changes); two rows a data rank, so every plan keeps the tables
# on their data shards; a vocabulary of 255 splits nowhere, 3 heads of 16 and
# glm4's one kv head do not split model (the MoE's smoke expert weights, which
# move over data as XLA moves them, are larger than its tables: left out)
DECODE_GUARD = [("granite-3-8b", {}), ("granite-3-8b", {"vocab": 255}),
                ("minicpm-2b", {"n_heads": 3, "n_kv_heads": 3}), ("glm4-9b", {}),
                ("mamba2-2.7b", {}), ("qwen2-vl-72b", {}), ("whisper-tiny", {})]


@pytest.fixture(scope="module")
def decode_guard():
    """Per ``DECODE_GUARD`` case: every collective of its smoke decode_32k
    step traced on 8 fake ranks ((kind, dtype, elements) each), its plan's
    rows, table, vocabulary and logit axes, and each table's and q / k / v
    weight's resolved and working specs."""
    r = _run(f"""
        import dataclasses, json
        from torch._subclasses.fake_tensor import FakeTensorMode
        import repro_torch.configs as C
        from repro_torch.launch.dryrun import laid_out, make_mesh
        from repro_torch.launch.steps import abstract_cache, build_decode, input_shardings
        from repro_torch.models import build
        from repro_torch.models.common import resolve_spec, tree_map_pspec
        from repro_torch.optim.adamw import tree_map_sorted
        from repro_torch.substrate import CostCounter, fake_store, init_group, mesh_context
        init_group("fake", 0, 8, store=fake_store())
        out = []
        mesh = make_mesh("single", smoke=True, device_type="cpu")
        sizes = dict(data=4, model=2)
        cell = C.smoke_cell("decode_32k")
        for arch, over in {DECODE_GUARD!r}:
            cfg = dataclasses.replace(C.get(arch, smoke=True), **over)
            model = build(cfg)
            inputs = {{k: v for k, v in model.input_specs(cell).items() if k != "pos"}}
            in_sh = input_shardings(inputs, mesh)
            step, sh = build_decode(model, mesh, cell)
            counter = CostCounter()
            with mesh_context(mesh), FakeTensorMode(allow_non_fake_inputs=True):
                batch = {{k: laid_out(v, in_sh[k], "cpu") for k, v in inputs.items()}}
                params = tree_map_sorted(lambda m, s: laid_out(m, s, "cpu"), model.abstract(),
                                         sh["params"])
                cache = tree_map_sorted(lambda m, s: laid_out(m, s, "cpu"),
                                        abstract_cache(model, cell), sh["cache"])
                batch["pos"] = cell.seq_len - 1
                with counter:
                    step(params, cache, batch)
                tp, _ = step.plan(batch["tokens"], cache)
            specs = model.specs()
            work = tp.working_shardings(specs)
            kept = {{}}
            def note(path, p, w=work):
                node = w
                for k in path.split("/")[1:]:
                    node = node[k]
                name = path.rsplit("/", 1)[-1]
                if name in ("embed", "unembed", "wq", "wk", "wv"):
                    kept[path] = [list(resolve_spec(p.shape, p.logical, sizes)), list(node.spec),
                                  list(p.logical)]
            tree_map_pspec(note, specs)
            out.append(dict(arch=arch, over=over, events=[[k, str(d), n] for k, d, n in
                                                          counter.collectives],
                            batch=tp.batch_axes, table=tp.table_axes, vocab=tp.vocab_axes,
                            logit=tp.logit_axes, kept=kept))
        print("RESULT" + json.dumps(out))
    """)
    return json.loads(r.stdout.split("RESULT", 1)[1])


def test_decode_moves_no_whole_table_weight_or_logits(decode_guard):
    """No collective of a smoke decode step whose rows split ``data``
    carries a whole table, a whole q / k / v weight or more than its rows'
    share of the logits (:data:`DECODE_GUARD`): each table's and q / k / v
    weight's working layout keeps every axis of its resolved spec but the
    embed axes the rows leave whole (a table keeps its ``data`` shard, the
    rows trading for its columns; wq / wk / wv keep their ``qkv`` columns,
    whether or not their heads split), and no collective's result holds a
    table's elements, whole or over ``data``; and no float32 collective's
    input or output (a reduce-scatter's input its output times the table
    axes' ranks) holds more than one rank's rows of every logit column or
    every row of the table axes on the model axis' share of them."""
    import dataclasses
    import repro_torch.configs as C
    sizes, B = dict(data=4, model=2), 8
    for case in decode_guard:
        cfg = dataclasses.replace(C.get(case["arch"], smoke=True), **case["over"])
        V, D = cfg.vocab, cfg.d_model
        assert case["batch"] == ["data"] and case["table"] == ["data"], case["arch"]
        assert case["logit"] == ["model"]
        R, t, m = B // 4, 4, sizes["model"]
        for path, (spec, work, logical) in case["kept"].items():
            want = [e if lname not in ("embed", "embed_d") else
                    ("data" if path in ("/embed", "/unembed") and e == "data" else None)
                    for e, lname in zip(spec, logical)]
            assert work == want, (case["arch"], case["over"], path, spec, work)
        whole = (V * D, V * D // math.prod(sizes[ax] for ax in case["vocab"]))
        for kind, dtype, n in case["events"]:
            assert n not in whole, (case["arch"], kind, dtype, n)
            if dtype == "torch.float32":
                wire = n * (t if kind == "reduce-scatter" else 1)
                assert wire <= max(R * V, R * t * -(-V // m)), (case["arch"], kind, n)


def _serve_plan(cell_name: str, arch: str = "granite-3-8b"):
    """The serving layout of a dense smoke model's ``cell_name`` (granite's
    by default) on the smoke mesh under the baseline profile, by hand from
    the resolved specs: ``_plan``'s weights' axes with the stream laid out as
    the cell's tokens, and the cache's rows and sequence axes."""
    from repro_torch import configs as C
    from repro_torch.models import build
    from repro_torch.models.common import resolve_spec
    cfg, _, plan = _plan("baseline", arch)
    cell = C.smoke_cell(cell_name)
    B, S = cell.global_batch, cell.seq_len
    tokens = _entries(resolve_spec((B, 1 if cell.kind == "decode" else S), ("batch", "seq"),
                                   SMOKE_MESH, profile="baseline"))
    cache = next(iter(_pspecs(build(cfg).cache_specs(B, S))))
    c_spec = _entries(resolve_spec(cache.shape, cache.logical, SMOKE_MESH, profile="baseline"))
    return cfg, cell, dict(plan, batch=tokens[0], seq=tokens[1], cache_batch=c_spec[1],
                           cache_seq=c_spec[2])


def _hand_serve_collectives(cell_name: str, arch: str = "granite-3-8b"):
    """Per-device collective bytes and executions of a dense smoke model's
    sharded prefill or decode step (granite's by default; the VLM's, whose
    positions are laid out as its stream, the same), from the specs (a
    product's weights and the stream in bf16, the partial softmax and the
    logits in float32):

    * each parameter the working layout moves gathered over its embed axes,
      in the compute type (the norms do not move), a block's where its
      period runs (:func:`_weight_gathers`);
    * prefill: the train forward's stream collectives (those of
      :func:`_hand_tp_collectives` without the recompute), each layer's k
      and v traded from heads to sequence by an all-to-all where the kv
      heads split, the last token gathered over the sequence;
    * decode: each layer's q, k and v gathered over their weights' columns'
      axes, the partial softmax's max, sum and weighted sum summed over the
      cache's sequence axes, ``wo``'s and the MLP's partial sums summed into
      the stream; the embedding, the unembedding and the greedy token as
      ``decode_ends`` gives them (the rows traded for the tables' columns
      over ``data``);
    * no logits gathered: they stay on the rows and columns that computed
      them."""
    from repro_torch.models import build
    from repro_torch.models.common import resolve_spec
    cfg, cell, plan = _serve_plan(cell_name, arch)
    B, S, D, V, hd = cell.global_batch, cell.seq_len, cfg.d_model, cfg.vocab, cfg.hd
    R = B // _parts(plan["batch"])
    n = _parts(plan["qkv"])
    st = _Stream(plan)
    bf, f32 = 2, 4
    wire = []

    def add(ops, itemsize):
        wire.extend((kind, k * itemsize) for kind, k in ops)
    decode = cell.kind == "decode"
    for path, p in _pspec_paths(build(cfg).specs()):
        spec = resolve_spec(p.shape, p.logical, SMOKE_MESH)
        add(_weight_gathers(path, p, spec, SMOKE_MESH,
                            _working_keep(path, p, spec, plan, decode)), bf)
    vocab = plan["vocab"]
    if cell.kind == "prefill":
        Sl = S // _parts(plan["seq"])
        full, own = R * S * D, R * Sl * D
        if vocab:
            add(st.gather(R * Sl), 4)
            add(st.to_stream(full, vocab), bf)
        for _ in range(cfg.n_layers):
            add(st.gather(own) + st.to_stream(full, plan["qkv"]) + st.gather(own)
                + st.to_stream(full, plan["ffn"]), bf)
            if plan["kv_local"]:
                add([("all-to-all", R * S * cfg.n_kv_heads // n * hd)] * 2, bf)
        add(st.gather(R * D), bf)
    else:
        table = tuple(ax for ax in plan["batch"] if ax in plan["embed_d"])
        emb, ends = decode_ends(R, D, V, SMOKE_MESH, plan["batch"], vocab, table=table)
        wire += emb
        seq = _Stream(dict(seq=plan["cache_seq"]))
        for _ in range(cfg.n_layers):
            add([("all-gather", R * h * hd) for h, axes in ((cfg.n_heads, plan["qkv"]),
                                                            (cfg.n_kv_heads, plan["kv"]),
                                                            (cfg.n_kv_heads, plan["kv"]))
                 if axes], bf)
            add(seq.sum(R * cfg.n_heads, plan["cache_seq"]) * 2
                + seq.sum(R * cfg.n_heads * hd, plan["cache_seq"]), f32)
            add(st.sum(R * D, plan["qkv"]) + st.sum(R * D, plan["ffn"]), bf)
        wire += ends
    counts: dict = {}
    for kind, _ in wire:
        counts[kind] = counts.get(kind, 0) + 1
    return sum(b for _, b in wire), counts


def _serve_parts(cell_name: str) -> tuple:
    cfg, cell, plan = _serve_plan(cell_name)
    parts = {k: _parts(plan[k]) for k in ("batch", "seq", "qkv", "ffn", "vocab", "cache_batch",
                                          "cache_seq")}
    return cfg, cell, parts


@pytest.mark.parametrize("cell", SERVE_CELLS)
def test_dryrun_serving_flops_hand_count(serve_dry, cell):
    """The sharded prefill's and decode step's per-device product FLOPs
    equal ``hand_prefill_flops`` / ``hand_decode_flops`` with the ranks each
    logical axis splits over on the smoke mesh."""
    from repro_torch.models.tensor_parallel import hand_decode_flops, hand_prefill_flops
    ref, port = serve_dry[cell]
    assert port["ok"], port.get("error")
    cfg, c, parts = _serve_parts(cell)
    hand = hand_decode_flops if c.kind == "decode" else hand_prefill_flops
    assert port["cost_analysis"]["flops"] == hand(cfg, c.global_batch, c.seq_len, parts)


@pytest.mark.parametrize("cell", SERVE_CELLS)
def test_dryrun_serving_collectives_hand_count(serve_dry, cell):
    """The sharded step's collective bytes a device and its executions of
    each kind equal the hand count from the specs (no cache leaf and no
    parameter gathered beyond its shard and its working layout)."""
    _, port = serve_dry[cell]
    want, counts = _hand_serve_collectives(cell)
    assert port["collectives"]["collective_bytes_per_device"] == want
    assert port["collectives"]["op_counts"] == counts


@pytest.mark.parametrize("cell", SERVE_CELLS)
def test_dryrun_serving_temp_within_twice_reference(serve_dry, cell):
    """The sharded step's temp a device is at most twice the reference's
    XLA count of the same smoke cell, its arguments the reference's bytes
    (the state laid out as the reference lays it out)."""
    ref, port = serve_dry[cell]
    got, want = (r["memory_analysis"]["temp_size_in_bytes"] for r in (port, ref))
    print(f"{cell}: temp {got}, {got / want:.4f} x the reference's {want}")
    assert got <= 2 * want
    assert port["state_bytes_laid_out"] == port["state_bytes_per_device"] \
        == ref["state_bytes_per_device"]


# ------------------------------------------------------------- the MoE family
MOE_CASES = [("dbrx-132b", "single", "baseline"), ("mixtral-8x22b", "moe", "moe_ep")]
MOE_CELLS = ("train_4k", "prefill_32k", "decode_32k")
# the ranks each logical axis splits over on the smoke meshes, (data 4, model
# 2) and (data 2, expert 2, tp 2): dbrx's 8 experts on model, mixtral's 4 on
# expert and their hidden columns on tp (wk's columns on the heads' axes);
# in decode (one token a row, the
# sequence unsplit) the experts and their columns split among the ranks
# that hold the same tokens
MOE_PARTS = {
    "dbrx-132b": dict(batch=4, seq=2, qkv=2, kv=2, ffn=1, vocab=2, cache_batch=4, cache_seq=2),
    "mixtral-8x22b": dict(batch=2, seq=4, qkv=4, kv=4, ffn=1, vocab=4, cache_batch=2,
                          cache_seq=4),
}
MOE_DECODE = {"dbrx-132b": dict(experts=2, expert_ffn=1),
              "mixtral-8x22b": dict(experts=2, expert_ffn=2)}


def _moe_parts(arch: str, cell) -> dict:
    parts = dict(MOE_PARTS[arch])
    if cell.kind == "decode":
        parts.update(seq=1, **MOE_DECODE[arch])
    return parts


@pytest.fixture(scope="module")
def moe_dry(tmp_path_factory):
    """The port's dry-run records of the MoE smoke cells on 8 fake ranks,
    and its roofline records of the same cells (each arch on its mesh,
    under its profile)."""
    out = tmp_path_factory.mktemp("moe_dry")
    _run(f"""
        import json
        from pathlib import Path
        import torch.distributed as dist
        import repro_torch.configs as C
        from repro_torch.launch.dryrun import make_mesh, run_cell
        from repro_torch.launch.roofline import analyze_cell
        from repro_torch.substrate import fake_store, init_group
        init_group("fake", 0, 8, store=fake_store())
        for arch, mesh_kind, prof in {MOE_CASES!r}:
            mesh = make_mesh(mesh_kind, smoke=True, device_type="cpu")
            for cell in {MOE_CELLS!r}:
                assert run_cell(arch, cell, mesh_kind, True, Path({str(out)!r}), profile=prof,
                                device="cpu")
                rec = analyze_cell(C.get(arch, smoke=True), C.smoke_cell(cell), mesh,
                                   profile=prof, device="cpu")
                open({str(out)!r} + f"/roof_{{arch}}_{{cell}}.json", "w").write(
                    json.dumps(rec, default=float))
        dist.destroy_process_group()
    """)
    recs = {}
    for arch, mesh_kind, prof in MOE_CASES:
        tag = "" if prof == "baseline" else f"__{prof}"
        for cell in MOE_CELLS:
            recs[arch, cell] = (
                json.loads((out / f"{arch}__{cell}__{mesh_kind}{tag}.json").read_text()),
                json.loads((out / f"roof_{arch}_{cell}.json").read_text()))
    return recs


MOE_KEYS = [(a, c) for a, _, _ in MOE_CASES for c in MOE_CELLS]


@pytest.mark.parametrize("arch, cell", MOE_KEYS, ids=["-".join(k) for k in MOE_KEYS])
def test_dryrun_moe_flops_hand_count(moe_dry, arch, cell):
    """The MoE family's sharded train step, prefill and decode step (dbrx
    smoke's experts apart on ``model``, mixtral smoke's under ``moe_ep``):
    the dry-run's per-device product FLOPs equal ``hand_train_flops`` /
    ``hand_prefill_flops`` / ``hand_decode_flops`` with the MoE block's
    counts."""
    import repro_torch.configs as C
    from repro_torch.models.tensor_parallel import (hand_decode_flops, hand_prefill_flops,
                                                    hand_train_flops)
    rec, _ = moe_dry[arch, cell]
    assert rec["ok"], rec.get("error")
    cfg, c = C.get(arch, smoke=True), C.smoke_cell(cell)
    hand = dict(train=hand_train_flops, prefill=hand_prefill_flops,
                decode=hand_decode_flops)[c.kind]
    assert rec["cost_analysis"]["flops"] == hand(cfg, c.global_batch, c.seq_len,
                                                 _moe_parts(arch, c))


@pytest.mark.parametrize("arch, cell", MOE_KEYS, ids=["-".join(k) for k in MOE_KEYS])
def test_roofline_moe_block_probe_on_the_plan(moe_dry, arch, cell):
    """The roofline's ``moe_block`` probe runs the planned layer code: its
    per-device product FLOPs equal the block's hand count
    (``tensor_parallel._moe_products``) on this rank's tokens and experts,
    the forward for prefill and decode and, for train, the probe's value and
    gradients (three times the products that differentiate both operands:
    the router, the expert products and the combine; twice the combine
    weights and the dispatch, whose second operand has no gradient), and it
    runs collectives (the dispatched tokens' all-to-alls, or decode's sums
    of the experts' outputs)."""
    import repro_torch.configs as C
    from repro_torch.models.tensor_parallel import _moe_products
    _, roof = moe_dry[arch, cell]
    cfg, c = C.get(arch, smoke=True), C.smoke_cell(cell)
    parts = _moe_parts(arch, c)
    S = 1 if c.kind == "decode" else c.seq_len
    m = _moe_products(cfg, c.global_batch // parts["batch"], S, parts)
    if c.kind == "train":
        want = 3 * (m["router"] + m["experts"] + m["combine"]) + 2 * (m["route"]
                                                                      + m["dispatch"])
    else:
        want = sum(m.values())
    probe = roof["components"]["moe_block"]
    assert probe["flops"] == want
    assert probe["coll"] > 0


# --------------------------------------------------- the hybrid and the VLM
HV_CASES = [("jamba-v0.1-52b", "train_4k", "single"), ("jamba-v0.1-52b", "long_500k", "multi"),
            ("qwen2-vl-72b", "decode_32k", "single")]
HV_IDS = ["-".join(c) for c in HV_CASES]


@pytest.fixture(scope="module")
def hv_dry(tmp_path_factory):
    """The port's dry-run records of the hybrid's and the VLM's smoke cells
    on 8 fake ranks, each case's roofline record, and the hybrid's train
    case through the ZeRO-3 step (``zero3``)."""
    out = tmp_path_factory.mktemp("hv_dry")
    _run(f"""
        import json
        from pathlib import Path
        import torch.distributed as dist
        import repro_torch.configs as C
        from repro_torch.launch.dryrun import make_mesh, run_cell
        from repro_torch.launch.roofline import analyze_cell
        from repro_torch.launch.steps import ShardedTrainStep
        from repro_torch.substrate import fake_store, init_group
        init_group("fake", 0, 8, store=fake_store())
        for arch, cell, mesh_kind in {HV_CASES!r}:
            assert run_cell(arch, cell, mesh_kind, True, Path({str(out)!r}), device="cpu")
            rec = analyze_cell(C.get(arch, smoke=True), C.smoke_cell(cell),
                               make_mesh(mesh_kind, smoke=True, device_type="cpu"), device="cpu")
            open({str(out)!r} + f"/roof_{{arch}}_{{cell}}.json", "w").write(
                json.dumps(rec, default=float))
        ShardedTrainStep.loss_and_grads = ShardedTrainStep._zero3
        assert run_cell(*{HV_CASES[0]!r}, True, Path({str(out / 'zero3')!r}), device="cpu")
        dist.destroy_process_group()
    """)
    recs = {case: (json.loads((out / f"{case[0]}__{case[1]}__{case[2]}.json").read_text()),
                   json.loads((out / f"roof_{case[0]}_{case[1]}.json").read_text()))
            for case in HV_CASES}
    recs["zero3"] = json.loads((out / "zero3" / "{}__{}__{}.json".format(*HV_CASES[0]))
                               .read_text())
    return recs


def _hv_keep(path: str, p, spec, plan) -> tuple[str, ...]:
    """The mesh axes a parameter's working layout keeps: none for the MoE
    router, an SSM block's conv weights and, but in decode, a q / k / v
    weight whose heads do not split (whole); the SSM heads' axes for its
    ``norm``'s and ``out_proj``'s ``ssm_inner`` rows; else all but the
    embed axes, the tables' ``table`` axes kept.  On a one-row decode plan,
    :func:`_stationary_keep`."""
    if plan["stationary"]:
        return _stationary_keep(path, p, spec, plan)
    name = path.rsplit("/", 1)[-1]
    if name == "router" or ("ssm_inner" in p.logical and name in ("conv_w", "conv_b")):
        return ()
    if plan["cell"].kind != "decode" and ((name == "wq" and not plan["q_local"])
                                          or (name in ("wk", "wv") and not plan["kv_local"])):
        return ()
    kept = plan["table"] if path in ("/embed", "/unembed") else ()
    return tuple(ax for e, lname in zip(spec, p.logical) for ax in (
        tuple(a for a in e if a in kept) if lname in ("embed", "embed_d")
        else plan["heads"] if lname == "ssm_inner" and name in ("norm", "out_proj") else e))


def _count(wire) -> tuple[int, dict]:
    counts: dict = {}
    for kind, _ in wire:
        counts[kind] = counts.get(kind, 0) + 1
    return sum(b for _, b in wire), counts


def _hand_hybrid_decode_collectives(arch: str, cell_name: str, mesh_kind: str):
    """Per-device collective bytes and executions of the hybrid's planned
    decode step on a smoke mesh, from the specs (weights and the stream in
    bf16; the SSM norm's scale, the partial softmax, the gated norm's sums
    and the logits in float32):

    * each parameter gathered over the axes its working layout drops (a
      block's where its period runs, :func:`_weight_gathers`);
    * an SSM layer: the one-token ``in_proj`` row gathered over its
      columns' axes, the conv history's rows over its channels', the gated
      norm's sum of squares and ``out_proj``'s partial sums over the heads';
    * an attention layer: q, k and v gathered over their weights' columns'
      axes, the partial softmax's max, sum and weighted sum over the cache's
      sequence axes, ``wo``'s partial sums over the heads';
    * the MLP's partial sums over its columns' axes, the experts' outputs
      over the experts' (each rank its own experts of the same tokens);
    * the embedding, the unembedding and the greedy token as
      ``decode_ends`` gives them (the rows traded for the tables' columns
      over the ``table`` axes).

    A plan whose rows leave the weights' embed axes whole (one row):
    :func:`_stationary_decode_wire`."""
    plan = _hv_plan(arch, cell_name, "baseline", mesh_kind)
    if plan["stationary"]:
        return _count(_stationary_decode_wire(plan))
    cfg, cell, sizes = plan["cfg"], plan["cell"], plan["sizes"]
    B, D, V, hd = cell.global_batch, cfg.d_model, cfg.vocab, cfg.hd
    di, H, N, k = cfg.d_inner, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_conv

    def n(axes) -> int:
        return math.prod(sizes[ax] for ax in axes)
    R, Rc = B // n(plan["batch"]), B // n(plan["cache_batch"])
    bf, f32 = 2, 4
    wire = []

    def add(ops, itemsize):
        wire.extend((kind, m * itemsize) for kind, m in ops)
    for path, p in _pspec_paths(plan["model"].specs()):
        spec = plan["spec"](p)
        own = "ssm_inner" in p.logical and path.endswith("/norm")     # travels in float32
        add(_weight_gathers(path, p, spec, sizes, _hv_keep(path, p, spec, plan)),
            f32 if own else bf)
    emb, ends = decode_ends(R, D, V, sizes, plan["batch"], plan["vocab"], table=plan["table"])
    wire += emb
    for _ in range(cfg.n_layers // cfg.period):
        for mixer, channel in cfg.layer_pattern():
            if mixer == "ssm":
                add([("all-gather", R * (2 * di + 2 * N + H))] if plan["columns"] else [], bf)
                add([("all-gather", Rc * (k - 1) * (di + 2 * N))] if plan["conv"] else [], bf)
                add(_Stream.sum(R, plan["heads"]), f32)
                add(_Stream.sum(R * D, plan["heads"]), bf)
            else:
                heads = [(cfg.n_heads, plan["qkv"]), (cfg.n_kv_heads, plan["kv"]),
                         (cfg.n_kv_heads, plan["kv"])]
                add([("all-gather", R * h * hd) for h, axes in heads if axes], bf)
                add(_Stream.sum(Rc * cfg.n_heads, plan["cache_seq"]) * 2
                    + _Stream.sum(Rc * cfg.n_heads * hd, plan["cache_seq"]), f32)
                add(_Stream.sum(R * D, plan["qkv"]), bf)
            add(_Stream.sum(R * D, plan["ffn"] if channel == "mlp" else plan["experts"]), bf)
    return _count(wire + ends)


def _stationary_keep(path: str, p, spec, plan) -> tuple[str, ...]:
    """The mesh axes a parameter's working layout keeps on a decode plan
    whose weights stay on their embed shards (``plan["stationary"]``: the
    embed axes the rows leave whole): its embed entries' stationary axes,
    the SSM heads' axes for an SSM block's ``norm``'s and ``out_proj``'s
    ``ssm_inner`` rows, every other entry's axes (the q / k / v weights'
    columns and the router's too); the conv weights whole only where their
    channels do not split as the conv history's (``plan["conv"]``)."""
    name = path.rsplit("/", 1)[-1]
    entries = _entries(spec)
    if "ssm_inner" in p.logical and name in ("conv_w", "conv_b") and \
            entries[-1] != tuple(plan["conv"]):
        return ()
    return tuple(ax for e, lname in zip(entries, p.logical) for ax in (
        tuple(a for a in e if a in plan["stationary"]) if lname in ("embed", "embed_d")
        else plan["heads"] if lname == "ssm_inner" and name in ("norm", "out_proj") else e))


def _stationary_weight_gathers(plan) -> list:
    """The weight all-gathers of a one-row decode plan (:func:`_stationary_keep`):
    (kind, elements), each leaf's a period at a time."""
    from repro_torch.models import build
    from repro_torch.models.common import resolve_spec
    out = []
    for path, p in _pspec_paths(build(plan["cfg"]).specs()):
        spec = resolve_spec(p.shape, p.logical, plan["sizes"])
        out += _weight_gathers(path, p, spec, plan["sizes"], _stationary_keep(path, p, spec, plan))
    return out


def _stationary_decode_wire(plan) -> list:
    """(kind, bytes a device) of each collective of a decode step whose
    weights stay on their embed shards (``plan["stationary"]``, the row's
    unsplit embed axes), in the order they run, from the specs (the stream,
    the products' partial sums and the weights in bf16; the gated norm's
    sums, the partial softmax and the logits in float32).  A sum over an
    axis is an all-reduce (twice its elements); a gather over axes one
    all-gather an axis, the minor first, each of its result:

    * the weights: none move (:func:`_stationary_weight_gathers`);
    * the embedding and the unembedding with the greedy token:
      ``decode_ends`` over the stationary axes;
    * an SSM layer: ``in_proj``'s partial products summed over the
      stationary axes, the row gathered over its columns' axes, the conv's
      output over the conv history's channels' (the history does not move),
      the gated norm's sum of squares and ``out_proj``'s partial sums over
      the heads', its columns gathered over the stationary axes;
    * an attention layer: q, k and v each summed over the stationary axes
      and gathered over its weight's columns' axes, the partial softmax's
      max, sum and weighted sum over the cache's sequence axes, ``wo``'s
      partial sums over the heads' axes and its columns gathered;
    * an MLP: the gate's and the up projection's partial products summed,
      the down projection's partial sums over its columns' axes, its
      columns gathered;
    * a MoE block (one-token groups): the router's partial logits summed and
      gathered over the experts' axes, the experts' up projections summed
      over the stationary axes, the outputs over the experts' (each rank its
      own experts of the same tokens) and hidden columns' axes, the columns
      gathered."""
    cfg, cell, sizes = plan["cfg"], plan["cell"], plan["sizes"]

    def n(axes) -> int:
        return math.prod(sizes[ax] for ax in axes)

    def summed(m: int, axes) -> list:
        return [("all-reduce", 2 * m)] * len(axes)

    def gathered(m: int, axes) -> list:
        out, m = [], m // n(axes)
        for ax in reversed(axes):
            m *= sizes[ax]
            out.append(("all-gather", m))
        return out
    st = plan["stationary"]
    B, D, V, hd = cell.global_batch, cfg.d_model, cfg.vocab, cfg.hd
    di, H, N = cfg.d_inner, cfg.ssm_heads, cfg.ssm_state
    R, Rc, e = B // n(plan["batch"]), B // n(plan["cache_batch"]), n(st)
    bf, f32 = 2, 4
    wire = []

    def add(ops, itemsize):
        wire.extend((kind, m * itemsize) for kind, m in ops)
    add(_stationary_weight_gathers(plan), bf)
    emb, ends = decode_ends(R, D, V, sizes, plan["batch"], plan["vocab"], stationary=st)
    wire += emb
    for _ in range(cfg.n_layers // cfg.period):
        for mixer, channel in cfg.layer_pattern():
            if mixer == "ssm":
                C = 2 * di + 2 * N + H
                add(summed(R * C // n(plan["columns"]), st) + gathered(R * C, plan["columns"])
                    + gathered(Rc * (di + 2 * N), plan["conv"]), bf)
                add(summed(R, plan["heads"]), f32)
                add(summed(R * D // e, plan["heads"]) + gathered(R * D, st), bf)
            else:
                for width, axes in ((cfg.n_heads * hd, plan["qkv"]),
                                    (cfg.n_kv_heads * hd, plan["kv"]),
                                    (cfg.n_kv_heads * hd, plan["kv"])):
                    add(summed(R * width // n(axes), st) + gathered(R * width, axes), bf)
                add(summed(Rc * cfg.n_heads, plan["cache_seq"]) * 2
                    + summed(Rc * cfg.n_heads * hd, plan["cache_seq"]), f32)
                add(summed(R * D // e, plan["qkv"]) + gathered(R * D, st), bf)
            if channel == "mlp":
                ups = 2 if cfg.mlp_style == "swiglu" else 1
                add(summed(R * cfg.d_ff // n(plan["ffn"]), st) * ups
                    + summed(R * D // e, plan["ffn"]) + gathered(R * D, st), bf)
            elif channel == "moe":
                E = cfg.n_experts
                C = max(1, int(cfg.capacity_factor * cfg.top_k / E))
                hidden = R * E // n(plan["experts"]) * C * (cfg.d_ff // n(plan["expert_ffn"]))
                add(summed(R * E // n(plan["experts"]), st) + gathered(R * E, plan["experts"])
                    + summed(hidden, st) * 2
                    + summed(R * D // e, plan["experts"] + plan["expert_ffn"])
                    + gathered(R * D, st), bf)
    return wire + ends


def _hand_hybrid_train_collectives(arch: str, cell_name: str):
    """Per-device collective bytes and executions of the hybrid's planned
    train step on the (data 4, model 2) smoke mesh, from the specs (the
    stream and the expert weights in bf16; the other weights, the norms'
    and the loss's sums and the routing counts in float32):

    * each parameter gathered over the axes its working layout drops (a
      block's a period at a time, in the forward and again in the
      recompute, :func:`_weight_gathers`);
    * the embedding over the split vocabulary: the tokens' sequence
      gathered (int32), the partial rows into the stream and back;
    * each period (its layers checkpointed together): the forward's
      collectives twice (the forward and the recompute: the period's last
      product, its MoE block's combine, is followed by none), then each
      one's adjoint.  An SSM layer: the stream's sequence gathered,
      ``in_proj``'s output exchanged to the heads' columns, the gated norm's
      sum of squares summed over the heads, ``out_proj``'s partial sums
      reduce-scattered (backward: the exchange returns what rank 0 sent,
      :func:`test_torch_ssm_parallel._sent_columns`).  An attention layer
      and an MLP: the stream's sequence gathered, the partial sums brought
      into the stream.  A MoE block whose groups span the sequence's ranks
      and whose experts split it: the group's expert counts, ``f`` and
      ``pbar`` gathered over the sequence (``pbar``'s adjoint a
      reduce-scatter), the dispatched tokens and the experts' outputs each
      an all-to-all over the experts' axes (each one's adjoint too);
    * the loss as the dense step's (:func:`_hand_tp_collectives`), the label
      counts, the loss, the squared norms, each working gradient summed into
      its parameter's layout (a block's a period at a time)."""
    from repro_torch.models.moe import GROUP
    from test_torch_ssm_parallel import _sent_columns
    plan = _hv_plan(arch, cell_name)
    cfg, cell, sizes = plan["cfg"], plan["cell"], plan["sizes"]
    assert sizes == SMOKE_MESH and plan["experts"] == plan["seq"]
    B, S, D = cell.global_batch, cell.seq_len, cfg.d_model
    di, H, N, E = cfg.d_inner, cfg.ssm_heads, cfg.ssm_state, cfg.n_experts
    R, ns = B // _parts(plan["batch"]), _parts(plan["seq"])
    Sl = S // ns
    full, own = R * S * D, R * Sl * D
    nh, nc = _parts(plan["heads"]), _parts(plan["columns"])
    cols = 2 * di // nh + 2 * N + H // nh
    gs = min(GROUP, S)
    nF = Sl // min(gs, Sl)
    assert gs > Sl      # a group spans ranks of the sequence
    dispatched = R * E * nF * max(1, int(cfg.capacity_factor * gs * cfg.top_k / E)) * D
    st = _Stream(plan)
    bf, f32, i32 = 2, 4, 4
    wire = []

    def add(ops, itemsize):
        wire.extend((kind, m * itemsize) for kind, m in ops)
    leaves = []
    for path, p in _pspec_paths(plan["model"].specs()):
        spec = plan["spec"](p)
        keep = _hv_keep(path, p, spec, plan)
        leaves.append((path, p, spec, keep))
        expert = "experts" in p.logical and "ffn" in p.logical
        add(_weight_gathers(path, p, spec, sizes, keep, train=True), bf if expert else f32)
    vocab = plan["vocab"]
    add(st.gather(R * Sl), i32)
    add(st.to_stream(full, vocab) + st.to_stream_back(full, vocab), bf)
    fwd, fwd32, back, back32 = [], [], [], []
    for mixer, channel in cfg.layer_pattern():
        if mixer == "ssm":
            fwd += st.gather(own) + [("all-to-all", R * S * cols)] + st.scatter(full)
            fwd32 += st.sum(R * S, plan["heads"])
            back += st.gather(own) + [("all-to-all", R * S * _sent_columns(cfg, nc, nh))] \
                + st.scatter(full)
            back32 += st.sum(R * S, plan["heads"])
        else:
            fwd += st.gather(own) + st.to_stream(full, plan["qkv"])
            back += st.to_stream_back(full, plan["qkv"]) + st.scatter(full)
        if channel == "mlp":
            fwd += st.gather(own) + st.to_stream(full, plan["ffn"])
            back += st.to_stream_back(full, plan["ffn"]) + st.scatter(full)
        else:
            fwd32 += [("all-gather", R * nF * ns * E)] * 3
            fwd += [("all-to-all", dispatched)] * 2
            back32 += [("reduce-scatter", R * nF * E)]
            back += [("all-to-all", dispatched)] * 2
    for _ in range(cfg.n_layers // cfg.period):
        add(fwd * 2 + back, bf)
        add(fwd32 * 2 + back32, f32)
    add(st.gather(own) + st.scatter(full), bf)
    add(st.gather(R * Sl), i32)
    c = min(cfg.loss_chunk, S)
    add(st.sum(R * c, vocab) * 8 * (-(-S // c)), f32)
    every = tuple(sizes)
    add(st.sum(1, every) * 2 + st.sum(len(leaves), every), f32)
    for path, p, spec, keep in leaves:
        add(_per_period(_tp_reduction(math.prod(p.shape), spec, keep, sizes),
                        _periods(path, p)), f32)
    return _count(wire)


@pytest.mark.parametrize("case", HV_CASES, ids=HV_IDS)
def test_dryrun_hybrid_vlm_flops_hand_count(hv_dry, case):
    """The planned train step (jamba smoke) and decode steps (jamba smoke's
    ``long_500k`` on (pod 2, data 2, model 2), qwen2-vl smoke's
    ``decode_32k``): the dry-run's per-device product FLOPs equal
    ``hand_train_flops`` / ``hand_decode_flops`` summed over the layer
    pattern, with the ranks each axis splits over from the specs."""
    from repro_torch.models.tensor_parallel import hand_decode_flops, hand_train_flops
    rec, _ = hv_dry[case]
    assert rec["ok"], rec.get("error")
    hand = _hv_plan(case[0], case[1], "baseline", case[2])
    c = hand["cell"]
    fn = hand_train_flops if c.kind == "train" else hand_decode_flops
    assert rec["cost_analysis"]["flops"] == fn(hand["cfg"], c.global_batch, c.seq_len,
                                               hand["parts"])


@pytest.mark.parametrize("case", HV_CASES, ids=HV_IDS)
def test_dryrun_hybrid_vlm_collectives_hand_count(hv_dry, case):
    """Each case's collective bytes a device and its executions of each kind
    equal the hand count from the specs: the hybrid's train step
    (:func:`_hand_hybrid_train_collectives`) and decode step
    (:func:`_hand_hybrid_decode_collectives`), the VLM's decode step as the
    dense family's (:func:`_hand_serve_collectives`: its positions lie as
    its stream's rows, so they move nothing)."""
    rec, _ = hv_dry[case]
    arch, cell, mesh = case
    if cell == "train_4k":
        want, counts = _hand_hybrid_train_collectives(arch, cell)
    elif arch == "qwen2-vl-72b":
        want, counts = _hand_serve_collectives(cell, arch)
    else:
        want, counts = _hand_hybrid_decode_collectives(arch, cell, mesh)
    assert rec["collectives"]["collective_bytes_per_device"] == want
    assert rec["collectives"]["collective_bytes"] == want * 8
    assert rec["collectives"]["op_counts"] == counts


@pytest.mark.parametrize("case", HV_CASES, ids=HV_IDS)
def test_dryrun_hybrid_vlm_temp_holds_working_layouts(hv_dry, case):
    """The planned steps gather a period's blocks where the period runs: a
    decode step's temp at least one period's share of the bytes its working
    layout moves in bf16 and every other moved leaf's, the train step's at
    least twice one period's working state and every other leaf's (the
    working weights and their gradients, float32); each below the parent's
    temp on the same case (:data:`PARENT_TEMP`), which held every period's
    at once, a decode step's below half the whole parameters', the train
    step's below the ZeRO-3 step's on the same case, which gathers every
    parameter and holds every gradient whole."""
    rec, _ = hv_dry[case]
    plan = _hv_plan(case[0], case[1], "baseline", case[2])
    cfg, sizes, mem = plan["cfg"], plan["sizes"], rec["memory_analysis"]
    whole = 0
    working, moved = [], []
    for path, p in _pspec_paths(plan["model"].specs()):
        spec = plan["spec"](p)
        keep = _hv_keep(path, p, spec, plan)
        numel = math.prod(p.shape)
        whole += numel * _itemsize(cfg.param_dtype)
        working.append((path, p, numel // math.prod(sizes[ax] for ax in keep)
                        * _itemsize(cfg.param_dtype)))
        if set(keep) != {ax for e in spec for ax in e}:
            moved.append((path, p, numel // math.prod(sizes[ax] for ax in keep) * 2))
    temp = mem["temp_size_in_bytes"]
    print(case, temp, _held_at_once(working), _held_at_once(moved), PARENT_TEMP[case], whole)
    assert temp < PARENT_TEMP[case], (temp, PARENT_TEMP[case])
    if plan["cell"].kind == "train":
        zero3 = hv_dry["zero3"]["memory_analysis"]["temp_size_in_bytes"]
        assert 2 * _held_at_once(working) <= temp < zero3 and zero3 >= 2 * whole, \
            (temp, working, zero3)
    else:
        assert _held_at_once(moved) <= temp < whole // 2, (temp, moved, whole)


@pytest.mark.parametrize("case", HV_CASES, ids=HV_IDS)
def test_roofline_hybrid_vlm_probes_on_the_plan(hv_dry, case):
    """The roofline's probes run the planned layer code: the ``mlp_block``
    probe's per-device product FLOPs equal the MLP's on this rank's columns
    (the forward; train: its value and gradients, three times), the
    ``moe_block`` probe's the block's hand count (``_moe_products`` on this
    rank's tokens and experts, as the MoE family's test holds it), and each
    of them runs collectives (the plan's stream or experts)."""
    from repro_torch.models.tensor_parallel import _mlp_products, _moe_products
    _, roof = hv_dry[case]
    hand = _hv_plan(case[0], case[1], "baseline", case[2])
    cfg, c, parts = hand["cfg"], hand["cell"], hand["parts"]
    S = 1 if c.kind == "decode" else c.seq_len
    rows = c.global_batch // parts["batch"]
    blocks = {"mlp_block": _mlp_products(cfg, rows, S, parts)}
    if cfg.n_experts:
        blocks["moe_block"] = _moe_products(cfg, rows, S, parts)
    for name, m in blocks.items():
        if c.kind != "train":
            want = sum(m.values())
        elif name == "mlp_block":
            want = 3 * sum(m.values())
        else:
            want = 3 * (m["router"] + m["experts"] + m["combine"]) + 2 * (m["route"]
                                                                          + m["dispatch"])
        probe = roof["components"][name]
        assert probe["flops"] == want, (name, probe["flops"], want)
        assert probe["coll"] > 0


ENCDEC_CELLS = ("train_4k", "prefill_32k", "decode_32k")


@pytest.fixture(scope="module")
def encdec_roof():
    """Both packages' roofline records of whisper smoke's three cells on the
    (4, 2) smoke mesh under the baseline profile: each probe's per-device
    FLOPs and the cell's per-device total."""
    body = """
        import json
        import repro{pkg}.configs as C
        from repro{pkg}.launch.dryrun import make_mesh
        from repro{pkg}.launch.roofline import analyze_cell
        {init}
        out = {{}}
        for cell in {cells!r}:
            rec = analyze_cell(C.get("whisper-tiny", smoke=True), C.smoke_cell(cell), {mesh},
                               profile="baseline"{device})
            out[cell] = dict(probes={{k: v["flops"] for k, v in rec["components"].items()}},
                             total=rec["hlo_flops_global"] / rec["chips"])
        print("RESULT" + json.dumps(out, default=float))
    """
    ref = _run(body.format(pkg="", init="", cells=ENCDEC_CELLS, device="",
                           mesh='make_mesh("single", smoke=True)'),
               env={"REPRO_DRYRUN_DEVICES": "8", "JAX_PLATFORMS": "cpu"})
    port = _run(body.format(
        pkg="_torch", cells=ENCDEC_CELLS, device=', device="cpu"',
        init="from repro_torch.substrate import fake_store, init_group; "
             "init_group('fake', 0, 8, store=fake_store())",
        mesh='make_mesh("single", smoke=True, device_type="cpu")'))
    return tuple(json.loads(r.stdout.split("RESULT", 1)[1]) for r in (ref, port))


@pytest.mark.parametrize("cell", ENCDEC_CELLS)
def test_roofline_encdec_probes_on_the_plan(encdec_roof, cell):
    """whisper smoke's probes run its plan: the encoder's blocks are probes
    of their own at the 64 frames on the frames' layout (the reference folds
    them into the decoder's probes as fractional trips), the ``mlp_block``
    and ``enc_mlp_block`` probes' FLOPs the MLP's on this rank's columns
    (train: its value and gradients, three times); each probe both packages
    have at or below the reference's FLOPs, but where ``ABOVE_REFERENCE``
    says why, and the cell's total below the reference's; the ratios are
    printed."""
    from repro_torch import configs as C
    from repro_torch.models.tensor_parallel import _mlp_products
    ref, port = (r[cell] for r in encdec_roof)
    cfg, c = C.get("whisper-tiny", smoke=True), C.smoke_cell(cell)
    _, _, plan = _serve_plan(cell, "whisper-tiny")
    parts = {k: _parts(plan[k]) for k in ("batch", "ffn")}
    rows = c.global_batch // parts["batch"]
    S = 1 if c.kind == "decode" else c.seq_len
    blocks = {"mlp_block": S} if c.kind == "decode" else {"mlp_block": S,
                                                          "enc_mlp_block": cfg.enc_seq}
    for name, n in blocks.items():
        want = sum(_mlp_products(cfg, rows, n, parts).values())
        assert port["probes"][name] == want * (3 if c.kind == "train" else 1), name
    for name in sorted(set(ref["probes"]) & set(port["probes"])):
        got, want = port["probes"][name], ref["probes"][name]
        print(f"whisper {cell} {name}: port / reference FLOPs {got / max(want, 1):.4f}")
        if (cell, "baseline", name) in ABOVE_REFERENCE:
            assert got > want
        else:
            assert got <= want
    print(f"whisper {cell}: the cell's FLOPs {port['total'] / ref['total']:.4f} x the "
          f"reference's")
    assert port["total"] < ref["total"]


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


def _hand_flops(name: str, profile: str, arch: str = "granite-3-8b", **overrides) -> int:
    """Per-device product FLOPs of a granite smoke train_4k probe (or
    ``arch``'s with ``overrides``), run as the tensor-parallel step runs a
    layer (forward and gradients; a product's backward is two of its size):
    the projections on this rank's rows of the whole sequence and its
    columns (q, where the heads do not split, on its query slice), the loss
    chunk on its columns of the vocabulary."""
    cfg, cell, plan = _plan(profile, arch, **overrides)
    B, S, D, hd = cell.global_batch, cell.seq_len, cfg.d_model, cfg.hd
    rows = B // _parts(plan["batch"])
    T = rows * S                                   # the gathered sequence of this rank's rows
    Tq = rows * -(-S // _parts(plan["q_slice"]))   # the queries of this rank's rows
    n = _parts(plan["qkv"])
    q = (cfg.n_heads // n if plan["q_local"] else cfg.n_heads) * hd
    kv = (cfg.n_kv_heads // n if plan["kv_local"] else 1 if plan["q_local"]
          else cfg.n_kv_heads) * hd
    o = cfg.n_heads * hd // n                      # this rank's rows of wo
    if name == "attn_proj":
        # forward: q, k, v, o; the output reaches only v and o, so only
        # their backward runs
        return 2 * D * (Tq * q + T * (2 * kv + o)) + 2 * (2 * T * o * D + 2 * T * D * kv)
    if name == "mlp_block":   # swiglu: three products
        return 3 * 3 * 2 * T * D * (cfg.d_ff // _parts(plan["ffn"]))
    if name == "loss_chunk":
        Tc = rows * min(cfg.loss_chunk, S)         # the chunk's tokens, not split over seq
        return 3 * 2 * Tc * D * (cfg.vocab // _parts(plan["vocab"]))
    if name == "attn_tile":   # two products forward, four backward
        tile = _local((B, cfg.n_heads, 512, cfg.hd), ("batch", "heads", "tile_q", "none"),
                      profile)
        return 6 * 2 * tile * 1024
    return 0                  # embed and adamw: no products


#: (cell, profile, probe) whose per-device FLOPs exceed the reference's HLO
#: FLOPs, and why (ROADMAP Queue 3)
ABOVE_REFERENCE = {
    ("train_4k", "baseline", "attn_proj"): "computes q and k, which XLA drops as dead",
    ("train_4k", "serve", "attn_proj"): "computes q and k, which XLA drops as dead",
    # the probe's output reaches only v and o: XLA drops the q and k
    # products, the port runs them on this rank's heads (1.82 x)
    ("prefill_32k", "baseline", "attn_proj"): "computes q and k, which XLA drops as dead",
    # the same, on the whole stream every rank holds under serve (6.71 x)
    ("prefill_32k", "serve", "attn_proj"): "computes q and k, which XLA drops as dead",
}
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
    print(f"{profile} {name}: port / reference FLOPs {got / want:.4f}")
    assert got == _hand_flops(name, profile)
    if ("train_4k", profile, name) in ABOVE_REFERENCE:
        assert got > want
    else:
        assert got <= want


def _hand_probe_collectives(name: str, profile: str, arch: str = "granite-3-8b",
                            **overrides) -> int:
    """Per-device collective bytes of a granite smoke train_4k probe (or
    ``arch``'s with ``overrides``), run as the tensor-parallel step runs a
    layer: each parameter gathered over the
    axes its working layout drops (:func:`_gathers`) and its gradient summed
    back into its layout (:func:`_tp_reduction`), float32; the stream's
    collectives of the layer code and their adjoints (:class:`_Stream`):
    the attention's and the MLP's input gathered and output brought into the
    stream (bf16; where the q heads do not split, its query slice's output
    brought to ``wo``'s columns by an all-to-all an axis, and back in the
    backward), the embedding's tokens gathered (int32) and rows brought
    into the stream, the loss chunk's max, sum of exponentials and gold
    logit summed over the vocab axes and the two sums' adjoints (float32;
    the chunk's tokens are every rank's of the vocab axes already)."""
    from repro_torch.models.common import PSpec, resolve_spec
    from repro_torch.models.layers import attn_specs, mlp_specs, rmsnorm_spec
    cfg, cell, plan = _plan(profile, arch, **overrides)
    B, S, D, V = cell.global_batch, cell.seq_len, cfg.d_model, cfg.vocab
    rows = B // _parts(plan["batch"])
    full, own = rows * S * D, rows * (S // _parts(plan["seq"]))
    st = _Stream(plan)
    c = min(cfg.loss_chunk, S)
    sliced = [("all-to-all", rows * -(-S // _parts(plan["q_slice"])) * cfg.n_heads * cfg.hd)
              for _ in plan["q_slice"]] * 2
    params, acts = {
        "attn_proj": ({"norm": rmsnorm_spec(D), **attn_specs(cfg)},
                      [(2, st.gather(own * D) + st.to_stream(full, plan["qkv"]) + sliced
                        + st.to_stream_back(full, plan["qkv"]) + st.scatter(full))]),
        "mlp_block": ({"norm": rmsnorm_spec(D), **mlp_specs(cfg)},
                      [(2, st.gather(own * D) + st.to_stream(full, plan["ffn"])
                        + st.to_stream_back(full, plan["ffn"]) + st.scatter(full))]),
        "loss_chunk": ({"unembed": PSpec((D, V), ("embed_d", "vocab"))},
                       [(4, st.sum(rows * c, plan["vocab"]) * 5)]),
        "embed": ({"embed": PSpec((V, D), ("vocab", "embed_d"))},
                  [(4, st.gather(own) if plan["vocab"] else []),
                   (2, st.to_stream(full, plan["vocab"]) + st.to_stream_back(full, plan["vocab"])
                    if plan["vocab"] else [])]),
    }.get(name, ({}, []))
    total = sum(itemsize * n for itemsize, ops in acts for _, n in ops)
    for path, p in _pspec_paths(params):
        spec = resolve_spec(p.shape, p.logical, SMOKE_MESH, profile=profile)
        keep = _working_keep(path, p, spec, plan)
        total += 4 * sum(_gathers(math.prod(p.shape), spec, SMOKE_MESH, keep))
        total += 4 * sum(k for _, k in _tp_reduction(math.prod(p.shape), spec, keep, SMOKE_MESH))
    return total


@pytest.mark.parametrize("name", PROBES)
@pytest.mark.parametrize("profile", PROFILES)
def test_roofline_probe_collectives(roof, profile, name):
    """Each probe's per-device collective bytes equal their hand count."""
    _, port = roof[profile]
    assert port["components"][name]["coll"] == _hand_probe_collectives(name, profile)


def _hand_cell(roof, profile) -> tuple[float, float, float]:
    """The cell's per-device FLOPs, fusion-ideal bytes and collective bytes
    by hand: each probe's hand count times its trips, a gradient probe's
    FLOPs and bytes once more a third for ``remat = "full"`` (the
    reference's approximation), but the loss chunk's; the bytes are the
    reference's."""
    from repro_torch import configs as C
    ref, port = roof[profile]
    remat = C.get("granite-3-8b", smoke=True).remat == "full"
    flops = nbytes = coll = 0.0
    for name, comp in port["components"].items():
        again = 1 + (1 / 3 if comp["grad"] and remat and name != "loss_chunk" else 0)
        flops += _hand_flops(name, profile) * comp["trips"] * again
        nbytes += ref["components"][name]["bytes"] * comp["trips"] * again
        coll += _hand_probe_collectives(name, profile) * comp["trips"]
    return flops, nbytes, coll


@pytest.mark.parametrize("profile", PROFILES)
def test_roofline_terms_from_hand_counts(roof, profile):
    """The cell's three terms and its global FLOPs are the hand counts of
    its probes (:func:`_hand_cell`) over the H100's peaks."""
    _, port = roof[profile]
    flops, nbytes, coll = _hand_cell(roof, profile)
    assert port["terms"]["compute_s"] == pytest.approx(flops / 989e12, rel=1e-12)
    assert port["terms"]["memory_s"] == pytest.approx(nbytes / 3.35e12, rel=1e-12)
    assert port["terms"]["collective_s"] == pytest.approx(coll / 450e9, rel=1e-12)
    assert port["hlo_flops_global"] == pytest.approx(flops * port["chips"], rel=1e-12)
    assert port["step_time_lower_bound_s"] == max(port["terms"].values())


def _coll(rec) -> float:
    return sum(c["coll"] * c["trips"] for c in rec["components"].values())


#: the most the cell's collective bytes may be over the reference's, by
#: profile: under ``baseline`` no more than XLA's partitioning moves; under
#: ``serve`` (the heads and the MLP on ("model", "data"), the stream whole)
#: twice, since the port sums a row-parallel product's partial sums with an
#: all-reduce over each of the two axes in turn, each counted as twice its
#: result, where XLA's one all-reduce over the 8-rank group counts so once
COLL_OVER_REFERENCE = {"baseline": 1.0, "serve": 2.0}


@pytest.mark.parametrize("profile", PROFILES)
def test_roofline_cell_ratios_to_reference(roof, profile):
    """The cell's global FLOPs sit below the reference's under both profiles
    (the tensor-parallel probes split over ``model`` what XLA splits), and
    its collective bytes are at most ``COLL_OVER_REFERENCE`` times the
    reference's."""
    ref, port = roof[profile]
    flops = port["hlo_flops_global"] / ref["hlo_flops_global"]
    coll = _coll(port) / _coll(ref)
    print(f"{profile}: port / reference FLOPs {flops:.6f}, collective bytes {coll:.6f}")
    assert flops < 1.0
    assert coll <= COLL_OVER_REFERENCE[profile]


SERVE_PROBES = {"prefill_32k": ("attn_proj", "attn_tile", "mlp_block", "loss_chunk", "embed"),
                "decode_32k": ("dec_attn", "mlp_block", "embed+unembed")}
SERVE_KEYS = [(c, p) for c in SERVE_CELLS for p in PROFILES]


@pytest.mark.parametrize("cell, profile", SERVE_KEYS)
def test_roofline_serving_structure_matches_reference(roof_serve, cell, profile):
    """The serving cells' probes: names, trips, chips, mesh shape and model
    FLOPs the reference's; each probe's fusion-ideal bytes within rel
    1e-12."""
    ref, port = roof_serve[(cell, profile)]
    assert "error" not in port, port.get("error")
    for key in ("chips", "mesh_shape", "model_flops"):
        assert port[key] == ref[key], key
    assert list(port["components"]) == list(ref["components"]) == list(SERVE_PROBES[cell])
    for name, got in port["components"].items():
        want = ref["components"][name]
        assert got["trips"] == want["trips"] and not got["grad"], name
        assert got["bytes"] == pytest.approx(want["bytes"], rel=1e-12), name


@pytest.mark.parametrize("cell, profile, name",
                         [(c, p, n) for c, p in SERVE_KEYS for n in SERVE_PROBES[c]])
def test_roofline_serving_probe_flops(roof_serve, cell, profile, name):
    """Each serving probe, run as the sharded step runs its layer, has
    product FLOPs at or below the reference's HLO FLOPs, or above them where
    ``ABOVE_REFERENCE`` says why; the ratio is printed."""
    ref, port = roof_serve[(cell, profile)]
    got, want = port["components"][name]["flops"], ref["components"][name]["flops"]
    print(f"{cell} {profile} {name}: port / reference FLOPs {got / max(want, 1):.4f}")
    if (cell, profile, name) in ABOVE_REFERENCE:
        assert got > want
    else:
        assert got <= want


@pytest.mark.parametrize("cell, profile", SERVE_KEYS)
def test_roofline_serving_cell_ratios_to_reference(roof_serve, cell, profile):
    """The serving cells' global FLOPs below the reference's, their
    collective bytes within ``COLL_OVER_REFERENCE`` of its (under ``serve``
    the partial sums over ("model", "data") go one axis at a time, as in
    train)."""
    ref, port = roof_serve[(cell, profile)]
    flops = port["hlo_flops_global"] / ref["hlo_flops_global"]
    coll = _coll(port) / _coll(ref)
    print(f"{cell} {profile}: port / reference FLOPs {flops:.6f}, collective bytes {coll:.6f}")
    assert flops < 1.0
    assert coll <= COLL_OVER_REFERENCE[profile]


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
