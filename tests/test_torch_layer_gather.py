"""Every planned step gathers a period's stacked block weights where the
period runs (``models.tensor_parallel.StackedWeights``; the reference's
``lax.scan`` of ``jax.checkpoint(body)`` gathers its step's weight shards
inside each scan step), so no step holds every period's working copy at
once.

Each family's smoke model (granite, mixtral, mamba2, jamba, qwen2-vl,
whisper) at K and 2K periods (an encoder-decoder's encoder and decoder each
K and 2K blocks), its planned train step, prefill and decode traced on a
fake group of 4 ranks laid out as (data 2, model 2) under the baseline
profile (``launch.dryrun.trace_step``: fake tensors, nothing allocated; the
train step's loss and gradients, its update writing in place).

Held:

* the gathers' sizes: every all-gather of the K-period trace is in the
  2K-period trace, and what the 2K trace adds holds K times (train: 2K
  times, the recompute's too) each period's weight gathers, by hand from
  the plan's layouts (``_gathers``): a step that gathered a stacked leaf
  whole would gather it at twice the size at 2K periods;
* the temp: a serving step's at 2K exceeds its temp at K by at most the
  added periods' outputs (prefill: each added period's cache shard twice,
  its entries and their stacked copy; decode: nothing, the cache is an
  argument); the train step's by at most the added periods' saved inputs
  (each period's checkpoint holds its input, this rank's slice of the
  stream in the compute type; the encoder-decoder's two streams) and their
  gradients' shards (float32, summed into the shards as the backward leaves
  each period).  Neither bound carries a working-copy term.
"""
import collections
import concurrent.futures
import json
import math
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from conftest import REPO  # noqa: E402
from test_torch_analysis import STACKED, _gathers  # noqa: E402

FAMILIES = {"dense": "granite-3-8b", "moe": "mixtral-8x22b", "ssm": "mamba2-2.7b",
            "hybrid": "jamba-v0.1-52b", "vlm": "qwen2-vl-72b", "encdec": "whisper-tiny"}
CELLS = ("train_4k", "prefill_32k", "decode_32k")
K = 1
SIZES = {"data": 2, "model": 2}
# the traces run in concurrent processes (a process holds one fake group),
# the jobs spread by a rough cost: a train trace takes about three serving
# ones, jamba's (its period is 4 layers, one of them a MoE block, one an
# SSM) about four of another family's
PROCESSES = 5
COST = {"jamba-v0.1-52b": 4.0, "whisper-tiny": 1.5, "mixtral-8x22b": 1.3}


def _cost(job) -> float:
    arch, cell, _ = job
    return COST.get(arch, 1.0) * (3.0 if cell == "train_4k" else 1.0)


def _groups() -> list[list]:
    """Every (arch, cell, periods) trace, the costliest first, each into
    the process with the least work so far."""
    jobs = sorted(((a, c, n) for a in FAMILIES.values() for c in CELLS for n in (K, 2 * K)),
                  key=_cost, reverse=True)
    groups: list[list] = [[] for _ in range(PROCESSES)]
    for job in jobs:
        min(groups, key=lambda g: sum(map(_cost, g))).append(job)
    return groups


TRACE = """
import dataclasses, json
import torch.distributed as dist
import repro_torch.configs as C
from repro_torch.launch.dryrun import trace_step
from repro_torch.launch.steps import ShardedTrainStep
from repro_torch.models import build
from repro_torch.models.common import sorted_leaves, tree_map_pspec
from repro_torch.models.tensor_parallel import plan_decode, plan_prefill, plan_train
from repro_torch.substrate import compat, fake_store, init_group, make_mesh

counters = []
init = compat.CostCounter.__init__


def keep(self):
    init(self)
    counters.append(self)
compat.CostCounter.__init__ = keep
# the train step's loss and gradients: the update writes in place, at any depth
ShardedTrainStep.__call__ = lambda self, params, _, batch: self.loss_and_grads(params, batch)
init_group("fake", 0, 4, store=fake_store())
mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
out = {}
for arch, name, periods in JOBS:
    cell = C.smoke_cell(name)
    cfg = C.get(arch, smoke=True)
    cfg = dataclasses.replace(cfg, n_layers=cfg.period * periods,
                              **({"enc_layers": periods} if cfg.family == "encdec"
                                 else {}))
    rec = trace_step(cfg, cell, mesh, "cpu")
    specs = build(cfg).specs()
    B, S = cell.global_batch, cell.seq_len
    if cell.kind == "train":
        tp = plan_train(cfg, specs, mesh, (B, S))
    elif cell.kind == "prefill":
        tp = plan_prefill(cfg, specs, mesh, (B, S))
    else:
        tp = plan_decode(cfg, specs, build(cfg).cache_specs(B, S), mesh, B)
    paths = sorted_leaves(tree_map_pspec(lambda path, p: path, specs))
    out[f"{arch}/{name}/{periods}"] = dict(
        temp=rec["memory_analysis"]["temp_size_in_bytes"],
        gathers=[n for k, _, n in counters[-1].collectives if k == "all-gather"],
        layouts=[[path, spec, work] for path, (spec, work)
                 in zip(paths, tp.layouts(specs))])
dist.destroy_process_group()
print("RESULT" + json.dumps(out))
"""


def _trace(jobs) -> dict:
    script = f"JOBS = {jobs!r}\n" + textwrap.dedent(TRACE)
    r = subprocess.run([sys.executable, "-c", script],
                       env=dict(os.environ, PYTHONPATH=str(REPO / "src")),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    return json.loads(r.stdout.split("RESULT", 1)[1])


@pytest.fixture(scope="module")
def traces():
    with concurrent.futures.ThreadPoolExecutor(PROCESSES) as pool:
        out = {}
        for part in pool.map(_trace, _groups()):
            out.update(part)
    return out


def _entries(spec) -> list[tuple[str, ...]]:
    return [() if e is None else tuple(e) if isinstance(e, list) else (e,) for e in spec]


def _specs(arch: str, periods: int):
    import dataclasses

    from repro_torch import configs as C
    from repro_torch.models import build
    cfg = C.get(arch, smoke=True)
    cfg = dataclasses.replace(cfg, n_layers=cfg.period * periods,
                              **({"enc_layers": periods} if cfg.family == "encdec" else {}))
    return cfg, build(cfg)


def _leaves(model) -> dict:
    from repro_torch.models.common import tree_map_pspec
    out = {}
    tree_map_pspec(lambda path, p: out.__setitem__(path, p), model.specs())
    return out


def _shard_bytes(p, spec, itemsize: int) -> int:
    return math.prod(p.shape) // math.prod(SIZES[ax] for e in _entries(spec) for ax in e) \
        * itemsize


def _period_gathers(rec, leaves, stacks) -> collections.Counter:
    """One period's weight all-gathers (elements of each result) by hand:
    each leaf of the stacked trees ``stacks``, its shard of one period
    gathered over the axes its working layout drops (the plan's
    layouts)."""
    out = collections.Counter()
    for path, spec, work in rec["layouts"]:
        if path.split("/")[1] not in stacks:
            continue
        p = leaves[path]
        kept = tuple(ax for e in _entries(work) for ax in e)
        out.update(_gathers(math.prod(p.shape) // p.shape[0], _entries(spec)[1:], SIZES, kept))
    return out


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("family", FAMILIES)
def test_stacked_leaves_gathered_a_period_at_a_time(traces, family, cell):
    """Every all-gather of the K-period trace is in the 2K-period trace;
    what the 2K trace adds holds each period's weight gathers K times (the
    train step's 2K times: the forward's and the recompute's; an
    encoder-decoder's decode gathers no encoder block).  A stacked leaf
    gathered whole would change its gather's size with the depth."""
    arch = FAMILIES[family]
    one, two = (traces[f"{arch}/{cell}/{n}"] for n in (K, 2 * K))
    small, big = collections.Counter(one["gathers"]), collections.Counter(two["gathers"])
    assert not small - big, small - big
    added = big - small
    # an encoder-decoder's decode step runs its decoder's blocks only
    stacks = ("dec_blocks",) if (family, cell) == ("encdec", "decode_32k") else STACKED
    period = _period_gathers(two, _leaves(_specs(arch, 2 * K)[1]), stacks)
    assert period, "no stacked leaf moves"
    times = K * (2 if cell == "train_4k" else 1)
    want = collections.Counter({n: c * times for n, c in period.items()})
    assert not want - added, (want - added, added)


def _cache_period_bytes(arch: str, cell) -> int:
    """One period's prefill cache shard on (data 2, model 2): every stacked
    cache leaf's local bytes over its periods (an encoder-decoder's self
    and cross cache of one decoder block)."""
    from repro_torch.models.common import resolve_spec, torch_dtype, tree_map_pspec
    cfg, model = _specs(arch, 1)
    total = []

    def add(_, p):
        spec = resolve_spec(p.shape, p.logical, SIZES)
        item = torch.empty((), dtype=torch_dtype(p.dtype)).element_size()
        total.append(_shard_bytes(p, spec, item) // p.shape[0])
    tree_map_pspec(add, model.cache_specs(cell.global_batch, cell.seq_len, ring=False))
    return sum(total)


def _train_period_bytes(arch: str, cell) -> int:
    """One period's train-step growth bound on (data 2, model 2): its
    checkpointed input (this rank's rows and sequence slice of the stream,
    the compute type; an encoder-decoder's frames' stream too) and its
    blocks' gradient shards (float32)."""
    from repro_torch.models.common import resolve_spec, torch_dtype
    cfg, model = _specs(arch, 1)
    item = torch.empty((), dtype=torch_dtype(cfg.compute_dtype)).element_size()
    B, S, D = cell.global_batch, cell.seq_len, cfg.d_model
    streams = [(B, S)] + ([(B, cfg.enc_seq)] if cfg.family == "encdec" else [])
    saved = 0
    for rows, seq in streams:
        b, s = _entries(resolve_spec((rows, seq), ("batch", "seq"), SIZES))
        saved += rows // math.prod(SIZES[ax] for ax in b) * seq \
            // math.prod(SIZES[ax] for ax in s) * D * item
    grads = sum(_shard_bytes(p, resolve_spec(p.shape, p.logical, SIZES), 4) // p.shape[0]
                for path, p in _leaves(model).items() if path.split("/")[1] in STACKED)
    return saved + grads


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("family", FAMILIES)
def test_temp_carries_no_working_copy_term(traces, family, cell):
    """The temp at 2K periods exceeds the temp at K by at most K periods'
    outputs (serving) or saved inputs and gradient shards (train), by
    hand: no term grows with a period's working weights."""
    from repro_torch import configs as C
    arch = FAMILIES[family]
    c = C.smoke_cell(cell)
    one, two = (traces[f"{arch}/{cell}/{n}"]["temp"] for n in (K, 2 * K))
    if c.kind == "train":
        bound = K * _train_period_bytes(arch, c)
    elif c.kind == "prefill":
        bound = K * 2 * _cache_period_bytes(arch, c)
    else:
        bound = 0
    print(family, cell, one, two, two - one, bound)
    assert two - one <= bound, (one, two, bound)
