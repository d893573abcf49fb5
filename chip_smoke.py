#!/usr/bin/env python3
"""Drive the port's CEFT planning path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. build the CUDA kernels from ``src/repro_torch/csrc`` (nvcc, sm_90a);
  2. hold each kernel against its plain PyTorch version on the card, bit-equal,
     at the test shapes and the planning path's shapes;
  3. plan the paper's largest graph (RGG "high", n = 16384, P = 64) through
     ``PlanCache(device="cuda")``: bit-equal to the CPU path, a partial
     re-sweep after a change to the deepest levels' costs, and one realized
     CEFT-CPOP schedule, validated;
  4. batched re-planning (B = 8) bit-equal to 8 single sweeps;
  5. the dense layout (star fan-in) and the segment fallback (heavy-tailed
     fan-in), the padded sweep, and the paper's Algorithm 1 on a small graph;
  6. the straggler loop: quiet, cached and degraded steps, equal to the same
     loop on the CPU;
  7. report: launches of each kernel during phases 3-6, then each kernel's time
     at the path's shapes beside its plain version and its bound.

The last line is ``{"ok": true, "device": {...}}``; the line before it holds
the card's name and power limit, and the one before that the kernel report.
Exits with code 2 and prints no result when CUDA is not available.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import ceft_reference, planners, random_machine  # noqa: E402
from repro_torch.core import ceft_torch as ct  # noqa: E402
from repro_torch.core.machine import Machine  # noqa: E402
from repro_torch.core.schedule import validate_schedule  # noqa: E402
from repro_torch.graphs import heavy_tail_fan_in, rgg, star_fan_in  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ceft_relax import ceft_relax_plain  # noqa: E402
from repro_torch.kernels.edge_relax import edge_relax_plain  # noqa: E402
from repro_torch.sched import PlanCache, StragglerMonitor, plancache  # noqa: E402

# the card's published peaks (H100 SXM data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# float32 operations per relaxation candidate: divide, add, multiply, add, compare
OPS_PER_CANDIDATE = 5

EDGE_SHAPES = [(5, 3), (128, 16), (300, 7), (1, 1), (257, 13), (64, 64)]
CELL_SHAPES = [(8, 3, 4), (5, 1, 2), (16, 7, 13), (33, 9, 64), (64, 2, 128), (1, 1, 1)]
EDGE_PATH_SHAPES = [(1024, 64), (2048, 64)]
CELL_PATH_SHAPES = [(1, 4096, 64), (8, 28, 64)]


def log(*args):
    print(*args, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(f"chip_smoke: {what}")


def same_result(a, b, what: str) -> None:
    check(np.array_equal(a.ceft, b.ceft), f"{what}: CEFT tables differ")
    check(np.array_equal(a.pred_task, b.pred_task), f"{what}: pred_task differs")
    check(np.array_equal(a.pred_proc, b.pred_proc), f"{what}: pred_proc differs")
    check(a.cpl == b.cpl and a.path == b.path, f"{what}: cpl or path differs")


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def edge_inputs(shape, seed: int, device, batch: int | None = None):
    E, P = shape
    lead = () if batch is None else (batch,)
    rng = np.random.default_rng(seed)
    arrs = (rng.uniform(0, 100, (*lead, E, P)), rng.uniform(0, 10, (E,)),
            rng.uniform(0, 2, (*lead, P)), rng.uniform(0.5, 2, (*lead, P, P)))
    return [torch.as_tensor(a.astype(np.float32), device=device) for a in arrs]


def cell_inputs(shape, seed: int, device, n_valid: int | None = None):
    """Random dense-relaxation inputs; ``n_valid`` makes the first n_valid
    parent slots of each task real (the star's pattern), else 80% at random."""

    W, D, P = shape
    rng = np.random.default_rng(seed)
    if n_valid is None:
        validp = rng.random((W, D)) < 0.8
    else:
        validp = np.arange(D)[None, :].repeat(W, 0) < n_valid
    arrs = (rng.uniform(0, 100, (W, D, P)), rng.uniform(0, 10, (W, D)), validp,
            rng.uniform(0, 2, (P,)), rng.uniform(0.5, 2, (P, P)))
    return [torch.as_tensor(np.asarray(a, np.float32), device=device) for a in arrs]


def compare_kernels(device) -> dict:
    """Phase 2: every kernel against its plain version, bit-equal."""
    err = {"edge_relax": 0.0, "ceft_relax": 0.0}
    cases = [(s, None) for s in EDGE_SHAPES + EDGE_PATH_SHAPES] + [((1024, 64), 8)]
    for i, (shape, batch) in enumerate(cases):
        pv, pdata, L, bw = edge_inputs(shape, 100 + i, device, batch)
        got = ops.edge_relax(pv, pdata, L, bw)
        torch.cuda.synchronize()
        b = (lambda t: t[None]) if batch is None else (lambda t: t)
        want = edge_relax_plain(b(pv), pdata, b(L), b(bw))
        want = want if batch is not None else tuple(w[0] for w in want)
        err["edge_relax"] = max(err["edge_relax"], float((got[0] - want[0]).abs().max()))
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              f"edge_relax kernel != plain at {shape} batch {batch}")
    for i, shape in enumerate(CELL_SHAPES + CELL_PATH_SHAPES):
        n_valid = 3999 if shape == (1, 4096, 64) else None
        pv, pdata, validp, L, bw = cell_inputs(shape, 200 + i, device, n_valid)
        got = ops.ceft_relax(pv, pdata, validp, L, bw)
        torch.cuda.synchronize()
        want = ceft_relax_plain(pv[None], pdata, validp, L[None], bw[None])
        err["ceft_relax"] = max(err["ceft_relax"], float((got[0] - want[0][0]).abs().max()))
        for g, w, name in zip(got, want, ("maxk", "argk", "argl")):
            check(torch.equal(g, w[0]), f"ceft_relax kernel != plain ({name}) at {shape}")
    log(f"phase 2: kernels bit-equal to their plain versions; max_abs_err {err}")
    return err


def plan_large(device):
    """Phase 3: the paper's largest graph through the plan cache."""
    t = time.perf_counter()
    wl = rgg("high", 16384, 64, np.random.default_rng(5), o=4, alpha=0.75, beta=50)
    g, comp, m = wl.graph, wl.comp, wl.machine
    log(f"phase 3: rgg n={g.n} e={g.n_edges} levels={g.n_levels} P={m.P} "
        f"built in {time.perf_counter() - t:.3f} s")
    pc = PlanCache(device=device)
    t = time.perf_counter()
    res, status, _ = pc.plan(g, comp, m, planner="ceft_cpop")
    first_s = time.perf_counter() - t
    check(status == "full", f"first plan status {status}")
    check(res.ceft.shape == (g.n, m.P) and np.isfinite(res.ceft).all(),
          "CEFT table not finite or of the wrong shape")
    t = time.perf_counter()
    res_cpu, _, _ = PlanCache(device="cpu").plan(g, comp, m, planner="ceft_cpop")
    cpu_s = time.perf_counter() - t
    same_result(res, res_cpu, "n=16384 plan, cuda vs cpu")

    inputs = ct.csr_device_inputs(g, comp, m, device=device)
    steady = []
    for _ in range(5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        ct.csr_sweep(inputs)
        torch.cuda.synchronize()
        steady.append(time.perf_counter() - t)

    _, _, _, spans = plancache.device_state(g, device)
    comp2 = comp.copy()
    comp2[g.level >= spans[-1][0]] *= 1.5
    t = time.perf_counter()
    res2, status2, _ = pc.plan(g, comp2, m, planner="ceft_cpop")
    partial_s = time.perf_counter() - t
    check(status2 == "partial", f"top-level change gave status {status2}")
    same_result(res2, ct.ceft_torch_csr(g, comp2, m, device=device),
                "partial re-sweep vs full sweep")

    t = time.perf_counter()
    plan = planners.realize("ceft_cpop", g, comp, m, res)
    realize_s = time.perf_counter() - t
    validate_schedule(plan.schedule, g, comp, m)
    check(plan.makespan >= res.cpl * (1 - 1e-6), "makespan below the critical path")
    log(f"phase 3: plan first {first_s:.4f} s, steady sweep "
        f"{sorted(steady)[2] * 1e3:.3f} ms (median of 5), partial {partial_s:.4f} s, "
        f"cpu-path plan {cpu_s:.3f} s, realize {realize_s:.3f} s, cpl {res.cpl!r}, "
        f"makespan {plan.makespan!r}, runs {spans}")
    return g, comp, m, inputs


def batched(device, g, comp, m):
    """Phase 4: B = 8 scenarios in one sweep against 8 single sweeps."""
    rng = np.random.default_rng(11)
    B, P = 8, m.P
    comps = comp[None] * rng.uniform(1.0, 2.0, (B, 1, P))
    Ls = np.repeat(m.L[None], B, 0)
    bws = m.bw[None] * rng.uniform(0.8, 1.25, (B, P, P))
    torch.cuda.synchronize()
    t = time.perf_counter()
    results = ct.ceft_batch_csr_results(g, comps, Ls, bws, device=device)
    batch_s = time.perf_counter() - t
    t = time.perf_counter()
    for b in range(B):
        mb = Machine(L=Ls[b], bw=bws[b], counts=m.counts)
        same_result(results[b], ct.ceft_torch_csr(g, comps[b], mb, device=device),
                    f"batched plane {b} vs single sweep")
    single_s = time.perf_counter() - t
    log(f"phase 4: batched B={B} bit-equal to single sweeps; batched {batch_s:.4f} s, "
        f"8 singles {single_s:.4f} s")


def layouts(device):
    """Phase 5: dense layout, segment fallback, padded sweep, Algorithm 1."""
    rng = np.random.default_rng(21)
    for name, g, want in (("star_fan_in(4000)", star_fan_in(4000), "dense"),
                          ("heavy_tail_fan_in(4000)", heavy_tail_fan_in(4000, rng), "seg")):
        comp = rng.uniform(1, 10, (g.n, 64))
        m = random_machine(64, rng, L_range=(0.0, 1.0))
        kinds = [r.layout for r in ct.csr_device_inputs(g, comp, m, device=device)[0]]
        check(want in kinds, f"{name}: no {want}-layout run in {kinds}")
        same_result(ct.ceft_torch_csr(g, comp, m, device=device),
                    ct.ceft_torch_csr(g, comp, m, device="cpu"), f"{name} cuda vs cpu")
        log(f"phase 5: {name} layouts {kinds} bit-equal to the CPU path")
    wl = rgg("high", 2048, 64, np.random.default_rng(5), o=4, alpha=0.75, beta=50)
    same_result(ct.ceft_torch(wl.graph, wl.comp, wl.machine, device=device),
                ct.ceft_torch_csr(wl.graph, wl.comp, wl.machine, device=device),
                "padded sweep vs CSR sweep")
    wl = rgg("high", 60, 8, np.random.default_rng(6), o=4, alpha=0.75, beta=50)
    ref = ceft_reference(wl.graph, wl.comp, wl.machine)
    got = ct.ceft_torch_csr(wl.graph, wl.comp, wl.machine, device=device)
    check(np.allclose(got.ceft, ref.ceft, rtol=2e-5) and got.path == ref.path,
          "CSR sweep disagrees with Algorithm 1")
    log("phase 5: padded sweep == CSR sweep (n=2048); Algorithm 1 agrees (n=60, rtol 2e-5)")


def straggler(device):
    """Phase 6: the straggler loop on the card and on the CPU."""
    wl = rgg("high", 2048, 64, np.random.default_rng(5), o=4, alpha=0.75, beta=50)
    g, comp, m = wl.graph, wl.comp, wl.machine
    slow = np.ones(m.P)
    slow[int(np.argmin(comp.sum(axis=0)))] = 3.0   # the fastest class degrades
    steps = [np.ones(m.P), np.ones(m.P), slow, slow]
    mons = {dev: StragglerMonitor(m.P, device=dev) for dev in (device, "cpu")}
    out = {}
    for dev, mon in mons.items():
        rows = []
        for k, times in enumerate(steps):
            t = time.perf_counter()
            sched, ev = mon.maybe_replan(k, g, comp, m, times)
            rows.append((sched, ev, time.perf_counter() - t, mon.plancache.snapshot()))
        out[dev] = rows
    gpu, cpu = out[device], out["cpu"]
    for (s, e, _, c), (s2, e2, _, c2) in zip(gpu, cpu):
        check(np.array_equal(s.proc, s2.proc) and np.array_equal(s.start, s2.start)
              and s.makespan == s2.makespan, "straggler schedules differ cuda vs cpu")
        check((e is None) == (e2 is None) and c == c2, "straggler events differ")
    check(gpu[0][1] is None and gpu[1][1] is None, "quiet steps raised an event")
    check(gpu[1][3]["hits"] >= 1, "repeated quiet step missed the cache")
    check(gpu[2][1] is not None, "degraded step raised no event")
    ev = gpu[2][1]
    log(f"phase 6: straggler steps {[round(r[2], 4) for r in gpu]} s; event class "
        f"{ev.device_class} slowdown {ev.slowdown!r} makespan {ev.old_makespan!r} -> "
        f"{ev.new_makespan!r}; counters {gpu[-1][3]}")


def bound(nbytes: int, n_ops: int) -> tuple[float, str]:
    """The least time the card could take (ms) and what bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def timed(kernel, plain, reps: int) -> dict:
    """Kernel and plain version timed in turns (plain, kernel, kernel, plain)."""
    p1, k1, k2, p2 = (cuda_ms(f, reps) for f in (plain, kernel, kernel, plain))
    return {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2}


def kernel_report(launches, errs, per_sweep, device) -> list:
    """Phase 7: each kernel at the planning path's shapes beside its plain
    version and its bound; the first shape is the one the path runs most."""

    edge_rows = []
    for E, P in EDGE_PATH_SHAPES:
        pv, pdata, L, bw = edge_inputs((E, P), 7, device)
        t_min, by = bound(4 * (3 * E * P + E + P + P * P), OPS_PER_CANDIDATE * E * P * P)
        edge_rows.append(dict(shape=[E, P], bound_ms=t_min, bound_by=by, **timed(
            lambda: ops.edge_relax(pv, pdata, L, bw),
            lambda: edge_relax_plain(pv[None], pdata, L[None], bw[None]), 100)))
    cell_rows = []
    for W, D, P in CELL_PATH_SHAPES:
        n_valid = 3999 if (W, D, P) == (1, 4096, 64) else None
        pv, pdata, validp, L, bw = cell_inputs((W, D, P), 8, device, n_valid)
        valid = int(validp.sum().item())       # the work depends on the mask
        t_min, by = bound(4 * (W * D * P + 2 * W * D + P + P * P + 3 * W * P),
                          OPS_PER_CANDIDATE * valid * P * P)
        cell_rows.append(dict(shape=[W, D, P], valid_parents=valid, bound_ms=t_min,
                              bound_by=by, **timed(
            lambda: ops.ceft_relax(pv, pdata, validp, L, bw),
            lambda: ceft_relax_plain(pv[None], pdata, validp, L[None], bw[None]), 10)))
    rows = []
    for name, line, fn, by_shape in (
            ("edge_relax", 67, "_edge_relax_kernel", edge_rows),
            ("ceft_relax", 30, "_relax_kernel", cell_rows)):
        rows.append(dict(
            name=name, route="cuda", source=f"src/repro_torch/csrc/{name}.cu",
            replaces=f"src/repro/kernels/ceft_relax.py:{line} ({fn})",
            launches=launches[name], max_abs_err=errs[name],
            launches_per_rgg16384_sweep=per_sweep[name], library_ms=None,
            **{k: by_shape[0][k] for k in ("shape", "ms", "plain_ms", "bound_ms", "bound_by")},
            by_shape=by_shape))
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check needs one NVIDIA GPU",
              file=sys.stderr)
        return 2

    device = "cuda"
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    t = time.perf_counter()
    ops.build_all()
    log(f"phase 1: kernels built and loaded in {time.perf_counter() - t:.3f} s")
    errs = compare_kernels(device)

    ops.reset_launches()
    g, comp, m, inputs = plan_large(device)
    batched(device, g, comp, m)
    layouts(device)
    straggler(device)
    launches = dict(ops.LAUNCHES)
    log(f"main path launches: {launches}")
    check(all(n > 0 for n in launches.values()), f"a kernel never launched: {launches}")

    ops.reset_launches()
    ct.csr_sweep(inputs)
    per_sweep = dict(ops.LAUNCHES)
    log(f"launches per full n=16384 sweep: {per_sweep}")
    rows = kernel_report(launches, errs, per_sweep, device)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
