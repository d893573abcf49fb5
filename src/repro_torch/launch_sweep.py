"""Every launch shape of ``csrc/edge_relax.cu``'s two kernels, timed on the card.

    PYTHONPATH=src python -m repro_torch.launch_sweep [--kernel edge_relax|seg_level]

Both kernels take their launch shape from the host (``kernels/edge_relax.py``:
``edge_relax_grid``, ``seg_level_grid``): lanes a cell, classes j a block,
threads a block and edges a tile.  This launches a kernel at every shape of
:data:`CHOICES` that it accepts, checks each result bit-equal to the default
launch's, and times each: the mean device ms of 20 launches by
``torch.profiler`` (null where the profiler's records came back incomplete
three times).  ``edge_relax`` runs at :data:`EDGE_SHAPES` (``chip_smoke.py``'s
timed shapes and shapes around them), ``seg_level`` at the n = 16384 graph's
three path shapes (those of ``seg_level_profile``).  Prints one JSON line a
shape: the default launch and its time, the five fastest shapes, and whether
every shape gave the default's result; then the card's name and power limit.
Exits 1 if a shape gave another result.  Needs one NVIDIA GPU and ``nvcc``.
"""
from __future__ import annotations

import argparse
import itertools
import json
import subprocess
import sys

import numpy as np
import torch

from .core import ceft_torch as ct
from .graphs import rgg
from .kernels import ops
from .kernels.edge_relax import (ER_EPT, ER_MAX_LANES, SEG_EPT, SMEM_LIMIT, edge_relax_grid,
                                 edge_smem, seg_level_grid, seg_smem)
from .sched import plancache

#: edge_relax's (B, E, P): phase a's two level widths and 8 planes, then
#: fewer and more edges, 2 planes, narrower and wider machines, and one edge
#: of 8 classes (a launch's fixed cost)
EDGE_SHAPES = [(1, 1024, 64), (1, 2048, 64), (8, 1024, 64), (1, 256, 64), (1, 512, 64),
               (1, 4096, 64), (2, 1024, 64), (1, 1024, 16), (1, 1024, 128), (1, 1, 8)]
#: lanes a cell, classes a block, threads, passes a tile
CHOICES = ((1, 2, 4, 8), (4, 8, 16, 32), (64, 128, 256), (1, 2, 4))


def shapes(P: int, E: int, ept: int, most_lanes: int, smem):
    """(lanes, jc, threads, te) of :data:`CHOICES` that the kernel accepts
    (``smem(lanes, jc, threads, te)`` within a block's shared memory), tiles
    of at most twice E edges."""
    for G, jc, threads, passes in itertools.product(*CHOICES):
        if G > min(most_lanes, max(1, P // 2)) or G * jc > threads or jc > P:
            continue
        if P in (8, 16, 32, 64) and (P // G) % 2:
            continue
        te = passes * threads // (G * jc) * ept
        if (passes == 1 or te <= 2 * E) and smem(G, jc, threads, te) <= SMEM_LIMIT:
            yield G, jc, threads, te


def device_ms(fn, kernel: str, reps: int = 20, attempts: int = 3):
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.name]
        if len(us) >= reps:
            return sum(us) / reps / 1e3
    return None


def sweep(run, result, default, candidates, kernel: str) -> dict:
    """Run each launch shape, compare ``result()`` with the default's, time it."""
    run(*default)
    torch.cuda.synchronize()
    want = result()
    rows = []
    for s in candidates:
        run(*s)
        torch.cuda.synchronize()
        rows.append(dict(zip(("lanes", "jc", "threads", "te"), s),
                         equal=all(torch.equal(a, b) for a, b in zip(result(), want)),
                         ms=device_ms(lambda: run(*s), kernel)))
    timed = sorted((r for r in rows if r["ms"] is not None), key=lambda r: r["ms"])
    mine = [r for r in rows if (r["lanes"], r["jc"], r["threads"], r["te"]) == tuple(default)]
    return dict(default=mine[0] if mine else dict(zip(("lanes", "jc", "threads", "te"), default),
                                                  ms=device_ms(lambda: run(*default), kernel)),
                fastest=timed[:5], shapes_timed=len(timed), all_equal=all(r["equal"] for r in rows))


def edge_relax_rows(lib, n_sm: int):
    for B, E, P in EDGE_SHAPES:
        rng = np.random.default_rng(7)
        pv, pdata, L, bw = (torch.as_tensor(a.astype(np.float32), device="cuda") for a in (
            rng.uniform(0, 100, (B, E, P)), rng.uniform(0, 10, E), rng.uniform(0, 2, (B, P)),
            rng.uniform(0.5, 2, (B, P, P))))
        out = (torch.empty_like(pv), torch.empty(pv.shape, dtype=torch.int32, device="cuda"))

        def run(G, jc, threads, te):
            err = lib.edge_relax_f32(pv.data_ptr(), pdata.data_ptr(), L.data_ptr(),
                                     bw.data_ptr(), out[0].data_ptr(), out[1].data_ptr(), B, E, P,
                                     G, jc, threads, te, torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"launch_sweep: edge_relax launch failed: CUDA error {err}")

        g = edge_relax_grid(B, E, P, n_sm)
        yield [B, E, P], sweep(run, lambda: tuple(o.clone() for o in out),
                               (g.lanes, g.jc, g.threads, g.te),
                               shapes(P, E, ER_EPT, ER_MAX_LANES,
                                      lambda G, jc, threads, te: edge_smem(P, G, jc, te)),
                               "edge_relax_kernel")


def seg_level_rows(lib, n_sm: int):
    wl = rgg("high", 16384, 64, np.random.default_rng(5), o=4, alpha=0.75, beta=50)
    inputs = ct.csr_device_inputs(wl.graph, wl.comp, wl.machine, device="cuda")
    runs = plancache.device_state(wl.graph, "cuda")[0]
    levels = [max(r.levels, key=lambda lv: lv.e_real) for r in runs if r.layout == "seg"]
    for B, lv in [(1, lv) for lv in levels] + [(8, levels[0])]:
        # a finished carry: the level rewrites its tasks' rows with the same values
        carry = tuple(c[None].expand(B, *c.shape).contiguous() for c in ct.csr_sweep(inputs))
        comp, L, bw = (t[None].expand(B, *t.shape).contiguous()
                       for t in (inputs[1], inputs[3], inputs[4]))
        V, P = carry[0].shape[1:]
        stream = torch.cuda.current_stream().cuda_stream
        scratch = ops._scratch(carry[0].device, stream)

        def run(G, jc, threads, te):
            keys, _ = scratch(B * lv.width * (P + -(-P // jc)), 0)
            err = lib.seg_level_f32(
                carry[0].data_ptr(), carry[1].data_ptr(), carry[2].data_ptr(), comp.data_ptr(),
                L.data_ptr(), bw.data_ptr(), lv.tasks.data_ptr(), lv.edge_src.data_ptr(),
                lv.edge_data.data_ptr(), lv.edge_seg.data_ptr(), keys, B, V, P, lv.width,
                lv.e_real, G, jc, threads, te, stream)
            if err != 0:
                raise RuntimeError(f"launch_sweep: seg_level launch failed: CUDA error {err}")

        g = seg_level_grid(B, lv.e_real, P, n_sm)
        yield [B, lv.e_real, P], sweep(
            run, lambda: tuple(c.clone() for c in carry), (g.lanes, g.jc, g.threads, g.te),
            shapes(P, lv.e_real, SEG_EPT, 8,
                   lambda G, jc, threads, te: seg_smem(P, G, jc, te, threads)),
            "seg_level_kernel")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--kernel", choices=("edge_relax", "seg_level"), default="edge_relax")
    kernel = parser.parse_args().kernel
    if not torch.cuda.is_available():
        print("launch_sweep: needs one NVIDIA GPU", file=sys.stderr)
        return 2
    lib = ops._library("edge_relax")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    rows = edge_relax_rows if kernel == "edge_relax" else seg_level_rows
    ok = True
    for shape, row in rows(lib, n_sm):
        ok = ok and row["all_equal"]
        print(json.dumps(dict(kernel=kernel, shape=shape, **row)), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
