"""Where a CEFT sweep's time goes on the card.

    PYTHONPATH=src python -m repro_torch.sweep_profile

For the paper's largest graph (RGG "high", n = 16384, P = 64), single and
batched (B = 8), and for the star fan-in (n = 4000, one dense-layout level), it
prints one JSON line per workload: the steady sweep's host wall time (median of
7, no profiler), the launches of each of the port's kernels in one sweep
(``ops.LAUNCHES``: one ``seg_level`` per segment-layout level, one
``ceft_relax`` per dense level), and from one sweep under ``torch.profiler``
the number of device kernels (the port's and PyTorch's), their summed device
time by kernel name, and the device's idle share of the unprofiled wall time.
Needs one NVIDIA GPU.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from .core import ceft_torch as ct
from .core import random_machine
from .graphs import rgg, star_fan_in
from .kernels import ops


def _median_wall(fn, reps: int = 7) -> float:
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
    return sorted(walls)[reps // 2]


def profile_sweep(name: str, fn) -> dict:
    from torch.profiler import ProfilerActivity, profile

    ops.reset_launches()
    fn()
    torch.cuda.synchronize()
    launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    wall = _median_wall(fn)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            row = by_name.setdefault(e.name, [0, 0.0])
            row[0] += 1
            row[1] += e.time_range.elapsed_us()
    busy_us = sum(v[1] for v in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    return {
        "workload": name,
        "steady_wall_ms": wall * 1e3,
        "launches": launches,
        "device_kernels": sum(v[0] for v in by_name.values()),
        "device_busy_ms": busy_us / 1e3 if busy_us else "not measured",
        "device_idle_share": 1 - busy_us / (wall * 1e6) if busy_us else "not measured",
        "top_kernels": [{"name": k[:60], "count": v[0], "ms": v[1] / 1e3} for k, v in top],
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("sweep_profile: needs one NVIDIA GPU", file=sys.stderr)
        return 2
    dev = "cuda"
    wl = rgg("high", 16384, 64, np.random.default_rng(5), o=4, alpha=0.75, beta=50)
    g, comp, m = wl.graph, wl.comp, wl.machine
    inputs = ct.csr_device_inputs(g, comp, m, device=dev)
    rows = [profile_sweep("rgg16384", lambda: ct.csr_sweep(inputs))]
    rng = np.random.default_rng(11)
    comps = comp[None] * rng.uniform(1.0, 2.0, (8, 1, m.P))
    binputs = ct.csr_batch_device_inputs(g, comps, np.repeat(m.L[None], 8, 0),
                                         np.repeat(m.bw[None], 8, 0), device=dev)
    rows.append(profile_sweep("rgg16384_batch8", lambda: ct.csr_batch_sweep(binputs)))
    gs = star_fan_in(4000)
    sinputs = ct.csr_device_inputs(gs, rng.uniform(1, 10, (gs.n, 64)),
                                   random_machine(64, rng, L_range=(0.0, 1.0)), device=dev)
    rows.append(profile_sweep("star4000", lambda: ct.csr_sweep(sinputs)))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    for r in rows:
        r["card"] = smi
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
