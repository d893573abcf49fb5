"""Where a ``seg_level`` block's time goes on the card.

    PYTHONPATH=src python -m repro_torch.seg_level_profile

Builds a copy of ``csrc/edge_relax.cu`` in which thread 0 of every block
reads ``clock64`` after each block-wide phase of ``seg_level_kernel`` and
``%globaltimer`` at its start and end, launches it on the paper's largest
graph (RGG "high", n = 16384, P = 64) at the fused level's path shapes (the
widest level of each segment-layout run with 1 plane, the first run's with
8), and prints one JSON line per shape: the launch shape, the mean time of a
launch by CUDA events, the span from the first block's start to the last
block's end, block durations, block start times, the SMs used, and the
median and 90th-percentile cycles of each phase:

  stage    the window of edge tables, the machine's j-chunk, tile boundaries
  rows     the parent rows and task rows
  relax    the relaxation passes
  comp     waiting for the comp rows
  fold     the segment pieces, written or posted
  crossing the crossing segments' counters and decodes

The marks sit at anchors in the kernel's source (:data:`MARKS`); a change to
those lines needs a change here, and ``tests/test_torch_kernels.py`` checks
that every anchor is found.  Needs one NVIDIA GPU and ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import json
import subprocess
import sys

import numpy as np
import torch

from .core import ceft_torch as ct
from .graphs import rgg
from .kernels import ops
from .kernels.edge_relax import edge_relax_argtypes, seg_level_grid, seg_level_launch
from .sched import plancache

PHASES = ("stage", "rows", "relax", "comp", "fold", "crossing")
#: (source line, mark after it (True) or before it, mark index); mark k ends
#: phase k - 1
MARKS = (
    ("  const int g = lane & (G - 1), jl = (tid / G) & (JC - 1), eg = tid / (G * JC);\n",
     True, 0),
    ("  const bool bw_window = __syncthreads_and(ok);\n", True, 1),
    ("  __syncthreads();     // and everyone's\n", True, 2),
    ("  cp_async_wait<0>();\n  __syncthreads();\n\n  // one thread per (segment piece", False, 3),
    ("  // one thread per (segment piece, j)", False, 4),
    ("  // the tile that arrives last", False, 5),
)
_SLOTS = 10  # per block: marks 0-6, start and end times, SM
_AT = "seg_probe[((size_t)blockIdx.y * gridDim.x + blockIdx.x) * 10 + "


def _clock(k: int) -> str:
    return f"  if (threadIdx.x == 0) {_AT}{k}] = clock64();\n"


def _timer(k: int) -> str:
    return ("  if (threadIdx.x == 0) { unsigned long long t; unsigned sm;"
            ' asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));'
            ' asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));'
            f" {_AT}{k}] = t; {_AT}9] = sm; }}\n")


_END = "      pproc[o] = key_class(lo);\n    }\n  }\n}\n"


def instrument(src: str) -> str:
    """``src`` (``csrc/edge_relax.cu``) with the phase marks and a reader of
    them, ``seg_probe_read``; raises if an anchor is missing."""
    for anchor, after, k in MARKS:
        if src.count(anchor) != 1:
            raise ValueError(f"seg_level_profile: anchor not found once: {anchor!r}")
        mark = _clock(k) + (_timer(7) if k == 0 else "")
        src = src.replace(anchor, anchor + mark if after else mark + anchor)
    if src.count(_END) != 1:
        raise ValueError("seg_level_profile: the kernel's end not found once")
    src = src.replace(_END, _END[:-2] + _clock(6) + _timer(8) + "}\n")
    return src.replace('#include "relax.cuh"\n', '#include "relax.cuh"\n'
                       "__device__ unsigned long long seg_probe[1 << 20];\n"
                       'extern "C" int seg_probe_read(void* dst, int n) {\n'
                       "  return (int)cudaMemcpyFromSymbol(dst, seg_probe, (size_t)n * 8);\n}\n")


def build() -> ctypes.CDLL:
    """Compile the instrumented copy with the kernels' flags (under
    ``_build/``, keyed by its text) and load it."""
    src = instrument((ops.CSRC / "edge_relax.cu").read_text())
    out = ops.BUILD / ("probe-" + hashlib.sha256(src.encode()).hexdigest()[:16])
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / "edge_relax_probe.cu", out / "libedge_relax_probe.so"
    if not so.exists():
        cu.write_text(src)
        subprocess.run([ops._nvcc(), *ops.NVCC_FLAGS, "-I", str(ops.CSRC), "-o", str(so),
                        str(cu)], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    edge_relax_argtypes(lib)
    lib.seg_probe_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    return lib


def profile_level(lib, inputs, B: int, lv, n_sm: int) -> dict:
    carry = tuple(c[None].expand(B, *c.shape).contiguous() for c in ct.csr_sweep(inputs))
    comp, L, bw = (t[None].expand(B, *t.shape).contiguous()
                   for t in (inputs[1], inputs[3], inputs[4]))
    args = (comp, L, bw, lv.tasks, lv.edge_src, lv.edge_data, lv.edge_seg, lv.e_real,
            lv.width)
    stream = torch.cuda.current_stream().cuda_stream
    scratch = ops._scratch(carry[0].device, stream)

    def run():
        return seg_level_launch(lib, carry, *args, scratch, n_sm, stream)

    for _ in range(5):
        run()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(50):
        run()
    end.record()
    torch.cuda.synchronize()
    grid = run()
    torch.cuda.synchronize()
    buf = np.zeros(grid.blocks * _SLOTS, np.uint64)
    if lib.seg_probe_read(buf.ctypes.data, buf.size) != 0:
        raise RuntimeError("seg_level_profile: reading the marks failed")
    marks = buf.reshape(grid.blocks, _SLOTS).astype(np.int64)
    cycles = np.diff(marks[:, :7], axis=1)
    t0, t1 = marks[:, 7], marks[:, 8]
    return {
        "shape": [B, lv.e_real, carry[0].shape[-1]], "launch": grid._asdict(),
        "event_ms": start.elapsed_time(end) / 50,
        "span_us": float(t1.max() - t0.min()) / 1e3,
        "block_us": [float(np.median(t1 - t0)) / 1e3, float((t1 - t0).max()) / 1e3],
        "start_us_p50_p100": [float(np.percentile(t0 - t0.min(), q)) / 1e3 for q in (50, 100)],
        "sms": int(len(set(marks[:, 9].tolist()))),
        "phase_cycles_p50": dict(zip(PHASES, np.median(cycles, axis=0).tolist())),
        "phase_cycles_p90": dict(zip(PHASES, np.percentile(cycles, 90, axis=0).tolist())),
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("seg_level_profile: needs one NVIDIA GPU", file=sys.stderr)
        return 2
    lib = build()
    wl = rgg("high", 16384, 64, np.random.default_rng(5), o=4, alpha=0.75, beta=50)
    inputs = ct.csr_device_inputs(wl.graph, wl.comp, wl.machine, device="cuda")
    runs = plancache.device_state(wl.graph, "cuda")[0]
    levels = [max(r.levels, key=lambda lv: lv.e_real) for r in runs if r.layout == "seg"]
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    for B, lv in [(1, lv) for lv in levels] + [(8, levels[0])]:
        row = profile_level(lib, inputs, B, lv, n_sm)
        row["card"] = card.splitlines()[0]
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
