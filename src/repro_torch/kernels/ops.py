"""Public wrappers around the Hopper kernels: the CPU/CUDA split, shape
normalization, launch counters and the build of ``csrc/*.cu``.

Dispatch is on the tensor's device and nothing else: a CPU tensor takes the
kernel's plain PyTorch version, a CUDA tensor launches the hand-written kernel
or raises.  There is no fallback and no switch.

Scratch: the kernels that combine partial results across blocks
(``ceft_relax`` when it splits a fan-in, ``seg_level`` when a segment crosses
an edge tile) take zeroed buffers and leave them zeroed.  One pair of buffers
per device and stream (:func:`_scratch`) is allocated at first use, grows to
the largest call seen, and is never cleared again, so a level costs no
allocation or memset; launches on one stream are ordered, so they never share
it at the same time.

Build: each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, loaded with ``ctypes``; shared
device code sits in ``csrc/*.cuh``.  The libraries live in
``_build/<hash of the source, the headers and the flags>/`` inside the
package (ignored by git), are built at first use, and :func:`build_all` starts
every compile at once.  ``ptxas -v``'s report (registers, shared memory and
spills of each kernel) is kept beside each library and read by
:func:`resource_usage`.  Nothing is compiled or loaded at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from .ceft_relax import ceft_relax_argtypes, ceft_relax_launch, ceft_relax_plain
from .edge_relax import (edge_relax_argtypes, edge_relax_launch, edge_relax_plain,
                         seg_level_launch, seg_level_plain)
from .edge_relax_superstep import MAX_P as MAX_SUPERSTEP_P
from .edge_relax_superstep import (edge_relax_superstep_argtypes,
                                   edge_relax_superstep_launch,
                                   edge_relax_superstep_plain)
from .minplus import minplus_argtypes, minplus_launch, minplus_plain

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: one library per source, ``csrc/<name>.cu``; ``edge_relax.cu`` also holds
#: the ``seg_level`` entry
KERNELS = {"edge_relax": edge_relax_argtypes, "ceft_relax": ceft_relax_argtypes,
           "edge_relax_superstep": edge_relax_superstep_argtypes,
           "minplus": minplus_argtypes}

#: launches of each CUDA kernel entry (incremented only where it launches);
#: ``ceft_relax_bf16`` counts the bf16 instance of ``csrc/ceft_relax.cu``
LAUNCHES = {name: 0 for name in (*KERNELS, "seg_level", "ceft_relax_bf16")}

# the packed (value, index, class) keys hold an index below 2**24 and a class
# below 256 (``csrc/ceft_relax.cu``, ``csrc/edge_relax.cu``)
MAX_KEY_INDEX, MAX_KEY_P = 1 << 24, 256

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
_SCRATCH: dict[tuple, tuple] = {}
_N_SM: dict[int, int] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return str(path)


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD / digest / f"lib{name}.so"


def _compile(names) -> None:
    """Compile the named kernels' sources concurrently (one nvcc each);
    existing libraries are reused.  Each output is written under a temporary
    name and renamed into place, so concurrent builders never load a partial
    file."""
    procs = []
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            out.with_suffix(".ptxas.txt").write_text(log)
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))


def _library(name: str) -> ctypes.CDLL:
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            _compile([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            KERNELS[name](lib)
            _LIBS[name] = lib
        return lib


def build_all() -> None:
    """Compile (concurrently) and load every kernel."""
    with _LOCK:
        _compile([n for n in KERNELS if n not in _LIBS])
    for name in KERNELS:
        _library(name)


_PTXAS_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_PTXAS_SPILL = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads")
_PTXAS_REGS = re.compile(r"Used (\d+) registers")
_PTXAS_SMEM = re.compile(r"(\d+) bytes smem")


def resource_usage() -> dict[str, list[dict]]:
    """Per kernel source, each entry function's registers a thread, static
    shared memory, stack frame and spill bytes, as ``ptxas -v`` reported
    them when the library was built (empty for a library built before
    the report was kept)."""
    out = {}
    for name in KERNELS:
        report = _lib_path(name).with_suffix(".ptxas.txt")
        rows, row = [], None
        for line in report.read_text().splitlines() if report.exists() else ():
            if m := _PTXAS_ENTRY.search(line):
                row = {"function": m.group(1)}
                rows.append(row)
            elif row is not None and (m := _PTXAS_SPILL.search(line)):
                row.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                           spill_loads=int(m.group(3)))
            elif row is not None and (m := _PTXAS_REGS.search(line)):
                smem = _PTXAS_SMEM.search(line)
                row.update(registers=int(m.group(1)), smem=int(smem.group(1)) if smem else 0)
        out[name] = rows
    return out


def _scratch(device: torch.device, stream: int):
    """``get(n_keys, n_counts)`` -> pointers to zeroed int64 and int32 buffers
    of at least those sizes, one pair per device and stream."""
    key = (device.index, stream)

    def get(n_keys: int, n_counts: int):
        have = _SCRATCH.get(key)
        if have is None or have[0].numel() < n_keys or have[1].numel() < n_counts:
            n_keys = max(n_keys, 0 if have is None else have[0].numel())
            n_counts = max(n_counts, 0 if have is None else have[1].numel())
            have = (torch.zeros(n_keys, dtype=torch.int64, device=device),
                    torch.zeros(n_counts, dtype=torch.int32, device=device))
            _SCRATCH[key] = have
        return have[0].data_ptr(), have[1].data_ptr()

    return get


def _n_sm(device: torch.device) -> int:
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _N_SM:
        _N_SM[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _N_SM[idx]


def _check_cuda(name: str, *tensors, dtypes=(torch.float32,)) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if t.dtype not in dtypes:
            raise TypeError(f"{name}: the CUDA kernel takes {dtypes}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the CUDA kernel takes contiguous tensors")


def edge_relax(pv, pdata, L, bw):
    """Edge relaxation (see ``edge_relax.py``).

    pv (E, P) with L (P,), bw (P, P); or batched pv (B, E, P) with L (B, P),
    bw (B, P, P).  pdata (E,) is shared.  Returns (minl, argl int32) shaped
    like pv."""
    single = pv.dim() == 2
    if single:
        pv, L, bw = pv[None], L[None], bw[None]
    B, E, P = pv.shape
    if pdata.shape != (E,) or L.shape != (B, P) or bw.shape != (B, P, P):
        raise ValueError(f"edge_relax: shapes {tuple(pv.shape)}, "
                         f"{tuple(pdata.shape)}, {tuple(L.shape)}, {tuple(bw.shape)}")
    if pv.device.type == "cpu":
        minl, argl = edge_relax_plain(pv, pdata, L, bw)
    elif pv.device.type == "cuda":
        _check_cuda("edge_relax", pv, pdata, L, bw)
        if pv.numel() == 0:
            minl = torch.empty_like(pv)
            argl = torch.empty(pv.shape, dtype=torch.int32, device=pv.device)
        else:
            minl, argl = edge_relax_launch(_library("edge_relax"), pv, pdata, L, bw,
                                           _n_sm(pv.device))
            LAUNCHES["edge_relax"] += 1
    else:
        raise ValueError(f"edge_relax: no kernel for device {pv.device}")
    return (minl[0], argl[0]) if single else (minl, argl)


def ceft_relax(pv, pdata, validp, L, bw):
    """Dense level relaxation (see ``ceft_relax.py``).

    pv (W, D, P) with L (P,), bw (P, P); or batched pv (B, W, D, P) with
    L (B, P), bw (B, P, P).  pdata and validp (W, D) are shared; validp is a
    float mask (1 real parent, 0 padding).  All five are float32, or all
    bf16 (each operation rounded to bf16).  Returns (maxk of the inputs'
    type, argk int32, argl int32), each shaped like pv without its D axis."""
    single = pv.dim() == 3
    if single:
        pv, L, bw = pv[None], L[None], bw[None]
    B, W, D, P = pv.shape
    if pdata.shape != (W, D) or validp.shape != (W, D) or L.shape != (B, P) \
            or bw.shape != (B, P, P):
        raise ValueError(f"ceft_relax: shapes {tuple(pv.shape)}, {tuple(pdata.shape)}, "
                         f"{tuple(validp.shape)}, {tuple(L.shape)}, {tuple(bw.shape)}")
    if pv.device.type == "cpu":
        out = ceft_relax_plain(pv, pdata, validp, L, bw)
    elif pv.device.type == "cuda":
        _check_cuda("ceft_relax", pv, pdata, validp, L, bw,
                    dtypes=(torch.float32, torch.bfloat16))
        if any(t.dtype != pv.dtype for t in (pdata, validp, L, bw)):
            raise TypeError(f"ceft_relax: the CUDA kernel takes one type, got {pv.dtype}, "
                            f"{pdata.dtype}, {validp.dtype}, {L.dtype}, {bw.dtype}")
        if D >= MAX_KEY_INDEX or P > MAX_KEY_P:
            raise ValueError(f"ceft_relax: the CUDA kernel takes D < {MAX_KEY_INDEX} "
                             f"and P <= {MAX_KEY_P}, got D = {D}, P = {P}")
        if B * W * P == 0:
            out = (torch.empty((B, W, P), dtype=pv.dtype, device=pv.device),
                   torch.empty((B, W, P), dtype=torch.int32, device=pv.device),
                   torch.empty((B, W, P), dtype=torch.int32, device=pv.device))
        else:
            stream = torch.cuda.current_stream(pv.device).cuda_stream
            out = ceft_relax_launch(_library("ceft_relax"), pv, pdata, validp, L, bw,
                                    _scratch(pv.device, stream), _n_sm(pv.device), stream)
            LAUNCHES["ceft_relax" if pv.dtype == torch.float32 else "ceft_relax_bf16"] += 1
    else:
        raise ValueError(f"ceft_relax: no kernel for device {pv.device}")
    return tuple(o[0] for o in out) if single else out


def seg_level(carry, comp_pad, L, bw, tasks, edge_src, edge_data, edge_seg,
              e_real: int, width: int) -> None:
    """One segment-layout level of the CSR sweep, in place on ``carry`` (see
    ``edge_relax.py``: :func:`seg_level_plain` on the CPU, one
    ``seg_level_f32`` launch on the card).

    carry = (ceft (B, V, P) float32, pred_task, pred_proc (B, V, P) int32);
    comp_pad (B, V, P); L (B, P); bw (B, P, P); tasks (w,) int64 carry rows of
    the level's children; edge_src (E_b,) int64 parent rows, edge_data
    (E_b,), edge_seg (E_b,) int64 child slots in ascending order, the first
    ``e_real`` edges real; ``width`` >= w is the run's segment count.  Every
    child slot below w has at least one real edge."""
    ceft_arr, ptask, pproc = carry
    B, V, P = ceft_arr.shape
    E_b = edge_src.shape[0]
    if (ptask.shape != (B, V, P) or pproc.shape != (B, V, P)
            or comp_pad.shape != (B, V, P) or L.shape != (B, P) or bw.shape != (B, P, P)
            or edge_data.shape != (E_b,) or edge_seg.shape != (E_b,)
            or not 0 < e_real <= E_b or not 0 < tasks.shape[0] <= width):
        raise ValueError(f"seg_level: shapes {tuple(ceft_arr.shape)}, {tuple(comp_pad.shape)}, "
                         f"{tuple(L.shape)}, {tuple(bw.shape)}, tasks {tuple(tasks.shape)}, "
                         f"edges {E_b}, e_real {e_real}, width {width}")
    if ceft_arr.device.type == "cpu":
        seg_level_plain(carry, comp_pad, L, bw, tasks, edge_src, edge_data, edge_seg,
                        e_real, width)
        return
    if ceft_arr.device.type != "cuda":
        raise ValueError(f"seg_level: no kernel for device {ceft_arr.device}")
    _check_cuda("seg_level", ceft_arr, comp_pad, L, bw, edge_data)
    _check_cuda("seg_level", ptask, pproc, dtypes=(torch.int32,))
    _check_cuda("seg_level", tasks, edge_src, edge_seg, dtypes=(torch.int64,))
    if ptask.device != ceft_arr.device or tasks.device != ceft_arr.device:
        raise ValueError(f"seg_level: tensors on {ptask.device}, {tasks.device} and "
                         f"{ceft_arr.device}")
    if E_b >= MAX_KEY_INDEX or P > MAX_KEY_P:
        raise ValueError(f"seg_level: the CUDA kernel takes fewer than {MAX_KEY_INDEX} "
                         f"edges and P <= {MAX_KEY_P}, got {E_b} and P = {P}")
    stream = torch.cuda.current_stream(ceft_arr.device).cuda_stream
    seg_level_launch(_library("edge_relax"), carry, comp_pad, L, bw, tasks, edge_src,
                     edge_data, edge_seg, e_real, width, _scratch(ceft_arr.device, stream),
                     _n_sm(ceft_arr.device), stream)
    LAUNCHES["seg_level"] += 1


def edge_relax_superstep(pv, pdata, L, bw):
    """Stacked edge relaxation over a fused run (see
    ``edge_relax_superstep.py``): pv (R, E, P), pdata (R, E) per level,
    L (P,) and bw (P, P) shared.  Returns (minl, argl int32) shaped like pv."""
    R, E, P = pv.shape
    if pdata.shape != (R, E) or L.shape != (P,) or bw.shape != (P, P):
        raise ValueError(f"edge_relax_superstep: shapes {tuple(pv.shape)}, "
                         f"{tuple(pdata.shape)}, {tuple(L.shape)}, {tuple(bw.shape)}")
    if pv.device.type == "cpu":
        return edge_relax_superstep_plain(pv, pdata, L, bw)
    if pv.device.type != "cuda":
        raise ValueError(f"edge_relax_superstep: no kernel for device {pv.device}")
    _check_cuda("edge_relax_superstep", pv, pdata, L, bw)
    if P > MAX_SUPERSTEP_P:
        raise ValueError(f"edge_relax_superstep: the CUDA kernel takes P <= "
                         f"{MAX_SUPERSTEP_P}, got P = {P}")
    if pv.numel() == 0:
        return (torch.empty_like(pv),
                torch.empty(pv.shape, dtype=torch.int32, device=pv.device))
    out = edge_relax_superstep_launch(_library("edge_relax_superstep"), pv, pdata, L, bw,
                                      _n_sm(pv.device))
    LAUNCHES["edge_relax_superstep"] += 1
    return out


def minplus(a, b):
    """Tropical matrix product C[i,j] = min(BIG, min_k A[i,k] + B[k,j]) (see
    ``minplus.py``): a (M, K), b (K, N), both float32 or both bf16; C has
    their type."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"minplus: shapes {tuple(a.shape)}, {tuple(b.shape)}")
    if a.dtype != b.dtype:
        raise TypeError(f"minplus: types {a.dtype} and {b.dtype} differ")
    if a.device.type == "cpu":
        return minplus_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"minplus: no kernel for device {a.device}")
    _check_cuda("minplus", a, b, dtypes=(torch.float32, torch.bfloat16))
    M, N = a.shape[0], b.shape[1]
    if M * N == 0:
        return torch.empty((M, N), dtype=a.dtype, device=a.device)
    out = minplus_launch(_library("minplus"), a, b)
    LAUNCHES["minplus"] += 1
    return out
