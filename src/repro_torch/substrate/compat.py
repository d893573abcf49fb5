"""Host and process placement facts for the engine pool.

The reference's ``substrate/compat.py`` also holds the JAX mesh and sharding
shims; the port keeps only the two functions the serving plane needs.
"""
from __future__ import annotations

import os
import socket

import torch


def host_id() -> str:
    """A stable identifier for this host (the pool's placement unit)."""
    return socket.gethostname()


def process_topology() -> dict:
    """Host/process placement of the CURRENT process — the seam the engine
    pool probes through: same pid => in-process transfer, same host / other
    pid => pipe transport, other host => network (future).

    The accelerator facts come from ``torch.cuda`` without initializing it:
    counting devices creates no CUDA context, so a pool worker that serves a
    host-only engine never holds one.  ``cuda_initialized`` reports whether
    this process has started CUDA."""
    available = torch.cuda.is_available()
    return {"host": host_id(), "pid": os.getpid(),
            "n_cpus": os.cpu_count() or 1,
            "platform": "cuda" if available else "cpu",
            "n_devices": torch.cuda.device_count() if available else 0,
            "cuda_initialized": torch.cuda.is_initialized()}
