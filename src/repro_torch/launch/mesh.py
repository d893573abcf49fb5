"""Mesh construction for the production topology and for runs over the world
a process was started in.

Defined as functions, never module-level constants, so importing this module
starts no process group.  All mesh handling lives in
``repro_torch.substrate``; this module only picks shapes.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from ..core.ceft_torch import resolve_device
from ..substrate import init_group, make_mesh, mesh_axis_sizes  # noqa: F401  (re-export)

# the backend for ranks that each own a device of this type
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """Single pod: 16x16 = 256 devices (data, model).  Multi-pod: 2 pods of
    256 (pod, data, model); the pod axis carries data parallelism."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type=device_type)


def init_world(device_type: str = "cuda") -> int:
    """Join the default process group of the world this process was started
    in, unless it is joined already: ``torchrun``'s (its ``RANK`` and
    ``WORLD_SIZE``), else a world of this one rank.  Returns the world
    size."""
    if not dist.is_initialized():
        if device_type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        if "WORLD_SIZE" in os.environ:
            init_group(BACKENDS[device_type], int(os.environ["RANK"]),
                       int(os.environ["WORLD_SIZE"]), "env://")
        else:
            init_group(BACKENDS[device_type])
    return dist.get_world_size()


def make_test_mesh(n_devices: int | None = None, *, device_type: str = "cuda"):
    """A (data, model) mesh over the world (``n_devices`` ranks of it when
    given): the model axis takes 4, 2 or 1 ranks, the first that divides."""
    resolve_device(device_type)          # CUDA that is not available raises
    world = init_world(device_type)
    n = n_devices or world
    model = next(c for c in (4, 2, 1) if n % c == 0)
    return make_mesh((n // model, model), ("data", "model"), device_type=device_type)
