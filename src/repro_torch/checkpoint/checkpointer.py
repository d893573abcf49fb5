"""Fault-tolerant checkpointing: per-leaf shards + manifest, atomic rename,
checksum verification, async writer, automatic fallback to the newest intact
checkpoint.

Layout:  <dir>/step_<n>/  {manifest.json, 000000.npy, 000001.npy, ...}
A checkpoint is valid iff the manifest exists, lists every shard, and every
shard's CRC matches.  Writes go to ``<dir>/.tmp_step_<n>`` and are renamed
into place only after fsync -- a crash mid-write can never corrupt the newest
valid checkpoint (restore() simply skips incomplete/corrupt directories).

The format is the reference's, byte for byte: leaves in its tree order (dict
keys sorted, tuple and ``NamedTuple`` fields in order), one ``np.save`` file
each, a bfloat16 leaf as 2-byte ``'<V2'`` records with dtype ``"bfloat16"``
in the manifest.  So a checkpoint written by either package restores in the
other; this one also restores bfloat16 leaves, which the reference cannot.

A tree laid out on a mesh (``DTensor`` leaves) is saved from its full
leaves: every rank gathers them, rank 0 writes, and a synchronous save ends
at a barrier so no rank reads the directory before it is whole.  ``restore``
lays each leaf out by the given shardings, on whatever mesh they name: the
elastic restore onto another mesh.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..models.common import sorted_leaves
from ..substrate import distribute, full_value

BF16 = "bfloat16"


def _unflatten(tree, leaves):
    """``tree`` with its leaves replaced, in ``sorted_leaves`` order, from
    the iterator ``leaves``."""
    if isinstance(tree, dict):
        new = {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
        return {k: new[k] for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_unflatten(x, leaves) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_unflatten(x, leaves) for x in tree)
    if tree is None:
        return None
    return next(leaves)


def _host(x) -> tuple[np.ndarray, str]:
    """A host copy of one leaf (never a view the caller can still write)
    and its manifest dtype; a bfloat16 tensor as its 16-bit patterns."""
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), BF16
        a = t.numpy()
    else:
        a = np.array(x)
    return a, str(a.dtype)


def _write_leaf(path: Path, a: np.ndarray, dtype: str) -> None:
    if dtype != BF16:
        np.save(path, a)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False, "shape": a.shape})
        f.write(np.ascontiguousarray(a).tobytes())


def save(ckpt_dir: str | os.PathLike, step: int, tree, *, async_: bool = False):
    """Device->host copy happens synchronously (consistent snapshot); disk IO
    optionally on a background thread.  Returns the Thread when async_.  A
    tree with ``DTensor`` leaves is a collective call: every rank gathers,
    rank 0 writes (its thread when async_), the others write nothing."""
    leaves = sorted_leaves(tree)
    sharded = any(isinstance(x, DTensor) for x in leaves)
    writer = not sharded or dist.get_rank() == 0
    host_leaves = []
    for x in leaves:
        full = full_value(x)              # every rank gathers a sharded leaf
        if writer:
            host_leaves.append(_host(full))
    if not writer:
        if not async_:
            dist.barrier()
        return None

    def write():
        d = Path(ckpt_dir)
        tmp = d / f".tmp_step_{step}"
        final = d / f"step_{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "leaves": []}
        for i, (a, dtype) in enumerate(host_leaves):
            fn = f"{i:06d}.npy"
            _write_leaf(tmp / fn, a, dtype)
            crc = zlib.crc32((tmp / fn).read_bytes())
            manifest["leaves"].append(
                {"file": fn, "shape": list(a.shape), "dtype": dtype, "crc": crc}
            )
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        fd = os.open(tmp, os.O_RDONLY)
        os.fsync(fd)
        os.close(fd)
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)

    if async_:
        t = threading.Thread(target=write, daemon=True)
        t.start()
        return t
    write()
    if sharded:
        dist.barrier()
    return None


def _verify(d: Path) -> bool:
    mf = d / "manifest.json"
    if not mf.exists():
        return False
    try:
        manifest = json.loads(mf.read_text())
        for leaf in manifest["leaves"]:
            f = d / leaf["file"]
            if not f.exists() or zlib.crc32(f.read_bytes()) != leaf["crc"]:
                return False
        return True
    except (OSError, ValueError, KeyError, TypeError):
        return False


def available_steps(ckpt_dir: str | os.PathLike) -> list[int]:
    d = Path(ckpt_dir)
    if not d.exists():
        return []
    steps = []
    for sub in d.iterdir():
        if sub.name.startswith("step_") and sub.is_dir():
            try:
                steps.append(int(sub.name.split("_")[1]))
            except ValueError:
                continue
    return sorted(steps)


def latest_valid(ckpt_dir: str | os.PathLike) -> int | None:
    """Newest checkpoint that passes full verification (corrupt/incomplete
    checkpoints are skipped -- the node-failure recovery path)."""
    for step in reversed(available_steps(ckpt_dir)):
        if _verify(Path(ckpt_dir) / f"step_{step}"):
            return step
    return None


def _load_leaf(path: Path, ref: dict, like, device):
    a = np.load(path)
    if list(a.shape) != list(ref["shape"]):
        raise IOError(f"{path}: shape {a.shape}, manifest {ref['shape']}")
    if ref["dtype"] == BF16:                 # '<V2' records: the bf16 bits
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    elif isinstance(like, torch.Tensor):
        t = torch.from_numpy(a)
    elif hasattr(like, "dtype"):
        return a.astype(like.dtype)
    else:
        return a
    if isinstance(like, torch.Tensor):
        dev = device if device is not None else (
            "cpu" if like.device.type == "meta" else like.device)
        return t.to(device=dev, dtype=like.dtype)
    return t


def restore(ckpt_dir: str | os.PathLike, step: int, target_tree, shardings=None,
            device=None):
    """Restore into the structure of target_tree.  A tensor leaf comes back
    as a tensor of that leaf's dtype, on ``device`` (default: the leaf's own,
    the CPU for a ``meta`` leaf); a bfloat16 leaf bit for bit.  With
    ``shardings`` (a tree like target_tree of ``Sharding``s) each leaf comes
    back as a ``DTensor`` laid out by its sharding, whatever mesh the tree
    was saved from."""
    d = Path(ckpt_dir) / f"step_{step}"
    if not _verify(d):
        raise IOError(f"checkpoint {d} is missing or corrupt")
    manifest = json.loads((d / "manifest.json").read_text())
    leaves = sorted_leaves(target_tree)
    if len(leaves) != len(manifest["leaves"]):
        raise IOError(f"checkpoint {d} holds {len(manifest['leaves'])} leaves, "
                      f"the target tree {len(leaves)}")
    if shardings is None:
        out = [_load_leaf(d / ref["file"], ref, like, device)
               for ref, like in zip(manifest["leaves"], leaves)]
    else:
        out = [distribute(_load_leaf(d / ref["file"], ref, like, "cpu"), sh)
               for ref, like, sh in zip(manifest["leaves"], leaves, sorted_leaves(shardings))]
    return _unflatten(target_tree, iter(out))
