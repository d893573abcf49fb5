"""Meshes, layouts and named-axis collectives on ``torch.distributed``, and the
host and process placement facts for the engine pool.

The reference's ``substrate/compat.py`` papers over two JAX mesh-API
generations; this module maps the same calls onto one PyTorch API:

    reference                       here
    ------------------------------  ------------------------------------------
    make_mesh                       a ``DeviceMesh`` over the default group
    mesh_context, current_...       a ``contextvars.ContextVar``
    PartitionSpec                   a tuple: per tensor dimension a mesh axis
                                    name, a tuple of names (major first) or None
    NamedSharding                   :class:`Sharding` (mesh, spec), with the
                                    ``DTensor`` placements that spec means
    shard_map + lax collectives     :func:`shard_map` with :func:`axis_index`,
                                    :func:`psum`, :func:`all_gather`,
                                    :func:`ppermute` on the axis's group

``jax_mesh_api`` tells JAX API generations apart and has no counterpart
here.  The reference's ``compiled_cost_analysis`` reads XLA's cost analysis
of a compiled program; here :class:`CostCounter` counts the same figures
over a traced step (below).

A tuple of mesh axes on one dimension chunks it as the reference does: the
first-named axis is the major one.  ``DTensor`` applies placements in mesh
order, so where a tuple names a later mesh axis first (the ``serve``
profile's ``("model", "data")`` on a (data, model) mesh) the earlier mesh
axis gets a strided shard and the local rows are the reference's
(:func:`local_slices` computes them; tests hold both to JAX's own map).

Transport.  A collective goes over the group of its mesh axis with that
group's backend.  Gloo moves host memory only, and NCCL refuses two ranks on
one card; so several ranks sharing one card run on gloo, and the named-axis
collectives stage a CUDA tensor through a host copy exactly when the group's
backend is gloo.  That is the transport of a one-card run; the compute stays
on the card.  Ranks on cards of their own run NCCL with no staging.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
import os
import socket
import weakref
from typing import Any, Callable, Iterator, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F
import torch.utils._pytree as pytree
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
from torch.distributed.tensor.placement_types import Partial, _StridedShard
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary


# ------------------------------------------------------------------- groups
def init_group(backend: str, rank: int = 0, world_size: int = 1,
               init_method: str | None = None, store: dist.Store | None = None) -> None:
    """Initialize the default process group.  ``backend`` is the caller's
    choice (``"nccl"`` for ranks on cards of their own, ``"gloo"`` for host
    tensors or ranks sharing a card, ``"fake"`` for a fleet that one process
    stands in for, with :func:`fake_store`).  The rendezvous is ``store``
    when given, else ``init_method`` (a ``file://`` / ``tcp://`` /
    ``env://`` URL); a one-rank world may give neither and rendezvous in
    process memory."""
    if store is None and init_method is None:
        if world_size != 1:
            raise ValueError("a world of more than one rank needs an init_method or a store")
        store = dist.HashStore()
    if store is not None:
        dist.init_process_group(backend, store=store, rank=rank, world_size=world_size)
        return
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)


def fake_store() -> dist.Store:
    """The store of a ``"fake"`` process group: one process plays one rank
    of a fleet of any size, and every collective completes at once without
    moving data.  Importing PyTorch's testing module registers the backend."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    return FakeStore()


def is_fake_group(group=None) -> bool:
    """Whether ``group`` (the default group when None) is a ``"fake"`` one."""
    return dist.is_initialized() and dist.get_backend(group) == "fake"


# ------------------------------------------------------------------ make_mesh
def make_mesh(shape: Sequence[int], axes: Sequence[str], *,
              device_type: str = "cuda") -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` over ``axes``, laid over the first
    ranks of the initialized default group in row-major order.  Raises
    RuntimeError when CUDA is wanted and absent (a ``"fake"`` world needs no
    card: its tensors are fake ones), or when the world has fewer ranks than
    the shape needs."""
    if device_type == "cuda" and not torch.cuda.is_available() and not is_fake_group():
        raise RuntimeError("device_type='cuda' was requested but CUDA is not available; "
                           "pass device_type='cpu' to run on the CPU")
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have < n:
        raise RuntimeError(f"need {n} devices, have {have}")
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=tuple(axes))


def mesh_axis_sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's shards live on (card 0 in a ``"fake"``
    world, whose tensors are fake ones)."""
    if mesh.device_type == "cuda" and is_fake_group():
        return torch.device("cuda", 0)
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


# --------------------------------------------------------------- mesh context
_MESH: contextvars.ContextVar[DeviceMesh | None] = \
    contextvars.ContextVar("repro_torch_mesh", default=None)


@contextlib.contextmanager
def mesh_context(mesh: DeviceMesh) -> Iterator[DeviceMesh]:
    """Activate ``mesh`` for constraints in this block (per thread and
    task); exiting restores the enclosing one even when the body raises."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def current_abstract_mesh() -> DeviceMesh | None:
    """The mesh of the innermost ``mesh_context`` block, or None."""
    return _MESH.get()


def current_axis_sizes() -> dict[str, int] | None:
    """axis-name -> size of the active mesh, or None outside any mesh."""
    mesh = _MESH.get()
    return None if mesh is None else mesh_axis_sizes(mesh)


# ------------------------------------------------------------------ topology
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


# -------------------------------------------------------------------- layouts
def _names(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def degrade_spec(shape: Sequence[int], candidates: Sequence[Sequence[str]],
                 sizes: dict[str, int]) -> tuple:
    """Greedy divisibility degradation: per dimension, keep the candidate
    mesh axes (outermost first) that exist in ``sizes``, are not yet used,
    and whose cumulative product divides the dimension.  Returns one entry
    per dimension: None, an axis name, or a tuple of names."""
    out: list[Any] = []
    used: set[str] = set()
    for dim, names in zip(shape, candidates):
        keep: list[str] = []
        shard = 1
        for ax in names:
            if ax is None:
                continue
            if ax in sizes and ax not in used and dim % (shard * sizes[ax]) == 0:
                keep.append(ax)
                shard *= sizes[ax]
        used.update(keep)
        if not keep:
            out.append(None)
        elif len(keep) == 1:
            out.append(keep[0])
        else:
            out.append(tuple(keep))
    return tuple(out)


def spec_placements(spec: Sequence, mesh: DeviceMesh) -> tuple:
    """The ``DTensor`` placements (one per mesh dimension) of ``spec``.  An
    axis that a tuple names after an axis of a later mesh dimension is the
    minor one there, so it is a strided shard whose split factor is the
    product of those major axes' sizes."""
    axes = list(mesh.mesh_dim_names)
    sizes = mesh_axis_sizes(mesh)
    out: list[Any] = [Replicate()] * len(axes)
    for d, entry in enumerate(spec):
        names = _names(entry)
        for t, ax in enumerate(names):
            i = axes.index(ax)
            split = math.prod(sizes[b] for b in names[:t] if axes.index(b) > i)
            out[i] = _StridedShard(d, split_factor=split) if split > 1 else Shard(d)
    return tuple(out)


def local_slices(shape: Sequence[int], spec: Sequence, sizes: dict[str, int],
                 coords: dict[str, int]) -> tuple[slice, ...]:
    """The slice of a ``shape`` tensor that the rank at mesh coordinates
    ``coords`` holds under ``spec``, as the reference chunks it: a dimension
    over axes (a, b, ...) splits into size(a)·size(b)·... even chunks, and
    the rank takes chunk ((coord(a)·size(b) + coord(b))·...)."""
    out = []
    for d, dim in enumerate(shape):
        names = _names(spec[d]) if d < len(spec) else ()
        n, idx = 1, 0
        for ax in names:
            n *= sizes[ax]
            idx = idx * sizes[ax] + coords[ax]
        step = dim // n
        out.append(slice(idx * step, (idx + 1) * step))
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A tensor's layout on a mesh: the reference's spec entries (one per
    tensor dimension) and the ``DTensor`` placements they mean."""
    mesh: DeviceMesh
    spec: tuple

    @property
    def placements(self) -> tuple:
        return spec_placements(self.spec, self.mesh)

    def local(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's shard of ``full`` (a view where it can be one)."""
        coords = dict(zip(self.mesh.mesh_dim_names, self.mesh.get_coordinate()))
        return full[local_slices(full.shape, self.spec, mesh_axis_sizes(self.mesh), coords)]


def distribute(full: torch.Tensor, sharding: Sharding) -> DTensor:
    """A ``DTensor`` laid out by ``sharding`` from the full value, which
    every rank holds: each rank keeps its own shard on the mesh's device (no
    collective).  A shard smaller than ``full`` is a copy, so ``full`` can
    be freed; a shard that is all of it stays ``full`` itself."""
    local = sharding.local(full)
    if local.numel() < full.numel():
        local = local.clone()
    local = local.to(mesh_device(sharding.mesh)).contiguous()
    return DTensor.from_local(local, sharding.mesh, sharding.placements,
                              run_check=False, shape=full.shape, stride=full.stride())


@torch.no_grad()
def full_value(x) -> torch.Tensor:
    """The full value of a ``DTensor`` on every rank (an all-gather over its
    sharded mesh dimensions; the local tensor itself when no dimension is
    split); any other tensor as it is."""
    if isinstance(x, DTensor):
        return x.full_tensor()
    return x


def local_value(x) -> torch.Tensor:
    """The tensor this rank holds: a ``DTensor``'s local shard (its own
    storage, so in-place writes reach the ``DTensor``), else ``x``."""
    if isinstance(x, DTensor):
        with torch.no_grad():
            return x.to_local()
    return x


def reduce_over(x: torch.Tensor, mesh: DeviceMesh, axes: Sequence[str],
                placements: Sequence, layout: Sequence | None = None,
                shape: Sequence[int] | None = None) -> DTensor:
    """Sum the per-rank values ``x`` over the mesh axes ``axes`` and lay the
    sum out by ``placements``: a reduce-scatter where a placement shards,
    an all-reduce where it replicates.  On the other axes ``x`` is laid out
    by ``layout`` (one placement per mesh axis; default replicated: ranks
    that differ only there hold the same ``x``), a tensor of global
    ``shape`` (default: ``x``'s own, as a replicated layout has it)."""
    layout = layout or [Replicate()] * mesh.ndim
    src = [Partial() if ax in axes else p for ax, p in zip(mesh.mesh_dim_names, layout)]
    shape = tuple(shape) if shape is not None else tuple(x.shape)
    stride = tuple(math.prod(shape[d + 1:]) for d in range(len(shape)))
    return DTensor.from_local(x, mesh, src, run_check=False, shape=shape,
                              stride=stride).redistribute(mesh, tuple(placements))


# ------------------------------------------------------------------ constrain
def constrain_spec(x, spec: Sequence):
    """Lay a ``DTensor`` out by ``spec`` on the active mesh; the identity
    for any other tensor and outside a mesh."""
    mesh = _MESH.get()
    if mesh is None or not isinstance(x, DTensor):
        return x
    return x.redistribute(mesh, spec_placements(spec, mesh))


def constrain(x, *axes):
    """Constrain ``x`` by mesh-axis names, degrading gracefully.  Each
    entry is a mesh axis name, a tuple of names, or None.  Axes absent from
    the active mesh or not dividing the dimension are dropped; with no
    active mesh the call is the identity."""
    sizes = current_axis_sizes()
    if not sizes:
        return x
    cands = [entry if isinstance(entry, tuple) else (entry,) for entry in axes]
    return constrain_spec(x, degrade_spec(x.shape, cands, sizes))


# ----------------------------------------------------------------- shard_map
_SHARD_MESH: contextvars.ContextVar[DeviceMesh | None] = \
    contextvars.ContextVar("repro_torch_shard_map_mesh", default=None)


def _tree_map(fn, tree, spec):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, spec) for k, v in tree.items()}
    return fn(tree, spec)


def shard_map(f: Callable, *, mesh: DeviceMesh, in_specs: Sequence, out_specs):
    """``f`` run on every rank over its local shards.  Each argument (a
    tensor or a nested dict of them) is laid out by its entry of
    ``in_specs``: a ``DTensor`` hands over its local shard; a full tensor,
    which every rank holds, hands over this rank's slice.  Inside ``f`` the
    named-axis collectives act on ``mesh``.  An output whose spec replicates
    (``()``) comes back as the local tensor, which the collectives in ``f``
    must have made equal on every rank; another comes back as a
    ``DTensor``."""
    def local(x, spec):
        return local_value(x) if isinstance(x, DTensor) else Sharding(mesh, spec).local(x)

    def wrapped(*args):
        token = _SHARD_MESH.set(mesh)
        try:
            out = f(*(_tree_map(local, a, s) for a, s in zip(args, in_specs)))
        finally:
            _SHARD_MESH.reset(token)
        if not any(_names(e) for e in out_specs):
            return out
        sh = Sharding(mesh, tuple(out_specs))
        return DTensor.from_local(out, mesh, sh.placements, run_check=False)
    return wrapped


def _axis_mesh(mesh: DeviceMesh | None) -> DeviceMesh:
    mesh = mesh if mesh is not None else _SHARD_MESH.get()
    if mesh is None:
        raise RuntimeError("a named-axis collective outside shard_map needs mesh=")
    return mesh


def _staged(x: torch.Tensor, group) -> bool:
    """Whether ``x`` crosses ``group`` through a host copy: a CUDA tensor
    on a gloo group."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


def axis_index(axis: str, *, mesh: DeviceMesh | None = None) -> int:
    """This rank's coordinate along ``axis``."""
    return _axis_mesh(mesh).get_local_rank(axis)


def psum(x: torch.Tensor, axis: str, *, mesh: DeviceMesh | None = None) -> torch.Tensor:
    """The sum of ``x`` over ``axis`` (a new tensor, the same on each rank
    of the axis)."""
    group = _axis_mesh(mesh).get_group(axis)
    wire = x.cpu() if _staged(x, group) else x.clone()
    dist.all_reduce(wire, group=group)
    return wire.to(x.device)


def all_gather(x: torch.Tensor, axis: str, *, mesh: DeviceMesh | None = None) -> torch.Tensor:
    """Every rank's ``x`` along ``axis``, stacked on a new leading
    dimension in axis order."""
    group = _axis_mesh(mesh).get_group(axis)
    wire = x.cpu() if _staged(x, group) else x.contiguous()
    parts = [torch.empty_like(wire) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, wire, group=group)
    return torch.stack(parts).to(x.device)


def ppermute(x: torch.Tensor, axis: str, perm: Sequence[tuple[int, int]], *,
             mesh: DeviceMesh | None = None) -> torch.Tensor:
    """Send ``x`` along ``axis`` by ``perm`` ((source, destination) axis
    indices); returns what this rank received, zeros where no source sends
    to it."""
    mesh = _axis_mesh(mesh)
    group = mesh.get_group(axis)
    dim = list(mesh.mesh_dim_names).index(axis)
    me = mesh.get_local_rank(axis)
    coord = list(mesh.get_coordinate())

    def peer(index: int) -> int:
        coord[dim] = index
        return int(mesh.mesh[tuple(coord)])
    staged = _staged(x, group)
    wire = x.cpu() if staged else x.contiguous()
    recv = torch.zeros_like(wire)
    if (me, me) in perm:
        recv.copy_(wire)
    p2p = [dist.P2POp(dist.isend, wire, peer(dst), group)
           for src, dst in perm if src == me != dst]
    p2p += [dist.P2POp(dist.irecv, recv, peer(src), group)
            for src, dst in perm if dst == me != src]
    if p2p:
        for req in dist.batch_isend_irecv(p2p):
            req.wait()
    return recv.to(x.device) if staged else recv


# ------------------------------------------- collectives under autograd
# A tensor-parallel step computes each rank's share of one loss: the whole
# loss is the sum of every rank's part.  So each collective below is
# differentiable with its adjoint under that sum: an all-gather's backward
# is a reduce-scatter, a reduce-scatter's an all-gather, an all-reduce's an
# all-reduce.  A tuple of mesh axes splits a dimension as ``local_slices``
# does, its first-named axis the major one.
def _gather_dim(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    wire = (x.cpu() if _staged(x, group) else x).contiguous()
    out = wire.new_empty((n * wire.shape[0],) + tuple(wire.shape[1:]))
    dist.all_gather_into_tensor(out, wire, group=group)
    return out.to(x.device).unflatten(0, (n, -1)).movedim(0, dim).flatten(dim, dim + 1)


def _scatter_dim(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    parts = x.unflatten(dim, (n, x.shape[dim] // n)).movedim(dim, 0)
    wire = (parts.cpu() if _staged(x, group) else parts).contiguous()
    out = wire.new_empty(wire.shape[1:])
    dist.reduce_scatter_tensor(out, wire.flatten(0, 1), group=group)
    return out.to(x.device)


def _sum_over(x: torch.Tensor, groups, op=dist.ReduceOp.SUM) -> torch.Tensor:
    for group in groups:
        wire = x.cpu() if _staged(x, group) else x.clone()
        dist.all_reduce(wire, op=op, group=group)
        x = wire.to(x.device)
    return x


class _GatherOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups, dim):
        ctx.groups, ctx.dim = groups, dim
        for group in reversed(groups):
            x = _gather_dim(x, group, dim)
        return x

    @staticmethod
    def backward(ctx, g):
        for group in ctx.groups:
            g = _scatter_dim(g, group, ctx.dim)
        return g, None, None


class _ScatterOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups, dim):
        ctx.groups, ctx.dim = groups, dim
        for group in groups:
            x = _scatter_dim(x, group, dim)
        return x

    @staticmethod
    def backward(ctx, g):
        for group in reversed(ctx.groups):
            g = _gather_dim(g, group, ctx.dim)
        return g, None, None


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return _sum_over(x, groups)

    @staticmethod
    def backward(ctx, g):
        return _sum_over(g, ctx.groups), None


def _axis_groups(mesh: DeviceMesh, axes: Sequence[str]) -> tuple:
    return tuple(mesh.get_group(ax) for ax in axes)


def gather_over(x: torch.Tensor, mesh: DeviceMesh, axes: Sequence[str],
                dim: int) -> torch.Tensor:
    """Every rank's ``x`` over the mesh axes ``axes``, joined along ``dim``
    in chunk order (an all-gather an axis, the minor one first); its
    backward is the reduce-scatter.  No axes: ``x`` itself."""
    if not axes:
        return x
    return _GatherOver.apply(x, _axis_groups(mesh, axes), dim % x.dim())


def scatter_over(x: torch.Tensor, mesh: DeviceMesh, axes: Sequence[str],
                 dim: int) -> torch.Tensor:
    """The sum of every rank's ``x`` over ``axes``, of which this rank keeps
    its chunk along ``dim`` (a reduce-scatter an axis, the major one first);
    its backward is the all-gather.  No axes: ``x`` itself."""
    if not axes:
        return x
    return _ScatterOver.apply(x, _axis_groups(mesh, axes), dim % x.dim())


def sum_over(x: torch.Tensor, mesh: DeviceMesh, axes: Sequence[str]) -> torch.Tensor:
    """The sum of every rank's ``x`` over ``axes`` (an all-reduce an axis);
    its backward is the same sum of the gradients.  No axes: ``x`` itself."""
    if not axes:
        return x
    return _SumOver.apply(x, _axis_groups(mesh, axes))


@torch.no_grad()
def max_over(x: torch.Tensor, mesh: DeviceMesh, axes: Sequence[str]) -> torch.Tensor:
    """The elementwise maximum of every rank's ``x`` over ``axes``, outside
    autograd."""
    return _sum_over(x, _axis_groups(mesh, axes), dist.ReduceOp.MAX) if axes else x


def _all_to_all_dim(x: torch.Tensor, group, split_dim: int, cat_dim: int, split_lead: int = 1,
                    cat_lead: int = 1) -> torch.Tensor:
    """One all-to-all over ``group``'s n ranks: ``split_dim`` viewed as
    (split_lead, n, rest), the rank at index j sent the j-th slice of the
    middle factor; what rank j sent joined along ``cat_dim`` as the middle
    factor of (cat_lead, n, rest)."""
    n = dist.get_world_size(group)
    parts = x.unflatten(split_dim, (split_lead, n, -1)).movedim(split_dim + 1, 0)
    parts = parts.flatten(split_dim + 1, split_dim + 2)
    wire = (parts.cpu() if _staged(x, group) else parts).contiguous()
    out = torch.empty_like(wire)
    dist.all_to_all_single(out, wire, group=group)
    out = out.to(x.device).unflatten(cat_dim + 1, (cat_lead, -1)).movedim(0, cat_dim + 1)
    return out.flatten(cat_dim, cat_dim + 2)


def _all_to_all_over(x, groups, split_dim: int, cat_dim: int, reverse: bool):
    """The all-to-all over ``groups`` (major first) as one over their joined
    ranks: the minor axis first, each on its own factor of ``split_dim``,
    so the chunks come split and joined in chunk order; ``reverse``, its
    inverse (the major axis first)."""
    sizes = [dist.get_world_size(g) for g in groups]
    if not reverse:
        for k in reversed(range(len(groups))):
            x = _all_to_all_dim(x, groups[k], split_dim, cat_dim, split_lead=math.prod(sizes[:k]))
        return x
    for k in range(len(groups)):
        x = _all_to_all_dim(x, groups[k], cat_dim, split_dim, cat_lead=math.prod(sizes[:k]))
    return x


class _AllToAllOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups, split_dim, cat_dim, reverse):
        ctx.args = groups, split_dim, cat_dim, reverse
        return _all_to_all_over(x, groups, split_dim, cat_dim, reverse)

    @staticmethod
    def backward(ctx, g):
        groups, split_dim, cat_dim, reverse = ctx.args
        return _all_to_all_over(g, groups, split_dim, cat_dim, not reverse), None, None, None, None


def all_to_all_over(x: torch.Tensor, mesh: DeviceMesh, axes: Sequence[str], split_dim: int,
                    cat_dim: int, reverse: bool = False) -> torch.Tensor:
    """``x`` split evenly along ``split_dim`` over the ranks of ``axes``, the
    rank at chunk index j (the first-named axis the major one, as
    ``chunk_of``) sent chunk j; what every rank sent this one, joined along
    ``cat_dim`` in chunk order (an all-to-all an axis).  ``reverse``: the
    inverse of that all-to-all with the same arguments (the chunks joined
    along ``cat_dim`` go back, and come back along ``split_dim``).  Each
    one's backward is the other.  No axes: ``x`` itself."""
    if not axes:
        return x
    return _AllToAllOver.apply(x, _axis_groups(mesh, axes), split_dim % x.dim(),
                               cat_dim % x.dim(), reverse)


def _exchange(x: torch.Tensor, group, send: Sequence[int], recv: Sequence[int],
              dim: int) -> torch.Tensor:
    """Consecutive runs of ``x`` along ``dim`` sent over ``group``'s ranks
    (``send[j]`` elements to rank j), the ``recv[j]`` each rank j sent
    joined along ``dim`` in rank order."""
    wire = x.movedim(dim, 0)
    wire = (wire.cpu() if _staged(x, group) else wire).contiguous()
    out = wire.new_empty((sum(recv),) + tuple(wire.shape[1:]))
    dist.all_to_all_single(out, wire, list(recv), list(send), group=group)
    return out.to(x.device).movedim(0, dim)


class _TradeOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, send, recv, dim):
        ctx.args = group, send, recv, dim
        return _exchange(x, group, send, recv, dim)

    @staticmethod
    def backward(ctx, g):
        group, send, recv, dim = ctx.args
        return _exchange(g, group, recv, send, dim), None, None, None, None


@torch.no_grad()
def exchange_over(x: torch.Tensor, mesh: DeviceMesh, axis: str, send: Sequence[int],
                  recv: Sequence[int]) -> torch.Tensor:
    """Consecutive runs of ``x``'s first dimension sent over the ranks of
    ``axis``: the first ``send[0]`` rows to the rank at index 0, the next
    ``send[1]`` to index 1, and so on; returns the ``recv[j]`` rows each rank
    j sent this one, joined in axis order (an all-to-all of uneven runs)."""
    return _exchange(x, mesh.get_group(axis), send, recv, 0)


def trade_over(x: torch.Tensor, mesh: DeviceMesh, axis: str, send: Sequence[int],
               recv: Sequence[int], dim: int) -> torch.Tensor:
    """:func:`exchange_over` along ``dim``, differentiable: its backward
    sends each rank's gradient back the way its elements came (the same
    exchange with ``send`` and ``recv`` swapped), its adjoint under the sum
    of every rank's share of one loss."""
    return _TradeOver.apply(x, mesh.get_group(axis), tuple(send), tuple(recv), dim % x.dim())


def from_shard(local: torch.Tensor, sharding: "Sharding",
               shape: Sequence[int] | None = None) -> DTensor:
    """The ``DTensor`` whose shard on this rank is ``local``, laid out by
    ``sharding`` (each rank passes its own; no collective): its global
    shape is the local one times the ranks each dimension is split over,
    or ``shape`` (a dimension split unevenly, in ``DTensor``'s ceil-sized
    chunks)."""
    sizes = mesh_axis_sizes(sharding.mesh)
    if shape is None:
        shape = [n * math.prod(sizes[ax] for ax in _names(sharding.spec[d]))
                 if d < len(sharding.spec) else n for d, n in enumerate(local.shape)]
    stride = tuple(math.prod(shape[d + 1:]) for d in range(len(shape)))
    return DTensor.from_local(local, sharding.mesh, sharding.placements, run_check=False,
                              shape=torch.Size(shape), stride=stride)


@torch.no_grad()
def gather_full(x) -> torch.Tensor:
    """The full value of a ``DTensor`` on every rank, from every rank's
    shard and its place in the whole (``DTensor``'s own offsets: even,
    uneven or strided shards), gathered over the whole mesh by
    :func:`gather_over` (staged through the host on a gloo group, where
    ``DTensor``'s own collectives are not), each shard padded to the
    largest: for small values, such as a serving step's logits; any other
    tensor as it is."""
    if not isinstance(x, DTensor):
        return x
    mesh, local = x.device_mesh, x.to_local()
    axes = mesh.mesh_dim_names
    shape, offset = compute_local_shape_and_global_offset(x.shape, mesh, x.placements)
    places = gather_over(torch.tensor([list(shape) + list(offset)], device=local.device),
                         mesh, axes, 0).tolist()
    top = [max(r[d] for r in places) for d in range(local.dim())]
    pad = [q for d in reversed(range(local.dim())) for q in (0, top[d] - local.shape[d])]
    every = gather_over(F.pad(local, pad)[None], mesh, axes, 0)
    out = local.new_empty(x.shape)
    for r, place in zip(every, places):
        n, at = place[:local.dim()], place[local.dim():]
        out[tuple(slice(a, a + k) for a, k in zip(at, n))] = r[tuple(slice(0, k) for k in n)]
    return out


def chunk_of(n: int, mesh: DeviceMesh, axes: Sequence[str]) -> slice:
    """This rank's chunk of ``n`` elements split evenly over ``axes``."""
    parts, idx = 1, 0
    for ax in axes:
        size = mesh.size(list(mesh.mesh_dim_names).index(ax))
        parts *= size
        idx = idx * size + mesh.get_local_rank(ax)
    step = n // parts
    return slice(idx * step, (idx + 1) * step)


# ------------------------------------------------------------- cost analysis
#: the reference's collective kinds (HLO op names) of the ``c10d`` and
#: functional collectives; a point-to-point receive is one rank's share of a
#: ``collective-permute``
COLLECTIVE_KINDS = {
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather", "allgather_into_tensor_coalesced_": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all", "recv_": "collective-permute",
}
_COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional", "c10d_functional",
                          "_c10d_functional_autograd")
#: ops that take one transcendental function an element, as XLA counts them
#: (exp, log, logistic, tanh, sqrt, rsqrt, erf, sin, cos): the elementwise
#: ones, the activations and softmaxes built on them, and the backward ops
#: that recompute one (``silu_backward`` its sigmoid, ``gelu_backward`` its
#: tanh or erf, ``_log_softmax_backward_data`` its exp); ``pow`` is left out,
#: since a square is a product
TRANSCENDENTAL_OPS = frozenset((
    "exp", "exp2", "expm1", "log", "log1p", "log2", "log10", "tanh", "sqrt", "rsqrt",
    "erf", "sin", "cos", "tan", "sigmoid", "silu", "gelu", "_softmax", "_log_softmax",
    "logsumexp", "silu_backward", "gelu_backward", "_log_softmax_backward_data"))


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


class CostCounter(TorchDispatchMode):
    """The counterpart of the reference's ``compiled_cost_analysis``
    (``src/repro/substrate/compat.py``), which reads XLA's cost analysis of a
    compiled program: a dispatch mode that counts, over the ops a traced step
    runs, the same figures per device, and the step's collectives and live
    bytes.  Run the step inside ``with counter:``, over fake tensors
    (``FakeTensorMode``) on a ``"fake"`` world for a fleet that is not there.

    Per device: an op on ``DTensor``s is let through (``NotImplemented``), so
    ``DTensor`` runs it as ops on this rank's local shards and their
    collectives, and only those are counted.  (Counting above the
    ``DTensor`` layer, as ``FlopCounterMode`` does, counts the global
    product: the whole mesh's work.)

    * ``flops``: products, from ``torch.utils.flop_counter``'s registry
      (matrix products, convolutions, attention);
    * ``bytes accessed``: every op's input and output bytes, unfused, as
      XLA:CPU's figure is (view ops move nothing and are left out);
    * ``transcendentals``: the elements of the ops in
      :data:`TRANSCENDENTAL_OPS` (of the larger of the first input and the
      outputs, so that ``logsumexp`` counts an exp an input element);
    * :attr:`collectives`: one event ``(kind, dtype, numel)`` per collective
      executed, the kind the reference's HLO name and the result's type and
      elements (``launch.hlo_stats.collective_stats`` sums them);
    * :attr:`live`, :attr:`peak`: bytes of the storages alive now and at
      most, each storage counted once whatever views it has, from its birth
      in an op (or :meth:`hold`) to its death (a weak reference).
    """

    def __init__(self) -> None:
        super().__init__()
        self.flops = 0
        self.bytes_accessed = 0
        self.transcendentals = 0
        self.collectives: list[tuple[str, torch.dtype, int]] = []
        self.live = 0
        self.peak = 0
        self._storages = WeakIdKeyDictionary()

    def _track(self, t: torch.Tensor) -> int:
        st = t.untyped_storage()
        if st in self._storages:
            return 0
        n = st.nbytes()
        self._storages[st] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._release, n)
        return n

    def _release(self, n: int) -> None:
        self.live -= n

    def hold(self, tree) -> int:
        """Count the storages of a tree's tensors (a ``DTensor`` by its local
        shard) as live, as arguments that exist before the step; returns the
        bytes newly counted."""
        return sum(self._track(local_value(t)) for t in _tensors(tree))

    def cost_analysis(self) -> dict:
        """The reference's keys: {"flops", "bytes accessed",
        "transcendentals"}, per device."""
        return {"flops": float(self.flops), "bytes accessed": float(self.bytes_accessed),
                "transcendentals": float(self.transcendentals)}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if not isinstance(func, torch._ops.OpOverload):
            return out
        name = func._overloadpacket.__name__
        if func.namespace in _COLLECTIVE_NAMESPACES:
            kind = COLLECTIVE_KINDS.get(name)
            if kind is not None:
                res = _tensors(out) or _tensors(args[0])
                self.collectives.append((kind, res[0].dtype, sum(t.numel() for t in res)))
        elif func._overloadpacket in flop_registry:
            self.flops += flop_registry[func._overloadpacket](*args, **kwargs, out_val=out)
        outs = _tensors(out)
        if not func.is_view:
            self.bytes_accessed += sum(t.numel() * t.element_size()
                                       for t in _tensors((args, kwargs)) + outs)
        if name.rstrip("_") in TRANSCENDENTAL_OPS:
            self.transcendentals += max(t.numel() for t in _tensors(args[:1]) + outs)
        for t in outs:
            self._track(t)
        return out
