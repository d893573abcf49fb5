"""Model substrate plumbing: spec-first parameters and logical-axis sharding.

Spec-first parameters: model builders return a *tree of PSpec* (shape +
logical axis names + init kind).  The tree is materialized three ways:
  * ``init_params``      -> real tensors on a device, from a ``torch.Generator``
  * ``abstract_params``  -> tensors on the ``meta`` device (no bytes)
  * ``param_shardings``  -> a :class:`~repro_torch.substrate.Sharding` per leaf
                            from the logical rules

Logical-axis sharding with divisibility degradation: a logical axis maps to
mesh axes only when the dimension is divisible by their product, so one rules
table serves every architecture on every mesh.  The rules come from the
active scoped profile (``sharding_profile``), else the process default
that the deprecated :func:`set_sharding_profile` sets; the router's pool also
validates profile names against :func:`profile_names`.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
import warnings
from types import MappingProxyType
from typing import Any, Callable, Iterator, Mapping

import torch
import torch.utils.checkpoint

from ..substrate import Sharding, constrain_spec, current_axis_sizes, degrade_spec

# logical axis name -> preferred mesh axes (applied greedily, outermost first).
# The baseline table; profile overlays never mutate it.  No module outside
# models/common.py reads it: consumers go through the active ShardingProfile.
LOGICAL_RULES: dict[str, tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "seq": ("model",),
    "cache_seq": ("model",),
    "cache_hd": (),
    "cache_batch": ("pod", "data"),
    "tile_q": ("model",),
    "vocab": ("model",),
    "heads": ("model",),
    "qkv": ("model",),
    "ffn": ("model",),
    "experts": ("model",),
    "embed": ("data",),
    "embed_d": ("data",),
    "ssm_inner": ("model",),
    "layers": (),
    "state": (),
    "none": (),
}

# Sharding profiles:
#  baseline : FSDP everywhere, decode-SP caches
#  opt1     : baseline minus FSDP on the (un)embedding tables
#  moe_ep   : a true expert axis for MoE archs whose expert count does not
#             divide the model axis
#  serve    : inference layout -- 2D tensor parallelism on weights, decode
#             activations replicated over the data axis
PROFILES: dict[str, dict[str, tuple[str, ...]]] = {
    "baseline": {},
    "opt1": {"embed_d": ()},
    "moe_ep": {
        "experts": ("expert",),
        "heads": ("expert", "tp"),
        "qkv": ("expert", "tp"),
        "ffn": ("tp",),
        "vocab": ("expert", "tp"),
        "seq": ("expert", "tp"),
        "cache_seq": ("expert", "tp"),
        "ssm_inner": ("expert", "tp"),
        "tile_q": ("expert", "tp"),
        "embed_d": (),
    },
    "serve": {
        "batch": (),
        "seq": (),
        "embed_d": (),
        "embed": (),
        "qkv": ("model", "data"),
        "ffn": ("model", "data"),
        "vocab": ("model", "data"),
        "ssm_inner": ("model", "data"),
    },
}


def profile_names() -> list[str]:
    """Registry-derived profile names, the single source of truth for CLI
    ``--profile`` / ``--pool`` choices."""
    return sorted(PROFILES)


@dataclasses.dataclass(frozen=True)
class ShardingProfile:
    """An immutable, fully-resolved logical->mesh rules table (the baseline
    rules with the named overlay applied)."""
    name: str
    rules: Mapping[str, tuple[str, ...]]

    def rule(self, logical: str) -> tuple[str, ...]:
        return self.rules.get(logical, ())


_PROFILE_CACHE: dict[str, ShardingProfile] = {}


def resolve_profile(profile: str | ShardingProfile) -> ShardingProfile:
    """Name or profile -> ShardingProfile; an unknown name raises KeyError
    before any state changes."""
    if isinstance(profile, ShardingProfile):
        return profile
    if profile not in _PROFILE_CACHE:
        if profile not in PROFILES:
            raise KeyError(
                f"unknown sharding profile {profile!r}; known: {sorted(PROFILES)}")
        _PROFILE_CACHE[profile] = ShardingProfile(
            profile, MappingProxyType({**LOGICAL_RULES, **PROFILES[profile]}))
    return _PROFILE_CACHE[profile]


# contextvars give per-thread AND per-async-task scoping
_ACTIVE_PROFILE: contextvars.ContextVar[ShardingProfile | None] = \
    contextvars.ContextVar("repro_torch_sharding_profile", default=None)
# process-wide fallback for the deprecated set_sharding_profile() shim;
# scoped sharding_profile(...) blocks always take precedence
_PROCESS_DEFAULT_PROFILE: ShardingProfile | None = None


def active_profile() -> ShardingProfile:
    """The innermost ``sharding_profile`` block's profile on this thread or
    task, else the process default set by the deprecated shim, else
    baseline."""
    prof = _ACTIVE_PROFILE.get()
    if prof is not None:
        return prof
    if _PROCESS_DEFAULT_PROFILE is not None:
        return _PROCESS_DEFAULT_PROFILE
    return resolve_profile("baseline")


@contextlib.contextmanager
def sharding_profile(profile: str | ShardingProfile) -> Iterator[ShardingProfile]:
    """Scoped profile selection; nesting replaces, exiting restores the
    enclosing profile even when the body raises."""
    prof = resolve_profile(profile)  # validate before touching any state
    token = _ACTIVE_PROFILE.set(prof)
    try:
        yield prof
    finally:
        _ACTIVE_PROFILE.reset(token)


def set_sharding_profile(name: str) -> None:
    """DEPRECATED shim: sets the process-wide *default* profile.

    Use ``sharding_profile(name)`` instead: the scoped form composes under
    concurrency; this one is a process global that any active scoped profile
    overrides.  An unknown name raises before the default changes."""
    warnings.warn(
        "set_sharding_profile() is deprecated; use the scoped "
        "`with sharding_profile(name):` context manager",
        DeprecationWarning, stacklevel=2)
    prof = resolve_profile(name)
    global _PROCESS_DEFAULT_PROFILE
    _PROCESS_DEFAULT_PROFILE = prof


# ------------------------------------------------------------------ spec tree
@dataclasses.dataclass(frozen=True)
class PSpec:
    """One parameter leaf: shape + logical axes + initializer."""
    shape: tuple[int, ...]
    logical: tuple[str, ...]
    init: str = "fan_in"      # fan_in | zeros | ones | embed | a_log | dt_bias
    dtype: str = "float32"

    def __post_init__(self):
        if len(self.shape) != len(self.logical):
            raise ValueError(f"shape {self.shape} and logical axes {self.logical} "
                             "differ in length")


def is_pspec(x) -> bool:
    return isinstance(x, PSpec)


def tree_map_pspec(fn: Callable[[str, PSpec], Any], tree, path: str = "") -> Any:
    if is_pspec(tree):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: tree_map_pspec(fn, v, f"{path}/{k}") for k, v in tree.items()}
    raise TypeError(type(tree))


def torch_dtype(name: str | torch.dtype) -> torch.dtype:
    """``"bfloat16"`` -> ``torch.bfloat16`` (a torch dtype passes through)."""
    return name if isinstance(name, torch.dtype) else getattr(torch, name)


_RANDOM_KINDS = ("fan_in", "embed", "a_log", "dt_bias")


def _initialize(gen: torch.Generator | None, p: PSpec, dtype: torch.dtype,
                device) -> torch.Tensor:
    if p.init == "zeros":
        return torch.zeros(p.shape, dtype=dtype, device=device)
    if p.init == "ones":
        return torch.ones(p.shape, dtype=dtype, device=device)
    f32 = dict(dtype=torch.float32, device=device, generator=gen)
    if p.init == "a_log":  # mamba2: A ~ U[1,16], stored as log
        return torch.rand(p.shape, **f32).mul_(15.0).add_(1.0).log_().to(dtype)
    if p.init == "dt_bias":  # mamba2: softplus^-1 of dt ~ logU[1e-3, 1e-1]
        u = torch.rand(p.shape, **f32)
        dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
        return (dt + torch.log(-torch.expm1(-dt))).to(dtype)
    if p.init == "embed":
        return torch.randn(p.shape, **f32).mul_(0.02).to(dtype)
    # fan_in: normal with 1/sqrt(fan_in); fan-in = first axis that is not a
    # stacking ("layers") axis
    fan = 1
    for s, l in zip(p.shape, p.logical):
        if l != "layers":
            fan = s
            break
    return torch.randn(p.shape, **f32).mul_(1.0 / math.sqrt(max(fan, 1))).to(dtype)


def init_params(spec_tree, generator: torch.Generator | None, device,
                param_dtype=torch.float32):
    """Materialize real parameters on ``device``.

    One 62-bit base seed is drawn from ``generator``; the leaf at sorted path
    index i then draws from its own generator on ``device`` seeded from
    (base, i), so a leaf's values do not depend on which other leaves exist
    or on the order they are made in.  The bits differ from the reference's
    ``jax.random`` (tests carry the reference's arrays across instead).  A
    tree of ``zeros``/``ones`` leaves (a decode cache) needs no generator."""
    dtype = torch_dtype(param_dtype)
    leaves: list[tuple[str, PSpec]] = []
    tree_map_pspec(lambda path, p: leaves.append((path, p)), spec_tree)
    idx = {path: i for i, path in enumerate(sorted(path for path, _ in leaves))}
    base = None
    if any(p.init in _RANDOM_KINDS for _, p in leaves):
        if generator is None:
            raise ValueError("random initializers need a torch.Generator")
        base = int(torch.randint(1 << 62, (), generator=generator,
                                 device=generator.device).item())

    def make(path, p):
        gen = None
        if p.init in _RANDOM_KINDS:
            gen = torch.Generator(device=device)
            gen.manual_seed((base * 1_000_003 + idx[path]) % (1 << 63))
        return _initialize(gen, p, dtype, device)

    return tree_map_pspec(make, spec_tree)


def tree_leaves(tree) -> list:
    """The tensors of a nested-dict tree, in insertion order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]


def sorted_leaves(tree, out: list | None = None) -> list:
    """The leaves of a tree in the reference's tree order (``jax.tree``'s):
    dict keys sorted, tuple and ``NamedTuple`` fields in order, None an
    empty subtree."""
    out = [] if out is None else out
    if isinstance(tree, dict):
        for k in sorted(tree):
            sorted_leaves(tree[k], out)
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            sorted_leaves(x, out)
    elif tree is not None:
        out.append(tree)
    return out


def tree_to(tree, device):
    """The same tree with every tensor moved to ``device`` (a copy per leaf
    unless it is there already)."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def abstract_params(spec_tree, param_dtype=torch.float32):
    """Stand-ins on the ``meta`` device: shapes and dtypes, no allocation."""
    dtype = torch_dtype(param_dtype)
    return tree_map_pspec(
        lambda _, p: torch.empty(p.shape, dtype=dtype, device="meta"), spec_tree)


def checkpointed(fn, *args, enabled: bool = True):
    """``fn(*args)``, keeping only its inputs for the backward pass and
    recomputing its activations there (what ``jax.checkpoint`` does).
    Without autograd (inference), or not ``enabled``, it is a plain call."""
    if not (enabled and torch.is_grad_enabled()):
        return fn(*args)
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)


# ----------------------------------------------------------------- shardings
def resolve_spec(shape: tuple[int, ...], logical: tuple[str, ...],
                 mesh_shape: dict[str, int],
                 profile: str | ShardingProfile | None = None) -> tuple:
    """Logical axes -> spec entries (one per dimension: None, a mesh axis
    or a tuple of them) with divisibility degradation.  Rules come from
    ``profile`` when given, else from the active scoped profile."""
    prof = resolve_profile(profile) if profile is not None else active_profile()
    return degrade_spec(shape, [prof.rule(lname) for lname in logical], mesh_shape)


def param_shardings(spec_tree, mesh, profile: str | ShardingProfile | None = None):
    """A :class:`Sharding` per leaf of a PSpec tree on ``mesh`` (its
    ``placements`` are the leaf's ``DTensor`` placements)."""
    ms = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    prof = resolve_profile(profile) if profile is not None else active_profile()
    return tree_map_pspec(
        lambda _, p: Sharding(mesh, resolve_spec(p.shape, p.logical, ms, profile=prof)),
        spec_tree)


def logical_pspecs(spec_tree, mesh_shape: dict[str, int],
                   profile: str | ShardingProfile | None = None):
    """The spec entries of every leaf for a mesh of ``mesh_shape`` (shapes
    only: no mesh, no allocation)."""
    prof = resolve_profile(profile) if profile is not None else active_profile()
    return tree_map_pspec(
        lambda _, p: resolve_spec(p.shape, p.logical, mesh_shape, profile=prof),
        spec_tree)


def constrain(x, *logical: str | None, profile: str | ShardingProfile | None = None):
    """Constrain by logical axis names: the identity outside a mesh
    context; inside one, a ``DTensor`` is laid out by the resolved spec
    (an axis that does not divide is dropped)."""
    ms = current_axis_sizes()
    if not ms:
        return x
    spec = resolve_spec(x.shape, tuple(l or "none" for l in logical), ms, profile=profile)
    return constrain_spec(x, spec)
