"""Roofline analysis via component probes (the counterpart of the reference's
``src/repro/launch/roofline.py``).

The reference compiles every scan-free component of the step on the
production mesh, because XLA's cost analysis counts a ``scan`` body once.
Here every component (a probe) is traced once, eagerly, on fake ``DTensor``s
laid out on the mesh by the model's own shardings (``resolve_spec``, the same
degradation), under :class:`repro_torch.substrate.CostCounter`; the cell's
totals multiply each probe by its trips, taken from the code structure as in
the reference:

    layer blocks       x n_layers (per kind)
    attention tiles    x nq * nk  (the online-softmax chunk grid; the masked
                                   upper triangle is counted)
    SSD chunks         x S / Q
    loss chunks        x S / loss_chunk
    optimizer update   x param_count / probe_elements

Training probes run the scalarised probe's value and its gradients
(``torch.autograd`` in place of ``jax.value_and_grad``); remat="full" adds
one forward per layer with the reference's approximation (a third of the
probe's figures).  A probe runs as the port's step runs that layer: every
family's probes call the layer code of its tensor-parallel steps
(``models.tensor_parallel``: parameters gathered over their embed axes,
this rank's heads, columns, experts and vocabulary, the stream's, the
dispatched tokens' and ``in_proj``'s output's collectives; the train probes
sum their gradients into the parameters' layouts, the expert weights
travelling in the compute type, the prefill and decode probes gather their
weights in the compute type, decode attends over this rank's cache shard
and steps its SSM heads' state; the SSD chunk probe runs on this rank's
rows and heads; the encoder-decoder's encoder blocks run at its frames on
the frames' layout, and its decode's cross-attention over the cross
cache's shard).

Per device: the counter counts this rank's local ops below the ``DTensor``
layer, so ``flops`` and ``coll`` are one device's, as XLA's are under SPMD.
A probe whose sharding degrades to replicated counts the full work on every
device, as XLA does.  ``flops`` holds products only (the registry of
``torch.utils.flop_counter``); XLA's also counts elementwise work, so the
port's figure is at most the reference's.  ``bytes`` is the fusion-ideal HBM
traffic (:func:`_io_bytes_per_device`, the reference's formula) and
``bytes_hlo`` the counter's unfused sum.

Terms (per device):

    compute_s    = flops / peak_flops
    memory_s     = bytes / hbm_bw
    collective_s = collective_bytes / link_bw

with :data:`HW` the H100's published peaks.
"""
from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path
from typing import Callable

import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode

from ..configs.base import ArchConfig, ShapeCell
from ..models.common import (PSpec, ShardingProfile, abstract_params, active_profile,
                             param_shardings, profile_names, resolve_profile, resolve_spec,
                             sharding_profile, sorted_leaves, torch_dtype)
from ..models.layers import (attn_decode, attn_out, attn_prefill, attn_specs, mlp, mlp_specs,
                             qkv_proj, rmsnorm, rmsnorm_spec)
from ..models.encdec import _cross_decode
from ..models.model import Model
from ..models.moe import moe, moe_specs
from ..models.ssm import (_causal_conv, _conv_params, _gated_norm, _in_proj, _out_proj, _segsum,
                          ssd_decode, ssm_specs)
from ..models.tensor_parallel import (TensorParallel, expert_leaves, plan_decode,
                                      plan_prefill, plan_train, spec_entry,
                                      weight_leaves)
from ..models.transformer import _xent_chunk, embed_tokens, unembed
from ..substrate import CostCounter, Sharding, local_value, mesh_context
from .dryrun import laid_out
from .hlo_stats import collective_stats
from .mesh import mesh_axis_sizes

# NVIDIA H100 80GB HBM3 (SXM), at its 700 W power limit: the dense bf16
# tensor-core peak, HBM3's bandwidth, and NVLink 4's 450 GB/s each way
HW = {"peak_flops": 989e12, "hbm_bw": 3.35e12, "link_bw": 450e9}
Q_CHUNK, K_CHUNK = 512, 1024  # layers.chunked_attention defaults


def _sh(mesh, shape, logical) -> Sharding:
    return Sharding(mesh, resolve_spec(shape, logical, mesh_axis_sizes(mesh)))


def _io_bytes_per_device(args, shardings, outs, mesh) -> float:
    """Fusion-ideal HBM traffic: every input read once, every output written
    once, at the per-device shard sizes (the XLA:CPU 'bytes accessed' has no
    fusion and overcounts intermediates).  ``args`` and ``outs`` hold
    tensors (meta or fake) of the global shapes."""
    total = 0.0
    for a, sh in zip(sorted_leaves(args), sorted_leaves(shardings)):
        total += float(math.prod(sh.local(a).shape)) * a.element_size()
    n = float(math.prod(mesh_axis_sizes(mesh).values()))
    for o in sorted_leaves(outs):
        # outputs: assume they shard as well as the batch-heaviest input;
        # divide by the full device count as the optimistic bound
        total += float(math.prod(o.shape)) * o.element_size() / n
    return total


def _traced(arg, sharding, make):
    """A probe argument as traced: ``make(meta, sharding)`` over the tensors
    of a tree; a scalar integer (a decode position) as the Python int 0."""
    if isinstance(arg, dict):
        return {k: _traced(arg[k], sharding[k], make) for k in arg}
    if arg.dim() == 0 and not arg.is_floating_point():
        return 0
    return make(arg, sharding)


def _tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree(fn, v) for k, v in tree.items()}
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def _compile_stats(fn, args, shardings, mesh, device: str = "cuda", grad: bool = False,
                   tp: TensorParallel | None = None) -> dict:
    """Trace ``fn`` once on fake ``DTensor``s laid out by ``shardings`` on
    ``mesh``, as the port's sharded step runs a layer: every argument on
    this rank's shards; with ``tp`` (the step's plan) ``fn`` takes it and
    gathers its parameters as the step gathers a period (``build_probes``'
    ``add``), a gradient probe's gradients summed into the parameters'
    layouts in its backward.  Returns per-device product flops, unfused and
    fusion-ideal bytes, and collective bytes."""
    # the outputs' global shapes, for the fusion-ideal bytes
    outs = fn(*(_traced(a, s, lambda m, _: torch.empty_like(m))
                for a, s in zip(args, shardings)))
    bytes_io = _io_bytes_per_device(
        args, shardings, [o for o in sorted_leaves(outs) if isinstance(o, torch.Tensor)], mesh)
    counter = CostCounter()
    with FakeTensorMode(allow_non_fake_inputs=True), mesh_context(mesh):
        laid = [_traced(a, s, lambda m, sh: laid_out(m, sh, device))
                for a, s in zip(args, shardings)]
        with counter:
            local = [_tree(local_value, a) for a in laid]
            fn(*local) if tp is None else fn(*local, tp=tp)
    coll = collective_stats(counter.collectives, mesh.mesh.numel())
    return {
        "flops": float(counter.flops),
        "bytes_hlo": float(counter.bytes_accessed),
        "bytes": bytes_io,
        "coll": float(coll["collective_bytes_per_device"]),
    }


@dataclasses.dataclass
class Probe:
    name: str
    fn: Callable
    args: tuple
    shardings: tuple
    trips: float
    grad: bool = False  # trace the value and its gradients instead of fn
    tp: TensorParallel | None = None  # the step's plan (the first argument: its parameters)


def _scalarize(fn):
    def wrapped(*args, **kw):
        out = fn(*args, **kw)
        leaves = [x for x in sorted_leaves(out) if isinstance(x, torch.Tensor)]
        return sum(torch.sum(x.float()) for x in leaves)
    return wrapped


def _value_and_grad(fn, argnums):
    """``fn``'s value and its gradients with respect to the tensors of the
    arguments ``argnums`` (one list per argument, in ``sorted_leaves``
    order), as ``jax.value_and_grad`` gives them."""
    def wrapped(*args, **kw):
        wrt = [sorted_leaves(args[i]) for i in argnums]
        flat = [t.requires_grad_(True) for group in wrt for t in group]
        val = fn(*args, **kw)
        grads = iter(torch.autograd.grad(val, flat, allow_unused=True,
                                         materialize_grads=True))
        return val.detach(), [[next(grads) for _ in group] for group in wrt]
    return wrapped


def _abs(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def build_probes(cfg: ArchConfig, cell: ShapeCell, mesh) -> list[Probe]:
    B, S = cell.global_batch, cell.seq_len
    D = cfg.d_model
    bf16 = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    f32, i32 = torch.float32, torch.int32
    train = cell.kind == "train"
    decode = cell.kind == "decode"
    probes: list[Probe] = []
    pattern = cfg.layer_pattern()
    reps = cfg.n_layers // cfg.period
    n_attn = sum(1 for mx, _ in pattern if mx == "attn") * reps
    n_ssm = sum(1 for mx, _ in pattern if mx == "ssm") * reps
    n_mlp = sum(1 for _, ch in pattern if ch == "mlp") * reps
    n_moe = sum(1 for _, ch in pattern if ch == "moe") * reps
    encdec = cfg.family == "encdec"
    if encdec:
        # the decoder's self-attention (train and prefill: its cross-attention's
        # projections too) at S tokens; the encoder's blocks, and decode's
        # cross-attention, are probes of their own
        n_attn, n_mlp = cfg.n_layers * (1 if decode else 2), cfg.n_layers

    x_sh = _sh(mesh, (B, S, D), ("batch", "seq", "none"))
    x_abs = _abs((B, S, D), bf16)
    # every family's steps are tensor-parallel (launch.steps): the probes run
    # the step's layer code on this rank's working shards under the step's
    # plan, and on whole tensors (tp=None) for their outputs' global shapes
    model = Model(cfg)
    if train:
        plan = plan_train(cfg, model.specs(), mesh, (B, S))
    elif decode:
        plan = plan_decode(cfg, model.specs(), model.cache_specs(B, S), mesh, B)
    else:
        plan = plan_prefill(cfg, model.specs(), mesh, (B, S))

    def add(name, fn, params_specs, extra_args, extra_sh, trips, grad, argnums=(0, 1), tp=plan):
        p_abs = abstract_params(params_specs, f32)
        p_sh = param_shardings(params_specs, mesh)
        layouts = tp.layouts(params_specs)
        cast = expert_leaves(params_specs) if train else weight_leaves(params_specs)

        def period(p, *rest, tp=None):
            # on the plan the probe's parameters are one period of the step's
            # blocks: this rank's shards, gathered as the step gathers a
            # period, the gradients summed into the shards in its backward
            if tp is not None:
                p = tp.gather_period(p, layouts, bf16, cast)
            return fn(p, *rest, tp=tp)
        g = _value_and_grad(_scalarize(period), argnums) if grad else period
        probes.append(Probe(name, g, (p_abs,) + extra_args, (p_sh,) + extra_sh, trips, grad,
                            tp=tp))

    # ---------------------------------------------------------- attention
    if n_attn and not decode:
        specs = {"norm": rmsnorm_spec(D), **attn_specs(cfg)}

        def attn_proj(p, x, tp=None):
            h = rmsnorm(p["norm"], x, cfg.norm_eps)
            if tp is not None:
                h = tp.gather_seq(h)
            q, k, v = qkv_proj(p, h, cfg, None, tp)
            # v's heads stand in for the attention's output: every head of
            # this rank's queries (its query slice where the heads do not
            # split), brought to wo's rows as the step brings it
            ctx = torch.repeat_interleave(v, q.shape[2] // v.shape[2], dim=2).flatten(2)
            if tp is not None:
                ctx = tp.query_cols(tp.query_rows(ctx), h.shape[1])
            return x + attn_out(p, ctx, tp)

        add("attn_proj", attn_proj, specs, (x_abs,), (x_sh,), n_attn, train)
        if encdec:
            T = cfg.enc_seq
            enc_abs = _abs((B, T, D), bf16)
            enc_sh = _sh(mesh, (B, T, D), ("batch", "seq", "none"))

            def enc_attn(p, x, tp=None):
                h = rmsnorm(p["norm"], x, cfg.norm_eps)
                return x + attn_prefill(p, h, cfg, None, causal=False, tp=tp)[0]

            def enc_mlp(p, x, tp=None):
                return x + mlp(p, rmsnorm(p["norm"], x, cfg.norm_eps), cfg, tp)

            add("enc_attn_block", enc_attn, specs, (enc_abs,), (enc_sh,), cfg.enc_layers,
                train, tp=plan.encoder)
            add("enc_mlp_block", enc_mlp, {"norm": rmsnorm_spec(D), **mlp_specs(cfg)},
                (enc_abs,), (enc_sh,), cfg.enc_layers, train, tp=plan.encoder)

        hq, hd = cfg.n_heads, cfg.hd
        # flat-Hq layout: q as (B, Hq, Q, hd) with Hq on the model axis; k/v
        # expanded across GQA groups, as the chunked attention's tiles hold them
        qt = _abs((B, hq, Q_CHUNK, hd), bf16)
        kt = _abs((B, hq, hd, K_CHUNK), bf16)
        vt = _abs((B, hq, K_CHUNK, hd), bf16)
        st_m = _abs((B, hq, Q_CHUNK), f32)
        st_acc = _abs((B, hq, Q_CHUNK, hd), f32)
        # heads take the model axis when divisible; otherwise the q-chunk dim
        tile_sh = (
            _sh(mesh, qt.shape, ("batch", "heads", "tile_q", "none")),
            _sh(mesh, kt.shape, ("batch", "heads", "none", "none")),
            _sh(mesh, vt.shape, ("batch", "heads", "none", "none")),
            _sh(mesh, st_m.shape, ("batch", "heads", "tile_q")),
            _sh(mesh, st_m.shape, ("batch", "heads", "tile_q")),
            _sh(mesh, st_acc.shape, ("batch", "heads", "tile_q", "none")),
        )

        def attn_tile(q, kT, vT, m_run, l_run, acc):
            scale = 1.0 / math.sqrt(hd)
            s = (torch.einsum("bhqd,bhdk->bhqk", q, kT) * scale).float()
            m2 = torch.maximum(m_run, s.amax(dim=-1))
            alpha = torch.exp(m_run - m2)
            pexp = torch.exp(s - m2[..., None])
            l2 = l_run * alpha + pexp.sum(dim=-1)
            acc2 = acc * alpha[..., None] + torch.einsum(
                "bhqk,bhkd->bhqd", pexp.to(vT.dtype), vT).float()
            return m2, l2, acc2

        nq = max(1, math.ceil(S / Q_CHUNK))
        nk = max(1, math.ceil(S / K_CHUNK))
        if cfg.family == "encdec":  # enc (TxT) + dec self (SxS) + cross (SxT)
            T = cfg.enc_seq
            tiles = (cfg.enc_layers * math.ceil(T / Q_CHUNK) * math.ceil(T / K_CHUNK)
                     + cfg.n_layers * nq * nk
                     + cfg.n_layers * nq * math.ceil(T / K_CHUNK))
        else:
            tiles = n_attn * nq * nk
        probes.append(Probe(
            "attn_tile",
            _value_and_grad(_scalarize(attn_tile), (0, 1, 2)) if train else attn_tile,
            (qt, kt, vt, st_m, st_m, st_acc), tile_sh, tiles, train))

    if n_attn and decode:
        specs = {"norm": rmsnorm_spec(D), **attn_specs(cfg)}
        Sc = min(S, cfg.window) if cfg.window else S
        cache_abs = {"k": _abs((B, Sc, cfg.n_kv_heads, cfg.hd), bf16),
                     "v": _abs((B, Sc, cfg.n_kv_heads, cfg.hd), bf16)}
        cache_sh = {k: _sh(mesh, v.shape, ("cache_batch", "cache_seq", "heads", "cache_hd"))
                    for k, v in cache_abs.items()}
        x1 = _abs((B, 1, D), bf16)
        x1_sh = _sh(mesh, x1.shape, ("batch", "none", "none"))

        def dec_attn(p, x, cache, pos, tp=None):
            h = rmsnorm(p["norm"], x, cfg.norm_eps)
            out, nc = attn_decode(p, h, cfg, cache, pos, None, window=cfg.window, tp=tp)
            return x + out, nc

        add("dec_attn", dec_attn, specs, (x1, cache_abs, _abs((), i32)),
            (x1_sh, cache_sh, Sharding(mesh, ())), n_attn, False)
        if encdec:
            T = cfg.enc_seq
            cross_abs = {k: _abs((B, T, cfg.n_kv_heads, cfg.hd), bf16) for k in ("k", "v")}
            cross_sh = {k: _sh(mesh, v.shape, ("cache_batch", "cache_seq", "heads", "cache_hd"))
                        for k, v in cross_abs.items()}

            def dec_cross(p, x, cache, tp=None):
                h = rmsnorm(p["norm"], x, cfg.norm_eps)
                return x + _cross_decode({"cross_attn": p}, h, cache, cfg, tp)

            add("dec_cross", dec_cross, specs, (x1, cross_abs), (x1_sh, cross_sh),
                cfg.n_layers, False)

    # ---------------------------------------------------------------- ssd
    if n_ssm:
        specs = {"block_norm": rmsnorm_spec(D), "ssm": ssm_specs(cfg)}
        di, H, P, N = cfg.d_inner, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
        if decode:
            x1 = _abs((B, 1, D), bf16)
            st = {"ssm": _abs((B, H, P, N), f32),
                  "conv": _abs((B, cfg.ssm_conv - 1, di + 2 * N), bf16)}
            st_sh = {"ssm": _sh(mesh, st["ssm"].shape,
                                ("cache_batch", "ssm_inner", "none", "none")),
                     "conv": _sh(mesh, st["conv"].shape, ("cache_batch", "none", "ssm_inner"))}

            def dec_ssd(p, x, state, tp=None):
                h = rmsnorm(p["block_norm"], x, cfg.norm_eps)
                out, ns = ssd_decode(p["ssm"], h, cfg, state, tp)
                return x + out, ns

            # the state and the conv history on this rank's cache shard
            add("dec_ssd", dec_ssd, specs, (x1, st),
                (_sh(mesh, x1.shape, ("batch", "none", "none")), st_sh), n_ssm, False)
        else:
            # (a) per-layer projections: weights stream from HBM once per
            # layer; on a plan the head-parallel layer's: in_proj's output
            # moved to this rank's heads, the conv on their channels, the
            # gated norm summed over the heads, out_proj row-parallel
            def ssm_proj(p, x, tp=None):
                h = rmsnorm(p["block_norm"], x, cfg.norm_eps)
                if tp is not None:
                    h = tp.gather_seq(h)
                z, xbc, _ = _in_proj(p["ssm"], h, cfg, tp)
                xbc = _causal_conv(xbc, *_conv_params(p["ssm"], cfg, tp, h.dtype))
                xs = xbc[..., :z.shape[-1]]
                return x + _out_proj(p["ssm"], _gated_norm(p["ssm"]["norm"], xs, z, cfg, tp), tp)

            add("ssm_proj", ssm_proj, specs, (x_abs,), (x_sh,), n_ssm, train)

            # (b) per-chunk inner SSD (dual form + state construction), no
            # weights -- the chunk math of ssm.ssd_prefill; on a plan on this
            # rank's rows and heads
            Q = cfg.ssm_chunk
            xh = _abs((B, Q, H, P), bf16)
            Bh = _abs((B, Q, N), f32)
            dth = _abs((B, Q, H), f32)
            rows, heads = spec_entry(plan.batch_axes), spec_entry(plan.ssm_head_axes)
            inner_sh = (Sharding(mesh, (rows, None, heads, None)),
                        Sharding(mesh, (rows, None, None)), Sharding(mesh, (rows, None, None)),
                        Sharding(mesh, (rows, None, heads)))

            def ssd_inner(xh, Bc, Cc, dt):
                # this rank's heads
                A = -torch.ones((dt.shape[-1],), dtype=f32, device=dt.device) * 0.5
                dA = dt * A
                dAc = torch.cumsum(dA, dim=1)
                L = torch.exp(_segsum(dA.movedim(-1, 1)))
                scores = torch.einsum("bin,bjn->bij", Cc, Bc)
                M = scores[:, None] * L
                xdt = xh * dt[..., None].to(xh.dtype)
                y_diag = torch.einsum("bhij,bjhp->bihp", M.to(xh.dtype), xdt)
                decay = torch.exp(dAc[:, -1:, :] - dAc)
                states = torch.einsum("bqn,bqh,bqhp->bhpn", Bc, dt * decay, xh.float())
                y_off = torch.einsum("bqn,bhpn,bqh->bqhp", Cc, states,
                                     torch.exp(dAc)).to(xh.dtype)
                return y_diag + y_off

            probes.append(Probe(
                "ssd_inner",
                _value_and_grad(_scalarize(ssd_inner), (0, 1, 2, 3)) if train else ssd_inner,
                (xh, Bh, Bh, dth), inner_sh, n_ssm * math.ceil(S / Q), train))

    # ------------------------------------------------------------- mlp/moe
    tok_shape = (B, 1, D) if decode else (B, S, D)
    tok_abs = _abs(tok_shape, bf16)
    tok_sh = _sh(mesh, tok_shape, ("batch", "seq" if not decode else "none", "none"))
    if n_mlp:
        specs = {"norm": rmsnorm_spec(D), **mlp_specs(cfg)}

        def mlp_block(p, x, tp=None):
            return x + mlp(p, rmsnorm(p["norm"], x, cfg.norm_eps), cfg, tp)

        add("mlp_block", mlp_block, specs, (tok_abs,), (tok_sh,), n_mlp, train)
    if n_moe:
        specs = {"norm": rmsnorm_spec(D), **moe_specs(cfg)}

        def moe_block(p, x, tp=None):
            y, aux = moe(p, rmsnorm(p["norm"], x, cfg.norm_eps), cfg, tp)
            return x + y + aux

        add("moe_block", moe_block, specs, (tok_abs,), (tok_sh,), n_moe, train)

    # ------------------------------------------------------- embed + loss
    emb_spec = {"embed": PSpec((cfg.vocab, D), ("vocab", "embed_d"), init="embed")}
    if decode:
        tok = _abs((B, 1), i32)

        tied = dataclasses.replace(cfg, tie_embeddings=True)  # the probe's one table

        def emb_unemb(p, t, tp=None):
            if tp is None:
                x = F.embedding(t, p["embed"]).to(bf16)
                return (x @ p["embed"].T.to(bf16)).float()
            return unembed(p, tied, embed_tokens(p, cfg, t, tp=tp), tp)

        add("embed+unembed", emb_unemb, emb_spec,
            (tok,), (_sh(mesh, tok.shape, ("batch", "none")),), 1, False)
    else:
        c = min(cfg.loss_chunk, S)
        spec = {"unembed": PSpec((D, cfg.vocab), ("embed_d", "vocab"))}
        hc = _abs((B, c, D), bf16)
        lc = _abs((B, c), i32)

        untied = dataclasses.replace(cfg, tie_embeddings=False)  # the probe's (D, V) table

        def loss_chunk(p, h, l, tp=None):
            return _xent_chunk(p, untied, h, l, tp)[0]

        add("loss_chunk", loss_chunk, spec,
            (hc, lc), (_sh(mesh, hc.shape, ("batch", "none", "none")),
                       _sh(mesh, lc.shape, ("batch", "none"))),
            math.ceil(S / c), train)

        tok = _abs((B, S), i32)

        def emb(p, t, tp=None):
            return embed_tokens(p, cfg, t, tp=tp)

        add("embed", emb, emb_spec, (tok,),
            (_sh(mesh, tok.shape, ("batch", "seq")),), 1, train, argnums=(0,))

    # ------------------------------------------------------------ optimizer
    if train:
        probe_shape = (4096, 4096)
        pb = _abs(probe_shape, f32)
        mb = _abs(probe_shape, torch_dtype(cfg.optstate_dtype))
        psh = _sh(mesh, probe_shape, ("embed", "ffn"))

        def adam_probe(p, g, m1, v1):
            m2 = 0.9 * m1.float() + 0.1 * g
            v2 = 0.95 * v1.float() + 0.05 * g * g
            step = m2 / (torch.sqrt(v2) + 1e-8) + 0.1 * p
            return p - 1e-3 * step, m2.to(m1.dtype), v2.to(v1.dtype)

        trips = cfg.n_params() / float(math.prod(probe_shape))
        probes.append(Probe("adamw", adam_probe, (pb, pb, mb, mb),
                            (psh, psh, psh, psh), trips, False))
    return probes


def analyze_cell(cfg: ArchConfig, cell: ShapeCell, mesh,
                 profile: str | ShardingProfile | None = None, device: str = "cuda") -> dict:
    """The cell's roofline on ``mesh`` with the H100's peaks (:data:`HW`),
    from its probes, each traced on fake ``device`` tensors."""
    # all probe construction and tracing under one scoped profile, so
    # concurrent analyses with different profiles cannot race
    prof = resolve_profile(profile) if profile is not None else active_profile()
    with sharding_profile(prof):
        return _analyze_cell(cfg, cell, mesh, prof, device)


def _analyze_cell(cfg: ArchConfig, cell: ShapeCell, mesh, prof: ShardingProfile,
                  device: str) -> dict:
    chips = int(mesh.mesh.numel())
    comps = {}
    totals = {"flops": 0.0, "bytes": 0.0, "bytes_hlo": 0.0, "coll": 0.0}
    for pr in build_probes(cfg, cell, mesh):
        st = _compile_stats(pr.fn, pr.args, pr.shardings, mesh, device, pr.grad, pr.tp)
        comps[pr.name] = {**st, "trips": pr.trips, "grad": pr.grad}
        for k in totals:
            totals[k] += st[k] * pr.trips
        # remat="full": backward recomputes the forward once more
        if pr.grad and cfg.remat == "full" and pr.name != "loss_chunk":
            # approximation: fwd ~ (vag - fwd) ~ vag/3 for matmul-bound blocks
            totals["flops"] += st["flops"] / 3.0 * pr.trips
            totals["bytes"] += st["bytes"] / 3.0 * pr.trips

    tokens = cell.global_batch * (cell.seq_len if cell.kind != "decode" else 1)
    n = cfg.n_active_params()
    model_flops = (6.0 if cell.kind == "train" else 2.0) * n * tokens
    hlo_global = totals["flops"] * chips
    terms = {
        "compute_s": totals["flops"] / HW["peak_flops"],
        "memory_s": totals["bytes"] / HW["hbm_bw"],
        "collective_s": totals["coll"] / HW["link_bw"],
    }
    terms_upper = {"memory_hlo_s": totals["bytes_hlo"] / HW["hbm_bw"]}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    return {
        "arch": cfg.name, "cell": cell.name, "chips": chips,
        "profile": prof.name,
        "mesh_shape": dict(mesh_axis_sizes(mesh)),
        "terms": terms, "terms_upper": terms_upper, "dominant": dominant,
        "step_time_lower_bound_s": bound,
        "model_flops": model_flops,
        "hlo_flops_global": hlo_global,
        "useful_flops_ratio": model_flops / max(hlo_global, 1.0),
        "roofline_fraction": (model_flops / HW["peak_flops"] / chips) / max(bound, 1e-30),
        "components": comps,
    }


def main():
    import argparse

    import torch.distributed as dist

    from .. import configs as C
    from ..substrate import fake_store, init_group
    from .dryrun import make_mesh, mesh_shape

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=C.ARCHS, required=False)
    ap.add_argument("--cell", choices=list(C.SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "moe"])
    ap.add_argument("--smoke", action="store_true",
                    help="small fake fleet, smoke configs + shrunk cells")
    ap.add_argument("--profile", default="baseline", choices=profile_names())
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the type of the fake tensors")
    ap.add_argument("--out", default="experiments/roofline")
    args = ap.parse_args()
    if not args.all and not (args.arch and args.cell):
        ap.error("--arch and --cell (or --all)")
    init_group("fake", 0, math.prod(mesh_shape(args.mesh, args.smoke)[0]), store=fake_store())
    try:
        mesh = make_mesh(args.mesh, smoke=args.smoke, device_type=args.device)
        out = Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        cells = ([(args.arch, args.cell)] if not args.all else
                 [(a, c) for a in C.ARCHS for c in C.cells_for(C.get(a))])
        for arch, cell_name in cells:
            cfg = C.get(arch, smoke=args.smoke)
            cell = C.smoke_cell(cell_name) if args.smoke else C.SHAPES[cell_name]
            try:
                rec = analyze_cell(cfg, cell, mesh, profile=args.profile, device=args.device)
            except Exception:  # pragma: no cover
                import traceback
                rec = {"arch": arch, "cell": cell_name,
                       "error": traceback.format_exc(limit=15)}
            rec["profile"] = args.profile
            tag = "" if args.profile == "baseline" else f"__{args.profile}"
            (out / f"{arch}__{cell_name}__{args.mesh}{tag}.json").write_text(
                json.dumps(rec, indent=1, default=float))
            if "terms" in rec:
                t = rec["terms"]
                print(f"{arch:16s} {cell_name:12s} comp={t['compute_s']*1e3:9.3f}ms "
                      f"mem={t['memory_s']*1e3:9.3f}ms coll={t['collective_s']*1e3:9.3f}ms "
                      f"dom={rec['dominant'][:-2]:10s} useful={rec['useful_flops_ratio']:.2f} "
                      f"roofline={rec['roofline_fraction']:.2f}", flush=True)
            else:
                print(f"{arch:16s} {cell_name:12s} ERROR", flush=True)
                print(rec["error"], flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
