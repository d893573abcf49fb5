"""The port's model layers and decoder stacks (``repro_torch.models``) against
the reference's on the same inputs and weights.

Inputs come from numpy seeds; weights from the reference's ``init_params`` /
``Model.init``, carried across by ``params_from_reference``.  Tolerances:
``chunked_attention`` atol 2e-5 (the reference's own test's); each layer in
float32 within 1e-5 relative (max abs difference over max abs value); a whole
stack's float32 logits within 1e-4 relative; bf16 compute within 5e-2
relative, the reference's own bf16 bound.  MoE stacks in bf16 are the
exception stated at their test: bf16 rounding flips the top-k expert choice
of a few tokens, which moves those tokens' logits by far more than any
tolerance, so only the tokens outside a bounded flipped share are held to
5e-2 (the reference holds its MoE stacks in float32 for the same reason).
The SSM mixer and the encoder-decoder are held to the same bounds.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as JC  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import encdec as jed  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.models.common import init_params as j_init  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro_torch.interop import params_from_reference  # noqa: E402
from repro_torch.models import abstract_params, build, init_params  # noqa: E402
from repro_torch.models import encdec as ted  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402

DECODERS = ["granite-3-8b", "glm4-9b", "llama3-405b", "minicpm-2b", "mixtral-8x22b",
            "dbrx-132b", "qwen2-vl-72b", "mamba2-2.7b", "jamba-v0.1-52b"]
MOE = {"mixtral-8x22b", "dbrx-132b", "jamba-v0.1-52b"}


def cfgs(arch, **kw):
    """The smoke config of ``arch`` from each package, with the same edits."""
    return (dataclasses.replace(JC.get(arch, smoke=True), **kw),
            dataclasses.replace(TC.get(arch, smoke=True), **kw))


def T(a):
    return params_from_reference(a, "cpu")


def N(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def rel(got, want) -> float:
    got, want = N(got), N(want)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def jparams(specs, seed=0):
    return jax.tree.map(np.asarray, j_init(specs, jax.random.PRNGKey(seed)))


# ------------------------------------------------------------------ layers
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_reference(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 48)).astype(np.float32) * 3
    w = rng.normal(size=(48,)).astype(np.float32)
    want = jl.rmsnorm(jnp.asarray(w), jnp.asarray(x).astype(dtype), 1e-5)
    got = tl.rmsnorm(T(w), T(x).to(getattr(torch, dtype)), 1e-5)
    assert str(got.dtype) == f"torch.{dtype}"
    assert rel(got, want) < (1e-6 if dtype == "float32" else 1e-2)


@pytest.mark.parametrize("arch", ["granite-3-8b", "llama3-405b", "qwen2-vl-72b"])
def test_rope_matches_reference(arch):
    """cos/sin and the rotation (M-RoPE for qwen2vl, with distinct t/h/w ids)."""
    jcfg, tcfg = cfgs(arch)
    rng = np.random.default_rng(1)
    B, S = 2, 9
    pos = rng.integers(0, 300, (3, B, S) if jcfg.mrope else (B, S)).astype(np.int32)
    jc, js = jl.rope_cos_sin(jcfg, jnp.asarray(pos))
    tc, ts = tl.rope_cos_sin(tcfg, T(pos))
    assert rel(tc, jc) < 1e-5 and rel(ts, js) < 1e-5
    x = rng.normal(size=(B, S, 3, jcfg.hd)).astype(np.float32)
    for dtype, tol in (("float32", 1e-5), ("bfloat16", 1e-2)):
        want = jl.apply_rope(jnp.asarray(x).astype(dtype), jc, js)
        got = tl.apply_rope(T(x).to(getattr(torch, dtype)), tc, ts)
        assert rel(got, want) < tol, dtype


def test_mrope_wants_three_position_rows():
    _, tcfg = cfgs("qwen2-vl-72b")
    with pytest.raises(ValueError, match="M-RoPE"):
        tl.rope_cos_sin(tcfg, torch.zeros((2, 4), dtype=torch.int32))


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 7), (False, 0)])
@pytest.mark.parametrize("S", [8, 33, 64])
def test_chunked_attention_matches_reference(causal, window, S):
    """Ragged lengths against small chunks (padding on both axes), as the
    reference's own test; then the default chunks with a padded cache
    (``kv_len``) and a query offset."""
    rng = np.random.default_rng(S * 7 + window)
    B, Hk, G, hd = 2, 2, 2, 16
    q = rng.normal(size=(B, Hk, G, S, hd)).astype(np.float32)
    k = rng.normal(size=(B, S, Hk, hd)).astype(np.float32)
    v = rng.normal(size=(B, S, Hk, hd)).astype(np.float32)
    for kw in (dict(q_chunk=16, k_chunk=8), dict(kv_len=S - 3, q_offset=2)):
        want = jl.chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    causal=causal, window=window, **kw)
        got = tl.chunked_attention(T(q), T(k), T(v), causal=causal, window=window, **kw)
        np.testing.assert_allclose(N(got), N(want), atol=2e-5, err_msg=str(kw))


@pytest.mark.parametrize("window", [0, 7])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attn_prefill_matches_reference(window, dtype):
    jcfg, tcfg = cfgs("granite-3-8b")
    p = jparams(jl.attn_specs(jcfg))
    rng = np.random.default_rng(2)
    B, S = 2, 21
    x = rng.normal(size=(B, S, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    jcs = jl.rope_cos_sin(jcfg, jnp.asarray(pos))
    tcs = tl.rope_cos_sin(tcfg, T(pos))
    jout, (jk, jv) = jl.attn_prefill(p, jnp.asarray(x).astype(dtype), jcfg, jcs, window=window)
    tout, (tk, tv) = tl.attn_prefill(T(p), T(x).to(getattr(torch, dtype)), tcfg, tcs,
                                     window=window)
    tol = 1e-5 if dtype == "float32" else 5e-2
    for got, want in ((tout, jout), (tk, jk), (tv, jv)):
        assert got.shape == want.shape and rel(got, want) < tol


@pytest.mark.parametrize("window,Sc,pos", [(0, 12, 0), (0, 12, 7), (0, 12, 11),
                                           (8, 8, 3), (8, 8, 8), (8, 8, 21)])
def test_attn_decode_matches_reference(window, Sc, pos):
    """One decode step against a random cache: the absolute slot, and the SWA
    ring slot ``pos % Sc`` with the valid mask ``idx < min(pos+1, Sc)``
    before and after the ring wraps."""
    jcfg, tcfg = cfgs("granite-3-8b", window=window)
    p = jparams(jl.attn_specs(jcfg), seed=3)
    rng = np.random.default_rng(pos + 10 * window)
    B = 3
    x = rng.normal(size=(B, 1, jcfg.d_model)).astype(np.float32)
    ck = rng.normal(size=(B, Sc, jcfg.n_kv_heads, jcfg.hd)).astype(np.float32)
    cv = rng.normal(size=(B, Sc, jcfg.n_kv_heads, jcfg.hd)).astype(np.float32)
    positions = np.full((B, 1), pos, np.int32)
    jcs = jl.rope_cos_sin(jcfg, jnp.asarray(positions))
    tcs = tl.rope_cos_sin(tcfg, T(positions))
    jout, jc = jl.attn_decode(p, jnp.asarray(x), jcfg, {"k": jnp.asarray(ck), "v": jnp.asarray(cv)},
                              jnp.int32(pos), jcs, window=window)
    tcache = {"k": T(ck), "v": T(cv)}
    tout, tc = tl.attn_decode(T(p), T(x), tcfg, tcache, pos, tcs, window=window)
    assert rel(tout, jout) < 1e-5
    assert tc["k"] is tcache["k"]          # written in place
    for n in ("k", "v"):
        assert rel(tc[n], jc[n]) < 1e-6


@pytest.mark.parametrize("style", ["swiglu", "gelu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_matches_reference(style, dtype):
    jcfg, tcfg = cfgs("granite-3-8b", mlp_style=style)
    p = jparams(jl.mlp_specs(jcfg), seed=4)
    x = np.random.default_rng(5).normal(size=(2, 7, jcfg.d_model)).astype(np.float32)
    want = jl.mlp(p, jnp.asarray(x).astype(dtype), jcfg)
    got = tl.mlp(T(p), T(x).to(getattr(torch, dtype)), tcfg)
    assert rel(got, want) < (1e-5 if dtype == "float32" else 5e-2)


# --------------------------------------------------------------------- MoE
def test_top_k_keeps_the_lower_index_first_on_ties():
    """Tied probabilities: ``jax.lax.top_k`` puts the lower index first, and
    so does the port (``torch.topk`` promises no order among equals)."""
    rng = np.random.default_rng(6)
    probs = rng.integers(0, 3, (64, 8)).astype(np.float32) / 4
    probs[0] = 0.25                                   # all tied
    for k in (1, 2, 4, 8):
        jv, ji = jax.lax.top_k(jnp.asarray(probs), k)
        tv, ti = tmoe.top_k_first_index(T(probs), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("arch,S,tied", [("mixtral-8x22b", 16, False), ("dbrx-132b", 16, False),
                                         ("mixtral-8x22b", 512, False), ("mixtral-8x22b", 16, True),
                                         ("dbrx-132b", 1, True)])
def test_moe_matches_reference(arch, S, tied):
    """The GShard dispatch in float32: group split (S = 512 takes two groups
    of 256), capacity drops (the default factor drops tokens at S = 16 and
    512), the combine and the aux loss.  ``tied``: a router whose columns
    repeat, so every token's probabilities tie across experts and the top-k
    order decides which experts run."""
    jcfg, tcfg = cfgs(arch, compute_dtype="float32")
    p = jparams(jmoe.moe_specs(jcfg), seed=7)
    if tied:
        E = jcfg.n_experts
        p["router"] = np.repeat(p["router"][:, :2], E // 2, axis=1)
    x = np.random.default_rng(8).normal(size=(2, S, jcfg.d_model)).astype(np.float32)
    jout, jaux = jmoe.moe(p, jnp.asarray(x), jcfg)
    tout, taux = tmoe.moe(T(p), T(x), tcfg)
    assert rel(tout, jout) < 1e-5
    assert abs(float(taux) - float(jaux)) <= 1e-6 * abs(float(jaux)) + 1e-9


# --------------------------------------------------------------------- SSM
def _ssm_case(dtype, seed=0):
    jcfg, tcfg = cfgs("mamba2-2.7b", compute_dtype=dtype)
    return jcfg, tcfg, jparams(jssm.ssm_specs(jcfg), seed=seed)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [1, 2, 5, 16])
def test_causal_conv_matches_reference(S, dtype):
    """The depthwise causal conv and its SiLU, a prompt shorter than the
    kernel (S < k - 1) included."""
    rng = np.random.default_rng(20 + S)
    xbc = rng.normal(size=(2, S, 24)).astype(np.float32)
    w = rng.normal(size=(4, 24)).astype(np.float32)
    b = rng.normal(size=(24,)).astype(np.float32)
    want = jssm._causal_conv(*(jnp.asarray(a).astype(dtype) for a in (xbc, w, b)))
    got = tssm._causal_conv(*(T(a).to(getattr(torch, dtype)) for a in (xbc, w, b)))
    assert got.dtype == getattr(torch, dtype)
    assert rel(got, want) < (1e-6 if dtype == "float32" else 1e-2)


@pytest.mark.parametrize("T_len", [1, 7, 16])
def test_segsum_matches_reference(T_len):
    """The masked difference of cumulative sums: -inf above the diagonal
    in the same places, the rest within float32 rounding."""
    x = np.random.default_rng(T_len).normal(size=(2, 3, T_len)).astype(np.float32)
    want = np.asarray(jssm._segsum(jnp.asarray(x)))
    got = tssm._segsum(T(x)).numpy()
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("S", [1, 2, 3, 8, 16, 20, 48])
def test_ssd_prefill_matches_reference(S, with_state):
    """The chunked SSD in float32 (chunk 16): one token, S below the conv
    width, S below the chunk, one whole chunk, a padded last chunk (20) and
    three chunks; with and without an initial state.  Output, final state
    and conv tail within 1e-5."""
    jcfg, tcfg, p = _ssm_case("float32")
    rng = np.random.default_rng(30 + S)
    x = rng.normal(size=(2, S, jcfg.d_model)).astype(np.float32)
    H, P, N = jcfg.ssm_heads, jcfg.ssm_head_dim, jcfg.ssm_state
    s0 = rng.normal(size=(2, H, P, N)).astype(np.float32) if with_state else None
    jy, jst = jssm.ssd_prefill(p, jnp.asarray(x), jcfg,
                               None if s0 is None else {"ssm": jnp.asarray(s0)})
    ty, tst = tssm.ssd_prefill(T(p), T(x), tcfg, None if s0 is None else {"ssm": T(s0)})
    assert ty.shape == jy.shape and tst["conv"].shape == jst["conv"].shape
    assert tst["ssm"].dtype == torch.float32
    for got, want in ((ty, jy), (tst["ssm"], jst["ssm"]), (tst["conv"], jst["conv"])):
        assert rel(got, want) < 1e-5


@pytest.mark.parametrize("S", [3, 16, 20])
def test_ssd_prefill_matches_reference_bf16(S):
    """bf16 compute: the intra-chunk product in bf16, states, recurrence and
    inter-chunk output in float32 (cast after); within 5e-2, the state
    float32 and the conv tail bf16 as the reference's."""
    jcfg, tcfg, p = _ssm_case("bfloat16", seed=1)
    x = np.random.default_rng(40 + S).normal(size=(2, S, jcfg.d_model)).astype(np.float32)
    jy, jst = jssm.ssd_prefill(p, jnp.asarray(x).astype("bfloat16"), jcfg)
    ty, tst = tssm.ssd_prefill(T(p), T(x).to(torch.bfloat16), tcfg)
    assert ty.dtype == torch.bfloat16 and tst["conv"].dtype == torch.bfloat16
    for got, want in ((ty, jy), (tst["ssm"], jst["ssm"]), (tst["conv"], jst["conv"])):
        assert rel(got, want) < 5e-2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [2, 20])
def test_ssd_decode_matches_reference(S, dtype):
    """Three decode steps from a prefill's state, the state carried in
    float32 as the engine's decode cache holds it: in bf16 compute the conv
    history, the conv and x/B/C promote to float32 and the new state stays
    float32 in both packages."""
    jcfg, tcfg, p = _ssm_case(dtype, seed=2)
    rng = np.random.default_rng(50 + S)
    x = rng.normal(size=(2, S, jcfg.d_model)).astype(np.float32)
    _, jst = jssm.ssd_prefill(p, jnp.asarray(x).astype(dtype), jcfg)
    jst = {k: v.astype(jnp.float32) for k, v in jst.items()}
    tst = {k: T(np.asarray(v)) for k, v in jst.items()}
    tol = 1e-5 if dtype == "float32" else 5e-2
    for step in range(3):
        xd = rng.normal(size=(2, 1, jcfg.d_model)).astype(np.float32)
        jy, jst = jssm.ssd_decode(p, jnp.asarray(xd).astype(dtype), jcfg, jst)
        ty, tst = tssm.ssd_decode(T(p), T(xd).to(getattr(torch, dtype)), tcfg, tst)
        assert ty.dtype == getattr(torch, dtype)
        assert tst["ssm"].dtype == tst["conv"].dtype == torch.float32
        assert str(jst["conv"].dtype) == "float32"
        for got, want in ((ty, jy), (tst["ssm"], jst["ssm"]), (tst["conv"], jst["conv"])):
            assert rel(got, want) < tol, step


# ------------------------------------------------------------------ stacks
def _inputs(cfg, rng, B, S):
    """(reference kwargs, port kwargs) for a stack's forward: tokens, or for
    the VLM backbone patch embeddings and distinct (t, h, w) positions."""
    if cfg.family == "vlm":
        emb = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
        pos = np.stack([np.broadcast_to(np.arange(S), (B, S)),
                        rng.integers(0, 9, (B, S)), rng.integers(0, 9, (B, S))]).astype(np.int32)
        return (dict(embeds=jnp.asarray(emb), positions=jnp.asarray(pos)),
                dict(embeds=T(emb), positions=T(pos)))
    tok = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    return dict(tokens=jnp.asarray(tok)), dict(tokens=T(tok))


def _forward(arch, dtype, B=2, S=40, seed=0):
    jcfg, tcfg = cfgs(arch, compute_dtype=dtype)
    params = jbuild(jcfg).init(jax.random.PRNGKey(seed))
    jkw, tkw = _inputs(jcfg, np.random.default_rng(seed), B, S)
    jh, jaux, jcache = jax.jit(lambda p: jt.forward_full(p, jcfg, want_cache=True, **jkw))(params)
    with torch.inference_mode():
        tp = T(params)
        th, taux, tcache = tt.forward_full(tp, tcfg, want_cache=True, **tkw)
        tlog = tt.unembed(tp, tcfg, th)
    return (jt.unembed(params, jcfg, jh), jaux, jcache), (tlog, taux, tcache)


@pytest.mark.parametrize("arch", DECODERS)
def test_forward_full_matches_reference_fp32(arch):
    """Float32 compute: logits within 1e-4, each layer's prefill cache (K
    and V; an SSM's state and conv tail) within 1e-5, the aux loss to
    float32 rounding.  S = 40 pads the SSM's last chunk of 16."""
    (jlog, jaux, jcache), (tlog, taux, tcache) = _forward(arch, "float32")
    assert tlog.dtype == torch.float32 and tlog.shape == jlog.shape
    assert rel(tlog, jlog) < 1e-4
    for pos, entry in jcache.items():
        assert set(tcache[pos]) == set(entry)
        for n in entry:
            for layer in range(entry[n].shape[0]):
                assert rel(tcache[pos][n][layer], entry[n][layer]) < 1e-5, (pos, n, layer)
    assert abs(float(taux) - float(jaux)) <= 1e-5 * abs(float(jaux)) + 1e-9


@pytest.mark.parametrize("arch", DECODERS)
def test_forward_full_matches_reference_bf16(arch):
    """The config's own bf16 compute: logits within 5e-2 relative.  MoE
    stacks: a token whose bf16 router rounding picks other experts in one
    package than in the other is far off by design; such flips hit a few
    tokens, so at most 1/16 of the tokens may exceed 5e-2.  jamba routes
    through 4 MoE layers of its 8 and carries each flip on to the later
    tokens through its SSM and attention: the reference's own bf16 and
    float32 logits differ beyond 5e-2 on 6 of these 80 tokens, above 1/16,
    so its share is bounded at 1/4."""
    (jlog, _, _), (tlog, _, _) = _forward(arch, "bfloat16")
    err = np.abs(N(tlog) - N(jlog)).max(-1) / np.abs(N(jlog)).max()
    if arch in MOE:
        share = 1 / 4 if arch == "jamba-v0.1-52b" else 1 / 16
        assert (err > 5e-2).mean() <= share, err.max()
    else:
        assert err.max() < 5e-2


def _decode_runs(arch, dtype, T_steps, seed=1, **kw):
    """Decode ``T_steps`` tokens one at a time from zero caches in both
    packages (teacher forced); returns per-step (reference, port) logits."""
    jcfg, tcfg = cfgs(arch, compute_dtype=dtype, **kw)
    jm, tm = jbuild(jcfg), build(tcfg)
    params = jm.init(jax.random.PRNGKey(seed))
    tp = T(params)
    B = 2
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, jcfg.vocab, (B, T_steps)).astype(np.int32)
    jcache = j_init(jm.cache_specs(B, T_steps), jax.random.PRNGKey(0))
    tcache = init_params(tm.cache_specs(B, T_steps), None, "cpu")
    jdec = jax.jit(jm.decode)
    out = []
    for t in range(T_steps):
        extra_j, extra_t = {}, {}
        if jcfg.mrope:
            pos3 = np.stack([np.full((B, 1), t), rng.integers(0, 9, (B, 1)),
                             rng.integers(0, 9, (B, 1))]).astype(np.int32)
            extra_j, extra_t = {"positions": jnp.asarray(pos3)}, {"positions": T(pos3)}
        jlog, jcache = jdec(params, jcache, jnp.asarray(tok[:, t:t + 1]), jnp.int32(t), **extra_j)
        with torch.inference_mode():
            tlog, tcache = tm.decode(tp, tcache, T(tok[:, t:t + 1]), t, **extra_t)
        out.append((jlog, tlog))
    return out


@pytest.mark.parametrize("arch", DECODERS)
def test_decode_step_matches_reference(arch):
    """Float32 decode steps against the reference's, step by step within
    1e-4; mixtral's window (32) is passed, so its ring cache wraps."""
    T_steps = 40 if arch == "mixtral-8x22b" else 12
    for t, (jlog, tlog) in enumerate(_decode_runs(arch, "float32", T_steps)):
        assert rel(tlog, jlog) < 1e-4, t


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "jamba-v0.1-52b"])
def test_decode_step_matches_reference_bf16(arch):
    """The config's bf16 compute over the float32 decode cache (an SSM's
    conv history and x/B/C promote to float32 in both packages): each
    step's logits within 5e-2; jamba's MoE flips bounded as in
    ``test_forward_full_matches_reference_bf16``."""
    err = np.stack([np.abs(N(tlog) - N(jlog)).max(-1) / np.abs(N(jlog)).max()
                    for jlog, tlog in _decode_runs(arch, "bfloat16", 12)])
    if arch in MOE:
        assert (err > 5e-2).mean() <= 1 / 4, err.max()
    else:
        assert err.max() < 5e-2


@pytest.mark.parametrize("arch,dtype,kw,tol", [
    ("granite-3-8b", "bfloat16", {}, 5e-2), ("glm4-9b", "bfloat16", {}, 5e-2),
    ("minicpm-2b", "bfloat16", {}, 5e-2), ("llama3-405b", "bfloat16", {}, 5e-2),
    ("mamba2-2.7b", "bfloat16", {}, 5e-2),
    ("mixtral-8x22b", "float32", {"capacity_factor": 8.0}, 1e-4),
    ("dbrx-132b", "float32", {"capacity_factor": 8.0}, 1e-4),
    ("jamba-v0.1-52b", "float32", {"capacity_factor": 8.0}, 1e-4)])
def test_decode_matches_teacher_forcing(arch, dtype, kw, tol):
    """The port alone: sequential decode reproduces its own teacher-forced
    forward (the reference's property and bounds: bf16 for dense stacks;
    float32 with no-drop capacity for MoE, where routing is then stable)."""
    _, tcfg = cfgs(arch, compute_dtype=dtype, **kw)
    model = build(tcfg)
    params = model.init(torch.Generator().manual_seed(1), "cpu")
    B, S = 2, 12
    tok = torch.as_tensor(np.random.default_rng(1).integers(0, tcfg.vocab, (B, S)))
    with torch.inference_mode():
        hidden, _, _ = tt.forward_full(params, tcfg, tokens=tok)
        full = tt.unembed(params, tcfg, hidden)
        cache = init_params(model.cache_specs(B, S), None, "cpu")
        for t in range(S):
            lt, cache = model.decode(params, cache, tok[:, t:t + 1], t)
            assert rel(lt[:, 0], full[:, t]) < tol, t


def _shapes(tree, prefix=""):
    """{path: shape} of a nested-dict tree of arrays, tensors or PSpecs."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _shapes(sub, f"{prefix}/{key}").items()}
    return {prefix: tuple(tree.shape)}


@pytest.mark.parametrize("arch", TC.ARCHS)
def test_build_accepts_every_arch(arch):
    """Every assigned architecture builds, with the reference's parameter
    and decode-cache trees: the same paths and shapes."""
    jcfg, tcfg = cfgs(arch)
    jm, tm = jbuild(jcfg), build(tcfg)
    assert _shapes(tm.abstract()) == _shapes(jm.abstract())
    assert _shapes(tm.cache_specs(2, 24)) == _shapes(jm.cache_specs(2, 24))


# ---------------------------------------------------------- encoder-decoder
@pytest.mark.parametrize("S,d,offset", [(1, 64, 0), (7, 64, 5), (64, 64, 0),
                                        (1500, 384, 0), (1, 384, 1234)])
def test_sinusoidal_embedding_matches_reference(S, d, offset):
    want = jl.sinusoidal_embedding(S, d, offset=offset)
    got = tl.sinusoidal_embedding(S, d, offset=offset)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=2e-6)


def _whisper(dtype, seed=0, B=2, S=9):
    """The whisper smoke model's weights, random frames and tokens."""
    jcfg, tcfg = cfgs("whisper-tiny", compute_dtype=dtype)
    params = jbuild(jcfg).init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    frames = rng.normal(size=(B, jcfg.enc_seq, jcfg.d_model)).astype(np.float32)
    tok = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    return jcfg, tcfg, params, frames, tok


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 5e-2)])
def test_encode_and_decode_full_match_reference(dtype, tol):
    """The encoder (non-causal attention over the frames), then the
    teacher-forced decoder with its self and cross caches."""
    jcfg, tcfg, params, frames, tok = _whisper(dtype)
    jenc = jed.encode(params, jcfg, jnp.asarray(frames))
    jh, jcache = jed.decode_full(params, jcfg, jnp.asarray(tok), jenc, want_cache=True)
    with torch.inference_mode():
        tp = T(params)
        tenc = ted.encode(tp, tcfg, T(frames))
        th, tcache = ted.decode_full(tp, tcfg, T(tok), tenc, want_cache=True)
    assert tenc.dtype == getattr(torch, dtype) and rel(tenc, jenc) < tol
    assert th.shape == jh.shape and rel(th, jh) < tol
    for part in ("self", "cross"):
        for n in ("k", "v"):
            assert tcache[part][n].shape == jcache[part][n].shape
            assert rel(tcache[part][n], jcache[part][n]) < tol, (part, n)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 5e-2)])
def test_whisper_prefill_and_decode_match_reference(dtype, tol):
    """``Model.prefill`` on frames and a prompt, then teacher-forced
    ``Model.decode`` steps on the prefill's cross cache and its self cache
    padded to the decode length (the reference's decode drops writes past
    its cache): logits within 1e-4 in float32 and 5e-2 in bf16."""
    jcfg, tcfg, params, frames, tok = _whisper(dtype, seed=3, S=12)
    P, steps = 6, 6
    jm, tm = jbuild(jcfg), build(tcfg)
    jcache, jlog = jax.jit(jm.prefill)(params, {"frames": jnp.asarray(frames),
                                                "tokens": jnp.asarray(tok[:, :P])})
    tp = T(params)
    with torch.inference_mode():
        tcache, tlog = tm.prefill(tp, {"frames": T(frames), "tokens": T(tok[:, :P])})
    assert tlog.dtype == torch.float32 and tlog.shape == jlog.shape == (2, 1, jcfg.vocab)
    assert rel(tlog, jlog) < tol
    zeros = j_init(jm.cache_specs(2, P + steps), jax.random.PRNGKey(0))
    jdc = {"self": {n: zeros["self"][n].at[:, :, :P].set(jcache["self"][n]) for n in ("k", "v")},
           "cross": {n: jcache["cross"][n].astype(zeros["cross"][n].dtype) for n in ("k", "v")}}
    tdc = init_params(tm.cache_specs(2, P + steps), None, "cpu")
    for n in ("k", "v"):
        tdc["self"][n][:, :, :P] = tcache["self"][n]
        tdc["cross"][n].copy_(tcache["cross"][n])
    jdec = jax.jit(jm.decode)
    for t in range(P, P + steps):
        jlog, jdc = jdec(params, jdc, jnp.asarray(tok[:, t:t + 1]), jnp.int32(t))
        with torch.inference_mode():
            tlog, tdc = tm.decode(tp, tdc, T(tok[:, t:t + 1]), t)
        assert rel(tlog, jlog) < tol, t


def test_whisper_decode_matches_teacher_forcing():
    """The port alone, bf16: decode from zero self caches and the cross K/V
    of the encoder output reproduces the teacher-forced decoder (the
    reference's property and bound)."""
    _, tcfg = cfgs("whisper-tiny")
    model = build(tcfg)
    params = model.init(torch.Generator().manual_seed(1), "cpu")
    rng = np.random.default_rng(1)
    B, S = 2, 12
    frames = torch.as_tensor(rng.normal(size=(B, tcfg.enc_seq, tcfg.d_model)), dtype=torch.float32)
    tok = torch.as_tensor(rng.integers(0, tcfg.vocab, (B, S)))
    with torch.inference_mode():
        enc = ted.encode(params, tcfg, frames)
        hidden, _ = ted.decode_full(params, tcfg, tok, enc)
        full = (hidden @ params["unembed"].to(hidden.dtype)).float()
        cache = init_params(model.cache_specs(B, S), None, "cpu")
        for i in range(tcfg.n_layers):
            ck, cv = ted._cross_kv(tt.layer_params(params["dec_blocks"], i), enc, tcfg)
            cache["cross"]["k"][i], cache["cross"]["v"][i] = ck, cv
        for t in range(S):
            lt, cache = model.decode(params, cache, tok[:, t:t + 1], t)
            assert rel(lt[:, 0], full[:, t]) < 5e-2, t


# ------------------------------------------------------------- parameters
def test_params_from_reference_keeps_keys_shapes_dtypes():
    jcfg, tcfg = cfgs("mixtral-8x22b")
    jp = jbuild(jcfg).init(jax.random.PRNGKey(0))
    tp = T(jp)
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(flat_j) == len(jax.tree.leaves(build(tcfg).abstract()))
    for path, leaf in flat_j:
        t = tp
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == leaf.shape and str(t.dtype) == f"torch.{leaf.dtype}"
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))
    bf = T({"w": np.asarray(jnp.asarray([1.5, -2.0, 3e-3], jnp.bfloat16))})["w"]
    assert bf.dtype == torch.bfloat16 and bf.float().tolist() == [1.5, -2.0, 0.0030059814453125]


def test_init_params_kinds_scales_and_per_leaf_seeds():
    """Spec shapes and dtypes (``abstract`` allocates nothing), the init
    kinds' scales, and per-leaf seeds: a leaf's values depend on the base
    seed and its sorted path index only."""
    _, tcfg = cfgs("granite-3-8b", d_model=256, d_ff=512, vocab=1024)
    model = build(tcfg)
    p = model.init(torch.Generator().manual_seed(3), "cpu")
    q = model.init(torch.Generator().manual_seed(3), "cpu")
    r = model.init(torch.Generator().manual_seed(4), "cpu")
    abst = model.abstract()
    assert abst["embed"].device.type == "meta" and abst["embed"].shape == p["embed"].shape
    assert torch.equal(p["blocks"]["pos0"]["attn"]["wq"], q["blocks"]["pos0"]["attn"]["wq"])
    assert not torch.equal(p["blocks"]["pos0"]["attn"]["wq"], r["blocks"]["pos0"]["attn"]["wq"])
    assert not torch.equal(p["blocks"]["pos0"]["mlp"]["wg"], p["blocks"]["pos0"]["mlp"]["wu"])
    assert p["blocks"]["pos0"]["attn"]["wq"].shape == (2, 256, 4 * 16)
    assert torch.equal(p["final_norm"], torch.ones(256))
    assert abs(float(p["embed"].std()) - 0.02) < 2e-3
    # fan_in: 1/sqrt of the first axis after the stacking axis
    assert abs(float(p["blocks"]["pos0"]["mlp"]["wd"].std()) - 512 ** -0.5) < 3e-3
    assert abs(float(p["unembed"].std()) - 256 ** -0.5) < 3e-3
    assert all(t.dtype == torch.float32 for t in (p["embed"], p["unembed"]))
    with pytest.raises(ValueError, match="Generator"):
        init_params(model.specs(), None, "cpu")
    zeros = init_params(model.cache_specs(2, 5), None, "cpu")
    assert zeros["pos0"]["k"].shape == (2, 2, 5, 2, 16) and not zeros["pos0"]["k"].any()


def test_abstract_params_allocate_nothing_at_full_width():
    """granite-3-8b as published: shapes from the specs on the meta device,
    and the analytic parameter count agrees with them (norms aside)."""
    cfg = TC.get("granite-3-8b")
    tree = abstract_params(build(cfg).specs())
    leaves = []

    def walk(t):
        for v in t.values():
            walk(v) if isinstance(v, dict) else leaves.append(v)
    walk(tree)
    assert all(t.device.type == "meta" for t in leaves)
    n = sum(t.numel() for t in leaves)
    norms = cfg.d_model * (2 * cfg.n_layers + 1)
    assert n - norms == cfg.n_params() == 8_371_855_360


def test_mamba2_abstract_params_at_full_width():
    """mamba2-2.7b as published: ``n_params()`` counts the embedding and the
    SSM in/out projections; the spec tree adds each layer's norm, conv
    weight and bias, A, D, dt bias and gated norm, and the final norm."""
    cfg = TC.get("mamba2-2.7b")
    tree = abstract_params(build(cfg).specs())
    blocks = tree["blocks"]["pos0"]
    assert set(blocks) == {"norm1", "ssm"}
    counted = tree["embed"].numel() + sum(blocks["ssm"][k].numel() for k in ("in_proj", "out_proj"))
    assert counted == cfg.n_params() == 2_700_349_440
    extra = sum(t.numel() for k, t in blocks["ssm"].items() if k not in ("in_proj", "out_proj"))
    extra += blocks["norm1"].numel() + tree["final_norm"].numel()
    L, d, di, N, H, k = 64, 2560, 5120, 128, 80, 4
    assert extra == L * (d + k * (di + 2 * N) + (di + 2 * N) + 3 * H + di) + d
    assert all(t.device.type == "meta" for t in blocks["ssm"].values())
