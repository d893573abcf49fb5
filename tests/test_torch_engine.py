"""The port's serving engine, its routers and its launcher against the
reference's, with the same weights (``params_from_reference``).

Tolerance: exact tokens.  In float32 compute both packages' logits agree to
about 1e-6 relative (``test_torch_models.py``), far inside the greedy argmax
margins of these seeded prompts, so every generated token must be equal."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.configs as JC  # noqa: E402
from repro import serve as jserve  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro_torch import serve as tserve  # noqa: E402
from repro_torch.interop import params_from_reference  # noqa: E402

from conftest import REPO  # noqa: E402


def engines(arch, n=1, **kw):
    """``n`` reference engines (seed 0, float32 compute) and ``n`` port
    engines on the CPU sharing one copy of the same weights."""
    jcfg = dataclasses.replace(JC.get(arch, smoke=True), compute_dtype="float32", **kw)
    tcfg = dataclasses.replace(TC.get(arch, smoke=True), compute_dtype="float32", **kw)
    js = [jserve.Engine(jcfg, seed=0, profile=p)
          for p in ("serve", "baseline")[:n]]
    params = params_from_reference(jax.tree.map(np.asarray, js[0].params), "cpu")
    ts = [tserve.Engine(tcfg, params=params, profile=p, device="cpu")
          for p in ("serve", "baseline")[:n]]
    return js, ts


@pytest.mark.parametrize("arch,P", [("granite-3-8b", 16), ("minicpm-2b", 16),
                                    ("glm4-9b", 24), ("mixtral-8x22b", 20),
                                    ("mixtral-8x22b", 40), ("mamba2-2.7b", 8),
                                    ("mamba2-2.7b", 16), ("mamba2-2.7b", 20),
                                    ("jamba-v0.1-52b", 16), ("jamba-v0.1-52b", 20)])
def test_generate_matches_reference(arch, P):
    """Greedy tokens equal to the reference's.  minicpm unembeds with the
    tied embedding; mixtral's window is 32, so a 40-token prompt is packed
    into the ring (slot t % 32) and a 20-token one is not, and both decode
    past the window.  mamba2 and jamba (SSM chunk 16) prefill below one
    chunk, one whole chunk and a padded second chunk, and their SSM states
    pass to the decode cache."""
    (je,), (te,) = engines(arch)
    prompts = np.random.default_rng(P).integers(2, je.cfg.vocab, (3, P)).astype(np.int32)
    want = je.generate(prompts, jserve.ServeConfig(max_new_tokens=16))
    got = te.generate(prompts, tserve.ServeConfig(max_new_tokens=16))
    assert got.dtype == np.int32 and got.shape == (3, P + 16)
    np.testing.assert_array_equal(got, want)


def test_generate_stops_each_sequence_at_eos():
    """EOS = the first token sequence 0 generates: it stops there (EOS fills
    its tail) while the others run on, in both packages alike."""
    (je,), (te,) = engines("granite-3-8b")
    prompts = np.random.default_rng(3).integers(2, 256, (3, 12)).astype(np.int32)
    free = te.generate(prompts, tserve.ServeConfig(max_new_tokens=10))
    eos = int(free[0, 12])
    want = je.generate(prompts, jserve.ServeConfig(max_new_tokens=10, eos_id=eos))
    got = te.generate(prompts, tserve.ServeConfig(max_new_tokens=10, eos_id=eos))
    np.testing.assert_array_equal(got, want)
    assert (got[0, 12:] == eos).all()
    assert not (got[1:, 12:] == eos).all()


def test_engines_share_one_parameter_set():
    _, (a, b) = engines("granite-3-8b", n=2)
    assert a.params is b.params
    assert a.profile.name == "serve" and b.profile.name == "baseline"
    with pytest.raises(ValueError, match="params lie on"):
        tserve.Engine(a.cfg, params={"w": torch.zeros(1, device="meta")}, device="cpu")


def _serve(pkg, engs, **kw):
    slots = [pkg.EngineSlot(f"e{i}", e, p) for i, (e, p) in
             enumerate(zip(engs, ("serve", "baseline")))]
    router = pkg.Router(slots, max_batch=4, **kw)
    rng = np.random.default_rng(0)
    rids = []
    for t in range(2):
        plen = 16 >> t
        for _ in range(4):
            req = pkg.Request(f"tenant{t}", rng.integers(2, 256, plen).astype(np.int32), 6)
            assert router.submit(req)
            rids.append(req.rid)
    done = router.serve()
    return [done[r] for r in rids]


def _same_as_reference_router(arch):
    js, ts = engines(arch, n=2)
    want = _serve(jserve, js)
    got = _serve(tserve, ts, device="cpu")
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_router_matches_reference():
    """The port's Router (planning on the CPU) over two port engines returns
    every request's tokens equal to the reference Router over two reference
    engines with the same weights."""
    _same_as_reference_router("granite-3-8b")


def test_router_over_mamba2_engines_matches_reference():
    """The same traffic over two mamba2 engines (O(1) SSM decode state)."""
    _same_as_reference_router("mamba2-2.7b")


def test_neither_engine_serves_a_vlm():
    """A gap both packages share: ``generate`` builds (B, S) token
    positions, and qwen2-vl's M-RoPE wants (3, B, S).  The reference raises
    AssertionError, the port ValueError, on the same prompts."""
    (je,), (te,) = engines("qwen2-vl-72b")
    prompts = np.random.default_rng(0).integers(2, je.cfg.vocab, (2, 8)).astype(np.int32)
    with pytest.raises(AssertionError, match="M-RoPE"):
        je.generate(prompts, jserve.ServeConfig(max_new_tokens=4))
    with pytest.raises(ValueError, match="M-RoPE"):
        te.generate(prompts, tserve.ServeConfig(max_new_tokens=4))


def test_neither_engine_serves_the_encoder_decoder():
    """A gap both packages share: the reference's engine prefills whisper,
    then its cache seeding looks for a period key in the encoder-decoder
    cache and raises KeyError; the port's engine refuses the family up
    front with NotImplementedError (ROADMAP Queue 3)."""
    jcfg = dataclasses.replace(JC.get("whisper-tiny", smoke=True), compute_dtype="float32")
    tcfg = dataclasses.replace(TC.get("whisper-tiny", smoke=True), compute_dtype="float32")
    prompts = np.random.default_rng(0).integers(2, jcfg.vocab, (2, 8)).astype(np.int32)
    with pytest.raises(KeyError, match="self"):
        jserve.Engine(jcfg, seed=0).generate(prompts, jserve.ServeConfig(max_new_tokens=4))
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 3"):
        tserve.Engine(tcfg, device="cpu")
    with pytest.raises(NotImplementedError, match="encoder-decoder"):
        tserve.smoke_engine_factory("whisper-tiny", "serve", device="cpu")


def _launch(*args, package="repro_torch", timeout=240):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src") + os.pathsep + env.get("PYTHONPATH", "")
    extra = ["--device", "cpu"] if package == "repro_torch" else []
    r = subprocess.run([sys.executable, "-m", f"{package}.launch.serve", *extra, *args],
                       env=env, capture_output=True, text=True, timeout=timeout)
    assert r.returncode == 0, r.stdout + r.stderr
    return r.stdout.splitlines()


def test_launcher_plain_mode():
    """Plain batched mode prints the reference launcher's ``seq i:`` lines
    for the same seeded prompts.  Each launcher's engine initializes its own
    weights from a seed (``jax.random`` there, ``torch.Generator`` here), so
    only the prompts and the form of the lines are shared."""
    args = ("--batch", "3", "--prompt-len", "8", "--max-new", "5")
    lines, ref = _launch(*args), _launch(*args, package="repro")
    assert [ln.split(":")[0] for ln in lines] == [ln.split(":")[0] for ln in ref] \
        == ["seq 0", "seq 1", "seq 2"]
    toks = [eval(ln.split(": ", 1)[1]) for ln in lines]
    ref_toks = [eval(ln.split(": ", 1)[1]) for ln in ref]
    assert all(len(t) == 13 and all(0 <= x < 256 for x in t) for t in toks)
    assert [t[:8] for t in toks] == [t[:8] for t in ref_toks]


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "jamba-v0.1-52b"])
def test_launcher_serves_the_ssm_families(arch):
    """``--arch`` mamba2 and jamba through the launcher's plain mode (the
    reference launcher's seeded prompts in front) and its router mode."""
    args = ("--arch", arch, "--batch", "2", "--prompt-len", "20", "--max-new", "4")
    lines, ref = _launch(*args), _launch(*args, package="repro")
    assert [ln.split(":")[0] for ln in lines] == ["seq 0", "seq 1"]
    toks = [eval(ln.split(": ", 1)[1]) for ln in lines]
    ref_toks = [eval(ln.split(": ", 1)[1]) for ln in ref]
    assert all(len(t) == 24 and all(0 <= x < 256 for x in t) for t in toks)
    assert [t[:20] for t in toks] == [t[:20] for t in ref_toks]
    text = "\n".join(_launch("--arch", arch, "--router", "--requests", "2", "--max-new", "3"))
    assert (f"router: 4 requests served on 2 workers ({arch}:serve#0, "
            f"{arch}:baseline#1) backend=inproc") in text
    assert "router: tenant0: 2 completed" in text and "router: tenant1: 2 completed" in text


@pytest.mark.parametrize("backend", ["inproc", "subprocess"])
def test_launcher_router_mode(backend):
    """``--router`` over two engines, in process and in subprocess workers
    built by ``smoke_engine_factory``: every request served and the
    reference's summary lines."""
    lines = _launch("--router", "--requests", "2", "--max-new", "3", "--backend", backend)
    text = "\n".join(lines)
    assert (f"router: 4 requests served on 2 workers (granite-3-8b:serve#0, "
            f"granite-3-8b:baseline#1) backend={backend}") in text
    assert "router: tenant0: 2 completed" in text and "router: tenant1: 2 completed" in text
    assert "router: planner=ceft_cpop max_split=1" in text
    assert any(ln.startswith("router: last critical path (task, engine):") for ln in lines)
    if backend == "subprocess":
        assert "router: pool launched=2 lost=0" in text


def test_smoke_engine_factory_builds_a_port_engine():
    eng = tserve.smoke_engine_factory("mixtral-8x22b", "moe_ep", device="cpu")
    assert isinstance(eng, tserve.Engine) and eng.profile.name == "moe_ep"
    out = eng.generate(np.full((2, 4), 5, np.int32), tserve.ServeConfig(max_new_tokens=3))
    assert out.shape == (2, 7)
