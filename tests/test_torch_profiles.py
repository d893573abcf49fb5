"""The port's scoped sharding profiles against the reference's
(``tests/test_profiles.py``, test for test): immutability, restore on error,
nesting, the deprecated process-default shim, and the concurrency cases the
old global rules table failed: two threads holding different profiles at
once, two engines built concurrently under different profiles, router
tenants resolving their own profiles mid-trace, and ``observe()`` mid-tick
keeping the plan cache coherent.

Where a test's subject exists in both packages, the port's result is held
to the reference's: each rules table, each resolved spec, and each thread's
and engine's resolved ``logical_pspecs`` equal the reference's for the same
smoke config and mesh shape (specs are exact).  Engines and routers run with
``device="cpu"``."""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as JC  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
import repro_torch.configs as C  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models.common import (  # noqa: E402
    PROFILES,
    ShardingProfile,
    active_profile,
    logical_pspecs,
    resolve_profile,
    resolve_spec,
    set_sharding_profile,
    sharding_profile,
)
from repro_torch.serve import Engine  # noqa: E402

MS = {"data": 16, "model": 16}
MS_EP = {"data": 16, "expert": 8, "tp": 2}
CPU = "cpu"


def entries(tree):
    """A reference ``logical_pspecs`` tree with each PartitionSpec as the
    port's tuple of entries."""
    if isinstance(tree, dict):
        return {k: entries(v) for k, v in tree.items()}
    return tuple(tree)


def reference_pspecs(arch: str, mesh: dict, profile: str):
    return entries(jcommon.logical_pspecs(jbuild(JC.get(arch, smoke=True)).specs(), mesh,
                                          profile=profile))


def same_rules(prof: ShardingProfile) -> bool:
    return dict(prof.rules) == dict(jcommon.resolve_profile(prof.name).rules)


def test_profiles_are_immutable():
    prof = resolve_profile("serve")
    assert isinstance(prof, ShardingProfile)
    with pytest.raises(TypeError):
        prof.rules["batch"] = ("data",)
    with pytest.raises(TypeError):
        jcommon.resolve_profile("serve").rules["batch"] = ("data",)
    assert same_rules(prof)


def test_context_manager_restores_on_error():
    before = active_profile()
    with pytest.raises(RuntimeError, match="boom"):
        with sharding_profile("serve"):
            assert active_profile().name == "serve" and same_rules(active_profile())
            raise RuntimeError("boom")
    assert active_profile() is before


def test_unknown_profile_raises_without_state_change():
    before = active_profile()
    for scoped in (sharding_profile, jcommon.sharding_profile):
        with pytest.raises(KeyError, match="unknown sharding profile"):
            with scoped("no-such-profile"):
                pass  # pragma: no cover
    assert active_profile() is before


def test_nesting_inner_replaces_then_restores_outer():
    with sharding_profile("serve"), jcommon.sharding_profile("serve"):
        for active in (active_profile, jcommon.active_profile):
            assert active().rule("batch") == ()
        with sharding_profile("moe_ep"), jcommon.sharding_profile("moe_ep"):
            # full replacement, not a merge: moe_ep has no batch override,
            # so batch falls back to the baseline rule, not serve's
            for active in (active_profile, jcommon.active_profile):
                assert active().rule("batch") == ("pod", "data")
                assert active().rule("experts") == ("expert",)
            assert same_rules(active_profile())
        for active in (active_profile, jcommon.active_profile):
            assert active().rule("batch") == ()
            assert active().rule("experts") == ("model",)


def test_shim_warns_and_is_overridden_by_scoped(monkeypatch):
    """The deprecated shim in both packages, step for step: a warning, the
    process default, a scoped profile over it, and an unknown name raising
    with the default left as it was."""
    import repro_torch.models.common as mc
    monkeypatch.setattr(mc, "_PROCESS_DEFAULT_PROFILE", None)
    monkeypatch.setattr(jcommon, "_PROCESS_DEFAULT_PROFILE", None)
    for shim, active, scoped in ((set_sharding_profile, active_profile, sharding_profile),
                                 (jcommon.set_sharding_profile, jcommon.active_profile,
                                  jcommon.sharding_profile)):
        assert active().name == "baseline"
        with pytest.warns(DeprecationWarning):
            shim("serve")
        assert active().name == "serve"
        with scoped("opt1"):
            assert active().name == "opt1"
        assert active().name == "serve"
        with pytest.raises(KeyError):
            with pytest.warns(DeprecationWarning):
                shim("bogus")
        assert active().name == "serve"
    assert same_rules(active_profile())
    # the process default resolves specs where no scope is active
    assert resolve_spec((256, 4096), ("batch", "ffn"), MS) == \
        tuple(jcommon.resolve_spec((256, 4096), ("batch", "ffn"), MS))
    from repro_torch.models import set_sharding_profile as exported
    assert exported is set_sharding_profile


def test_threads_resolve_their_own_profiles():
    """Two threads hold different profiles *simultaneously*; each sees its
    own rules for the whole overlap, and its resolved ``logical_pspecs``
    (granite smoke under ``serve`` on (16, 16), mixtral smoke under
    ``moe_ep`` on (16, 8, 2)) equal the reference's."""
    barrier = threading.Barrier(2, timeout=30)
    errors: list[str] = []
    got: dict[str, object] = {}
    cases = {"serve": ("granite-3-8b", MS, (), ("model", "data")),
             "moe_ep": ("mixtral-8x22b", MS_EP, ("pod", "data"), ("expert", "tp"))}
    specs = {name: build(C.get(arch, smoke=True)).specs()
             for name, (arch, _, _, _) in cases.items()}

    def worker(name: str):
        _, mesh, expect_batch, expect_qkv = cases[name]
        try:
            with sharding_profile(name):
                barrier.wait()  # both threads now inside their profile
                for _ in range(200):
                    prof = active_profile()
                    if prof.name != name:
                        errors.append(f"{name}: saw {prof.name}")
                        return
                    if prof.rule("batch") != expect_batch or \
                            prof.rule("qkv") != expect_qkv:
                        errors.append(f"{name}: wrong rules {prof.rules}")
                        return
                got[name] = logical_pspecs(specs[name], mesh)
                barrier.wait()  # hold the overlap until both finish reading
        except Exception as e:  # pragma: no cover
            errors.append(f"{name}: {e!r}")

    threads = [threading.Thread(target=worker, args=(n,)) for n in cases]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    for name, (arch, mesh, _, _) in cases.items():
        assert got[name] == reference_pspecs(arch, mesh, name), name


def test_concurrent_engines_match_isolated_shardings():
    """Two engines constructed under different active profiles in two
    threads resolve the same param pspecs as each profile selected alone,
    and those are the reference's for granite smoke on (16, 16)."""
    cfg = C.get("granite-3-8b", smoke=True)

    def alone(profile):
        eng = Engine(cfg, profile=profile, device=CPU)
        return logical_pspecs(eng.model.specs(), MS, profile=eng.profile)

    expected = {p: alone(p) for p in ("serve", "baseline")}

    barrier = threading.Barrier(2, timeout=60)
    results: dict[str, object] = {}
    errors: list[str] = []

    def make(profile):
        try:
            with sharding_profile(profile):
                barrier.wait()
                eng = Engine(cfg, device=CPU)  # inherits this thread's active profile
                assert eng.profile.name == profile
                results[profile] = logical_pspecs(eng.model.specs(), MS)
        except Exception as e:  # pragma: no cover
            errors.append(f"{profile}: {e!r}")

    threads = [threading.Thread(target=make, args=(p,)) for p in ("serve", "baseline")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    for p in ("serve", "baseline"):
        assert results[p] == expected[p] == reference_pspecs("granite-3-8b", MS, p), p
    # the two layouts genuinely differ (the race would have collapsed them)
    assert results["serve"] != results["baseline"]


def test_every_declared_profile_resolves():
    assert sorted(PROFILES) == sorted(jcommon.PROFILES)
    for name in PROFILES:
        prof = resolve_profile(name)
        assert same_rules(prof)
        for mesh in (MS, MS_EP):
            spec = resolve_spec((256, 4096), ("batch", "ffn"), mesh, profile=prof)
            assert len(spec) == 2
            assert spec == tuple(jcommon.resolve_spec((256, 4096), ("batch", "ffn"), mesh,
                                                      profile=name))


def test_profile_names_derive_from_registry():
    """Launcher ``--profile`` choices come from the registry: the helper
    tracks PROFILES exactly, as the reference's does."""
    from repro_torch.models.common import profile_names
    assert profile_names() == sorted(PROFILES) == jcommon.profile_names()
    assert "serve" in profile_names() and "baseline" in profile_names()


def _engines(cfg, record, barrier):
    """One engine per profile, each recording the profile active inside its
    trace and waiting at ``barrier`` there."""
    class RecordingEngine(Engine):
        def _generate(self, prompts, scfg=None):
            if record is not None:
                record[self.profile.name] = active_profile().name
            barrier.wait()  # both engines are inside their trace scope now
            return super()._generate(prompts, scfg)

    from repro_torch.serve import EngineSlot
    return [EngineSlot(f"eng-{p}", RecordingEngine(cfg, profile=p, device=CPU), p)
            for p in ("serve", "baseline")]


def test_router_tenants_resolve_own_profiles_concurrently():
    """Two tenants served through the router from two threads, each
    micro-batch on an engine pinned to a different profile, both mid-trace
    at the same time: each trace resolves its own profile."""
    from repro_torch.serve import Dispatch, Request, Router

    cfg = C.get("granite-3-8b", smoke=True)
    barrier = threading.Barrier(2, timeout=60)
    seen: dict[str, str] = {}
    errors: list[str] = []
    router = Router(_engines(cfg, seen, barrier), device=CPU)
    rng = np.random.default_rng(0)
    reqs = [Request(t, rng.integers(2, cfg.vocab, 8).astype(np.int32), 2)
            for t in ("tenantA", "tenantB")]

    def drive(idx, req):
        try:
            d = Dispatch(engine=idx, requests=[req], wclass=req.wclass,
                         on_critical_path=False, node_prefill=0, node_decode=1)
            out = router.run_dispatch(d)
            assert out[req.rid].shape[0] >= 9
        except Exception as e:  # pragma: no cover
            errors.append(f"{req.tenant}: {e!r}")

    threads = [threading.Thread(target=drive, args=(i, r)) for i, r in enumerate(reqs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert seen == {"serve": "serve", "baseline": "baseline"}


def test_router_observe_mid_tick_keeps_plan_cache_coherent():
    """Two engine worker threads feeding ``observe()`` cost deltas back
    while the main thread ticks do not tear the plan cache's reverse index,
    and the next tick re-plans (the deltas dirty the cached entry through
    the reverse index) instead of short-circuiting on the stale plan."""
    from repro_torch.serve import Dispatch, Request, Router

    cfg = C.get("granite-3-8b", smoke=True)
    barrier = threading.Barrier(3, timeout=60)
    errors: list[str] = []
    router = Router(_engines(cfg, None, barrier), tick_budget=2, device=CPU)
    rng = np.random.default_rng(0)

    def _req(tenant, plen):
        return Request(tenant, rng.integers(2, cfg.vocab, plen).astype(np.int32), 2)

    for plen in (8, 8, 4, 4):  # two workload classes resident
        router.submit(_req("tenantQ", plen))
    assert router.tick(), "seed tick produced no dispatches"

    # worker dispatches built up-front (rng is not thread-safe)
    worker_ds = [
        Dispatch(engine=i, requests=[_req(f"tenant{i}", plen)],
                 wclass=(plen, 2), on_critical_path=False,
                 node_prefill=0, node_decode=1)
        for i, plen in enumerate((8, 4))
    ]

    def drive(d):
        try:
            out = router.run_dispatch(d)  # observe() fires on completion
            rid = d.requests[0].rid
            assert out[rid].shape[0] >= d.wclass[0] + 1
        except Exception as e:  # pragma: no cover
            errors.append(f"engine{d.engine}: {e!r}")

    threads = [threading.Thread(target=drive, args=(d,)) for d in worker_ds]
    for t in threads:
        t.start()
    barrier.wait()          # both engines are mid-generate: tick now
    router.tick()           # drains the 2 residents the seed tick left
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert router.stats["invalidations"] >= 1, "observe() deltas must land"

    # pin one more delta from this thread (the raced ones may have landed
    # before the mid-flight tick planned, which would make its cached plan
    # legitimately current); now the entry is unambiguously dirty
    router.observe(0, (8, 2), 0.5, 10)
    for plen in (8, 4):
        router.submit(_req("tenantR", plen))
    plans = router.stats["plans"]
    hits = router.stats["cache_hits"]
    router.tick()
    assert router.stats["plans"] == plans + 1
    assert router.stats["cache_hits"] == hits
    # reverse index only references live plan keys (no torn state)
    pc = router.plancache
    with pc._lock:
        for keys in pc._by_class.values():
            assert keys <= set(pc._plans)
