"""Serving launcher: batched greedy generation with any decoder the engine
serves (dense, MoE, SSM, hybrid; smoke scale), on the card unless ``--device
cpu``.  whisper and qwen2-vl raise, as the reference's engine does
(ROADMAP Queue 3).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-8b --batch 4
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --arch mamba2-2.7b

Router mode (--router): a CEFT-routed multi-tenant front-end over an elastic
engine pool (repro_torch.serve.pool); each tick the pending requests are
planned as a task DAG and dispatched along the mapped critical path (see
repro_torch.serve.router); the plans sweep on ``--device`` too.
--pool-size replicates the profile list up to N workers, --backend
subprocess puts each worker in its own process with a measured comm plane,
--autoscale lets the pool grow/drain with queue depth.

  PYTHONPATH=src python -m repro_torch.launch.serve --router --tenants 2 \
      --pool serve,baseline --requests 4 --max-new 4
  PYTHONPATH=src python -m repro_torch.launch.serve --router --pool-size 4 \
      --autoscale --backend subprocess --requests 8

Failure containment (--deadline-factor N arms the plan-derived deadline
watchdog; --chaos-seed S additionally runs the whole thing under the
deterministic fault injector and asserts every admitted request completed
exactly once — the local chaos soak):

  PYTHONPATH=src python -m repro_torch.launch.serve --router --pool-size 4 \
      --requests 4 --deadline-factor 3 --chaos-seed 7

SLO plane (--tiers assigns tenants to weighted tiers round-robin; a tier
with an SLO stamps it on every admitted request, and the router propagates
it backward through each tick's plan; the reference's docs/cli.md lists the
same flags):

  PYTHONPATH=src python -m repro_torch.launch.serve --router --tenants 3 \
      --tiers gold:8:2.0,bronze:1 --deadline-factor 3
"""
import argparse
import sys

import numpy as np

from .. import configs as C
from ..core.planners import planner_names
from ..models.common import profile_names
from ..serve import (
    AdmissionQueue,
    Engine,
    EnginePool,
    Request,
    Router,
    ServeConfig,
    TenantTier,
    WorkerSpec,
)


def parse_tiers(spec: str) -> list[TenantTier]:
    """``name:weight[:slo]`` comma-separated, e.g. ``gold:8:2.0,bronze:1``."""
    tiers = []
    for part in [p.strip() for p in spec.split(",") if p.strip()]:
        bits = part.split(":")
        if not 2 <= len(bits) <= 3:
            raise SystemExit(f"--tiers: bad tier {part!r} "
                             "(want name:weight[:slo])")
        try:
            tiers.append(TenantTier(
                bits[0], float(bits[1]),
                float(bits[2]) if len(bits) == 3 else None))
        except ValueError as e:
            raise SystemExit(f"--tiers: {e}")
    return tiers


def run_router(args) -> None:
    profiles = [p.strip() for p in args.pool.split(",") if p.strip()]
    unknown = [p for p in profiles if p not in profile_names()]
    if unknown:
        raise SystemExit(f"unknown pool profile(s) {unknown}; "
                         f"known: {profile_names()}")
    # --pool-size N replicates the profile list round-robin up to N workers
    size = args.pool_size if args.pool_size else len(profiles)
    profiles = [profiles[i % len(profiles)] for i in range(size)]
    cfg = C.get(args.arch, smoke=True)
    if args.backend == "subprocess":
        specs = [WorkerSpec(f"{args.arch}:{p}#{i}", profile=p,
                            factory="repro_torch.serve.pool:smoke_engine_factory",
                            args=(args.arch, p), kwargs={"device": args.device},
                            backend="subprocess")
                 for i, p in enumerate(profiles)]
    else:
        specs = [WorkerSpec(f"{args.arch}:{p}#{i}", profile=p,
                            engine=Engine(cfg, profile=p, device=args.device))
                 for i, p in enumerate(profiles)]
    pool = EnginePool(
        specs,
        probe="measure" if args.backend == "subprocess" else "static",
        autoscale=args.autoscale, max_size=max(size, args.max_pool_size),
        high_water=args.batch)
    if pool.probe != "static":
        pool.refresh_probes()
    chaos = None
    if args.chaos_seed is not None:
        from ..serve.faults import install_chaos
        chaos = install_chaos(pool, args.chaos_seed, rate=args.chaos_rate,
                              hold=1.0)
    deadline_factor = args.deadline_factor if args.deadline_factor > 0 else None
    if chaos is not None and deadline_factor is None:
        deadline_factor = 3.0   # chaos without the watchdog would just hang
    # --tiers: tenant t takes tier t % len(tiers); the queue drains by tier
    # weight and stamps each tier's SLO onto its tenants' requests
    queue = None
    tier_of: dict[str, TenantTier] = {}
    if args.tiers:
        tiers = parse_tiers(args.tiers)
        for t in range(args.tenants):
            tier = tiers[t % len(tiers)]
            tier_of[f"tenant{t}"] = tier
        queue = AdmissionQueue(tiers={
            name: TenantTier(name, tier.weight, tier.slo)
            for name, tier in tier_of.items()})
    # generous floor under chaos or tier SLOs: a cold worker's first
    # generate must not read as a blown deadline -- with a sub-warm-up budget
    # floor the watchdog walks every cold worker to strike-3 lost before its
    # first result can land
    slo_tiers = any(t.slo is not None for t in tier_of.values())
    min_deadline = 2.0 if (chaos is not None or slo_tiers) else 0.05
    router = Router(pool, max_batch=args.batch, queue=queue,
                    deadline_factor=deadline_factor, hedge=args.hedge,
                    min_deadline=min_deadline, planner=args.planner,
                    max_split=args.max_split, device=args.device)
    rng = np.random.default_rng(0)
    # tenant i leans to its own prompt-length bucket -> a mixed-class DAG
    tenant_of: dict[int, str] = {}
    for t in range(args.tenants):
        plen = max(2, args.prompt_len >> (t % 2))
        for _ in range(args.requests):
            prompt = rng.integers(2, cfg.vocab, plen).astype(np.int32)
            req = Request(f"tenant{t}", prompt, args.max_new)
            if router.submit(req):
                tenant_of[req.rid] = req.tenant
            else:
                print(f"tenant{t}: request rejected (admission control)")
    try:
        done = router.serve(max_ticks=args.max_ticks)
    finally:
        if chaos is not None:
            chaos.release()
        pool.close()
    names = ", ".join(s.name for s in router.slots)
    print(f"router: {len(done)} requests served on {pool.size} workers "
          f"({names}) backend={args.backend}")
    for name, err in router.failures:
        print(f"router: WORKER LOST {name}: {err}")
    p = pool.stats
    print(f"router: pool launched={p['launched']} lost={p['lost']} "
          f"drained={p['drained']} probes={p['probes']} "
          f"scale_out={p['scale_out']} scale_in={p['scale_in']}")
    counts: dict[str, int] = {}
    for rid in done:
        counts[tenant_of[rid]] = counts.get(tenant_of[rid], 0) + 1
    for tenant in sorted(counts):
        tier = tier_of.get(tenant)
        extra = ("" if tier is None else
                 f" (tier={tier.name} w={tier.weight:g}"
                 + (f" slo={tier.slo:g}s" if tier.slo is not None else "")
                 + ")")
        print(f"router: {tenant}: {counts[tenant]} completed{extra}")
    s = router.stats
    print(f"router: planner={router.planner} max_split={router.max_split} "
          f"split_degree={s['split_degree']} "
          f"moldable_plans={s['moldable_plans']}")
    print(f"router: plans={s['plans']} (degraded={s['degraded_plans']}) "
          f"cache_hits={s['cache_hits']} partial_sweeps={s['partial_sweeps']} "
          f"invalidations={s['invalidations']} "
          f"dispatches={s['dispatches']} coalesced={s['coalesced']} "
          f"split={s['split']} shed={s['shed']}")
    if router.last_plan is not None:
        path = router.last_plan.path
        print(f"router: last critical path (task, engine): {path} "
              f"cpl={router.last_plan.cpl:.4f}s")
    if router.watchdog is not None:
        w = router.watchdog.stats
        print(f"router: watchdog armed={w['armed']} sweeps={w['sweeps']} "
              f"overdue={s['overdue']} overdue_cp={s['overdue_cp']} "
              f"hedges={s['hedges']} stale_replies={s['stale_replies']} "
              f"requeued={s['requeued']} wd_lost={s['watchdog_lost']}")
        print(f"router: slo shed={s['slo_shed']} slo_hedges={s['slo_hedges']} "
              f"clamped_budgets={s['clamped_budgets']}")
    if chaos is not None:
        f = chaos.stats
        fired = {k: v for k, v in f.items() if k != "calls" and v}
        print(f"chaos: seed={args.chaos_seed} calls={f['calls']} "
              f"fired={fired or 'none'}")
        # the soak's contract: every admitted request completes EXACTLY once
        # (zero lost, zero double-completed — duplicates were dropped as
        # stale), and hedge duplicate work stays bounded by the overdue
        # critical-path dispatch count
        admitted = set(tenant_of)
        missing = sorted(admitted - set(done))
        ok = True
        if missing:
            ok = False
            print(f"chaos: FAIL {len(missing)} admitted requests never "
                  f"completed: {missing}")
        if s["completions"] != len(done):
            ok = False
            print(f"chaos: FAIL completion count {s['completions']} != "
                  f"{len(done)} distinct rids (double-completion)")
        if s["hedges"] > s["overdue_cp"]:
            ok = False
            print(f"chaos: FAIL hedges ({s['hedges']}) exceed overdue "
                  f"critical-path dispatches ({s['overdue_cp']})")
        if not ok:
            sys.exit(1)
        print(f"chaos: every admitted request completed exactly once "
              f"({len(done)}/{len(admitted)})")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=C.ARCHS, default="granite-3-8b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--profile", default="serve", choices=profile_names(),
                    help="sharding profile, scoped to this engine")
    ap.add_argument("--router", action="store_true",
                    help="CEFT-routed multi-tenant front-end over a pool")
    ap.add_argument("--planner", default="ceft_cpop",
                    choices=planner_names(include_exhaustive=False),
                    help="router mode: planner from the scheduler registry "
                         "used for every per-tick request-DAG plan")
    ap.add_argument("--max-split", type=int, default=1,
                    help="router mode: moldable prefill ceiling; the planner "
                         "sees each class's prefill as a fork-join of d "
                         "chunks for d in powers of two up to this, and the "
                         "router keeps the degree whose realized schedule "
                         "finishes first (1 = classic prefill->decode chain)")
    ap.add_argument("--tenants", type=int, default=2,
                    help="router mode: number of synthetic tenants")
    ap.add_argument("--requests", type=int, default=4,
                    help="router mode: requests per tenant")
    ap.add_argument("--pool", default="serve,baseline",
                    help="router mode: comma-separated profiles, one engine each")
    ap.add_argument("--pool-size", type=int, default=0,
                    help="router mode: replicate the profile list round-robin "
                         "up to N workers (0 = one per listed profile)")
    ap.add_argument("--backend", choices=("inproc", "subprocess"),
                    default="inproc",
                    help="router mode: worker backend; subprocess workers get "
                         "a measured comm plane (probed transfer rates)")
    ap.add_argument("--autoscale", action="store_true",
                    help="router mode: scale the pool out/in with queue depth")
    ap.add_argument("--max-pool-size", type=int, default=8,
                    help="router mode: autoscale ceiling")
    ap.add_argument("--max-ticks", type=int, default=64,
                    help="router mode: serve-loop tick cap")
    ap.add_argument("--deadline-factor", type=float, default=0.0,
                    help="arm the deadline watchdog: budget = factor x "
                         "planned span per dispatch (0 = disarmed)")
    ap.add_argument("--hedge", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="speculatively re-dispatch overdue critical-path "
                         "work to the degraded plane's best alternate")
    ap.add_argument("--chaos-seed", type=int, default=None,
                    help="run under the deterministic fault injector with "
                         "this seed and assert exactly-once completion")
    ap.add_argument("--chaos-rate", type=float, default=0.25,
                    help="per-call fault probability for the seeded plan")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the engines run and the router's plans sweep "
                         "(cuda raises without a card)")
    ap.add_argument("--tiers", default="",
                    help="router mode: comma-separated tenant tiers "
                         "name:weight[:slo-seconds], assigned to tenants "
                         "round-robin; weights drive the admission queue's "
                         "weighted drain, SLOs arm backward deadline "
                         "propagation (e.g. gold:8:2.0,bronze:1)")
    args = ap.parse_args()

    if args.router:
        return run_router(args)

    cfg = C.get(args.arch, smoke=True)
    eng = Engine(cfg, profile=args.profile, device=args.device)
    rng = np.random.default_rng(0)
    prompts = rng.integers(2, cfg.vocab, (args.batch, args.prompt_len)).astype(np.int32)
    out = eng.generate(prompts, ServeConfig(max_new_tokens=args.max_new))
    for i, row in enumerate(out):
        print(f"seq {i}: {row.tolist()}")


if __name__ == "__main__":
    main()
