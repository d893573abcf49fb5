"""Multi-pod dry-run: trace one step of every (architecture x input shape x
mesh) cell on the production topology without the fleet, and record its
cost, memory and collectives (the counterpart of the reference's
``src/repro/launch/dryrun.py``, which lowers and compiles with XLA on fake
devices).

    python -m repro_torch.launch.dryrun --arch glm4-9b --cell train_4k --mesh single
    python -m repro_torch.launch.dryrun --all --out experiments/dryrun      # driver
    python -m repro_torch.launch.dryrun --arch granite-3-8b --cell prefill_32k \
        --mesh single --layers 4     # the published widths at 4 layers' depth

The fleet is a ``"fake"`` process group of ``--devices`` ranks (default: the
mesh's size) that this process stands in for, as rank 0; every collective
completes at once.  The state, the inputs and every intermediate are fake
tensors (``FakeTensorMode``): shapes, types and devices, no bytes, so a cell
of any size traces on any host.  ``--device cuda`` (the default) fakes CUDA
tensors and needs no card, but some of the models' indexing fakes only on a
PyTorch built with CUDA; ``--device cpu`` fakes host tensors.

A train cell runs ``ShardedTrainStep`` (forward, backward, the update),
prefill ``PrefillStep`` and decode ``DecodeStep`` (one token at the cache's
last position), on the state laid out by the cell's shardings.  The step
runs under :class:`repro_torch.substrate.CostCounter`, which counts this
rank's local ops, so every figure is per device.  The record
``<arch>__<cell>__<mesh>[__<profile>].json`` holds the reference's keys:

* ``cost_analysis``: {"flops", "bytes accessed", "transcendentals"} from
  the counter (products only in ``flops``; XLA also counts elementwise
  work; ``transcendentals`` the elements of the ops in
  ``substrate.compat.TRANSCENDENTAL_OPS``).  The reference's figures count
  a ``scan`` body once, so its step's ``flops`` cover one layer; the
  trace runs every layer;
* ``memory_analysis``: ``argument_size_in_bytes`` (this rank's parameters,
  optimizer state, cache and inputs), ``output_size_in_bytes`` (the
  distinct storages the step returns), ``temp_size_in_bytes`` (the peak of
  live bytes during the step, less the arguments), ``alias_size_in_bytes``
  (the arguments the step takes over: the decode cache; the train step's
  parameters and optimizer state, which it writes in place);
* ``collectives``: ``hlo_stats.collective_stats`` of the collectives the
  step issued;
* ``lower_s``: the trace's seconds.

Left out, with no counterpart: ``generated_code_size_in_bytes`` (no code
is generated) and ``compile_s`` (nothing is compiled).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor

from .. import configs as C
from ..configs.base import ArchConfig, ShapeCell
from ..models.common import (profile_names, resolve_spec, sharding_profile, sorted_leaves,
                             torch_dtype, tree_map_pspec)
from ..models.model import build
from ..optim import AdamWState
from ..optim.adamw import tree_map_sorted
from ..substrate import (CostCounter, Sharding, fake_store, init_group, local_value,
                         make_mesh as substrate_make_mesh, mesh_context)
from .hlo_stats import collective_stats
from .mesh import mesh_axis_sizes
from .steps import abstract_cache, abstract_state, build_decode, build_prefill, build_train, \
    input_shardings


def mesh_shape(kind: str, smoke: bool = False) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """The (shape, axis names) of a mesh kind: (16, 16) single pod, (2, 16,
    16) two pods, (16, 8, 2) the EP-aligned MoE pod; smoke (4, 2), (2, 2, 2)
    and (2, 2, 2)."""
    if kind == "moe":  # EP-aligned single-pod mesh (see PROFILES["moe_ep"])
        return ((2, 2, 2) if smoke else (16, 8, 2)), ("data", "expert", "tp")
    if smoke:
        shape = (2, 2, 2) if kind == "multi" else (4, 2)
    else:
        shape = (2, 16, 16) if kind == "multi" else (16, 16)
    return shape, (("pod", "data", "model") if len(shape) == 3 else ("data", "model"))


def make_mesh(kind: str, smoke: bool = False, device_type: str = "cuda"):
    """The mesh of ``kind`` over the first ranks of the default group."""
    shape, axes = mesh_shape(kind, smoke)
    return substrate_make_mesh(shape, axes, device_type=device_type)


def analytic_bytes_per_device(spec_tree, mesh, dtype_override=None) -> int:
    """Bytes of a PSpec tree on one device of ``mesh``: each leaf's bytes
    over the product of the mesh axes its resolved spec splits it over."""
    ms = mesh_axis_sizes(mesh)
    total = 0

    def add(_, p):
        nonlocal total
        shard = 1
        for entry in resolve_spec(p.shape, p.logical, ms):
            if entry is None:
                continue
            for ax in (entry if isinstance(entry, tuple) else (entry,)):
                shard *= ms[ax]
        itemsize = torch.empty((), dtype=torch_dtype(dtype_override or p.dtype)).element_size()
        total += math.prod(p.shape) * itemsize // shard
        return None

    tree_map_pspec(add, spec_tree)
    return total


def laid_out(meta: torch.Tensor, sharding: Sharding, device: str) -> DTensor:
    """A fake ``DTensor`` of ``meta``'s shape and type laid out by
    ``sharding``: this rank's shard made on ``device`` (inside a
    ``FakeTensorMode``, so nothing is allocated)."""
    local = sharding.local(meta)
    return DTensor.from_local(torch.empty(local.shape, dtype=meta.dtype, device=device),
                              sharding.mesh, sharding.placements, run_check=False,
                              shape=meta.shape, stride=meta.stride())


def _leaves(*trees) -> list[torch.Tensor]:
    """The tensors of trees (nested dicts, tuples and lists), in order."""
    return [t for t in sorted_leaves(trees) if isinstance(t, torch.Tensor)]


def _local_bytes(tensors) -> int:
    """Bytes of the distinct local storages of ``tensors``."""
    storages = {}
    for t in tensors:
        st = local_value(t).untyped_storage()
        storages[st._cdata] = st.nbytes()
    return sum(storages.values())


def trace_step(cfg: ArchConfig, cell: ShapeCell, mesh, device: str = "cuda") -> dict:
    """One step of ``cell`` traced on fake tensors laid out on ``mesh`` (its
    world may be a ``"fake"`` one); returns the record's analysis fields:
    ``state_bytes_per_device`` (from the specs), ``state_bytes_laid_out``
    (this rank's parameters, moments and cache as the trace laid them
    out), ``lower_s``, ``cost_analysis``, ``memory_analysis`` and
    ``collectives``."""
    model = build(cfg)
    specs = model.specs()
    inputs = {k: v for k, v in model.input_specs(cell).items() if k != "pos"}
    in_sh = input_shardings(inputs, mesh)
    state_bytes = analytic_bytes_per_device(specs, mesh)
    if cell.kind == "train":
        step, opt, sh = build_train(model, mesh)
        metas = abstract_state(model, opt)
        state_bytes += 2 * analytic_bytes_per_device(opt.moment_specs(specs), mesh)
    elif cell.kind == "prefill":
        step, sh = build_prefill(model, mesh)
        metas = (model.abstract(),)
    else:
        step, sh = build_decode(model, mesh, cell)
        metas = (model.abstract(), abstract_cache(model, cell))
        state_bytes += analytic_bytes_per_device(
            model.cache_specs(cell.global_batch, cell.seq_len), mesh)

    def lay(meta_tree, shardings):
        return tree_map_sorted(lambda m, s: laid_out(m, s, device), meta_tree, shardings)

    with mesh_context(mesh), FakeTensorMode(allow_non_fake_inputs=True):
        batch = {k: laid_out(v, in_sh[k], device) for k, v in inputs.items()}
        params = lay(metas[0], sh["params"])
        if cell.kind == "train":
            o_meta, o_sh = metas[1], sh["opt"]
            state = AdamWState(laid_out(o_meta.count, o_sh.count, device),
                               lay(o_meta.m, o_sh.m), lay(o_meta.v, o_sh.v))
            args, donated, held = (params, state, batch), (params, state), \
                (params, state.m, state.v)
        elif cell.kind == "prefill":
            args, donated, held = (params, batch), (), (params,)
        else:  # one new token at the cache's last position
            cache = lay(metas[1], sh["cache"])
            batch["pos"] = cell.seq_len - 1
            args, donated, held = (params, cache, batch), (cache,), (params, cache)
        state_laid_out = _local_bytes(_leaves(*held))
        counter = CostCounter()
        arg_bytes = counter.hold(_leaves(*args))
        t0 = time.monotonic()
        with counter:
            out = step(*args)
        lower_s = round(time.monotonic() - t0, 2)
        memory = {
            "argument_size_in_bytes": arg_bytes,
            "output_size_in_bytes": _local_bytes(_leaves(out)),
            "temp_size_in_bytes": counter.peak - arg_bytes,
            "alias_size_in_bytes": _local_bytes(_leaves(*donated)),
        }
    return {"state_bytes_per_device": state_bytes, "state_bytes_laid_out": state_laid_out,
            "lower_s": lower_s,
            "cost_analysis": counter.cost_analysis(), "memory_analysis": memory,
            "collectives": collective_stats(counter.collectives, mesh.mesh.numel())}


def run_cell(arch: str, cell_name: str, mesh_kind: str, smoke: bool, out_dir: Path,
             profile: str = "baseline", device: str = "cuda", devices: int = 0,
             layers: int = 0) -> bool:
    """Trace one cell on a fake fleet of ``devices`` ranks (default: the
    mesh's size) and write its record; returns whether it traced.
    ``layers`` cuts the architecture's depth (0: as configured; the record's
    ``n_layers`` says which).  The process joins the fleet as rank 0 unless a
    default group exists, and leaves a group it joined."""
    joined = False
    if not dist.is_initialized():
        init_group("fake", 0, devices or math.prod(mesh_shape(mesh_kind, smoke)[0]),
                   store=fake_store())
        joined = True
    try:
        # the profile travels with this cell, not with process-global state
        with sharding_profile(profile):
            return _run_cell(arch, cell_name, mesh_kind, smoke, out_dir, profile, device,
                             layers)
    finally:
        if joined:
            dist.destroy_process_group()


def _run_cell(arch: str, cell_name: str, mesh_kind: str, smoke: bool, out_dir: Path,
              profile: str, device: str, layers: int = 0) -> bool:
    cfg = C.get(arch, smoke=smoke)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    # smoke: shrink the cells to smoke scale but keep their character
    cell = C.smoke_cell(cell_name) if smoke else C.SHAPES[cell_name]
    shape, axes = mesh_shape(mesh_kind, smoke)
    rec = {
        "arch": arch, "cell": cell_name, "mesh": mesh_kind,
        "mesh_shape": dict(zip(axes, shape)),
        "seq_len": cell.seq_len, "global_batch": cell.global_batch,
        "kind": cell.kind, "ok": False,
        "n_params": cfg.n_params(), "n_active_params": cfg.n_active_params(),
        "n_layers": cfg.n_layers, "device": device,
    }
    t0 = time.monotonic()
    try:
        rec.update(trace_step(cfg, cell, make_mesh(mesh_kind, smoke, device), device))
        rec["ok"] = True
    except Exception:
        rec["error"] = traceback.format_exc(limit=20)
    rec["total_s"] = round(time.monotonic() - t0, 2)
    out_dir.mkdir(parents=True, exist_ok=True)
    rec["profile"] = profile
    tag = "" if profile == "baseline" else f"__{profile}"
    fn = out_dir / f"{arch}__{cell_name}__{mesh_kind}{tag}.json"
    fn.write_text(json.dumps(rec, indent=1, default=float))
    status = "OK " if rec["ok"] else "FAIL"
    print(f"[{status}] {arch:16s} {cell_name:12s} {mesh_kind:6s} "
          f"trace={rec.get('lower_s', '-'):>7}s", flush=True)
    if not rec["ok"]:
        # the traceback must reach the parent process, not just the json
        print(rec["error"], file=sys.stderr, flush=True)
    return rec["ok"]


def driver(args) -> int:
    """Every applicable cell of the chosen architectures, one subprocess
    each (a process holds one default group)."""
    cells = []
    for arch in (args.archs or C.ARCHS):
        for cell in C.cells_for(C.get(arch)):  # applicability from the FULL config
            for mk in (["single", "multi"] if args.mesh == "both" else [args.mesh]):
                cells.append((arch, cell, mk))
    if args.only_missing:
        def done(a, c, m):
            f = Path(args.out) / f"{a}__{c}__{m}.json"
            return f.exists() and json.loads(f.read_text())["ok"]
        cells = [cell for cell in cells if not done(*cell)]
    print(f"dry-run driver: {len(cells)} cells", flush=True)
    fails = []
    for arch, cell, mk in cells:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
               "--cell", cell, "--mesh", mk, "--out", args.out, "--profile", args.profile,
               "--device", args.device]
        if args.smoke:
            cmd.append("--smoke")
        if args.devices:
            cmd += ["--devices", str(args.devices)]
        if subprocess.run(cmd, env=dict(os.environ)).returncode != 0:
            fails.append((arch, cell, mk))
    print(f"driver done, {len(fails)} subprocess failures: {fails}", flush=True)
    return 1 if fails else 0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=C.ARCHS)
    ap.add_argument("--archs", nargs="*", help="driver: subset of archs")
    ap.add_argument("--cell", choices=list(C.SHAPES))
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both", "moe"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--only-missing", action="store_true")
    ap.add_argument("--devices", type=int, default=0,
                    help="ranks of the fake fleet (default: the mesh's size)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the type of the fake tensors")
    ap.add_argument("--profile", default="baseline", choices=profile_names())
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the architecture's depth to this many layers (0: as configured)")
    ap.add_argument("--out", default="experiments/dryrun")
    args = ap.parse_args()
    if args.all:
        sys.exit(driver(args))
    if not (args.arch and args.cell and args.mesh in ("single", "multi", "moe")):
        ap.error("--arch, --cell and one --mesh of single, multi, moe (or --all)")
    ok = run_cell(args.arch, args.cell, args.mesh, args.smoke, Path(args.out),
                  profile=args.profile, device=args.device, devices=args.devices,
                  layers=args.layers)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
