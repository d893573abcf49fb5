#!/usr/bin/env python3
"""Drive the port's CEFT planning path, its serving router, its LM engines, its
training stack and its distribution substrate on one NVIDIA GPU and check
them.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. build the CUDA kernels from ``src/repro_torch/csrc`` (nvcc, sm_90a) and
     print ``ptxas -v``'s registers, shared memory and spills per kernel;
  2. hold each kernel against its plain PyTorch version on the card, bit-equal,
     at the test shapes and the planning path's shapes, and on tie-heavy
     inputs: ``edge_relax`` past the 240 classes its kernel once refused (P =
     241, 256, 300, 2048, the widest staged launch, and 2049), batches of 3
     and 8 planes, ragged last tiles, tie-heavy and constant rows, and the
     divide probe's four kinds (16384 edges a call, every adversarial
     quotient reaching the output); ``ceft_relax`` with fan-ins split across
     blocks, the fused
     segment level (``seg_level``) with long, tile-crossing, single and
     padded segments and a batch of 8; then NaN, inf and -0.0 candidates
     through ``edge_relax``, ``ceft_relax`` and ``seg_level`` (a NaN wins the
     min and the max, and the first NaN's index is the arg); and the bf16
     instance of ``ceft_relax`` at the same shapes, tie cases and NaN, inf
     and -0.0 probes, bit for bit against the plain version in bf16;
  3. plan the paper's largest graph (RGG "high", n = 16384, P = 64) through
     ``PlanCache(device="cuda")``: bit-equal to the CPU path, a partial
     re-sweep after a change to the deepest levels' costs, and one realized
     CEFT-CPOP schedule, validated (the realize, host numpy, in a process of
     its own beside phases 4-g, read after g); a steady sweep launches
     ``seg_level`` once per segment-layout level and nothing else of the
     kernels;
  4. batched re-planning (B = 8) bit-equal to 8 single sweeps;
  5. the dense layout (star fan-in) and the segment fallback (heavy-tailed
     fan-in), the padded sweep, and the paper's Algorithm 1 on a small graph;
  6. the straggler loop: quiet, cached and degraded steps, equal to the same
     loop on the CPU;
  a. the edge relaxation at the Pallas kernels' contracts on the n = 16384
     graph's own segment-layout run tables: ``edge_relax`` level by level and
     ``edge_relax_superstep`` over each stacked run, bit-equal slice by slice
     to each other and as a whole to their plain versions, and at the test
     shapes and every instance's widths (P = 8, 32, 128, 161, 200, 240); then
     the superstep on tie-heavy tables (slice by slice against ``edge_relax``
     too), on NaN, inf and -0.0 candidates, and on about 2^26 adversarial
     (pdata, bw) quotients that each reach the output;
  b. the tropical product (``minplus``) at the test shapes and at
     (4096, 4096, 4096), float32 and bf16, bit-equal to its plain version, and
     the semiring identity; then NaN, inf and -0.0 operands and adversarial
     bf16 sums (rounding ties, near the largest bf16 and BIG, subnormals,
     ±0), float32 and bf16;
  c. the router (``pool8``: 8 null engines, 6 workload classes, moldable split
     up to 4) planning on the card: 192 requests served exactly once, every
     tick's plan bit-equal to the same DAG planned on the CPU, then one engine
     tripped and the path moved off it, nominal and degraded planes both on
     the card;
  d. the seeded chaos soak on 4 subprocess workers: every request completes
     exactly once, and no worker child starts CUDA (in a process of its own,
     its router on the card, beside phases e-g, read after g);
  e. the LM serving path at granite-3-8b's published widths: e1, at 2 of its
     40 layers, the engine on the card against the same weights on the CPU
     (float32 compute with TF32 off: logits within 1e-4 relative and 16
     greedy tokens identical; bf16: prefill and teacher-forced decode logits
     within 5e-2 relative); e2, all 40 layers (8.37 B parameters made on the
     card), two engines sharing one parameter set behind
     ``Router(device="cuda", max_batch=4)``, two rounds of 2 tenants x 4
     requests (prompts of 512 and 256 tokens, 32 new tokens): every request
     exactly once with its prompt in front, the ticks launching
     ``ceft_relax``, one engine deterministic on a batch; then prefill and
     decode-step times, tokens/s and peak memory beside their bounds;
  f. the SSM serving path at mamba2-2.7b's published widths: f1, at 2 of its
     64 layers, the engine on the card against the same weights on the CPU
     at prompts of one whole SSM chunk (64) and a padded one (100), held as
     in e1; f2, all 64 layers (2.70 B parameters made on the card; the
     count checked against ``n_params()`` plus each spec leaf it leaves out,
     named), e2's router, traffic and checks, then prefill and decode-step
     times beside their bounds (the decode bytes count the float32 SSM
     state and conv history); f3, jamba at smoke size through
     ``Engine.generate`` (identical tokens) and whisper-tiny as published
     (4 + 4 layers, 1500 zero frames) through ``Model.prefill`` and 8
     teacher-forced ``Model.decode`` steps (logits within 1e-4), card
     against CPU in float32 with TF32 off;
  g. training at minicpm-2b's published widths: g1, at 2 of its 40 layers,
     one ``TrainStep`` on the card against the same weights and batch on the
     CPU (float32 compute with TF32 off: loss within 1e-5 relative, grad
     norm within 1e-4, each gradient leaf within 1e-4 of its largest entry;
     bf16: loss, grad norm and the gradient tree within 5e-2; the updated
     parameters within two learning rates everywhere); g2, all 40 layers (2.72 B parameters made on the card), five
     steps through ``build_train`` and ``SyntheticLM`` at (B, S) = (2, 4096)
     (train_4k's sequence, its global batch of 256 cut to 2 for one card),
     every loss and grad norm finite, forward + backward and the AdamW
     update timed apart beside their bounds, tokens/s and peak memory; then
     ``StragglerMonitor(4, device="cuda")`` re-planning this cell's
     672-task layer DAG bit-equal to the CPU, the degraded plan launching
     ``ceft_relax``; g3, the ``Trainer`` loop on the card at the smoke
     config: a failure at step 6 recovers from the step-4 checkpoint with
     the unfailed run's losses within 2e-4, and a simulated straggler's
     re-plan launches ``ceft_relax``;
  x. the reference's examples through ``repro_torch.examples`` on the card:
     x1, ``quickstart`` (host work, as in the reference: its figures and
     seconds; the CPU tests hold them to the reference's); x2,
     ``heterogeneous_pipeline``: its plans (host work) once, its glm4-9b
     straggler scenario with the monitor's re-plans sweeping on the card and
     again on the CPU, the event (step, class, slowdown, old and new
     makespan) and the classes in use bit-equal, the ``ceft_relax``
     launches printed; x3, ``serve_batched`` (the demo dense model, mixtral
     smoke's ring cache, mamba2 smoke's state) in float32 with TF32 off on
     the card and on the CPU from the same weights: equal output shapes,
     every sequence EOS-padded after its first EOS, prefill and
     teacher-forced decode logits (on the CPU run's tokens) within 1e-4
     relative; x4, ``train_100m`` at full width (12 layers x 768, a
     vocabulary of 32768, (8, 256)) for 60 steps on a one-rank NCCL mesh, a
     node lost at step 55 restoring step 50's checkpoint, the loss falling,
     step ms, tokens/s and the peak;
  h. the distribution substrate: h1, minicpm-2b as published through
     ``build_train(model, mesh)`` on a (data 1, model 1) mesh of this
     process's one-rank NCCL world (state laid out by ``Model.shardings``),
     two ``ShardedTrainStep``s from g2's seed and batches: losses within
     1e-5 and grad norms within 1e-4 of g2's first two, step time and peak
     beside g2's; h2, the GPipe forward at granite-3-8b's widths cut to 8
     layers over 4 pipe ranks spawned on the card (gloo: NCCL refuses two
     ranks on one card), each making its own layers from per-layer seeds,
     (B, S) = (8, 512), 4 microbatches, float32 with TF32 off: within 1e-5
     of the plain stacked forward on the card, both timed; h3,
     ``compressed_psum`` over 2 pod ranks spawned on the card (gloo), 64 MiB
     of float32 each, bit-equal to its formula in plain PyTorch on the card,
     and ``ef_quantize``'s invariant over 50 rounds; h4, g3 with the
     ``Trainer`` on ``make_test_mesh``; h5, the dense family's tensor- and
     sequence-parallel ``ShardedTrainStep`` at granite-3-8b's widths cut to
     2 layers, (B, S) = (2, 4096), on a (data 1, model 4) mesh of 4 gloo
     ranks spawned on the card (the sequence, the heads, the 8 kv heads and
     the MLP's columns split; the vocabulary of 49155 does not): its first
     step's loss and grad norm within 1e-5 and 1e-4 of the one-device step
     on the card from the same seeded weights and batches in float32 (TF32
     off), within g1's 5e-2 in bf16; each rank's peak memory beside the
     one-device step's, and the step's ms (gloo on one card: not a speed);
     h6, the encoder-decoder's planned ``ShardedTrainStep`` on h1's (data
     1, model 1) NCCL mesh: whisper-tiny as published (its encoder's frames
     seeded normal), (B, S) = (2, 4096), two steps within 1e-5 (loss) and
     1e-4 (grad norm) of the one-device step on the card from the same
     seeded weights and batches, the step's plan made; h7, the
     dense family's sharded ``PrefillStep`` and ``DecodeStep`` at
     granite-3-8b's widths cut to 2 layers on 4 gloo ranks spawned on the
     card, a (1, 4) mesh under baseline and a (2, 2) mesh under serve (the
     cache in the decode-SP layout: rows on data, sequence on model):
     prefill (4, 512), the cache moved into 1024 positions by
     ``seed_cache``, 16 greedy tokens, float32 with TF32 off, every step's
     logits within 1e-5 of the one-device steps' on the card and every
     token identical; each rank's peak beside the one-device run's, the
     steps' ms (gloo on one card: not a speed); h8, the MoE family's
     sharded train step at mixtral-8x22b's published widths cut to 1 layer,
     (B, S) = (2, 4096), on 4 gloo ranks spawned on the card, a (1, 4) mesh
     under baseline (2 of the 8 experts a rank) and a (data, expert, tp) =
     (1, 2, 2) mesh under moe_ep: step 1's loss and grad norm against the
     one-device step run first and freed, at h5's bounds in float32 (TF32
     off) and bf16, and every expert choice that differs from the
     one-device step's at a router probability gap below 1e-5 in float32
     (bf16's reported); h9, its sharded prefill of a (1, 5120) prompt past
     the 4096-token window, ``seed_cache`` into the ring and 16 greedy
     tokens on the same meshes, float32, logits within 1e-5 of the
     one-device steps and tokens identical; h10, the SSM family's
     head-parallel train step at mamba2-2.7b's published widths cut to 2
     layers, (B, S) = (2, 4096), on a (1, 4) mesh of 4 gloo ranks under
     baseline (20 of the 80 heads and 2644 of in_proj's 10576 columns a
     rank), step 1 against the one-device step run first and freed, at h5's
     bounds in float32 (TF32 off) and bf16; h11, its sharded prefill of a
     (4, 1000) prompt (15 chunks of 64 and a ragged one), ``seed_cache`` and
     16 greedy tokens on h7's (1, 4) baseline and (2, 2) serve meshes,
     float32, logits within 1e-5 of the one-device steps and tokens
     identical; h12, the hybrid's planned train step at jamba-v0.1-52b's
     published widths cut to an (attention, MLP) and an (SSM, MoE) layer,
     (B, S) = (1, 4096), on (1, 4) (8 q heads, 4 of the 16 experts and 32
     of the 128 SSM heads a rank), step 1's loss and gradients (no update:
     with the moments neither the one-device step nor the 4 ranks fit) at
     h5's bounds in float32 and bf16 with h8's routing-gap rule; h13 its
     sharded prefill (4, 1024), ``seed_cache`` into 1040 positions and 16
     greedy tokens on (1, 4) baseline and (2, 2) serve, float32, logits
     within 1e-5 beyond the one-device prefill's own float32 spread (the
     same prompts prefilled whole against row by row: 9.5e-6 at these
     widths) and tokens identical; h14, the VLM's planned train step at
     qwen2-vl-72b's published widths cut to 1 layer, (2, 4096) of seeded
     embeds and image-grid (3, B, S) positions, as h12; h15 its sharded
     prefill from (4, 1000) embeds and decode with (3, B, 1) positions, as
     h13; h16, the encoder-decoder's planned train step at whisper-tiny as
     published, (B, S) = (2, 4096) tokens and seeded (2, 1500, 384) frames,
     on (1, 4) baseline (the 6 heads and the vocabulary whole, 375 frames a
     rank; each rank attends with every head of its query slice, over
     ``model``, and over both axes under serve) and (2, 2) serve, one step
     (the AdamW update included) against the one-device step at h5's bounds
     in float32 (TF32 off) and bf16; h17, its sharded prefill of (4, 1000)
     tokens with their frames,
     ``seed_cache`` into 1016 self-cache positions (the cross cache carried
     as the prefill laid it out) and 16 greedy tokens on h7's meshes and
     on (2, 2) under baseline (the 4 rows on data: the decode plan keeps
     both tables on their data shards, its ``table`` axes checked to be
     ``('data',)``, and 51865 logit columns split unevenly over model),
     float32, logits within 1e-5 of the one-device steps and tokens
     identical; h18, h8's train step at (1, 4096) against one-device steps
     of its own (at (2, 4096) four ranks of it do not fit the card) and h9's
     prefill and decode against h9's, on a (2, 2) mesh under serve (the
     experts on model, their hidden columns on data, what the experts leave
     of (model, data); the tokens replicated over data, the sequence whole),
     at h8's and h9's bounds with h8's routing-gap rule; h19, one row on a
     (2, 2) mesh under baseline, whose decode plan keeps every weight on its
     ``data`` (embed) shard and moves the token: h11's model, a (1, 1000)
     prompt, and h13's, a (1, 1024) prompt (whole 256-token MoE groups),
     each prefilled, moved by ``seed_cache`` and decoded for 16 greedy
     tokens, float32, logits within 1e-5 of the one-device steps (the
     hybrid's beyond its one-device prefill's spread: the row alone against
     the row in a batch of 4) and tokens identical, each rank's peak and
     decode ms printed beside h11's and h13's four-row figures.  h2, h5 and
     h7-h19 run on one group of 4 gloo ranks spawned
     once (each rank's spawn-to-first-collective seconds and each phase's
     seconds printed), their one-device references run first in this
     process, each freed; every h phase prints each rank's peak and the
     card's name and power limit;
  i. the analysis tools on the card's own runs, read after every timed
     phase (every trace runs in a process of its own at low priority,
     queued at the check's start beside the serial chain of phases 1-h, the
     longest first, at most the host's cores less two at once, each on
     host fake tensors but i1's, which fakes CUDA tensors): i1,
     ``launch.dryrun``'s trace of g2's exact cell (minicpm-2b as
     published, (B, S) = (2, 4096), float32 weights and moments) on a
     one-rank fake mesh: the predicted per-device argument + temp bytes
     within 15 % of g2's measured peak, its product FLOPs equal to the hand
     count of the products the step runs and within [1.0, 1.1] x g2's hand
     count; i2, ``roofline.analyze_cell`` with the H100's peaks on one chip
     for g2's cell, e2's prefill (4, 512) and e2's decode (B = 4, cache
     544), each beside the phase's measured time and its hand bound; i3,
     through the dry-run's command line, granite-3-8b
     ``train_4k`` as published on the (16, 16) production mesh of 256 fake
     ranks: the record ``ok``, collective bytes > 0, this rank's laid-out
     state equal to ``analytic_bytes_per_device``, argument + temp bytes
     below the card's memory, the temp at most twice the reference's XLA
     compile count of the same cell on 256 fake host devices
     (15,465,583,616 bytes), the collective bytes a device at most that
     count's (546,732,035,224), the product FLOPs equal to the tensor-parallel
     step's hand count (``hand_train_flops``) and at most a twelfth of the
     ZeRO-3 step's, and the trace's seconds; i4, the dense family's
     sharded serving cells on the same fleet:
     granite-3-8b ``decode_32k`` as published (argument + temp + output below
     the card's memory, temp at most twice the reference's XLA count
     5,664,096,168, collective bytes a device at most its 2,096,794,848,
     product FLOPs equal to ``hand_decode_flops``, the record equal to the
     CPU's counts of the same command (``I_DECODE_CPU``) to the byte) and
     ``prefill_32k`` cut to 4 of its 40 layers (FLOPs equal to
     ``hand_prefill_flops`` at that depth, collective bytes at most 4/40 of
     the reference's 140,338,135,088, argument + temp + output below 4/40
     of the card's memory, temp at most twice the reference's
     3,619,734,528), each beside the reference's figures and the card's
     name and power limit; i5, the MoE family's production cells:
     dbrx-132b and mixtral-8x22b (moe_ep, (16, 8, 2)) ``decode_32k`` and
     ``train_4k`` as published, mixtral-8x22b ``train_4k`` on (16, 16) and
     dbrx-132b ``prefill_32k`` cut to 4 of its 40 layers, each against the
     reference's XLA counts (``I5_REFERENCE``): argument + temp + output
     below the card's memory, collective bytes a device at most the
     reference's (scaled by the share of the layers where the depth is
     cut, as the memory bound), product FLOPs equal to the hand counts, the
     temp printed beside the reference's, each decode record equal to the
     CPU's counts to the byte; i6, the SSM
     family's production cells the same way: mamba2-2.7b ``train_4k``,
     ``prefill_32k``, ``decode_32k`` and ``long_500k`` as published on
     (16, 16), against the reference's XLA counts (``I6_REFERENCE``):
     argument + temp + output below the card's memory, collective bytes a
     device at most the reference's and, for ``long_500k`` (one row: the weights stay on their
     ``data`` shards and the token moves), at most a fiftieth of the parent
     tree's, which gathered every weight over ``data`` (the reference's
     printed beside them), product FLOPs equal to
     the hand counts and ``train_4k``'s at most a twelfth of the ZeRO-3
     step's; i7, the hybrid's and the VLM's production cells the same way:
     jamba-v0.1-52b ``train_4k``, ``prefill_32k``, ``decode_32k`` and
     ``long_500k`` and qwen2-vl-72b ``train_4k`` and ``decode_32k`` as
     published, its ``prefill_32k`` cut to 8 of its 80 layers, against the
     reference's XLA counts (``I7_REFERENCE``): argument + temp + output
     below the card's memory (scaled by the share of the layers where the
     depth is cut), collective bytes a device at most the reference's
     (long_500k: at most a fiftieth of the parent tree's), product FLOPs
     equal to the hand counts, each decode and long_500k record equal to
     the CPU's counts to the byte, beside
     the parent's gathering and ZeRO-3 steps' figures (``I7_BEFORE``); i8,
     the encoder-decoder's production cells the same way: whisper-tiny's
     ``train_4k``, ``prefill_32k`` and ``decode_32k`` as published, each
     record's sum, temp, collective bytes and FLOPs equal to the CPU's
     counts of the same command (``I8_CPU``) to the byte, FLOPs equal to the
     hand counts, collective bytes a device at most the reference's and,
     for ``decode_32k``, below a hundredth of the gathering step's with its
     temp below 1 GB, beside the reference's XLA counts
     (``I8_REFERENCE``) and the parent's ZeRO-3 and gathering steps'
     (``I8_BEFORE``); every i3-i8 cell's temp below a parent tree's
     (``I_PARENT_TEMP``: its steps gathered every period's working weights
     before the model ran, where these gather a period's where it runs; the
     long_500k cells' below the tree that gathered each period's weights
     over ``data``); i9, minicpm-2b's ``train_4k`` cut to 2 of its 40 layers
     on (16, 16), whose 36 q heads do not split over the 16 ranks of
     ``model`` (each rank attends with every head of its query slice): the
     record's sum, temp, collective bytes and FLOPs equal to the CPU's
     counts (``I9_CPU``) to the byte, its FLOPs to ``hand_train_flops``,
     its argument + temp below the card's memory and below the reference's
     whole-cell temp (80,860,100,744), beside the parent tree's
     (``I9_PARENT``); i10, the reference cells no other i cell traces, as
     published on (16, 16): minicpm-2b's ``decode_32k`` (36 q heads
     unsplit, its tied 122753-row table on ``data``) and mixtral-8x22b's
     ``long_500k`` (one row: every weight on its ``data`` shard), each
     record equal to the CPU's counts to the byte (``I_DECODE_CPU``), its
     FLOPs to ``hand_decode_flops``, its collective bytes at most the
     reference's (``I10_REFERENCE``: 718,783,648 and 29,897,224);
  7. report: launches of each kernel on each path (the counts are reset just
     before a path and read just after it), then each kernel's time at its
     path's shapes beside its plain version and its bound (``seg_level`` at
     the n = 16384 graph's widest segment-layout levels, 1 and 8 planes;
     ``edge_relax`` at phase a's (1024, 64) and (2048, 64) and at 8 planes of
     (1024, 64), with the launch shape ``edge_relax_grid`` chose), and for
     ``seg_level``, ``edge_relax``, the superstep and ``minplus`` the
     instruction-issue floor at the card's largest SM clock (``edge_relax``'s
     at the instructions a candidate that its class loop really has, read
     from the SASS of the built library by ``cuobjdump``); then the chain
     line: each phase's own seconds, where the serial chain (phases 1-h) and
     the trace chain (phase i's traces) end, ``os.cpu_count()``, each
     trace's seconds and the whole check's margin to its 1200 s limit.

The last line is ``{"ok": true, "device": {...}}``; the line before it holds
the card's name and power limit, and the one before that the kernel report.
Exits with code 2 and prints no result when CUDA is not available.

    python3 chip_smoke.py --turns OTHER_SRC

times the superstep, ``minplus``, ``edge_relax`` (at its three timed
shapes), ``seg_level`` and the steady sweeps of another tree (``OTHER_SRC`` is
its ``src`` directory) and of this one in turns on one card (see ``turns``).
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import itertools
import json
import math
import os
import pickle
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch.distributed.tensor import DTensor, Shard  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.core import ceft_reference, planners, random_machine  # noqa: E402
from repro_torch.core import ceft_torch as ct  # noqa: E402
from repro_torch.core.machine import Machine  # noqa: E402
from repro_torch.core.schedule import validate_schedule  # noqa: E402
from repro_torch.graphs import heavy_tail_fan_in, rgg, star_fan_in  # noqa: E402
from repro_torch.kernels import ops, probes  # noqa: E402
from repro_torch.kernels.ceft_relax import ceft_relax_plain  # noqa: E402
from repro_torch.kernels.edge_relax import (edge_relax_grid, edge_relax_plain,  # noqa: E402
                                            seg_level_grid, seg_level_plain)
from repro_torch.kernels.edge_relax_superstep import edge_relax_superstep_plain  # noqa: E402
from repro_torch.kernels.minplus import BIG, minplus_plain  # noqa: E402
from repro_torch.configs.base import ShapeCell  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.examples import (heterogeneous_pipeline, quickstart,  # noqa: E402
                                  serve_batched, train_100m)
from repro_torch.launch.dryrun import trace_step  # noqa: E402
from repro_torch.launch.mesh import make_test_mesh  # noqa: E402
from repro_torch.launch.roofline import HW, analyze_cell  # noqa: E402
from repro_torch.launch.pipeline import pipeline_forward  # noqa: E402
from repro_torch.launch.steps import (DecodeStep, PrefillStep, build_decode,  # noqa: E402
                                      build_prefill, build_train, input_shardings,
                                      ring_positions, seed_cache)
from repro_torch.models import build, transformer  # noqa: E402
from repro_torch.models import moe as moe_module  # noqa: E402
from repro_torch.models.common import init_params, tree_leaves, tree_to  # noqa: E402
from repro_torch.models.common import resolve_spec, sharding_profile, sorted_leaves  # noqa: E402
from repro_torch.models.layers import rmsnorm  # noqa: E402
from repro_torch.models.tensor_parallel import (hand_decode_flops,  # noqa: E402
                                                hand_prefill_flops, hand_train_flops)
from repro_torch.optim import grad_compress  # noqa: E402
from repro_torch.optim.adamw import tree_map_sorted  # noqa: E402
from repro_torch.optim.grad_compress import compressed_psum  # noqa: E402
from repro_torch.sched import PlanCache, StragglerMonitor, build_layer_dag, plancache  # noqa: E402
from repro_torch.serve import (Engine, EnginePool, EngineSlot, Request, Router,  # noqa: E402
                               ServeConfig,
                               WorkerSpec, null_engine_factory)
from repro_torch.serve.faults import KINDS, install_chaos  # noqa: E402
from repro_torch.substrate import (distribute, fake_store, gather_full, init_group,  # noqa: E402
                                   make_mesh)
from repro_torch.train import Trainer, TrainerConfig  # noqa: E402

# the card's published peaks (H100 SXM, dense, at 700 W): memory and float32
# outside the tensor cores from the data sheet; bf16 outside the tensor cores
# (packed pairs, twice the float32 rate) from NVIDIA's H100 white paper
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = {torch.float32: 67e12, torch.bfloat16: 133.8e12}
# float32 operations per relaxation candidate: divide, add, multiply, add, compare
OPS_PER_CANDIDATE = 5
# issue slots of one warp instruction per lane: 4 schedulers x 32 lanes an SM
LANES_PER_SM = 128
# instructions a superstep candidate needs at least: the divide (a multiply,
# two FMAs), add, multiply, add, a compare and two selects; a seg_level
# candidate one fewer (the multiply by off and the add are one exact FMA);
# minplus: an add
# and a min per (i, k, j) in float32, one packed pair of each per two in bf16
INSTR_PER_CANDIDATE = 9
INSTR_PER_SEG_CANDIDATE = 8
INSTR_PER_MINPLUS_TRIPLE = {torch.float32: 2.0, torch.bfloat16: 1.0}

EDGE_SHAPES = [(5, 3), (128, 16), (300, 7), (1, 1), (257, 13), (64, 64)]
# edge_relax past the 240 classes its kernel once held whole in shared memory,
# up to and past the widest staged launch (P = 2048, then one thread per
# output), and batches of planes each with its own machine
EDGE_WIDE_CASES = [((9, 241), None), ((40, 256), None), ((5, 300), None), ((6, 2048), None),
                   ((3, 2049), None), ((100, 241), 8), ((1029, 64), 8), ((77, 32), 3)]
# tie-heavy and constant rows through edge_relax (probes.edge_ties)
EDGE_TIE_SHAPES = [(1024, 64), (2048, 64), (300, 7), (257, 13), (40, 256), (100, 8)]
# edge_relax's timed shapes (E, P, B): phase a's two level widths, and a batch
# of 8 planes
EDGE_TIMED = [(1024, 64, 1), (2048, 64, 1), (1024, 64, 8)]
CELL_SHAPES = [(8, 3, 4), (5, 1, 2), (16, 7, 13), (33, 9, 64), (64, 2, 128), (1, 1, 1)]
EDGE_PATH_SHAPES = [(1024, 64), (2048, 64)]
CELL_PATH_SHAPES = [(1, 4096, 64), (8, 28, 64)]
# tie-heavy dense relaxations, most with fan-ins the kernel splits across blocks
CELL_TIE_CASES = [((1, 4096, 64), "ties"), ((1, 4096, 8), "ties"), ((2, 1000, 128), "ties"),
                  ((3, 300, 64), "constant"), ((8, 28, 64), "ties"), ((5, 40, 8), "constant"),
                  ((4, 700, 64), "invalid_rows"), ((6, 90, 8), "invalid_rows"),
                  ((1, 33, 128), "invalid_rows")]
# fused segment levels: (B, P, segment lengths or (count, longest), padded
# edges, padded segment slots); the kernel's edge tile is 4 to 128 edges
# (seg_level_grid); p8, p16, p32 take those instances, p24, p128 and p200
# the run-time P, tiles has the n = 16384 graph's segment lengths over many
# 16-edge tiles
SEG_CASES = {"long": (1, 64, [3, 3000, 1, 40], 0, 0), "crossing": (2, 8, (60, 300), 5, 0),
             "single": (1, 64, [500], 12, 0), "padded": (1, 16, (30, 90), 17, 3),
             "batch8": (8, 64, (100, 12), 600, 0), "p128": (2, 128, (12, 40), 1, 2),
             "p8": (3, 8, (50, 40), 2, 1), "p16": (1, 16, (70, 30), 0, 0),
             "p32": (2, 32, (40, 25), 4, 2), "p24": (2, 24, (30, 20), 3, 1),
             "p200": (1, 200, (6, 12), 0, 1), "tiles": (1, 64, (130, 15), 0, 0)}
# the divide probe's levels through seg_level (16384 single-edge segments)
SEG_DIVIDE_LEVELS = 16
SUPERSTEP_SHAPES = [(1, 5, 3), (4, 128, 16), (3, 300, 7), (2, 64, 64), (1, 1, 1)]
# the superstep's other instances: P = 8 and 32 (E not a multiple of the
# edge tile), the run-time-P instance above 64, and the wide-machine kernel
SUPERSTEP_WIDTHS = [(3, 300, 8), (5, 100, 32), (2, 70, 128), (2, 9, 161), (2, 40, 200),
                    (1, 17, 240)]
SHAPES_MINPLUS = [(4, 3, 5), (128, 16, 128), (300, 37, 260), (1, 1, 1),
                  (257, 129, 255), (16, 256, 16)]
MINPLUS_PATH_SHAPE = (4096, 4096, 4096)
# NaN, inf and -0.0 probes (probes.SPECIAL_MODES in each)
EDGE_NAN_SHAPES = [(64, 64), (1024, 64), (64, 300), (8, 2049)]
CELL_NAN_SHAPES = [(3, 33, 64), (1, 4096, 64), (2, 1000, 8)]
SUPERSTEP_NAN_SHAPES = [(3, 40, 7), (2, 64, 64), (12, 2048, 64)] + SUPERSTEP_WIDTHS
MINPLUS_NAN_SHAPES = [(4, 3, 5), (300, 37, 260), (256, 256, 256)]
# tie-heavy superstep tables ("ties", "constant") and the divide probe's
# levels per bw kind (1024 edges each at P = 64: 2^26 quotients in all)
SUPERSTEP_TIE_SHAPES = [(4, 128, 16), (3, 300, 7), (158, 1024, 64)] + SUPERSTEP_WIDTHS
DIVIDE_LEVELS = 256
MINPLUS_DTYPES = (torch.float32, torch.bfloat16)
# the serving router's largest configuration (benchmarks/serve_router.py, pool8)
POOL_P, POOL_CLASSES, POOL_NEW, POOL_PER_CLASS, POOL_ROUNDS = 8, 6, 8, 32, 4
# phase e: the LM serving path at the launcher's default model, granite-3-8b;
# e1 at 2 of its 40 layers (B, prompt, new tokens, teacher-forced steps), e2
# as published behind the router (prompt length per tenant, requests each)
LM_ARCH, LM_SEED = "granite-3-8b", 0
E1_LAYERS, E1_B, E1_P, E1_NEW, E1_FORCED = 2, 2, 64, 16, 8
E2_PROMPTS, E2_PER_TENANT, E2_NEW, E2_BATCH, E2_ROUNDS = (512, 256), 4, 32, 4, 2
# phase f: the SSM serving path at mamba2-2.7b's published widths; f1 at 2 of
# its 64 layers (prompts of one whole chunk and of a padded one), f2 as
# published behind the router with e2's traffic; f3 jamba at smoke size and
# whisper-tiny as published (prompt, teacher-forced decode steps)
SSM_ARCH, F1_LAYERS, F1_PROMPTS = "mamba2-2.7b", 2, (64, 100)
HYBRID_ARCH, ENCDEC_ARCH, F3_P, F3_STEPS = "jamba-v0.1-52b", "whisper-tiny", 16, 8
# phase g: training at minicpm-2b's published widths; g1 at 2 of its 40
# layers, one step card against CPU (B, S); g2 all 40 layers, train_4k's
# sequence with its global batch of 256 cut to 2 for one card, steps; g3 the
# Trainer loop at the smoke config (steps, failure step, straggler steps)
TRAIN_ARCH, G1_LAYERS, G1_B, G1_S = "minicpm-2b", 2, 2, 128
G2_B, G2_S, G2_STEPS, G2_PEAK_LR = 2, 4096, 5, 3e-4
G3_STEPS, G3_FAIL, G3_SLOW = 8, 6, {6: (0, 2.5), 7: (0, 2.5), 8: (0, 2.5)}
# phase h: the distribution substrate; h1 g2's model, seed and batches through
# the meshed step (steps); h2 the GPipe forward at granite-3-8b's widths cut to
# 8 layers over 4 pipe ranks sharing the card (microbatches, B, S, seed); h3
# compressed_psum over 2 pod ranks, 64 MiB of float32 each, and 50 rounds of
# error feedback; h4 is g3 on a mesh
H1_STEPS = 2
H2_LAYERS, H2_STAGES, H2_MICRO, H2_B, H2_S, H2_SEED = 8, 4, 4, 8, 512, 11
H3_PODS, H3_NUMEL, H3_ROUNDS, H3_SEED = 2, 16 * 2**20, 50, 13
# h5 the dense tensor-parallel step at granite-3-8b's widths cut to 2 layers,
# (B, S), on a (data 1, model 4) mesh of 4 gloo ranks sharing the card;
# the first step compared with the one-device step, the second timed
H5_LAYERS, H5_B, H5_S, H5_MESH, H5_SEED, H5_STEPS = 2, 2, 4096, (1, 4), 17, 2
H5_BOUNDS = {"float32": (1e-5, 1e-4), "bfloat16": (5e-2, 5e-2)}  # loss, grad norm (g1's)
# h6 the encoder-decoder's planned step on h1's (data 1, model 1) mesh:
# whisper-tiny as published (its encoder's frames seeded normal), (B, S),
# steps against the one-device step
H6_ARCHS, H6_B, H6_S, H6_SEED = (("whisper-tiny", False),), 2, 4096, 19
# h7 the dense family's sharded prefill and decode at granite-3-8b's widths
# cut to H5_LAYERS layers on 4 gloo ranks sharing the card, each mesh under its
# profile: (B, prompt) prefilled, moved into a cache of H7_CACHE positions,
# then H7_NEW greedy tokens, float32 with TF32 off, against the one-device
# steps on the card from the same seeded weights (logits within H7_RTOL)
H7_MESHES = (((1, 4), "baseline"), ((2, 2), "serve"))
H7_B, H7_P, H7_CACHE, H7_NEW, H7_SEED, H7_RTOL = 4, 512, 1024, 16, 23, 1e-5
# phase x: the reference's examples on the card (repro_torch.examples): x1
# quickstart (host work), x2 heterogeneous_pipeline's plans once and its
# straggler on the card and on the CPU, x3 serve_batched in float32 on the
# card against the CPU (weights made on the CPU from X3_SEED; teacher-forced
# on the CPU run's tokens), x4 train_100m at full width with its arguments,
# restoring from the checkpoint of step X4_RESTORE
X3_SEED = 71
X4_ARGS, X4_FAIL, X4_RESTORE = ("--steps", "60"), 55, 50
# h8 the MoE family's train step at mixtral-8x22b's published widths cut to
# H8_LAYERS layers, (B, S), on 4 gloo ranks sharing the card, each mesh under
# its profile: (1, 4) baseline (2 of the 8 experts a rank) and (data, expert,
# tp) = (1, 2, 2) under moe_ep; the first step against the one-device step at
# h5's bounds, float32 (TF32 off) and bf16, every expert choice that differs
# from the one-device step's at a router probability gap (its K-th largest
# less its (K+1)-th) below H8_GAP; h9 the sharded prefill of a (H9_B, H9_P)
# prompt longer than the 4096-token window (20 groups of 256), seed_cache
# into the ring and H9_NEW greedy tokens on the same meshes, float32, logits
# within H7_RTOL of the one-device steps and tokens identical
H8_ARCH, H8_LAYERS, H8_B, H8_S, H8_SEED, H8_GAP = "mixtral-8x22b", 1, 2, 4096, 29, 1e-5
H8_STEPS = 1
H8_MESHES = (((1, 4), ("data", "model"), "baseline"),
             ((1, 2, 2), ("data", "expert", "tp"), "moe_ep"))
H9_B, H9_P, H9_NEW, H9_SEED = 1, 5120, 16, 31
# h18 h8's train step and h9's prefill and decode (the same seeds and
# inputs; h9's one-device references) on a (2, 2) mesh under serve: the
# experts on model, their hidden columns on what the experts leave of (model,
# data), the tokens replicated over data and the sequence whole.  The train
# step runs at (H18_B, H8_S) against one-device references of its own: at
# h8's (2, 4096) the CPU dry-run's trace of a rank's step predicted 18.46 GB
# in float32 (73.8 GB for the four), and the four ranks ran out of the card's
# 79.18 GiB in the backward (NVIDIA H100 80GB HBM3, 700 W); at (1, 4096) it
# predicts 16.46 GB a rank
H18_MESHES, H18_B = (((2, 2), ("data", "model"), "serve"),), 1
# h10 the SSM family's head-parallel train step at mamba2-2.7b's published
# widths cut to H10_LAYERS layers, (B, S), on a (data 1, model 4) mesh of 4
# gloo ranks sharing the card (20 of the 80 heads a rank, 2644 of in_proj's
# 10576 columns), step 1 against the one-device step run first and freed, at
# h5's bounds in float32 (TF32 off) and bf16; h11 its sharded prefill of a
# (H11_B, H11_P) prompt (15 chunks of 64 and a ragged one), seed_cache and
# H11_NEW greedy tokens on each of H7_MESHES, float32, logits within H7_RTOL
# of the one-device steps and tokens identical
H10_ARCH, H10_LAYERS, H10_B, H10_S, H10_MESH, H10_SEED = "mamba2-2.7b", 2, 2, 4096, (1, 4), 37
H11_B, H11_P, H11_NEW, H11_SEED = 4, 1000, 16, 41
# h12 the hybrid's train step at jamba-v0.1-52b's published widths cut to
# H12_LAYERS layers, one (attention, MLP) and one (SSM, MoE) layer as jamba
# pairs them (H12_CUT; one real period of 8 layers holds about 51.5 GB of
# float32 weights), (B, S), on a (data 1, model 4) mesh of 4 gloo ranks
# sharing the card (8 of the 32 q heads, 4 of the 16 experts, 32 of the 128
# SSM heads a rank), step 1 against the one-device step run first and
# freed, at h5's bounds in float32 (TF32 off) and bf16, with h8's
# routing-gap rule; h13 its sharded prefill of a (H13_B, H13_P) prompt (a
# whole number of the MoE block's 256-token groups, as the reference's
# routing needs), seed_cache into H13_P + H13_NEW positions and H13_NEW
# greedy tokens on each of H7_MESHES, float32, logits within H7_RTOL beyond
# the one-device prefill's spread (SPREAD_BOUND) and tokens identical
H12_ARCH, H12_LAYERS, H12_B, H12_S, H12_MESH, H12_SEED = "jamba-v0.1-52b", 2, 1, 4096, (1, 4), 43
H12_CUT = dict(attn_every=2, attn_pos=0, moe_every=2)
H13_B, H13_P, H13_NEW, H13_SEED = 4, 1024, 16, 47
# h14 the VLM's train step at qwen2-vl-72b's published widths cut to
# H14_LAYERS layer, (B, S), fed seeded embeds and the (3, B, S) positions of
# an image grid (frames of GRID x GRID patches: the temporal, row and column
# ids differ, so every M-RoPE section turns), on h12's mesh at h5's bounds;
# h15 its sharded prefill from (H15_B, H15_P) embeds, seed_cache and H15_NEW
# greedy tokens with (3, B, 1) positions on each of H7_MESHES
H14_ARCH, H14_LAYERS, H14_B, H14_S, H14_SEED = "qwen2-vl-72b", 1, 2, 4096, 53
H15_B, H15_P, H15_NEW, H15_SEED = 4, 1000, 16, 59
GRID = 32
# h16 the encoder-decoder's planned train step at whisper-tiny as published
# (4 + 4 layers, d 384, 6 heads, a vocabulary of 51865, 1500 frames), (B, S)
# tokens and (B, 1500, 384) frames seeded normal, on (1, 4) baseline (the 6
# heads and the vocabulary whole, 375 frames a rank) and (2, 2) serve, at
# h5's bounds in float32 (TF32 off) and bf16, one step; h17 its sharded
# prefill of (H17_B, H17_P) tokens with their frames, seed_cache into
# H17_P + H17_NEW positions (the cross cache carried) and H17_NEW greedy
# tokens on each of H7_MESHES and on (2, 2) under baseline (PHASE_MESHES),
# float32, logits within H7_RTOL of the one-device steps and tokens identical
H16_ARCH, H16_B, H16_S, H16_SEED = "whisper-tiny", 2, 4096, 61
H16_MESHES = (((1, 4), "baseline"), ((2, 2), "serve"))
H17_B, H17_P, H17_NEW, H17_SEED = 4, 1000, 16, 67
# the planned train and serving phases: (arch, layers, B, S, meshes: (shape,
# profile) each, seed) and (arch, layers, B, prompt, cache positions, new
# tokens, seed); the config changes beside the depth; the train phases that
# hold step 1's loss and grad norm without the AdamW update (with the
# float32 moments neither the one-device step nor 4 ranks of h12 fit the
# card: the dry-run's trace of each takes 81.3 GB of arguments and temp; the
# update is h5's, h8's, h10's and h16's ``AdamW.apply`` on each rank's
# shards), and the steps of the others (H5_STEPS where not named)
TRAIN_PHASES = {"h5": (LM_ARCH, H5_LAYERS, H5_B, H5_S, ((H5_MESH, "baseline"),), H5_SEED),
                "h10": (H10_ARCH, H10_LAYERS, H10_B, H10_S, ((H10_MESH, "baseline"),),
                        H10_SEED),
                "h12": (H12_ARCH, H12_LAYERS, H12_B, H12_S, ((H12_MESH, "baseline"),),
                        H12_SEED),
                "h14": (H14_ARCH, H14_LAYERS, H14_B, H14_S, ((H12_MESH, "baseline"),),
                        H14_SEED),
                "h16": (H16_ARCH, configs.get(H16_ARCH).n_layers, H16_B, H16_S, H16_MESHES,
                        H16_SEED)}
SERVE_PHASES = {"h7": (LM_ARCH, H5_LAYERS, H7_B, H7_P, H7_CACHE, H7_NEW, H7_SEED),
                "h11": (H10_ARCH, H10_LAYERS, H11_B, H11_P, H11_P + H11_NEW, H11_NEW, H11_SEED),
                "h13": (H12_ARCH, H12_LAYERS, H13_B, H13_P, H13_P + H13_NEW, H13_NEW, H13_SEED),
                "h15": (H14_ARCH, H14_LAYERS, H15_B, H15_P, H15_P + H15_NEW, H15_NEW, H15_SEED),
                "h17": (H16_ARCH, configs.get(H16_ARCH).n_layers, H17_B, H17_P, H17_P + H17_NEW,
                        H17_NEW, H17_SEED)}
# h19 one row a phase on H19_MESHES, whose decode plan keeps every weight on
# its data shard: h11's model and seed (its prompt the first of h11's, of
# H19_P tokens) and h13's (the first of h13's prompts: H13_P tokens, whole
# 256-token MoE groups), prefill, seed_cache and H19_NEW greedy tokens,
# float32, at h11's and h13's bounds (the hybrid's spread: the row alone
# against the row in a batch of H13_B)
H19_MESHES = (((2, 2), "baseline"),)
H19_P, H19_NEW = 1000, 16
SERVE_PHASES.update({
    "h19-mamba2": (H10_ARCH, H10_LAYERS, 1, H19_P, H19_P + H19_NEW, H19_NEW, H11_SEED),
    "h19-jamba": (H12_ARCH, H12_LAYERS, 1, H13_P, H13_P + H19_NEW, H19_NEW, H13_SEED)})
# h17 adds the baseline on (2, 2): its 4 rows split over data, so the decode
# plan keeps both tables on their data shards and trades the rows for their
# columns, and 51865 divides neither axis (the logits' columns uneven)
PHASE_MESHES = {"h19-mamba2": H19_MESHES, "h19-jamba": H19_MESHES,
                "h17": H7_MESHES + (((2, 2), "baseline"),)}
PHASE_CUTS = {"h12": H12_CUT, "h13": H12_CUT, "h19-jamba": H12_CUT}
GRADS_ONLY = ("h12", "h14")
TRAIN_STEPS = {"h16": 1}
# each serving phase's one-device prefill also runs row by row: the float32
# spread of the same function batched otherwise (the products' reduction
# order follows the batch's shape), printed beside the sharded steps'
# errors.  h13's logits are held within H7_RTOL beyond that spread: at the
# hybrid's widths the spread alone is 9.5e-6 (granite's at h7's 4.9e-6,
# mamba2's 2.9e-6, qwen2-vl's 2.2e-6; NVIDIA H100 80GB HBM3, 700 W), so no
# other order of the same float32 sums is held to H7_RTOL itself
SPREAD_BOUND = ("h13", "h19-jamba")
# the phases one group of 4 gloo ranks spawned on the card runs in turn (h2's
# pipe, then the planned train and serving phases), each rank's memory freed
# between them; the one-device references run first, each freed
GROUP_PHASES = ("h2", "h5", "h7", "h8", "h10", "h11", "h12", "h13", "h14", "h15", "h16", "h17",
                "h18", "h19-mamba2", "h19-jamba")
GROUP_WORLD, GROUP_TIMEOUT_S = 4, 1000
# the parent tree's seconds of the group's phases that run whisper-tiny's
# unsplit heads (each phase's slowest rank) and of their one-device
# references, the two phases alone on a group of 4 gloo ranks on an H100
# 80GB HBM3 at 700 W (PERF.md, section 6)
H_PARENT_S = {"h16": 47.5, "h17": 34.0}
H_PARENT_REF_S = {"h16": 14.7, "h17": 0.8}
# bytes the AdamW update moves a float32 parameter: parameter, gradient and
# both moments read, parameter and moments written
ADAMW_BYTES_PER_PARAM = 28
# the tensor cores' dense bf16 peak (the LM's products run in bf16)
BF16_TENSOR_OPS_PER_S = 989e12
# phase i: i1's bound on the predicted peak's error against g2's measured
# one, and on its traced FLOPs over g2's hand count (the trace runs every
# masked attention tile, the hand count the causal half: 1.079 at g2's
# cell); e2's decode cell (its prompt plus its new tokens); i3's production
# cell and the longest its trace may take
I1_MEMORY_RTOL = 0.15
I1_FLOPS_OVER_HAND = (1.0, 1.10)
I2_DECODE_CACHE = E2_PROMPTS[0] + E2_NEW
I3_ARCH, I3_CELL, I3_MESH = "granite-3-8b", "train_4k", "single"
I3_TIMEOUT_S = 600
# i3 beside the reference's XLA compile count of the same cell on 256 fake
# host devices (python -m repro.launch.dryrun --arch granite-3-8b --cell
# train_4k --mesh single, on the CPU; jax 0.4.37 and 0.9.0 give the same
# temp): its temp, its collective bytes a device (each op weighted by its
# loops' trips, an all-reduce twice its result) and the collective ops of
# its HLO by kind (each op once, not its executions); and the port's ZeRO-3
# trace of the cell before the dense family's step went tensor-parallel
# (product FLOPs)
I3_REFERENCE_TEMP_BYTES = 15_465_583_616
I3_REFERENCE_COLLECTIVE_BYTES = 546_732_035_224
I3_REFERENCE_COLLECTIVE_OPS = {"all-gather": 55, "all-reduce": 14, "collective-permute": 14,
                               "all-to-all": 12}
I3_ZERO3_FLOPS = 4.7125e15
# i4 the dense family's sharded serving cells of granite-3-8b on the same mesh
# and fleet, each through the dry-run's command line in a process of its own
# beside i3: decode_32k as published, prefill_32k cut to 4 of its 40 layers
# (the whole depth traces for about 20 minutes on a CPU; PERF.md records that
# run), its collective bytes and its argument + temp + output bound scaled by
# 4/40.  Beside the reference's XLA compile counts of each cell on 256 fake
# host devices (python -m repro.launch.dryrun --arch granite-3-8b --cell
# <cell> --mesh single, on the CPU, jax 0.9.0): argument, temp and output
# bytes a device, collective bytes a device (each op weighted by its loops'
# trips, an all-reduce twice its result) and its HLO's collective ops by kind;
# and the port's gathering decode step's figures of decode_32k before the
# dense family's serving was sharded (its dry-run, the same command)
I4_CELLS = (("decode_32k", 0), ("prefill_32k", 4))
I4_REFERENCE = {
    "decode_32k": dict(argument=2_910_869_540, temp=5_664_096_168, output=2_685_927_584,
                       collective=2_096_794_848,
                       ops={"all-gather": 18, "all-reduce": 7, "collective-permute": 4,
                            "all-to-all": 1}),
    "prefill_32k": dict(argument=226_531_328, temp=3_619_734_528, output=5_704_646_704,
                        collective=140_338_135_088,
                        ops={"all-gather": 17, "all-to-all": 2, "all-reduce": 2,
                             "collective-permute": 1}),
}
I4_TEMP_OVER_REFERENCE = 2.0
I4_COLLECTIVE_OVER_REFERENCE = {"decode_32k": 1.0, "prefill_32k": 1.0}
I4_GATHERED_DECODE = dict(temp=1_429_351_793_152, collective=765_624_156_672, flops=4.84e12)
# i5 the MoE family's production cells on the same fleet, each through the
# dry-run's command line in a process of its own, queued (at low priority)
# at the check's start and read in phase i: (arch, cell, mesh kind, profile,
# layers: 0 as published); the train cells trace whole in 80-130 s on a
# CPU, the prefill cell is cut to 4 of its 40 layers (the whole depth
# traces for about 20 minutes; PERF.md records that CPU run), its
# collective bytes and argument + temp + output bound scaled by the share
# of the layers (a trace still running I5_TIMEOUT_S after the start is
# killed and fails).  Beside the reference's XLA
# compile counts of each whole cell on 256 fake host devices (python -m
# repro.launch.dryrun --arch <arch> --cell <cell> --mesh <mesh> [--profile
# moe_ep], on the CPU, jax 0.9.0): argument, temp and output bytes a device,
# collective bytes a device and its HLO's collective ops by kind; the port's
# figures before the MoE family was sharded (its ZeRO-3 train step and
# gathering decode step through the same dry-run: temp and collective bytes)
I5_CELLS = (("dbrx-132b", "decode_32k", "single", "baseline", 0),
            ("mixtral-8x22b", "decode_32k", "moe", "moe_ep", 0),
            ("dbrx-132b", "train_4k", "single", "baseline", 0),
            ("mixtral-8x22b", "train_4k", "moe", "moe_ep", 0),
            ("mixtral-8x22b", "train_4k", "single", "baseline", 0),
            ("dbrx-132b", "prefill_32k", "single", "baseline", 4))
I5_TIMEOUT_S = 900
I5_REFERENCE = {
    ("dbrx-132b", "train_4k", "single"): dict(
        argument=6_174_568_452, temp=31_441_918_240, output=6_174_536_028,
        collective=834_085_307_176,
        ops={"all-gather": 61, "all-reduce": 18, "collective-permute": 12, "all-to-all": 19}),
    ("mixtral-8x22b", "train_4k", "moe"): dict(
        argument=6_883_610_628, temp=26_249_517_384, output=6_883_578_204,
        collective=1_347_127_616_576,
        ops={"all-gather": 70, "all-reduce": 23, "collective-permute": 22, "all-to-all": 20}),
    ("mixtral-8x22b", "train_4k", "single"): dict(
        argument=6_602_301_444, temp=37_186_229_736, output=6_602_269_020,
        collective=2_415_047_197_736,
        ops={"all-gather": 64, "all-reduce": 17, "collective-permute": 12, "all-to-all": 12}),
    ("dbrx-132b", "decode_32k", "single"): dict(
        argument=4_742_533_156, temp=6_866_211_968, output=2_684_555_328,
        collective=32_820_509_216,
        ops={"all-gather": 24, "all-reduce": 9, "collective-permute": 3, "all-to-all": 1}),
    ("mixtral-8x22b", "decode_32k", "moe"): dict(
        argument=2_764_288_036, temp=2_018_643_264, output=469_827_648,
        collective=35_185_096_704,
        ops={"all-gather": 23, "all-reduce": 10, "collective-permute": 2}),
    ("dbrx-132b", "prefill_32k", "single"): dict(
        argument=2_058_194_944, temp=4_223_010_392, output=5_704_303_640,
        collective=200_090_664_960,
        ops={"all-gather": 19, "all-to-all": 5, "all-reduce": 3, "collective-permute": 2}),
}
I5_BEFORE = {
    ("dbrx-132b", "train_4k", "single"): dict(temp=1_428_782_604_316,
                                               collective=592_186_622_176),
    ("mixtral-8x22b", "train_4k", "moe"): dict(temp=1_536_131_162_140,
                                                collective=640_441_565_512),
    ("dbrx-132b", "decode_32k", "single"): dict(temp=1_922_248_475_136,
                                                 collective=1_289_427_550_720),
    ("mixtral-8x22b", "decode_32k", "moe"): dict(temp=932_958_437_888,
                                                  collective=730_872_316_416),
}
I5_COLLECTIVE_OVER_REFERENCE = {"train": 1.0, "prefill": 1.0, "decode": 1.0}
# i6 the SSM family's production cells on the same fleet, mamba2-2.7b as
# published on the (16, 16) mesh under the baseline profile, each through
# the dry-run's command line in a process of its own queued (at low
# priority) at the check's start and read in phase i.  Beside the reference's XLA
# compile counts of each cell on 256 fake host devices (python -m
# repro.launch.dryrun --arch mamba2-2.7b --cell <cell> --mesh single, on the
# CPU, jax 0.9.0): argument, temp and output bytes a device, collective
# bytes a device and its HLO's collective ops by kind; and the port's
# figures before the SSM family was sharded (its ZeRO-3 train step and
# gathering serving steps through the same dry-run, torch 2.13 on the CPU:
# temp, collective bytes a device and product FLOPs).  long_500k's one row
# leaves the weights on their data shards and moves the token, as XLA
# partitions the reference's step; its collective bytes are held to at most
# 1 / I_LONG_UNDER_PARENT of the parent tree's, whose decode gathered every
# weight over data (I_LONG_PARENT_COLLECTIVE: its dry-run on the card's host)
I6_ARCH, I6_MESH = "mamba2-2.7b", "single"
I6_CELLS = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
I6_REFERENCE = {
    "train_4k": dict(argument=220_832_772, temp=10_669_434_640, output=220_800_300,
                     collective=588_400_059_536,
                     ops={"all-gather": 44, "all-reduce": 10, "collective-permute": 38,
                          "all-to-all": 1}),
    "prefill_32k": dict(argument=73_616_384, temp=4_432_646_568, output=340_075_352,
                        collective=184_007_249_920,
                        ops={"all-gather": 14, "collective-permute": 12, "all-reduce": 1}),
    "decode_32k": dict(argument=158_518_304, temp=66_428_720, output=86_527_296,
                       collective=694_567_456,
                       ops={"all-gather": 5, "collective-permute": 54, "all-reduce": 3,
                            "all-to-all": 1}),
    "long_500k": dict(argument=84_214_788, temp=402_672, output=10_815_940,
                      collective=1_548_616,
                      ops={"all-gather": 3, "all-reduce": 6, "collective-permute": 54}),
}
I6_BEFORE = {
    "train_4k": dict(temp=73_442_620_224, collective=12_145_947_840, flops=1.3611e15),
    "prefill_32k": dict(temp=364_111_561_036, collective=11_456_954_368, flops=5.6141e15),
    "decode_32k": dict(temp=76_840_518_144, collective=34_550_268_416, flops=7.0238e11),
    "long_500k": dict(temp=21_233_336_320, collective=11_622_334_464, flops=5.4873e9),
}
I6_COLLECTIVE_OVER_REFERENCE = {"train_4k": 1.0, "prefill_32k": 1.0, "decode_32k": 1.0}
I_LONG_UNDER_PARENT = 50
I_LONG_PARENT_COLLECTIVE = {"mamba2-2.7b": 586_402_304, "jamba-v0.1-52b": 6_507_602_912}
# i7 the hybrid's and the VLM's production cells on the same fleet, each
# through the dry-run's command line in a process of its own queued (at low
# priority) at the check's start and read in phase i: (arch, cell, layers: 0 as
# published); jamba-v0.1-52b's four cells and qwen2-vl-72b's train_4k and
# decode_32k as published, its prefill_32k cut to 8 of its 80 layers (the
# share of i4's and i5's cuts: the whole depth traces for far longer than
# the check's limit), its collective bytes and argument + temp + output bound
# scaled by the share.  Beside the reference's XLA compile counts of each
# whole cell on 256 fake host devices (python -m repro.launch.dryrun --arch
# <arch> --cell <cell> --mesh single, on the CPU, jax 0.9.0): argument, temp
# and output bytes a device, collective bytes a device and its HLO's
# collective ops by kind; and the port's figures before the two families were
# planned (their ZeRO-3 train step and gathering decode step through the same
# dry-run, torch 2.13 on the CPU: temp, collective bytes a device, argument +
# temp + output and product FLOPs).  long_500k's as i6's
I7_CELLS = (("jamba-v0.1-52b", "train_4k", 0), ("jamba-v0.1-52b", "prefill_32k", 0),
            ("jamba-v0.1-52b", "decode_32k", 0), ("jamba-v0.1-52b", "long_500k", 0),
            ("qwen2-vl-72b", "train_4k", 0), ("qwen2-vl-72b", "decode_32k", 0),
            ("qwen2-vl-72b", "prefill_32k", 8))
I7_REFERENCE = {
    ("jamba-v0.1-52b", "train_4k"): dict(
        argument=2_416_502_052, temp=60_304_109_008, output=2_416_471_884,
        collective=226_279_220_456,
        ops={"collective-permute": 179, "all-gather": 359, "all-reduce": 17, "all-to-all": 35}),
    ("jamba-v0.1-52b", "prefill_32k"): dict(
        argument=805_506_144, temp=10_650_156_504, output=602_581_640,
        collective=68_398_020_096,
        ops={"all-gather": 148, "collective-permute": 78, "all-to-all": 8, "all-reduce": 2}),
    ("jamba-v0.1-52b", "decode_32k"): dict(
        argument=1_081_956_100, temp=4_492_712_376, output=276_597_552,
        collective=12_819_921_184,
        ops={"all-gather": 76, "collective-permute": 365, "all-reduce": 36, "all-to-all": 1}),
    ("jamba-v0.1-52b", "long_500k"): dict(
        argument=1_343_364_536, temp=1_506_059_136, output=537_891_300,
        collective=3_800_840, ops={"all-reduce": 73, "collective-permute": 380, "all-gather": 33}),
    ("qwen2-vl-72b", "train_4k"): dict(
        argument=3_558_113_284, temp=36_135_048_128, output=3_423_830_340,
        collective=2_404_379_902_104,
        ops={"collective-permute": 11, "all-gather": 56, "all-reduce": 13, "all-to-all": 12}),
    ("qwen2-vl-72b", "decode_32k"): dict(
        argument=6_509_985_924, temp=11_449_021_416, output=5_369_013_312,
        collective=18_062_894_880,
        ops={"all-gather": 22, "collective-permute": 3, "all-reduce": 7, "all-to-all": 1}),
    ("qwen2-vl-72b", "prefill_32k"): dict(
        argument=1_256_079_360, temp=7_584_351_232, output=11_408_582_936,
        collective=664_458_690_560,
        ops={"all-gather": 16, "all-to-all": 2, "all-reduce": 2, "collective-permute": 1}),
}
I7_BEFORE = {
    ("jamba-v0.1-52b", "train_4k"): dict(temp=889_963_029_048, collective=231_581_853_888,
        total=894_796_000_392, flops=7.0091e+15),
    ("jamba-v0.1-52b", "decode_32k"): dict(temp=346_600_130_560, collective=293_902_315_520,
        total=347_992_107_904, flops=1.3381e+13),
    ("jamba-v0.1-52b", "long_500k"): dict(temp=233_073_818_624, collective=227_309_476_608,
        total=234_955_320_072, flops=1.3675e+11),
    ("qwen2-vl-72b", "train_4k"): dict(temp=906_404_331_544, collective=329_327_378_640,
        total=913_386_274_856, flops=3.7740e+16),
    ("qwen2-vl-72b", "decode_32k"): dict(temp=3_082_545_006_592, collective=1_769_281_161_216,
        total=3_094_501_558_912, flops=2.9288e+13),
}
I7_COLLECTIVE_OVER_REFERENCE = {"train": 1.0, "prefill": 1.0, "decode": 1.0}
I6_TRAIN_FLOPS_UNDER_BEFORE = 12
# i8 the encoder-decoder's production cells on the same fleet: whisper-tiny's
# train_4k, prefill_32k and decode_32k as published on (16, 16) under the
# baseline profile, each through the dry-run's command line in a process of
# its own queued (at low priority) at the check's start and read in phase i.  Beside
# the reference's XLA compile counts of each cell on 256 fake host devices
# (python -m repro.launch.dryrun --arch whisper-tiny --cell <cell> --mesh
# single, on the CPU, jax 0.9.0): argument, temp and output bytes a device,
# collective bytes a device and its HLO's collective ops by kind; the port's
# figures before the family was planned (its ZeRO-3 train step and gathering
# serving steps through the same dry-run, torch 2.13 on the CPU: argument +
# temp + output, temp, collective bytes a device, product FLOPs); and the
# planned steps' counts of the same command on the CPU (the card's host, each
# period's blocks gathered where it runs, each rank attending with every head
# of its query slice), which the card's host must print
# to the byte.  decode_32k's 128 rows split over data: its tables stay on
# their data shards (the rows traded for their columns by an all-to-all),
# its q / k / v weights keep their model columns and its logits are never
# gathered, as XLA partitions the reference's step (Queue 1 item 5 of
# ROADMAP.md, closed), so its collective bytes are held to the reference's,
# and below a hundredth of the gathering step's with its temp below 1 GB
I8_ARCH = "whisper-tiny"
I8_CELLS = ("train_4k", "prefill_32k", "decode_32k")
I8_REFERENCE = {
    "train_4k": dict(argument=67_646_532, temp=15_489_875_632, output=30_750_396,
                     collective=42_046_598_656,
                     ops={"collective-permute": 14, "all-gather": 93, "all-reduce": 23,
                          "all-to-all": 1}),
    "prefill_32k": dict(argument=14_874_304, temp=631_274_640, output=223_540_464,
                        collective=2_749_120_912,
                        ops={"all-gather": 34, "all-reduce": 4, "collective-permute": 1}),
    "decode_32k": dict(argument=184_498_404, temp=380_911_104, output=176_051_056,
                       collective=10_438_848,
                       ops={"all-gather": 16, "all-reduce": 8, "all-to-all": 4,
                            "collective-permute": 2}),
}
I8_BEFORE = {
    "train_4k": dict(total=28_865_277_864, temp=28_766_881_560, collective=244_197_472,
                     flops=2.7067e13),
    "prefill_32k": dict(total=23_500_091_200, temp=16_741_215_232, collective=307_702_784,
                        flops=2.4303e14),
    "decode_32k": dict(total=54_135_539_936, temp=53_749_952_000, collective=28_789_583_360,
                       flops=3.4593e10),
}
I8_CPU = {
    "train_4k": dict(total=4_740_720_296, temp=4_642_323_992, collective=2_980_890_096,
                     flops=2_694_567_690_240),
    "prefill_32k": dict(total=743_201_160, temp=684_314_112, collective=796_706_304,
                        flops=1_107_587_667_456),
    "decode_32k": dict(total=410_611_424, temp=51_474_624, collective=1_644_096, flops=202_567_680),
}
I8_COLLECTIVE_OVER_REFERENCE = {"train_4k": 1.0, "prefill_32k": 1.0, "decode_32k": 1.0}
I8_DECODE_OVER_BEFORE, I8_DECODE_TEMP = 0.01, 1e9
# i9 the one production cell whose q heads do not split the model axis:
# minicpm-2b's train_4k (36 heads on 16 ranks) on the same fleet, cut to
# I9_LAYERS of its 40 layers, through the dry-run's command line in a process
# of its own queued at the check's start: each rank attends with every head
# of its query slice (models/tensor_parallel.py ``q_slice_axes``).  Beside the
# reference's XLA compile count of the whole cell on 256 fake host devices
# (python -m repro.launch.dryrun --arch minicpm-2b --cell train_4k --mesh
# single, on the CPU): its temp, which the cut cell's argument + temp stays
# below, as below the card's memory; the parent tree's trace of the same cut
# on the card's host, whose argument + temp was above the card's (I9_PARENT);
# and this tree's counts of the same command on the CPU (the card's host),
# which it must print to the byte
I9_ARCH, I9_CELL, I9_LAYERS = "minicpm-2b", "train_4k", 2
I9_REFERENCE = dict(argument=328_852_164, temp=80_860_100_744)
I9_PARENT = dict(argument_temp=111_090_598_624, temp=110_872_587_292)
I9_CPU = dict(total=12_337_836_968, temp=11_901_847_064, collective=5_595_182_992,
              flops=24_724_591_607_808)
# i10 the reference cells phase i traced nowhere else, as published, each
# through the dry-run's command line in a process of its own queued at the
# check's start: minicpm-2b's decode_32k (its 36 q heads unsplit on the model
# axis, its tied 122753-row table on data, the rows traded for its columns)
# and mixtral-8x22b's long_500k (one row on (16, 16): every weight, the
# router and the experts' too, on its data shard, the token moving).  Beside
# the reference's XLA compile counts of each cell on 256 fake host devices
# (python -m repro.launch.dryrun --arch <arch> --cell <cell> --mesh single,
# on the CPU; its scan body counted once): argument, temp and output bytes
# a device, collective bytes a device and its HLO's collective ops by kind;
# each record held to the CPU's counts to the byte (I_DECODE_CPU), its
# product FLOPs to the hand count and its collective bytes to the
# reference's; the parent tree's temp (I_PARENT_TEMP) printed beside it
I10_CELLS = (("minicpm-2b", "decode_32k"), ("mixtral-8x22b", "long_500k"))
I10_REFERENCE = {
    ("minicpm-2b", "decode_32k"): dict(
        argument=6_149_404_260, temp=12_611_437_984, output=6_043_725_920,
        collective=718_783_648,
        ops={"all-gather": 13, "all-reduce": 7, "collective-permute": 2, "all-to-all": 1}),
    ("mixtral-8x22b", "long_500k"): dict(
        argument=2_259_476_488, temp=157_617_536, output=58_728_484, collective=29_897_224,
        ops={"all-reduce": 13, "collective-permute": 4, "all-gather": 15}),
}
I10_COLLECTIVE_OVER_REFERENCE = 1.0
# every phase i decode cell's counts of the same command on the CPU (the
# card's host; whisper-tiny's in I8_CPU), which the card's host must print to
# the byte: argument + temp + output, temp, collective bytes a device and
# product FLOPs
I_DECODE_CPU = {
    ("granite-3-8b", "decode_32k", "single"):
        dict(total=5_759_022_688, temp=163_699_744, collective=1_021_445_408, flops=18_907_987_968),
    ("dbrx-132b", "decode_32k", "single"):
        dict(total=7_975_714_880, temp=548_625_952, collective=16_340_768_000,
             flops=147_144_613_888),
    ("mixtral-8x22b", "decode_32k", "moe"):
        dict(total=3_565_310_272, temp=331_194_144, collective=17_631_265_792,
             flops=143_287_924_736),
    ("mamba2-2.7b", "decode_32k", "single"):
        dict(total=253_324_116, temp=9_786_452, collective=357_670_368, flops=2_764_333_056),
    ("mamba2-2.7b", "long_500k", "single"):
        dict(total=111_326_536, temp=16_295_840, collective=2_786_464, flops=41_595_392),
    ("jamba-v0.1-52b", "decode_32k", "single"):
        dict(total=3_090_694_208, temp=1_732_140_224, collective=6_398_291_712,
             flops=52_297_793_536),
    ("jamba-v0.1-52b", "long_500k", "single"):
        dict(total=2_024_263_576, temp=143_007_888, collective=4_257_184, flops=2_547_979_712),
    ("qwen2-vl-72b", "decode_32k", "single"):
        dict(total=12_132_025_984, temp=253_026_304, collective=8_875_059_456,
             flops=114_408_030_208),
    ("minicpm-2b", "decode_32k", "single"):
        dict(total=12_504_067_104, temp=314_619_040, collective=321_958_944, flops=8_764_526_592),
    ("mixtral-8x22b", "long_500k", "single"):
        dict(total=2_337_288_936, temp=19_084_000, collective=9_069_856, flops=1_450_084_096),
}


# each phase i cell's temp a device in a parent tree's trace on the card's
# host, by (arch, cell, mesh kind): of the steps that gathered every period's
# working weights before the model ran, and for the long_500k cells of the
# decode step that gathered each period's weights over data where it ran;
# each i3-i8 cell's temp is held below it (i10's printed beside it: their
# parent's steps kept the weights where these do)
I_PARENT_TEMP = {
    ("granite-3-8b", "train_4k", "single"): 19_353_010_204,
    ("granite-3-8b", "decode_32k", "single"): 2_569_575_456,
    ("granite-3-8b", "prefill_32k", "single"): 2_985_476_108,
    ("dbrx-132b", "decode_32k", "single"): 22_861_578_240,
    ("mixtral-8x22b", "decode_32k", "moe"): 24_844_173_312,
    ("dbrx-132b", "train_4k", "single"): 54_311_283_744,
    ("mixtral-8x22b", "train_4k", "moe"): 57_895_708_192,
    ("mixtral-8x22b", "train_4k", "single"): 64_086_204_952,
    ("dbrx-132b", "prefill_32k", "single"): 4_647_157_772,
    ("mamba2-2.7b", "train_4k", "single"): 6_988_148_760,
    ("mamba2-2.7b", "prefill_32k", "single"): 2_841_768_992,
    ("mamba2-2.7b", "decode_32k", "single"): 855_851_520,
    ("mamba2-2.7b", "long_500k", "single"): 530_956_800,
    ("jamba-v0.1-52b", "train_4k", "single"): 49_660_043_620,
    ("jamba-v0.1-52b", "prefill_32k", "single"): 9_367_669_680,
    ("jamba-v0.1-52b", "decode_32k", "single"): 6_880_501_248,
    ("jamba-v0.1-52b", "long_500k", "single"): 1_818_270_272,
    ("qwen2-vl-72b", "train_4k", "single"): 69_678_989_336,
    ("qwen2-vl-72b", "decode_32k", "single"): 13_866_762_240,
    ("qwen2-vl-72b", "prefill_32k", "single"): 5_475_401_740,
    ("whisper-tiny", "train_4k", "single"): 27_641_091_864,
    ("whisper-tiny", "prefill_32k", "single"): 832_790_016,
    ("whisper-tiny", "decode_32k", "single"): 142_868_160,
    ("minicpm-2b", "decode_32k", "single"): 1_166_644_512,
    ("mixtral-8x22b", "long_500k", "single"): 19_084_000,
}

# the limit the whole check must end within, and each path's phase label in the
# chain line (``counted``)
CHECK_LIMIT_S = 1200
PHASE_OF = {"relax_bf16_path": "2 bf16", "planning_path": "3-6", "superstep_path": "a",
            "minplus_path": "b", "router_path": "c", "lm_path": "e",
            "ssm_path": "f", "training_path": "g", "examples_path": "x", "distributed_path": "h",
            "analysis_phase": "i"}
# phase 3's realize and phase d run each in a process of its own beside the
# serial chain, read after g
REALIZE_TIMEOUT_S, CHAOS_TIMEOUT_S = 600, 600
# phase i's traces run beside the serial chain from the check's start, each
# on one core at priority 19, on the host's cores less TRACE_CORES_HELD (the
# serial chain's process and phase 3's realize), the longest first by their
# CPU seconds on an H100 machine's host, each alone on a core
# (scripts/trace_times.py, 8 at once on its 8 cores, nothing else running)
TRACE_CORES_HELD = 2
TRACE_COST_S = {
    "i1": 131.2, ("granite-3-8b", "train_4k", "single"): 137.2,
    ("granite-3-8b", "decode_32k", "single"): 39.2,
    ("granite-3-8b", "prefill_32k", "single"): 153.5,
    ("dbrx-132b", "decode_32k", "single"): 41.2, ("mixtral-8x22b", "decode_32k", "moe"): 45.4,
    ("dbrx-132b", "train_4k", "single"): 146.1, ("mixtral-8x22b", "train_4k", "moe"): 199.2,
    ("mixtral-8x22b", "train_4k", "single"): 187.2, ("dbrx-132b", "prefill_32k", "single"): 145.5,
    ("mamba2-2.7b", "train_4k", "single"): 96.2, ("mamba2-2.7b", "prefill_32k", "single"): 98.1,
    ("mamba2-2.7b", "decode_32k", "single"): 34.9, ("mamba2-2.7b", "long_500k", "single"): 34.7,
    ("jamba-v0.1-52b", "train_4k", "single"): 78.6,
    ("jamba-v0.1-52b", "prefill_32k", "single"): 175.4,
    ("jamba-v0.1-52b", "decode_32k", "single"): 29.0,
    ("jamba-v0.1-52b", "long_500k", "single"): 29.0,
    ("qwen2-vl-72b", "train_4k", "single"): 222.1, ("qwen2-vl-72b", "decode_32k", "single"): 39.2,
    ("qwen2-vl-72b", "prefill_32k", "single"): 255.5,
    ("whisper-tiny", "train_4k", "single"): 36.1, ("whisper-tiny", "prefill_32k", "single"): 32.3,
    ("whisper-tiny", "decode_32k", "single"): 24.0, ("minicpm-2b", "train_4k", "single"): 24.0,
    ("minicpm-2b", "decode_32k", "single"): 40.0, ("mixtral-8x22b", "long_500k", "single"): 50.0,
}


_T0 = time.perf_counter()
# each phase's (start, end) in seconds since the check began, for the chain line
SPANS: dict[str, tuple[float, float]] = {}
# processes the check starts outside phase i's queue, and groups of spawned
# ranks, killed if it stops early
CHILDREN: list[subprocess.Popen] = []
RANKS: list = []


def log(*args):
    """A line of the check's output, after the seconds since it started."""
    print(f"[{time.perf_counter() - _T0:7.1f} s]", *args, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(f"chip_smoke: {what}")


def same_result(a, b, what: str) -> None:
    check(np.array_equal(a.ceft, b.ceft), f"{what}: CEFT tables differ")
    check(np.array_equal(a.pred_task, b.pred_task), f"{what}: pred_task differs")
    check(np.array_equal(a.pred_proc, b.pred_proc), f"{what}: pred_proc differs")
    check(a.cpl == b.cpl and a.path == b.path, f"{what}: cpl or path differs")


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def edge_inputs(shape, seed: int, device, batch: int | None = None):
    E, P = shape
    lead = () if batch is None else (batch,)
    rng = np.random.default_rng(seed)
    arrs = (rng.uniform(0, 100, (*lead, E, P)), rng.uniform(0, 10, (E,)),
            rng.uniform(0, 2, (*lead, P)), rng.uniform(0.5, 2, (*lead, P, P)))
    return [torch.as_tensor(a.astype(np.float32), device=device) for a in arrs]


def cell_inputs(shape, seed: int, device, n_valid: int | None = None):
    """Random dense-relaxation inputs; ``n_valid`` makes the first n_valid
    parent slots of each task real (the star's pattern), else 80% at random."""

    W, D, P = shape
    rng = np.random.default_rng(seed)
    if n_valid is None:
        validp = rng.random((W, D)) < 0.8
    else:
        validp = np.arange(D)[None, :].repeat(W, 0) < n_valid
    arrs = (rng.uniform(0, 100, (W, D, P)), rng.uniform(0, 10, (W, D)), validp,
            rng.uniform(0, 2, (P,)), rng.uniform(0.5, 2, (P, P)))
    return [torch.as_tensor(np.asarray(a, np.float32), device=device) for a in arrs]


def cell_tie_inputs(shape, mode: str, seed: int, device):
    """Small integers on a homogeneous machine; "constant" ties every slot,
    "invalid_rows" leaves every third task without a valid parent."""
    W, D, P = shape
    rng = np.random.default_rng(seed)
    pv = rng.integers(0, 4, (W, D, P)).astype(np.float32)
    pdata = rng.integers(0, 3, (W, D)).astype(np.float32)
    validp = (rng.random((W, D)) < 0.9).astype(np.float32)
    if mode == "constant":
        pv[:], pdata[:] = 2.0, 1.0
    if mode == "invalid_rows":
        validp[::3] = 0.0
    return [torch.as_tensor(a, device=device) for a in (
        pv, pdata, validp, np.full(P, 1.0, np.float32), np.full((P, P), 2.0, np.float32))]


def seg_inputs(case: str, ties: bool, seed: int):
    """One segment-layout level on the host: (carry, comp, L, bw, tasks,
    edge_src, edge_data, edge_seg, e_real, width); parents in the first half
    of the rows, the level's tasks in the second, the last row the scratch."""
    B, P, lens, pad_e, pad_w = SEG_CASES[case]
    rng = np.random.default_rng(seed)
    if isinstance(lens, tuple):
        lens = rng.integers(1, lens[1] + 1, lens[0])
    lens = np.asarray(lens)
    w, e_real = len(lens), int(lens.sum())
    V = 2 * max(w, 64) + 1
    if ties:
        ceft = rng.integers(0, 4, (B, V, P)).astype(np.float32)
        data = rng.integers(0, 3, e_real).astype(np.float32)
        L, bw = np.full((B, P), 1.0, np.float32), np.full((B, P, P), 2.0, np.float32)
    else:
        ceft = rng.uniform(0, 100, (B, V, P)).astype(np.float32)
        data = rng.uniform(0, 10, e_real).astype(np.float32)
        L = rng.uniform(0, 2, (B, P)).astype(np.float32)
        bw = rng.uniform(0.5, 2, (B, P, P)).astype(np.float32)
    ceft[:, V - 1] = 0.0
    comp = rng.integers(1, 4, (B, V, P)).astype(np.float32)
    width, E_b = w + pad_w, e_real + pad_e
    src = np.full(E_b, V - 1, np.int64)
    src[:e_real] = rng.integers(0, V // 2, e_real)
    dat = np.zeros(E_b, np.float32)
    dat[:e_real] = data
    seg = np.full(E_b, width - 1, np.int64)
    seg[:e_real] = np.repeat(np.arange(w), lens)
    tasks = (V // 2 + rng.permutation(V // 2)[:w]).astype(np.int64)
    carry = tuple(torch.as_tensor(a) for a in (
        ceft, np.full((B, V, P), -1, np.int32), np.full((B, V, P), -1, np.int32)))
    return (carry, *(torch.as_tensor(a) for a in (comp, L, bw, tasks, src, dat, seg)),
            e_real, width)


def nan_err(a, b) -> float:
    """max |a - b| where neither is NaN (0.0 where there is no such entry)."""
    a, b = a.float(), b.float()
    keep = ~(torch.isnan(a) | torch.isnan(b))
    return float((a[keep] - b[keep]).abs().max()) if keep.any() else 0.0


def on(device, arrays):
    return [torch.as_tensor(a, device=device) for a in arrays]


def scratch_is_zero() -> bool:
    return all(not k.any() and not c.any() for k, c in ops._SCRATCH.values())


def compare_kernels(device) -> dict:
    """Phase 2: the planning path's kernels against their plain versions,
    bit-equal."""
    err = {"edge_relax": 0.0, "ceft_relax": 0.0, "seg_level": 0.0}
    cases = [(s, None) for s in EDGE_SHAPES + EDGE_PATH_SHAPES] + [((1024, 64), 8)]
    cases += EDGE_WIDE_CASES
    for i, (shape, batch) in enumerate(cases):
        pv, pdata, L, bw = edge_inputs(shape, 100 + i, device, batch)
        got = ops.edge_relax(pv, pdata, L, bw)
        torch.cuda.synchronize()
        b = (lambda t: t[None]) if batch is None else (lambda t: t)
        want = edge_relax_plain(b(pv), pdata, b(L), b(bw))
        want = want if batch is not None else tuple(w[0] for w in want)
        err["edge_relax"] = max(err["edge_relax"], float((got[0] - want[0]).abs().max()))
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              f"edge_relax kernel != plain at {shape} batch {batch}")
    for i, (shape, mode) in enumerate(itertools.product(EDGE_TIE_SHAPES, ("ties", "constant"))):
        pv, pdata, L, bw = on(device, probes.edge_ties(shape, mode, 140 + i))
        got = ops.edge_relax(pv, pdata, L, bw)
        want = edge_relax_plain(pv[None], pdata, L[None], bw[None])
        check(torch.equal(got[0], want[0][0]) and torch.equal(got[1], want[1][0]),
              f"edge_relax kernel != plain at {shape} {mode}")
    for i, shape in enumerate(CELL_SHAPES + CELL_PATH_SHAPES):
        n_valid = 3999 if shape == (1, 4096, 64) else None
        pv, pdata, validp, L, bw = cell_inputs(shape, 200 + i, device, n_valid)
        got = ops.ceft_relax(pv, pdata, validp, L, bw)
        torch.cuda.synchronize()
        want = ceft_relax_plain(pv[None], pdata, validp, L[None], bw[None])
        err["ceft_relax"] = max(err["ceft_relax"], float((got[0] - want[0][0]).abs().max()))
        for g, w, name in zip(got, want, ("maxk", "argk", "argl")):
            check(torch.equal(g, w[0]), f"ceft_relax kernel != plain ({name}) at {shape}")
    for i, (shape, mode) in enumerate(CELL_TIE_CASES):
        pv, pdata, validp, L, bw = cell_tie_inputs(shape, mode, 250 + i, device)
        got = ops.ceft_relax(pv, pdata, validp, L, bw)
        torch.cuda.synchronize()
        want = ceft_relax_plain(pv[None], pdata, validp, L[None], bw[None])
        err["ceft_relax"] = max(err["ceft_relax"], float((got[0] - want[0][0]).abs().max()))
        for g, w, name in zip(got, want, ("maxk", "argk", "argl")):
            check(torch.equal(g, w[0]), f"ceft_relax kernel != plain ({name}) at {shape} {mode}")
    for i, case in enumerate(SEG_CASES):
        for ties in (True, False):
            carry, *rest, e_real, width = seg_inputs(case, ties, 700 + i)
            want = tuple(c.clone() for c in carry)
            seg_level_plain(want, *rest, e_real, width)
            got = tuple(c.to(device) for c in carry)
            ops.seg_level(got, *(t.to(device) for t in rest), e_real, width)
            torch.cuda.synchronize()
            err["seg_level"] = max(err["seg_level"], float((got[0].cpu() - want[0]).abs().max()))
            for g, w, name in zip(got, want, ("ceft", "pred_task", "pred_proc")):
                check(torch.equal(g.cpu(), w), f"seg_level kernel != plain ({name}) at {case} "
                      f"ties={ties}")
    check(scratch_is_zero(), "a kernel left its cross-block scratch non-zero")
    log(f"phase 2: kernels bit-equal to their plain versions (edge_relax at "
        f"{EDGE_SHAPES + EDGE_PATH_SHAPES}, B = 8, {EDGE_WIDE_CASES}, tie cases "
        f"{EDGE_TIE_SHAPES} x (ties, constant); ceft_relax tie cases {len(CELL_TIE_CASES)}, "
        f"seg_level cases {2 * len(SEG_CASES)}); max_abs_err {err}")
    n = compare_nan(device, err)
    log(f"phase 2: NaN, inf and -0.0 candidates in {n} calls: NaN where the plain versions "
        f"have it and bit-equal elsewhere, scratch zero; max_abs_err {err}")
    n = compare_seg_divide(device, err)
    log(f"phase 2: seg_level on the divide probe ({n} levels of "
        f"{SEG_DIVIDE_LEVELS * 1024} single-edge segments, P = 64, kinds "
        f"{probes.DIVIDE_KINDS}): bit-equal to the plain version, scratch zero")
    n = compare_edge_divide(device, err)
    log(f"phase 2: edge_relax on the divide probe ({n} calls of {SEG_DIVIDE_LEVELS * 1024} "
        f"edges, P = 64, kinds {probes.DIVIDE_KINDS}): bit-equal to the plain version")
    return err


def compare_edge_divide(device, err: dict) -> int:
    """Phase 2, divide: ``probes.divide_probe``'s levels as one edge_relax
    call each kind, every adversarial quotient reaching the output."""
    for i, kind in enumerate(probes.DIVIDE_KINDS):
        pv, pdata, L, bw = on(device, probes.divide_probe(kind, SEG_DIVIDE_LEVELS, 870 + i))
        pv, pdata = pv.reshape(-1, pv.shape[-1]), pdata.reshape(-1)
        got = ops.edge_relax(pv, pdata, L, bw)
        want = edge_relax_plain(pv[None], pdata, L[None], bw[None])
        err["edge_relax"] = max(err["edge_relax"], nan_err(got[0], want[0][0]))
        check(probes.equal_nan(got[0], want[0][0]) and torch.equal(got[1], want[1][0]),
              f"edge_relax kernel != plain on the {kind} divide probe")
        del want, got
    return len(probes.DIVIDE_KINDS)


def compare_seg_divide(device, err: dict) -> int:
    """Phase 2, divide: ``probes.seg_divide_level`` through seg_level, every
    adversarial quotient reaching the carry; plain version on the card."""
    for i, kind in enumerate(probes.DIVIDE_KINDS):
        carry, *rest, e_real, width = probes.seg_divide_level(kind, SEG_DIVIDE_LEVELS, 860 + i)
        args = on(device, rest)
        want = tuple(torch.as_tensor(c, device=device) for c in carry)
        seg_level_plain(want, *args, e_real, width)
        got = tuple(torch.as_tensor(c, device=device) for c in carry)
        ops.seg_level(got, *args, e_real, width)
        torch.cuda.synchronize()
        err["seg_level"] = max(err["seg_level"], nan_err(got[0], want[0]))
        for g, w, name in zip(got, want, ("ceft", "pred_task", "pred_proc")):
            check(probes.equal_nan(g, w), f"seg_level kernel != plain ({name}) on the {kind} "
                  f"divide probe")
        del want, got
    check(scratch_is_zero(), "seg_level left its scratch non-zero on the divide probe")
    return len(probes.DIVIDE_KINDS)


def compare_nan(device, err: dict) -> int:
    """Phase 2, NaN: special candidates through edge_relax, ceft_relax and
    seg_level against their plain versions (NaN positions equal, the rest
    bit-equal)."""
    n = 0
    for i, (shape, mode) in enumerate(itertools.product(EDGE_NAN_SHAPES, probes.SPECIAL_MODES)):
        pv, pdata, L, bw = on(device, probes.edge_specials(shape, mode, 800 + i))
        got = ops.edge_relax(pv, pdata, L, bw)
        want = edge_relax_plain(pv[None], pdata, L[None], bw[None])
        err["edge_relax"] = max(err["edge_relax"], nan_err(got[0], want[0][0]))
        check(all(probes.equal_nan(g, w[0]) for g, w in zip(got, want)),
              f"edge_relax kernel != plain at {shape} {mode}")
        n += 1
    for i, (shape, mode) in enumerate(itertools.product(CELL_NAN_SHAPES, probes.SPECIAL_MODES)):
        pv, pdata, validp, L, bw = on(device, probes.cell_specials(shape, mode, 820 + i))
        got = ops.ceft_relax(pv, pdata, validp, L, bw)
        want = ceft_relax_plain(pv[None], pdata, validp, L[None], bw[None])
        err["ceft_relax"] = max(err["ceft_relax"], nan_err(got[0], want[0][0]))
        check(all(probes.equal_nan(g, w[0]) for g, w in zip(got, want)),
              f"ceft_relax kernel != plain at {shape} {mode}")
        n += 1
    for i, case in enumerate(SEG_CASES):
        carry, *rest, e_real, width = seg_inputs(case, False, 850 + i)
        src, P = rest[4], carry[0].shape[-1]
        ceft = carry[0].clone()
        ceft[:, src[0], 2 % P] = float("nan")
        ceft[:, src[e_real // 2], :] = float("nan")
        carry = (ceft, *carry[1:])
        want = tuple(c.clone() for c in carry)
        seg_level_plain(want, *rest, e_real, width)
        got = tuple(c.to(device) for c in carry)
        ops.seg_level(got, *(t.to(device) for t in rest), e_real, width)
        torch.cuda.synchronize()
        err["seg_level"] = max(err["seg_level"], nan_err(got[0].cpu(), want[0]))
        for g, w, name in zip(got, want, ("ceft", "pred_task", "pred_proc")):
            check(probes.equal_nan(g.cpu(), w), f"seg_level kernel != plain ({name}) at "
                  f"{case} with NaN parents")
        n += 1
    check(scratch_is_zero(), "a kernel left its cross-block scratch non-zero after NaN keys")
    return n


def relax_bf16_path(device) -> list:
    """Phase 2, bf16 (drive): the bf16 instance of ``ceft_relax`` at phase
    2's shapes (random, tie cases across blocks, NaN, inf and -0.0 probes),
    the float32 inputs rounded to bf16."""
    cases = [(f"{shape}", cell_inputs(shape, 200 + i, device,
                                      3999 if shape == (1, 4096, 64) else None))
             for i, shape in enumerate(CELL_SHAPES + CELL_PATH_SHAPES)]
    cases += [(f"{shape} {mode}", cell_tie_inputs(shape, mode, 250 + i, device))
              for i, (shape, mode) in enumerate(CELL_TIE_CASES)]
    cases += [(f"{shape} {mode}", on(device, probes.cell_specials(shape, mode, 820 + i)))
              for i, (shape, mode) in enumerate(itertools.product(CELL_NAN_SHAPES,
                                                                  probes.SPECIAL_MODES))]
    calls = []
    for what, args in cases:
        args = [a.to(torch.bfloat16) for a in args]
        calls.append((what, args, ops.ceft_relax(*args)))
    torch.cuda.synchronize()
    return calls


def check_relax_bf16(calls) -> float:
    err = 0.0
    for what, (pv, pdata, validp, L, bw), got in calls:
        want = ceft_relax_plain(pv[None], pdata, validp, L[None], bw[None])
        check(got[0].dtype == torch.bfloat16, f"ceft_relax bf16 at {what}: {got[0].dtype}")
        err = max(err, nan_err(got[0], want[0][0]))
        check(probes.equal_bits(got[0], want[0][0]), f"ceft_relax bf16 kernel != plain (maxk) at {what}")
        for g, w, name in zip(got[1:], want[1:], ("argk", "argl")):
            check(torch.equal(g, w[0]), f"ceft_relax bf16 kernel != plain ({name}) at {what}")
    check(scratch_is_zero(), "the bf16 ceft_relax left its cross-block scratch non-zero")
    log(f"phase 2: the bf16 ceft_relax bit-equal to its plain version in bf16 at {len(calls)} "
        f"calls (random, tie cases, NaN, inf and -0.0 probes); max_abs_err {err}")
    return err


def plan_large(device):
    """Phase 3: the paper's largest graph through the plan cache."""
    t = time.perf_counter()
    wl = rgg("high", 16384, 64, np.random.default_rng(5), o=4, alpha=0.75, beta=50)
    g, comp, m = wl.graph, wl.comp, wl.machine
    log(f"phase 3: rgg n={g.n} e={g.n_edges} levels={g.n_levels} P={m.P} "
        f"built in {time.perf_counter() - t:.3f} s")
    pc = PlanCache(device=device)
    t = time.perf_counter()
    res, status, _ = pc.plan(g, comp, m, planner="ceft_cpop")
    first_s = time.perf_counter() - t
    check(status == "full", f"first plan status {status}")
    check(res.ceft.shape == (g.n, m.P) and np.isfinite(res.ceft).all(),
          "CEFT table not finite or of the wrong shape")
    t = time.perf_counter()
    res_cpu, _, _ = PlanCache(device="cpu").plan(g, comp, m, planner="ceft_cpop")
    cpu_s = time.perf_counter() - t
    same_result(res, res_cpu, "n=16384 plan, cuda vs cpu")

    inputs = ct.csr_device_inputs(g, comp, m, device=device)
    steady = []
    for _ in range(5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        ct.csr_sweep(inputs)
        torch.cuda.synchronize()
        steady.append(time.perf_counter() - t)

    _, _, _, spans = plancache.device_state(g, device)
    comp2 = comp.copy()
    comp2[g.level >= spans[-1][0]] *= 1.5
    t = time.perf_counter()
    res2, status2, _ = pc.plan(g, comp2, m, planner="ceft_cpop")
    partial_s = time.perf_counter() - t
    check(status2 == "partial", f"top-level change gave status {status2}")
    same_result(res2, ct.ceft_torch_csr(g, comp2, m, device=device),
                "partial re-sweep vs full sweep")

    realize = start_realize(g, comp, m, res)
    log(f"phase 3: plan first {first_s:.4f} s, steady sweep "
        f"{sorted(steady)[2] * 1e3:.3f} ms (median of 5), partial {partial_s:.4f} s, "
        f"cpu-path plan {cpu_s:.3f} s, cpl {res.cpl!r}, runs {spans}; the CEFT-CPOP "
        f"realize in a process of its own")
    return g, comp, m, inputs, realize


def realize_large(path: str) -> None:
    """Phase 3's realize in a process of its own (``start_realize``): the
    CEFT-CPOP schedule of the pickled (graph, costs, machine, CEFT result)
    at ``path``, validated; its seconds and makespan written beside it."""
    g, comp, m, res = pickle.loads(Path(path).read_bytes())
    t = time.perf_counter()
    plan = planners.realize("ceft_cpop", g, comp, m, res)
    realize_s = time.perf_counter() - t
    validate_schedule(plan.schedule, g, comp, m)
    Path(path).with_suffix(".json").write_text(json.dumps(dict(
        realize_s=realize_s, makespan=plan.makespan, cpl=res.cpl)))


def start_realize(g, comp, m, res) -> dict:
    """Phase 3's realize, host numpy, off the serial chain: ``realize_large``
    in a process of its own, started now and read by ``finish_realize``."""
    out = Path(tempfile.mkdtemp())
    path = out / "realize.pkl"
    path.write_bytes(pickle.dumps((g, comp, m, res)))
    root = Path(__file__).resolve().parent
    with open(out / "realize.log", "w") as log_file:
        proc = subprocess.Popen(
            [sys.executable, "-c", "import sys, chip_smoke; chip_smoke.realize_large(sys.argv[1])",
             str(path)], cwd=root, stdout=log_file, stderr=subprocess.STDOUT,
            env=dict(os.environ, PYTHONPATH=str(root / "src")))
    CHILDREN.append(proc)
    return dict(proc=proc, path=path, started_s=time.perf_counter() - _T0, wall=time.time())


def finish_realize(realize: dict) -> dict:
    """Phase 3's realize, read: the process's exit (its schedule valid), the
    makespan at least the critical path."""
    proc, path = realize["proc"], realize["path"]
    try:
        proc.wait(timeout=REALIZE_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    text = path.with_name("realize.log").read_text()
    check(proc.returncode == 0, f"phase 3's realize exited with {proc.returncode}: {text[-4000:]}")
    rec = json.loads(path.with_suffix(".json").read_text())
    check(rec["makespan"] >= rec["cpl"] * (1 - 1e-6), "makespan below the critical path")
    ended_s = realize["started_s"] + path.with_suffix(".json").stat().st_mtime - realize["wall"]
    rec.update(started_s=realize["started_s"], ended_s=ended_s, read_s=time.perf_counter() - _T0)
    SPANS["3 realize (own process)"] = (rec["started_s"], ended_s)
    log(f"phase 3: realize {rec['realize_s']:.3f} s in a process of its own (started at "
        f"{rec['started_s']:.1f} s, read at {rec['read_s']:.1f} s), its schedule valid, cpl "
        f"{rec['cpl']!r}, makespan {rec['makespan']!r}")
    shutil.rmtree(path.parent, ignore_errors=True)
    return rec


def batched(device, g, comp, m):
    """Phase 4: B = 8 scenarios in one sweep against 8 single sweeps."""
    rng = np.random.default_rng(11)
    B, P = 8, m.P
    comps = comp[None] * rng.uniform(1.0, 2.0, (B, 1, P))
    Ls = np.repeat(m.L[None], B, 0)
    bws = m.bw[None] * rng.uniform(0.8, 1.25, (B, P, P))
    torch.cuda.synchronize()
    t = time.perf_counter()
    results = ct.ceft_batch_csr_results(g, comps, Ls, bws, device=device)
    batch_s = time.perf_counter() - t
    t = time.perf_counter()
    for b in range(B):
        mb = Machine(L=Ls[b], bw=bws[b], counts=m.counts)
        same_result(results[b], ct.ceft_torch_csr(g, comps[b], mb, device=device),
                    f"batched plane {b} vs single sweep")
    single_s = time.perf_counter() - t
    log(f"phase 4: batched B={B} bit-equal to single sweeps; batched {batch_s:.4f} s, "
        f"8 singles {single_s:.4f} s")


def layouts(device):
    """Phase 5: dense layout, segment fallback, padded sweep, Algorithm 1."""
    rng = np.random.default_rng(21)
    for name, g, want in (("star_fan_in(4000)", star_fan_in(4000), "dense"),
                          ("heavy_tail_fan_in(4000)", heavy_tail_fan_in(4000, rng), "seg")):
        comp = rng.uniform(1, 10, (g.n, 64))
        m = random_machine(64, rng, L_range=(0.0, 1.0))
        kinds = [r.layout for r in ct.csr_device_inputs(g, comp, m, device=device)[0]]
        check(want in kinds, f"{name}: no {want}-layout run in {kinds}")
        same_result(ct.ceft_torch_csr(g, comp, m, device=device),
                    ct.ceft_torch_csr(g, comp, m, device="cpu"), f"{name} cuda vs cpu")
        log(f"phase 5: {name} layouts {kinds} bit-equal to the CPU path")
    wl = rgg("high", 2048, 64, np.random.default_rng(5), o=4, alpha=0.75, beta=50)
    same_result(ct.ceft_torch(wl.graph, wl.comp, wl.machine, device=device),
                ct.ceft_torch_csr(wl.graph, wl.comp, wl.machine, device=device),
                "padded sweep vs CSR sweep")
    wl = rgg("high", 60, 8, np.random.default_rng(6), o=4, alpha=0.75, beta=50)
    ref = ceft_reference(wl.graph, wl.comp, wl.machine)
    got = ct.ceft_torch_csr(wl.graph, wl.comp, wl.machine, device=device)
    check(np.allclose(got.ceft, ref.ceft, rtol=2e-5) and got.path == ref.path,
          "CSR sweep disagrees with Algorithm 1")
    log("phase 5: padded sweep == CSR sweep (n=2048); Algorithm 1 agrees (n=60, rtol 2e-5)")


def straggler(device):
    """Phase 6: the straggler loop on the card and on the CPU."""
    wl = rgg("high", 2048, 64, np.random.default_rng(5), o=4, alpha=0.75, beta=50)
    g, comp, m = wl.graph, wl.comp, wl.machine
    slow = np.ones(m.P)
    slow[int(np.argmin(comp.sum(axis=0)))] = 3.0   # the fastest class degrades
    steps = [np.ones(m.P), np.ones(m.P), slow, slow]
    mons = {dev: StragglerMonitor(m.P, device=dev) for dev in (device, "cpu")}
    out = {}
    for dev, mon in mons.items():
        rows = []
        for k, times in enumerate(steps):
            t = time.perf_counter()
            sched, ev = mon.maybe_replan(k, g, comp, m, times)
            rows.append((sched, ev, time.perf_counter() - t, mon.plancache.snapshot()))
        out[dev] = rows
    gpu, cpu = out[device], out["cpu"]
    for (s, e, _, c), (s2, e2, _, c2) in zip(gpu, cpu):
        check(np.array_equal(s.proc, s2.proc) and np.array_equal(s.start, s2.start)
              and s.makespan == s2.makespan, "straggler schedules differ cuda vs cpu")
        check((e is None) == (e2 is None) and c == c2, "straggler events differ")
    check(gpu[0][1] is None and gpu[1][1] is None, "quiet steps raised an event")
    check(gpu[1][3]["hits"] >= 1, "repeated quiet step missed the cache")
    check(gpu[2][1] is not None, "degraded step raised no event")
    ev = gpu[2][1]
    log(f"phase 6: straggler steps {[round(r[2], 4) for r in gpu]} s; event class "
        f"{ev.device_class} slowdown {ev.slowdown!r} makespan {ev.old_makespan!r} -> "
        f"{ev.new_makespan!r}; counters {gpu[-1][3]}")


def run_tables(device, g, inputs, ceft_pad) -> list:
    """The stacked (pv, pdata, L, bw) tables of ``g``'s segment-layout runs,
    with ``pv`` gathered from the finished (padded) CEFT table ``ceft_pad``
    (each vertex is written once, before its children's level reads it, so
    these are the values the sweep saw)."""
    L, bw = inputs[3], inputs[4]
    runs, _, _, _ = plancache.device_state(g, device)
    tables = []
    for run in runs:
        if run.layout != "seg":
            continue
        src = torch.stack([lv.edge_src for lv in run.levels])            # (R, E)
        pdata = torch.stack([lv.edge_data for lv in run.levels]).contiguous()
        R, E = src.shape
        pv = ceft_pad.index_select(0, src.reshape(-1)).view(R, E, -1).contiguous()
        tables.append((pv, pdata, L, bw))
    check(len(tables) >= 1, "the graph has no segment-layout run")
    return tables


def superstep_path(device, g, inputs, ceft_pad) -> tuple[list, list, list]:
    """Phase a: the n = 16384 graph's segment-layout levels relaxed at the
    Pallas kernels' contracts: ``edge_relax`` level by level, and
    ``edge_relax_superstep`` once per run over its stacked level tables.
    Returns the run tables and both kernels' outputs."""
    tables = run_tables(device, g, inputs, ceft_pad)
    per_level = [[ops.edge_relax(pv[r], pdata[r], L, bw) for r in range(pv.shape[0])]
                 for pv, pdata, L, bw in tables]
    outs = [ops.edge_relax_superstep(*t) for t in tables]
    torch.cuda.synchronize()
    return tables, outs, per_level


def check_superstep(device, tables, outs, per_level) -> tuple[float, float]:
    err = edge_err = 0.0
    for (pv, pdata, L, bw), (minl, argl), levels in zip(tables, outs, per_level):
        for r, (m1, a1) in enumerate(levels):
            check(torch.equal(minl[r], m1) and torch.equal(argl[r], a1),
                  f"superstep slice {r} of {tuple(pv.shape)} != edge_relax on that level")
            want = edge_relax_plain(pv[r][None], pdata[r], L[None], bw[None])
            edge_err = max(edge_err, float((m1 - want[0][0]).abs().max()))
            check(torch.equal(m1, want[0][0]) and torch.equal(a1, want[1][0]),
                  f"edge_relax kernel != plain on level {r} of {tuple(pv.shape)}")
        want = edge_relax_superstep_plain(pv, pdata, L, bw)
        err = max(err, float((minl - want[0]).abs().max()))
        check(torch.equal(minl, want[0]) and torch.equal(argl, want[1]),
              f"edge_relax_superstep kernel != plain at {tuple(pv.shape)}")
        del want
    for i, (R, E, P) in enumerate(SUPERSTEP_SHAPES + SUPERSTEP_WIDTHS):
        rng = np.random.default_rng(300 + i)
        pv, pdata, L, bw = (torch.as_tensor(a.astype(np.float32), device=device) for a in (
            rng.uniform(0, 100, (R, E, P)), rng.uniform(0, 10, (R, E)),
            rng.uniform(0, 2, (P,)), rng.uniform(0.5, 2, (P, P))))
        got = ops.edge_relax_superstep(pv, pdata, L, bw)
        want = edge_relax_superstep_plain(pv, pdata, L, bw)
        err = max(err, float((got[0] - want[0]).abs().max()))
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              f"edge_relax_superstep kernel != plain at {(R, E, P)}")
    log(f"phase a: edge_relax per level and the superstep per run on the run tables "
        f"{[tuple(t[0].shape) for t in tables]}, bit-equal to each other and to their "
        f"plain versions; test shapes bit-equal; max_abs_err {err} (edge_relax {edge_err})")
    for i, (shape, mode) in enumerate(itertools.product(SUPERSTEP_TIE_SHAPES,
                                                        ("ties", "constant"))):
        pv, pdata, L, bw = on(device, probes.edge_ties(shape, mode, 310 + i))
        got = ops.edge_relax_superstep(pv, pdata, L, bw)
        want = edge_relax_superstep_plain(pv, pdata, L, bw)
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              f"edge_relax_superstep kernel != plain at {shape} {mode}")
        for r in range(shape[0]):
            m1, a1 = ops.edge_relax(pv[r], pdata[r], L, bw)
            check(torch.equal(got[0][r], m1) and torch.equal(got[1][r], a1),
                  f"superstep slice {r} of {shape} {mode} != edge_relax")
    for i, (shape, mode) in enumerate(itertools.product(SUPERSTEP_NAN_SHAPES,
                                                        probes.SPECIAL_MODES)):
        pv, pdata, L, bw = on(device, probes.edge_specials(shape, mode, 330 + i))
        got = ops.edge_relax_superstep(pv, pdata, L, bw)
        want = edge_relax_superstep_plain(pv, pdata, L, bw)
        err = max(err, nan_err(got[0], want[0]))
        check(all(probes.equal_nan(g, w) for g, w in zip(got, want)),
              f"edge_relax_superstep kernel != plain at {shape} {mode}")
    pairs = 0
    for i, kind in enumerate(probes.DIVIDE_KINDS):
        pv, pdata, L, bw = on(device, probes.divide_probe(kind, DIVIDE_LEVELS, 360 + i))
        got = ops.edge_relax_superstep(pv, pdata, L, bw)
        for r0 in range(0, DIVIDE_LEVELS, 32):   # the plain version holds (R, E, P, P)
            want = edge_relax_superstep_plain(pv[r0:r0 + 32], pdata[r0:r0 + 32], L, bw)
            err = max(err, nan_err(got[0][r0:r0 + 32], want[0]))
            check(probes.equal_nan(got[0][r0:r0 + 32], want[0])
                  and torch.equal(got[1][r0:r0 + 32], want[1]),
                  f"edge_relax_superstep divide probe {kind}: kernel != plain at levels "
                  f"{r0}..{r0 + 31}")
        pairs += pv.shape[0] * pv.shape[1] * (pv.shape[2] - 1)
    log(f"phase a: superstep tie-heavy tables {SUPERSTEP_TIE_SHAPES} (ties, constant) "
        f"bit-equal and slice by slice equal to edge_relax; NaN, inf and -0.0 at "
        f"{SUPERSTEP_NAN_SHAPES}; {pairs} adversarial quotients ({probes.DIVIDE_KINDS}) "
        f"bit-equal; max_abs_err {err}")
    return err, edge_err


def minplus_inputs(shape, dtype, device, seed: int):
    m, k, n = shape
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.uniform(-5, 5, s).astype(np.float32), device=device).to(dtype)
            for s in ((m, k), (k, n))]


def minplus_path(device) -> list:
    """Phase b (drive): the product at the test shapes and at the timing shape,
    float32 and bf16, plus the semiring identity of the reference's test."""
    calls = []
    for dtype in MINPLUS_DTYPES:
        for i, shape in enumerate(SHAPES_MINPLUS + [MINPLUS_PATH_SHAPE]):
            a, b = minplus_inputs(shape, dtype, device, 400 + i)
            calls.append((f"{tuple(shape)} {dtype}", a, b, ops.minplus(a, b)))
    for n in (1, 7, 19, 256):
        a = minplus_inputs((n, n, n), torch.float32, device, 500 + n)[0]
        eye = torch.where(torch.eye(n, dtype=torch.bool, device=device),
                          torch.tensor(0.0, device=device), torch.tensor(BIG, device=device))
        calls.append((f"identity n={n}", a, eye, ops.minplus(a, eye)))
        calls.append((f"identity^T n={n}", eye, a, ops.minplus(eye, a)))
    torch.cuda.synchronize()
    return calls


def check_minplus(calls) -> float:
    err = 0.0
    for what, a, b, got in calls:
        want = minplus_plain(a, b)
        err = max(err, float((got.float() - want.float()).abs().max()))
        check(torch.equal(got, want), f"minplus kernel != plain at {what}")
        if what.startswith("identity"):
            check(torch.equal(got, a if what.startswith("identity n") else b),
                  f"minplus {what}: eye is not the identity")
    log(f"phase b: minplus bit-equal to its plain version at {len(calls)} calls "
        f"(float32 and bf16, up to {MINPLUS_PATH_SHAPE}); identity holds; "
        f"max_abs_err {err}")
    n, device = 0, calls[0][1].device
    for dtype in MINPLUS_DTYPES:
        cases = [(f"specials {s}", probes.minplus_specials(s, 420 + i))
                 for i, s in enumerate(MINPLUS_NAN_SHAPES)]
        cases += [(f"probe {k}", probes.minplus_probe(k, 440 + i))
                  for i, k in enumerate(probes.MINPLUS_KINDS)]
        for what, arrays in cases:
            a, b = (t.to(dtype) for t in on(device, arrays))
            got, want = ops.minplus(a, b), minplus_plain(a, b)
            err = max(err, nan_err(got, want))
            check(probes.equal_nan(got, want), f"minplus kernel != plain at {what} {dtype}")
            if what.startswith("specials"):
                check(bool(torch.isnan(got[0]).all() and torch.isnan(got[:, 1]).all()),
                      f"minplus {what} {dtype}: a NaN did not propagate")
            n += 1
    log(f"phase b: NaN, inf, -0.0 and adversarial bf16-sum operands in {n} calls (float32 "
        f"and bf16): NaN where the plain version has it, bit-equal elsewhere; max_abs_err {err}")
    return err


def pool8_router(device) -> Router:
    """The ``pool8`` configuration of benchmarks/serve_router.py: 8 null
    engines, costs pre-seeded from ``default_rng(7)`` for 6 workload classes."""
    slots = [EngineSlot(f"e{i}", null_engine_factory(), "baseline") for i in range(POOL_P)]
    router = Router(slots, max_batch=8, max_split=4, device=device)
    rng = np.random.default_rng(7)
    for c in range(POOL_CLASSES):
        for e in range(POOL_P):
            router.costs.update((1 << (3 + c), POOL_NEW), e, float(rng.uniform(0.5e-3, 2e-3)))
    return router


def watch_ticks(router) -> list:
    """Record each tick's snapshot (DAG, slowdowns, plans, dispatched rids,
    host wall ms, kernel launches) as ``serve`` runs it."""
    ticks, tick = [], router.tick

    def recorded():
        before = dict(ops.LAUNCHES)
        t = time.perf_counter()
        out = tick()
        ms = (time.perf_counter() - t) * 1e3
        if out:
            ticks.append(dict(dag=router.last_dag, slow=router._slow.copy(),
                              plan=router.last_plan, nominal=router.last_nominal,
                              machine=router.machine, ms=ms,
                              launches={k: ops.LAUNCHES[k] - before[k] for k in before},
                              rids=[r.rid for d in out for r in d.requests]))
        return out

    router.tick = recorded
    return ticks


def submit_round(router, rng, per_class: int) -> list:
    rids = []
    for c in range(POOL_CLASSES):
        plen = 1 << (3 + c)
        for _ in range(per_class):
            r = Request(f"t{c}", rng.integers(2, 100, plen).astype(np.int32), POOL_NEW)
            check(router.submit(r), "the router refused a request")
            rids.append(r.rid)
    return rids


def serve_rounds(router, rng, rounds: int, per_round: int) -> tuple[list, dict]:
    rids, done = [], {}
    for _ in range(rounds):
        rids += submit_round(router, rng, per_round)
        out = router.serve()
        check(not set(out) & set(done), "a request completed twice")
        done.update(out)
    return rids, done


def same_plan_on_cpu(tick: dict, cpu_cache: PlanCache, what: str) -> None:
    """The tick's winning DAG planned with device="cpu": bit-equal plans, for
    the plane the router dispatched on and, when degraded, the nominal one."""
    n, src, dst, data, comp_nominal = tick["dag"]
    g = ct.request_graph(n, src, dst, data)
    planes = [(comp_nominal * tick["slow"][None, :], tick["plan"])]
    if tick["nominal"] is not None:
        planes.append((comp_nominal, tick["nominal"]))
    for comp, got in planes:
        want, _, _ = cpu_cache.plan(g, comp, tick["machine"], planner="ceft_cpop", store=False)
        check(np.array_equal(got.ceft, want.ceft) and got.path == want.path
              and got.cpl == want.cpl, f"{what}: card plan != cpu plan")


def relax_launches(counts: dict) -> int:
    """Launches of the kernels a sweep relaxes levels with."""
    return counts["seg_level"] + counts["ceft_relax"] + counts["edge_relax"]


def router_path(device) -> dict:
    """Phase c: the pool8 router with max_split = 4 on the card, 192 requests in
    4 rounds; each tick's plan checked against the CPU; then one engine is
    tripped through ``monitor.report``."""
    cpu_cache = PlanCache(device="cpu")
    out = {}
    for dev in (device, "cpu"):
        router = pool8_router(dev)
        ticks = watch_ticks(router)
        before = dict(ops.LAUNCHES)
        rids, done = serve_rounds(router, np.random.default_rng(7), POOL_ROUNDS,
                                  POOL_PER_CLASS // POOL_ROUNDS)
        after = dict(ops.LAUNCHES)
        n_req = POOL_CLASSES * POOL_PER_CLASS
        dispatched = [rid for t in ticks for rid in t["rids"]]
        check(len(rids) == n_req and set(done) == set(rids),
              f"{dev}: {len(done)} of {n_req} requests completed")
        check(sorted(dispatched) == sorted(rids), f"{dev}: a request was dispatched twice")
        out[dev] = dict(router=router, ticks=ticks,
                        launches={k: after[k] - before[k] for k in after})
    router, ticks = out[device]["router"], out[device]["ticks"]
    for k, t in enumerate(ticks):
        same_plan_on_cpu(t, cpu_cache, f"router tick {k}")
    launched = out[device]["launches"]
    check(relax_launches(launched) > 0,
          f"the router's ticks launched no relaxation kernel: {launched}")
    check(sum(out["cpu"]["launches"].values()) == 0, "the cpu router launched a kernel")

    med = {dev: float(np.median([t["ms"] for t in out[dev]["ticks"]])) for dev in out}
    # trip the engine that carries most of the critical path of one planned
    # tick, whose requests go back unserved: the next tick plans the same
    # requests at the same costs with that engine degraded.  The null engines
    # have fed near-zero measured rates into the cost table, so the reported
    # slowdown must outweigh that (the factor the router's hedge uses).
    k0 = len(ticks)
    trip_rids = submit_round(router, np.random.default_rng(8), 4)
    before = dict(ops.LAUNCHES)
    router._requeue(router.tick())
    mid = dict(ops.LAUNCHES)
    base = ticks[k0]
    path_engines = [p for _, p in base["plan"].path]
    slow = max(set(path_engines), key=path_engines.count)
    router.monitor.report(slow, 1e6)
    router.plancache.invalidate(engine=slow)
    n_deg = router.stats["degraded_plans"]
    done = router.serve()
    trip = {k: ops.LAUNCHES[k] - before[k] for k in before}
    nominal_launches = relax_launches(mid) - relax_launches(before)
    check(set(done) == set(trip_rids), "the tripped round lost a request")
    check(router.stats["degraded_plans"] > n_deg, "the tripped engine gave no degraded plan")
    # the tripped tick serves its nominal plane from the cache the untripped
    # tick swept on the card, and sweeps its degraded plane on the card
    check(nominal_launches > 0 and relax_launches(trip) > nominal_launches,
          f"the nominal or the degraded planes launched no kernel: {mid} {trip}")
    deg = ticks[k0 + 1]
    check(base["nominal"] is None and deg["nominal"] is not None,
          "the tripped tick kept no nominal plane")
    for k, t in enumerate(ticks[k0:]):
        same_plan_on_cpu(t, cpu_cache, f"trip tick {k}")
    check(slow not in {p for _, p in deg["plan"].path},
          f"the degraded path still uses engine {slow}: {deg['plan'].path}")
    log(f"phase c: router pool8 max_split=4: {n_req} requests exactly once in "
        f"{len(ticks[:k0])} ticks, every plan bit-equal to the CPU; median tick "
        f"{med[device]:.3f} ms on the card, {med['cpu']:.3f} ms with device='cpu' "
        f"({len(out['cpu']['ticks'])} ticks); launches {launched}; engine {slow} tripped: "
        f"path {base['plan'].path} -> {deg['plan'].path} (nominal plane "
        f"{deg['nominal'].path}), launches {trip}; "
        f"stats {router.stats}")
    return dict(launches={k: launched[k] + trip[k] for k in launched}, ticks=k0,
                tick_ms=med[device], tick_ms_cpu=med["cpu"])


def chaos_soak(device) -> dict:
    """Phase d: the seeded chaos soak on 4 subprocess workers."""
    specs = [WorkerSpec(f"w{i}", factory="repro_torch.serve.pool:null_engine_factory",
                        backend="subprocess") for i in range(4)]
    pool = EnginePool(specs, relaunch_backoff=0.05, relaunch_backoff_max=0.2)
    try:
        topo = pool.topology()
        check(all(t["cuda_initialized"] is False for t in topo),
              f"a worker child started CUDA: {topo}")
        apps = subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.split()
        check(not {str(t["pid"]) for t in topo} & set(apps),
              f"a worker child holds a CUDA context: {apps}")
        inj = install_chaos(pool, 7, calls=8, rate=0.5, hold=0.3)
        inj.hang_timeout = 5.0
        router = Router(pool, deadline_factor=3.0, min_deadline=0.05, wd_poll=0.005,
                        max_batch=4, device=device)
        rng = np.random.default_rng(7)
        rids = []
        for t, plen in enumerate((8, 16)):
            for _ in range(6):
                r = Request(f"t{t}", rng.integers(2, 100, plen).astype(np.int32), 4)
                check(router.submit(r), "the router refused a request")
                rids.append(r.rid)
        t0 = time.perf_counter()
        try:
            done = router.serve(max_ticks=500)
        finally:
            inj.release()
        soak_s = time.perf_counter() - t0
    finally:
        pool.close()
    check(set(done) == set(rids), f"lost {sorted(set(rids) - set(done))} under chaos")
    check(router.stats["completions"] == len(rids), "a request completed twice")
    check(router.stats["hedges"] <= router.stats["overdue_cp"], "hedges past overdue")
    fired = {k: inj.stats[k] for k in KINDS}
    check(sum(fired.values()) >= 3, f"the soak fired {fired}")
    line = (f"phase d: chaos soak seed 7 on 4 subprocess workers: {len(rids)} requests "
            f"exactly once in {soak_s:.3f} s; faults {fired}; pool {pool.stats}; nvidia-smi "
            f"compute apps {apps}")
    log(line)
    return dict(seconds=soak_s, faults=fired, line=line)


def chaos_process(path: str) -> None:
    """Phase d in a process of its own (``start_chaos``): the soak with
    every launch count set to 0 just before it; its result, the counts read
    just after it and its log line written to ``path``."""
    ops.reset_launches()
    out = chaos_soak("cuda")
    Path(path).write_text(json.dumps(dict(out, launches=dict(ops.LAUNCHES))))


def start_chaos() -> dict:
    """Phase d off the serial chain: ``chaos_process`` in a process of its
    own (its router plans on the card; its workers wait on injected faults
    and timeouts, not on the card), started after phase c and read by
    ``finish_chaos`` after phase g."""
    out = Path(tempfile.mkdtemp())
    root = Path(__file__).resolve().parent
    with open(out / "chaos.log", "w") as log_file:
        proc = subprocess.Popen(
            [sys.executable, "-c", "import sys, chip_smoke; chip_smoke.chaos_process(sys.argv[1])",
             str(out / "chaos.json")], cwd=root, stdout=log_file, stderr=subprocess.STDOUT,
            env=dict(os.environ, PYTHONPATH=str(root / "src")))
    CHILDREN.append(proc)
    return dict(proc=proc, dir=out, started_s=time.perf_counter() - _T0, wall=time.time())


def finish_chaos(chaos: dict) -> tuple[dict, dict]:
    """Phase d, read: the process's exit (every check of the soak held) and
    its result and launch counts."""
    proc, out = chaos["proc"], chaos["dir"]
    try:
        proc.wait(timeout=CHAOS_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    text = (out / "chaos.log").read_text()
    check(proc.returncode == 0, f"phase d exited with {proc.returncode}: {text[-4000:]}")
    rec = json.loads((out / "chaos.json").read_text())
    ended_s = chaos["started_s"] + (out / "chaos.json").stat().st_mtime - chaos["wall"]
    SPANS["d (own process)"] = (chaos["started_s"], ended_s)
    shutil.rmtree(out, ignore_errors=True)
    log(f"{rec.pop('line')} (in a process of its own from {chaos['started_s']:.1f} s to "
        f"{ended_s:.1f} s, read at {time.perf_counter() - _T0:.1f} s)")
    return rec, rec.pop("launches")


def rel_err(got, want) -> float:
    """max |got - want| over max |want| (the reference's bf16 measure)."""
    got, want = got.float().cpu(), want.float().cpu()
    return float((got - want).abs().max() / want.abs().max())


def forced_logits(engine, prompts, forced) -> list:
    """The last prompt token's prefill logits, then each teacher-forced decode
    step's logits (the columns of ``forced`` fed one at a time), on the CPU."""
    B, P = prompts.shape
    dev = engine.device
    with torch.inference_mode():
        cache, logits = engine.model.prefill(
            engine.params, {"tokens": torch.as_tensor(prompts, device=dev)})
        out = [logits[:, -1].float().cpu()]
        cache = engine._seed_cache(cache, B, P + forced.shape[1], P)
        for i in range(forced.shape[1]):
            logits, cache = engine.model.decode(
                engine.params, cache, torch.as_tensor(forced[:, i:i + 1], device=dev), P + i)
            out.append(logits[:, -1].float().cpu())
    return out


def tf32_off() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    check(not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32,
          "TF32 is on")


def card_vs_cpu(base, params, on_card, prompts, forced, device) -> dict:
    """One engine on the card against the same weights on the CPU: in
    float32 compute (TF32 off) prefill and teacher-forced decode logits
    within 1e-4 relative and ``E1_NEW`` greedy tokens identical; in bf16
    the logits within 5e-2 relative (the reference's bf16 bound)."""
    out = {}
    for dtype, tol in (("float32", 1e-4), ("bfloat16", 5e-2)):
        cfg = dataclasses.replace(base, compute_dtype=dtype)
        cpu = Engine(cfg, params=params, device="cpu")
        card = Engine(cfg, params=on_card, device=device)
        errs = [rel_err(g, w) for g, w in zip(forced_logits(card, prompts, forced),
                                              forced_logits(cpu, prompts, forced))]
        check(max(errs) < tol, f"{dtype}: card logits off the CPU's by {errs} (bound {tol})")
        out[dtype] = dict(prefill_rel_err=errs[0], decode_rel_err=max(errs[1:]), bound=tol)
        if dtype == "float32":
            P = prompts.shape[1]
            scfg = ServeConfig(max_new_tokens=E1_NEW)
            got, want = card.generate(prompts, scfg), cpu.generate(prompts, scfg)
            check(np.array_equal(got, want), f"greedy tokens differ: card {got[:, P:]} "
                  f"cpu {want[:, P:]}")
            out[dtype]["greedy_tokens_equal"] = int(got.size)
    return out


def lm_card_vs_cpu(device) -> dict:
    """Phase e1: granite-3-8b at its published widths and 2 of its 40 layers,
    weights made once on the CPU from a seed and copied to the card; the card
    against the CPU in float32 compute with TF32 off (prefill and decode
    logits within 1e-4 relative, greedy tokens identical) and in the
    config's bf16 (logits within 5e-2 relative, the reference's bf16
    bound)."""
    tf32_off()
    base = dataclasses.replace(configs.get(LM_ARCH), n_layers=E1_LAYERS)
    t = time.perf_counter()
    params = build(base).init(torch.Generator().manual_seed(LM_SEED), "cpu")
    on_card = tree_to(params, device)
    setup_s = time.perf_counter() - t
    n_bytes = sum(p.numel() * p.element_size() for p in tree_leaves(params))
    rng = np.random.default_rng(LM_SEED)
    prompts = rng.integers(2, base.vocab, (E1_B, E1_P)).astype(np.int32)
    forced = rng.integers(2, base.vocab, (E1_B, E1_FORCED)).astype(np.int32)
    out = dict(layers=E1_LAYERS, param_bytes=n_bytes, setup_s=setup_s,
               **card_vs_cpu(base, params, on_card, prompts, forced, device))
    del on_card
    torch.cuda.empty_cache()
    log(f"phase e1: {LM_ARCH} at its published widths, {E1_LAYERS} layers "
        f"({n_bytes / 1e9:.3f} GB float32, made on the CPU and copied in {setup_s:.1f} s): "
        f"card vs CPU, B={E1_B} prompt {E1_P}: float32 (TF32 off) prefill rel err "
        f"{out['float32']['prefill_rel_err']:.3e}, decode {out['float32']['decode_rel_err']:.3e}, "
        f"{E1_NEW} greedy tokens identical; bf16 prefill {out['bfloat16']['prefill_rel_err']:.3e}, "
        f"{E1_FORCED} teacher-forced decode steps {out['bfloat16']['decode_rel_err']:.3e}")
    return out


def lm_step_times(engine, prompts, n_new: int, reps: int = 3) -> dict:
    """The engine's prefill of ``prompts`` and its decode step (decode, argmax,
    the token to the host, as ``generate`` takes it) in ms, host clock ended
    by a synchronize; medians of ``reps``."""
    B, P = prompts.shape
    dev = engine.device
    tokens = torch.as_tensor(prompts, device=dev)
    pf, dec = [], []
    with torch.inference_mode():
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cache, logits = engine.model.prefill(engine.params, {"tokens": tokens})
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            cache = engine._seed_cache(cache, B, P + n_new, P)
            cur = torch.argmax(logits[:, -1], dim=-1).cpu().numpy()
            t2 = time.perf_counter()
            for t in range(P, P + n_new - 1):
                step = torch.as_tensor(cur[:, None].astype(np.int32), device=dev)
                logits, cache = engine.model.decode(engine.params, cache, step, t)
                cur = torch.argmax(logits[:, -1], dim=-1).cpu().numpy()
            t3 = time.perf_counter()
            pf.append((t1 - t0) * 1e3)
            dec.append((t3 - t2) * 1e3 / (n_new - 1))
            del cache, logits
    return dict(prefill_ms=float(np.median(pf)), decode_ms_per_token=float(np.median(dec)),
                prefill_ms_runs=pf, decode_ms_runs=dec)


def ssm_bounds(cfg, B: int, P: int, n_new: int) -> dict:
    """The least time (ms) the card could take for an SSM engine's prefill
    of a (B, P) batch and for one of its decode steps.  Prefill: the
    products' operations (2 per multiply-add: the in and out projections on
    B·P tokens; the chunked SSD's scores C·B, its intra-chunk product, its
    chunk states and its inter-chunk output; the unembedding on the B last
    tokens) over the dense bf16 tensor-core peak, though the SSD's state
    products run in float32.  Decode: the bytes one step moves over the
    memory rate: 8 bytes a parameter as for the dense stack (each weight
    read in float32, its bf16 cast written and read; the tied embedding
    read whole to unembed, and B of its rows gathered), and the float32 SSM
    state and conv history, each read and written."""
    d, V, L = cfg.d_model, cfg.vocab, cfg.n_layers
    di, H, Ph, N = cfg.d_inner, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    Q = min(cfg.ssm_chunk, P)
    nc = -(-P // Q)
    proj = 2 * B * P * (d * (2 * di + 2 * N + H) + di * d)
    ssd = 2 * B * nc * (Q * Q * N + H * Q * Q * Ph + 2 * Q * H * Ph * N)
    flops = L * (proj + ssd) + 2 * B * d * V
    n_params = sum(t.numel() for t in tree_leaves(build(cfg).abstract()))
    state = L * B * (H * Ph * N + (cfg.ssm_conv - 1) * (di + 2 * N))
    dec_bytes = 8 * (n_params + B * d) + 2 * 4 * state
    return dict(prefill_flops=flops, prefill_bound_ms=flops / BF16_TENSOR_OPS_PER_S * 1e3,
                prefill_bound_by="operations", decode_bytes=dec_bytes,
                decode_bound_ms=dec_bytes / HBM_BYTES_PER_S * 1e3, decode_bound_by="bytes")


def beyond_n_params(cfg) -> dict:
    """Each leaf of the spec tree that ``ArchConfig.n_params()`` leaves out,
    by path, with its count over the stacked layers: the norms, and an SSM
    layer's conv weight and bias, A (``a_log``), D (``d_skip``), dt bias and
    gated norm.  ``n_params()`` counts the embeddings, attention, MLP and
    MoE weights and the SSM's in and out projections."""
    counted = {"embed", "unembed", "attn", "mlp", "moe", "in_proj", "out_proj"}
    out = {}

    def walk(tree, path):
        for k, v in tree.items():
            if k in counted:
                continue
            if isinstance(v, dict):
                walk(v, f"{path}{k}/")
            else:
                out[path + k] = v.numel()
    walk(build(cfg).abstract(), "")
    return out


def lm_bounds(cfg, B: int, P: int, n_new: int) -> dict:
    """The least time (ms) the card could take for the engine's prefill of a
    (B, P) batch and for one of its decode steps.  Prefill: the products'
    operations (2 per multiply-add: every layer weight on B·P tokens, the
    unembedding on the B last tokens, causal attention's QK and PV) over the
    bf16 tensor-core peak.  Decode: the bytes one step moves over the memory
    rate: each weight read in float32 and its bf16 cast written and read
    again (8 bytes a parameter), and the float32 KV cache read with its bf16
    cast written and read (8 bytes an element, the whole P + new slots)."""
    d, V, L, hd = cfg.d_model, cfg.vocab, cfg.n_layers, cfg.hd
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    w_layer = d * hd * (hq + 2 * hkv) + hq * hd * d + 3 * d * cfg.d_ff
    flops = (2 * B * P * L * w_layer + 2 * B * d * V + 2 * B * L * hq * hd * P * (P + 1))
    w_step = L * (w_layer + 2 * d) + d * V + d + B * d
    kv = 2 * L * B * (P + n_new) * hkv * hd
    dec_bytes = 8 * w_step + 8 * kv
    return dict(prefill_flops=flops, prefill_bound_ms=flops / BF16_TENSOR_OPS_PER_S * 1e3,
                prefill_bound_by="operations", decode_bytes=dec_bytes,
                decode_bound_ms=dec_bytes / HBM_BYTES_PER_S * 1e3, decode_bound_by="bytes")


def lm_serve_round(router, ticks: list, rng, cfg) -> dict:
    """One round of e2's traffic through ``router.serve``: every request
    completes exactly once, with its prompt in front and every token in the
    vocabulary.  Returns the requests, the serve wall time and the launches."""
    reqs = []
    for k, plen in enumerate(E2_PROMPTS):
        for _ in range(E2_PER_TENANT):
            r = Request(f"tenant{k}", rng.integers(2, cfg.vocab, plen).astype(np.int32), E2_NEW)
            check(router.submit(r), "the router refused a request")
            reqs.append(r)
    n_ticks = len(ticks)
    before = dict(ops.LAUNCHES)
    torch.cuda.synchronize()
    t = time.perf_counter()
    done = router.serve()
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t
    rids = sorted(r.rid for r in reqs)
    check(sorted(done) == rids, f"{len(done)} of {len(reqs)} requests completed")
    check(sorted(rid for tk in ticks[n_ticks:] for rid in tk["rids"]) == rids,
          "a request was dispatched twice or never")
    for r in reqs:
        got, plen = done[r.rid], r.prompt.shape[0]
        check(got.shape == (plen + E2_NEW,) and np.array_equal(got[:plen], r.prompt),
              f"request {r.rid}: {got.shape}, prompt not in front")
        check(got.min() >= 0 and got.max() < cfg.vocab, f"request {r.rid}: token out of range")
    return dict(reqs=reqs, serve_s=serve_s, tokens_per_s=len(reqs) * E2_NEW / serve_s,
                launches={k: ops.LAUNCHES[k] - before[k] for k in before})


def lm_router(device, arch: str = LM_ARCH, phase: str = "e2") -> dict:
    """Phase e2 (f2): granite-3-8b (mamba2-2.7b) as published, weights made
    on the card from a ``torch.Generator`` there and shared by two engines
    (profiles serve and baseline) behind ``Router(device="cuda",
    max_batch=4)``; two tenants send 4 requests each (prompts of 512 and 256
    tokens, 32 new tokens), twice (the first round meets cold engines).
    Every request completes once with its prompt in front and tokens in the
    vocabulary, the ticks launch ``ceft_relax``, and the same batch through
    one engine twice gives the same tokens.  Then the engine's prefill and
    decode step are timed at (4, 512) beside their bounds."""
    cfg = configs.get(arch)
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    params = build(cfg).init(torch.Generator(device).manual_seed(LM_SEED), device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    n_params = sum(p.numel() for p in tree_leaves(params))
    beyond = beyond_n_params(cfg)
    check(n_params == cfg.n_params() + sum(beyond.values()),
          f"{n_params} parameters, not {cfg.n_params()} and {beyond}")
    profiles = ("serve", "baseline")
    engines = [Engine(cfg, params=params, profile=p, device=device) for p in profiles]
    check(all(e.params is params for e in engines), "the engines copied the parameters")
    router = Router([EngineSlot(f"{arch}:{p}#{i}", e, p)
                     for i, (e, p) in enumerate(zip(engines, profiles))],
                    device=device, max_batch=E2_BATCH)
    ticks, dispatches, run = watch_ticks(router), [], router.run_dispatch

    def timed_dispatch(d):
        t = time.perf_counter()
        res = run(d)
        dispatches.append((d.engine, len(d.requests), int(d.requests[0].prompt.shape[0]),
                           round(time.perf_counter() - t, 4)))
        return res

    router.run_dispatch = timed_dispatch
    rng = np.random.default_rng(LM_SEED)
    rounds = [lm_serve_round(router, ticks, rng, cfg) for _ in range(E2_ROUNDS)]
    launched = {k: sum(r["launches"][k] for r in rounds) for k in ops.LAUNCHES}
    check(launched["ceft_relax"] >= 1, f"the router's ticks launched no ceft_relax: {launched}")
    reqs = rounds[0]["reqs"]

    batch = np.stack([r.prompt for r in reqs[:E2_BATCH]])         # (4, 512)
    scfg = ServeConfig(max_new_tokens=E2_NEW)
    t = time.perf_counter()
    first = engines[0].generate(batch, scfg)
    generate_s = time.perf_counter() - t
    check(np.array_equal(first, engines[0].generate(batch, scfg)),
          "the same batch through one engine twice gave other tokens")
    steps = lm_step_times(engines[0], batch, E2_NEW)
    peak = torch.cuda.max_memory_allocated()
    bounds = (ssm_bounds if cfg.family == "ssm" else lm_bounds)(cfg, *batch.shape, E2_NEW)
    card = smi("name,power.limit")
    out = dict(
        arch=arch, layers=cfg.n_layers, params=n_params, beyond_n_params=beyond,
        init_s=init_s,
        requests_per_round=len(reqs), serve_s=[r["serve_s"] for r in rounds],
        tokens_per_s=[r["tokens_per_s"] for r in rounds],
        generate_4x512_s=generate_s, generate_tokens_per_s=E2_BATCH * E2_NEW / generate_s,
        **steps, **bounds, max_memory_allocated=peak,
        ticks=[dict(ms=tk["ms"], ceft_relax=tk["launches"]["ceft_relax"],
                    dispatched=len(tk["rids"])) for tk in ticks],
        dispatches=dispatches, launches=launched, path=str(router.last_plan.path),
        card=card)
    # the patched tick and dispatch hold the router, and through it the
    # engines and their weights, in reference cycles: collect them so the
    # next phase starts with the card's memory free
    del engines, router, params, run, ticks, timed_dispatch
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase {phase}: {arch} as published ({cfg.n_layers} layers, {n_params} parameters "
        f"= n_params() {cfg.n_params()} + {beyond}, made on the card in {init_s:.1f} s), "
        f"2 engines sharing them behind "
        f"Router(device='cuda', max_batch={E2_BATCH}): {E2_ROUNDS} rounds of {len(reqs)} "
        f"requests, each exactly once, in {out['serve_s']} s ({out['tokens_per_s']} tokens/s; "
        f"the first round is cold), ticks "
        f"{[(round(tk['ms'], 3), tk['ceft_relax']) for tk in out['ticks']]} (ms, ceft_relax "
        f"launches), dispatches {dispatches} (engine, requests, prompt, s), launches "
        f"{launched}; card {card}")
    log(f"phase {phase}: (4, 512) prefill {steps['prefill_ms']:.3f} ms (bound "
        f"{bounds['prefill_bound_ms']:.3f} ms, operations), decode "
        f"{steps['decode_ms_per_token']:.3f} ms a token (bound {bounds['decode_bound_ms']:.3f} "
        f"ms, bytes), generate {generate_s:.3f} s ({out['generate_tokens_per_s']:.2f} tokens/s), "
        f"peak memory {peak / 2**30:.3f} GiB; card {card}")
    print(json.dumps({"lm_serving" if phase == "e2" else "ssm_serving": out}), flush=True)
    return out


def lm_path(device) -> dict:
    """Phase e: the LM serving path (e1, then e2)."""
    return dict(e1=lm_card_vs_cpu(device), e2=lm_router(device))


def ssm_card_vs_cpu(device) -> dict:
    """Phase f1: mamba2-2.7b at its published widths and 2 of its 64
    layers, weights made once on the CPU from a seed and copied to the card;
    the card against the CPU at B = 2 on a prompt of one whole SSM chunk
    (64) and a padded one (100), as ``card_vs_cpu`` holds them."""
    tf32_off()
    base = dataclasses.replace(configs.get(SSM_ARCH), n_layers=F1_LAYERS)
    params = build(base).init(torch.Generator().manual_seed(LM_SEED), "cpu")
    on_card = tree_to(params, device)
    n_bytes = sum(p.numel() * p.element_size() for p in tree_leaves(params))
    rng = np.random.default_rng(LM_SEED)
    out = dict(layers=F1_LAYERS, param_bytes=n_bytes)
    for P in F1_PROMPTS:
        prompts = rng.integers(2, base.vocab, (E1_B, P)).astype(np.int32)
        forced = rng.integers(2, base.vocab, (E1_B, E1_FORCED)).astype(np.int32)
        out[P] = card_vs_cpu(base, params, on_card, prompts, forced, device)
    del on_card
    torch.cuda.empty_cache()
    log(f"phase f1: {SSM_ARCH} at its published widths, {F1_LAYERS} layers "
        f"({n_bytes / 1e9:.3f} GB float32): card vs CPU, B={E1_B}, prefill / "
        f"{E1_FORCED} teacher-forced decode steps rel err: "
        + "; ".join(f"prompt {P}: float32 (TF32 off) {out[P]['float32']['prefill_rel_err']:.3e}"
                    f" / {out[P]['float32']['decode_rel_err']:.3e}, bf16 "
                    f"{out[P]['bfloat16']['prefill_rel_err']:.3e} / "
                    f"{out[P]['bfloat16']['decode_rel_err']:.3e}" for P in F1_PROMPTS)
        + f"; {E1_NEW} greedy float32 tokens identical at each")
    return out


def whisper_logits(model, params, tokens, P: int) -> list:
    """whisper's ``Model.prefill`` of ``tokens[:, :P]`` on zero frames (the
    reference engine's stub), then ``Model.decode`` teacher-forced on the
    rest (the self cache seeded from the prefill, the cross cache as it
    comes); the last-token logits of each call, on the CPU."""
    cfg, dev = model.cfg, tokens.device
    B, S = tokens.shape
    with torch.inference_mode():
        frames = torch.zeros((B, cfg.enc_seq, cfg.d_model), device=dev)
        pf, logits = model.prefill(params, {"frames": frames, "tokens": tokens[:, :P]})
        cache = init_params(model.cache_specs(B, S), None, dev)
        for n in ("k", "v"):
            cache["self"][n][:, :, :P] = pf["self"][n]
            cache["cross"][n].copy_(pf["cross"][n])
        out = [logits[:, -1].float().cpu()]
        for t in range(P, S):
            logits, cache = model.decode(params, cache, tokens[:, t:t + 1], t)
            out.append(logits[:, -1].float().cpu())
    return out


def hybrid_and_encdec(device) -> dict:
    """Phase f3, card against CPU in float32 with TF32 off: jamba-smoke
    through ``Engine.generate`` (identical greedy tokens), and whisper-tiny
    at its published widths (4 + 4 layers, 1500 encoder frames) through
    ``Model.prefill`` and teacher-forced ``Model.decode`` (logits within
    1e-4 relative)."""
    tf32_off()
    cfg = dataclasses.replace(configs.get(HYBRID_ARCH, smoke=True), compute_dtype="float32")
    cpu = Engine(cfg, seed=LM_SEED, device="cpu")
    card = Engine(cfg, params=tree_to(cpu.params, device), device=device)
    rng = np.random.default_rng(LM_SEED)
    prompts = rng.integers(2, cfg.vocab, (E1_B, F3_P)).astype(np.int32)
    scfg = ServeConfig(max_new_tokens=E1_NEW)
    got, want = card.generate(prompts, scfg), cpu.generate(prompts, scfg)
    check(np.array_equal(got, want), f"{cfg.name}: greedy tokens differ: card "
          f"{got[:, F3_P:]} cpu {want[:, F3_P:]}")
    wcfg = dataclasses.replace(configs.get(ENCDEC_ARCH), compute_dtype="float32")
    model = build(wcfg)
    params = model.init(torch.Generator().manual_seed(LM_SEED), "cpu")
    n_params = sum(p.numel() for p in tree_leaves(params))
    tokens = torch.as_tensor(rng.integers(2, wcfg.vocab, (E1_B, F3_P + F3_STEPS)))
    errs = [rel_err(g, w) for g, w in zip(
        whisper_logits(model, tree_to(params, device), tokens.to(device), F3_P),
        whisper_logits(model, params, tokens, F3_P))]
    check(max(errs) < 1e-4, f"{ENCDEC_ARCH}: card logits off the CPU's by {errs}")
    torch.cuda.empty_cache()
    out = dict(hybrid=dict(arch=cfg.name, greedy_tokens_equal=int(got.size)),
               encdec=dict(arch=wcfg.name, params=n_params, prefill_rel_err=errs[0],
                           decode_rel_err=max(errs[1:]), bound=1e-4))
    log(f"phase f3: {cfg.name} card vs CPU, B={E1_B} prompt {F3_P}: {E1_NEW} greedy tokens "
        f"identical; {wcfg.name} as published ({wcfg.n_layers} + {wcfg.enc_layers} layers, "
        f"{wcfg.enc_seq} frames, {n_params} parameters) card vs CPU, float32 (TF32 off): "
        f"prefill rel err {errs[0]:.3e}, {F3_STEPS} teacher-forced decode steps "
        f"{max(errs[1:]):.3e}")
    return out


def ssm_path(device) -> dict:
    """Phase f: the SSM serving path (f1, f2), then the hybrid and the
    encoder-decoder (f3)."""
    return dict(f1=ssm_card_vs_cpu(device), f2=lm_router(device, SSM_ARCH, "f2"),
                f3=hybrid_and_encdec(device))


def clone_tree(tree, device):
    """A copy of every tensor of a nested-dict tree on ``device``."""
    if isinstance(tree, dict):
        return {k: clone_tree(v, device) for k, v in tree.items()}
    return tree.to(device, copy=True)


def one_step(cfg, params, batch, device) -> dict:
    """One ``TrainStep`` of ``cfg`` on ``device`` from a copy of ``params``,
    its two halves apart: the loss and gradients, then the AdamW update.
    Returns the loss, the grad norm, the gradients and the updated
    parameters (sorted key order, on the CPU) and the step's rate."""
    step, opt, _ = build_train(build(cfg), None, G2_STEPS, G2_PEAK_LR)
    p = clone_tree(params, device)
    state = opt.init(p)
    loss, grads = step.loss_and_grads(p, {k: torch.as_tensor(v, device=device)
                                          for k, v in batch.items()})
    p, state, gnorm = opt.update(grads, state, p)
    return dict(loss=loss.item(), grad_norm=gnorm.item(), lr=float(opt.lr(state.count)),
                grads=[t.float().cpu() for t in sorted_leaves(grads)],
                params=[t.detach().float().cpu() for t in sorted_leaves(p)])


def train_card_vs_cpu(device) -> dict:
    """Phase g1: minicpm-2b at its published widths and 2 of its 40 layers,
    weights made once on the CPU from a seed; one ``TrainStep`` on a fixed
    ``SyntheticLM`` batch on the card against the CPU.  float32 compute
    (TF32 off): the loss within 1e-5 relative, the grad norm within 1e-4,
    each gradient leaf within 1e-4 of its largest entry; bf16 compute: the
    loss and grad norm within 5e-2 and the gradient tree within 5e-2 of its
    largest entry.  The updated parameters: no entry further from the CPU's
    than two learning rates (Adam's first step is the gradient's sign where
    the gradient is above its epsilon, so a gradient entry summed to near
    zero may step either way; the share of entries off by more than a
    hundredth of a step is reported)."""
    tf32_off()
    base = dataclasses.replace(configs.get(TRAIN_ARCH), n_layers=G1_LAYERS)
    params = build(base).init(torch.Generator().manual_seed(LM_SEED), "cpu")
    batch = SyntheticLM(DataConfig(base.vocab, G1_S, G1_B, LM_SEED)).batch(0)
    out = dict(layers=G1_LAYERS, batch=[G1_B, G1_S],
               params=sum(t.numel() for t in tree_leaves(params)))
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(base, compute_dtype=dtype)
        card, cpu = (one_step(cfg, params, batch, d) for d in (device, "cpu"))
        lr = cpu["lr"]
        diffs = [(a - b).abs() for a, b in zip(card["params"], cpu["params"])]
        errs = dict(
            loss=abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"]),
            grad_norm=abs(card["grad_norm"] - cpu["grad_norm"]) / abs(cpu["grad_norm"]),
            grad_leaf=max(float((a - b).abs().max() / b.abs().max())
                          for a, b in zip(card["grads"], cpu["grads"])),
            grad_tree=max(float((a - b).abs().max()) for a, b in zip(card["grads"], cpu["grads"]))
            / max(float(b.abs().max()) for b in cpu["grads"]),
            params_in_lr=max(float(d.max()) for d in diffs) / lr)
        out_share = sum(int((d > 1e-2 * lr).sum()) for d in diffs) / out["params"]
        f32 = dtype == "float32"
        # two rates: a step of -lr against one of +lr, and the parameter's rounding
        bounds = dict(loss=1e-5 if f32 else 5e-2, grad_norm=1e-4 if f32 else 5e-2,
                      params_in_lr=2.01)
        bounds["grad_leaf" if f32 else "grad_tree"] = 1e-4 if f32 else 5e-2
        check(all(errs[k] <= b for k, b in bounds.items()),
              f"{dtype}: the card's train step is off the CPU's by {errs} (bounds {bounds})")
        check(np.isfinite(card["loss"]) and np.isfinite(card["grad_norm"]), "not finite")
        out[dtype] = dict(loss=[card["loss"], cpu["loss"]],
                          grad_norm=[card["grad_norm"], cpu["grad_norm"]], lr=lr,
                          rel_err=errs, bounds=bounds, params_off_by_a_hundredth_step=out_share)
    torch.cuda.empty_cache()
    log(f"phase g1: {TRAIN_ARCH} at its published widths, {G1_LAYERS} layers "
        f"({out['params']} parameters): one TrainStep at (B, S) = ({G1_B}, {G1_S}) card vs "
        f"CPU: float32 (TF32 off) {out['float32']['rel_err']} (share of parameters off by "
        f"over a hundredth of a step {out['float32']['params_off_by_a_hundredth_step']:.3e}), "
        f"bf16 {out['bfloat16']['rel_err']} "
        f"({out['bfloat16']['params_off_by_a_hundredth_step']:.3e})")
    return out


def train_bounds(cfg, B: int, S: int, n_params: int) -> dict:
    """The least time (ms) the card could take for one full-width train
    step.  Forward + backward: the products' operations over the dense bf16
    tensor-core peak -- each layer weight and the (tied) unembedding on
    B·S tokens, causal attention's QK and PV, 2 per multiply-add -- taken
    4 times: the forward, the backward (twice the forward), and the forward
    again that ``remat = "full"`` (each layer) and the chunked loss
    (each logits chunk) recompute in the backward.  The AdamW update: 28
    bytes a float32 parameter over the memory rate."""
    d, V, L, hd = cfg.d_model, cfg.vocab, cfg.n_layers, cfg.hd
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    w_layer = d * hd * (hq + 2 * hkv) + hq * hd * d + 3 * d * cfg.d_ff
    fwd = 2 * B * S * (L * w_layer + d * V) + 2 * B * L * hq * hd * S * (S + 1)
    upd_bytes = ADAMW_BYTES_PER_PARAM * n_params
    fb_ms = 4 * fwd / BF16_TENSOR_OPS_PER_S * 1e3
    upd_ms = upd_bytes / HBM_BYTES_PER_S * 1e3
    return dict(fwd_bwd_flops=4 * fwd, fwd_bwd_bound_ms=fb_ms, fwd_bwd_bound_by="operations",
                update_bytes=upd_bytes, update_bound_ms=upd_ms, update_bound_by="bytes",
                step_bound_ms=fb_ms + upd_ms,
                tokens_per_s_bound=B * S / ((fb_ms + upd_ms) / 1e3))


def same_schedule(a, b, what: str) -> None:
    check(np.array_equal(a.proc, b.proc) and np.array_equal(a.start, b.start)
          and np.array_equal(a.finish, b.finish) and a.makespan == b.makespan,
          f"{what}: the card's schedule differs from the CPU's")


def train_replan(device, cfg, cell) -> dict:
    """The straggler re-plan of the training layer DAG of ``cell``:
    ``StragglerMonitor(4, device="cuda")`` against the same monitor on the
    CPU, fed one quiet step, then class 0 slowed 2x until the monitor's
    EWMA trips its threshold; every plan bit-equal to the CPU's, and the
    degraded one launching ``ceft_relax``."""
    g, comp, m, _ = build_layer_dag(cfg, cell)
    runs = plancache.device_state(g, device)[0]
    mons = {dev: StragglerMonitor(m.P, device=dev) for dev in (device, "cpu")}
    steps, launches = [], []
    for k in range(6):
        times = np.ones(m.P)
        if k:
            times[0] = 2.0
        before = ops.LAUNCHES["ceft_relax"]
        t = time.perf_counter()
        sched, ev = mons[device].maybe_replan(k, g, comp, m, times)
        torch.cuda.synchronize()
        steps.append(round(time.perf_counter() - t, 4))
        launches.append(ops.LAUNCHES["ceft_relax"] - before)
        want, want_ev = mons["cpu"].maybe_replan(k, g, comp, m, times)
        same_schedule(sched, want, f"re-plan step {k}")
        check((ev is None) == (want_ev is None), f"step {k}: events differ")
        if ev is not None:
            break
    check(ev is not None and launches[-1] >= 1,
          f"no degraded re-plan on the card launching ceft_relax: {launches}")
    return dict(tasks=g.n, edges=g.n_edges, P=m.P,
                layouts=[(r.layout, len(r.levels)) for r in runs],
                step_s=steps, ceft_relax_launches=launches, slowdown=ev.slowdown,
                makespan_ratio=ev.new_makespan / ev.old_makespan)


def train_full_width(device) -> dict:
    """Phase g2: minicpm-2b as published (40 layers, 2.72 B parameters made
    on the card from a ``torch.Generator``; float32 weights and AdamW
    moments, bf16 compute, the WSD schedule) through ``build_train`` and
    ``SyntheticLM``: five steps at (B, S) = (2, 4096), every loss and grad
    norm finite; forward + backward and the update timed apart (host clock
    ended by a synchronize), beside their bounds, tokens/s and the peak
    memory; then the straggler re-plan of this cell's layer DAG.  Starts
    and ends with the card's memory free."""
    cfg = configs.get(TRAIN_ARCH)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    free0 = torch.cuda.memory_allocated()
    t = time.perf_counter()
    model = build(cfg)
    params = model.init(torch.Generator(device).manual_seed(LM_SEED), device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    n_params = sum(p.numel() for p in tree_leaves(params))
    beyond = beyond_n_params(cfg)
    check(n_params == cfg.n_params() + sum(beyond.values()),
          f"{n_params} parameters, not {cfg.n_params()} and {beyond}")
    step, opt, _ = build_train(model, None, G2_STEPS, G2_PEAK_LR)
    state = opt.init(params)
    data = SyntheticLM(DataConfig(cfg.vocab, G2_S, G2_B, LM_SEED))
    batches = [data.device_batch(i, device) for i in range(G2_STEPS)]
    state_bytes = sum(t.numel() * t.element_size() for t in
                      tree_leaves(params) + sorted_leaves(state.m) + sorted_leaves(state.v))
    rows = []
    for batch in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grads = step.loss_and_grads(params, batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        params, state, gnorm = opt.update(grads, state, params)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        del grads
        rows.append(dict(loss=loss.item(), grad_norm=gnorm.item(),
                         fwd_bwd_ms=(t1 - t0) * 1e3, update_ms=(t2 - t1) * 1e3))
    check(all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in rows),
          f"a loss or grad norm is not finite: {rows}")
    check(int(state.count) == G2_STEPS, f"count {int(state.count)}")
    peak = torch.cuda.max_memory_allocated()
    last = rows[-3:]
    fb = float(np.median([r["fwd_bwd_ms"] for r in last]))
    upd = float(np.median([r["update_ms"] for r in last]))
    step_ms = float(np.median([r["fwd_bwd_ms"] + r["update_ms"] for r in last]))
    bounds = train_bounds(cfg, G2_B, G2_S, n_params)
    del params, state, batches, loss, gnorm, step, opt, model
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() - free0
    check(held < 2**28, f"{held} bytes still held after g2")
    replan = train_replan(device, cfg, ShapeCell("g2", G2_S, G2_B, "train"))
    card = smi("name,power.limit")
    out = dict(arch=TRAIN_ARCH, layers=cfg.n_layers, params=n_params, beyond_n_params=beyond,
               batch=[G2_B, G2_S], init_s=init_s, state_bytes=state_bytes, steps=rows,
               fwd_bwd_ms=fb, update_ms=upd, step_ms=step_ms,
               tokens_per_s=G2_B * G2_S / (step_ms / 1e3), max_memory_allocated=peak,
               **bounds, replan=replan, card=card)
    log(f"phase g2: {TRAIN_ARCH} as published ({cfg.n_layers} layers, {n_params} parameters, "
        f"made on the card in {init_s:.1f} s; weights and moments {state_bytes / 1e9:.2f} GB): "
        f"{G2_STEPS} steps at (B, S) = ({G2_B}, {G2_S}), losses "
        f"{[round(r['loss'], 5) for r in rows]}, grad norms "
        f"{[round(r['grad_norm'], 5) for r in rows]}")
    log(f"phase g2: step {step_ms:.3f} ms (bound {bounds['step_bound_ms']:.3f}): forward + "
        f"backward {fb:.3f} ms (bound {bounds['fwd_bwd_bound_ms']:.3f} ms, operations), "
        f"AdamW update {upd:.3f} ms (bound {bounds['update_bound_ms']:.3f} ms, bytes), "
        f"{out['tokens_per_s']:.1f} tokens/s (bound {bounds['tokens_per_s_bound']:.1f}), "
        f"peak memory {peak / 1e9:.3f} GB; medians of the last 3; card {card}")
    log(f"phase g2: straggler re-plan of the {replan['tasks']}-task layer DAG (P = "
        f"{replan['P']}, layouts {replan['layouts']}): steps {replan['step_s']} s, "
        f"ceft_relax launches {replan['ceft_relax_launches']}, bit-equal to the CPU, "
        f"slowdown {replan['slowdown']:.3f}, makespan x{replan['makespan_ratio']:.3f}")
    return out


def trainer_loop(device, phase: str = "g3", mesh_factory=None) -> dict:
    """Phase g3 (h4 with a mesh factory): the ``Trainer`` loop on the card at
    minicpm's smoke config (checkpoints every 4 steps under a temporary
    directory the phase removes): a failure at step 6 recovers from the
    step-4 checkpoint and finishes, its losses from step 7 on equal to an
    unfailed run's within 2e-4 (the reference's bound); a ``straggler_sim``
    run gives a ``straggler_replan`` event whose re-plan launched
    ``ceft_relax``."""
    cfg = configs.get(TRAIN_ARCH, smoke=True)
    cell = ShapeCell("smoke", 32, 4, "train")
    with tempfile.TemporaryDirectory() as tmp:
        def run(name, **kw):
            """One Trainer run; returns it, its metrics, its seconds and each
            re-plan call's (step, ceft_relax launches, event or not)."""
            tr = Trainer(cfg, cell, TrainerConfig(steps=G3_STEPS, ckpt_every=4,
                                                  ckpt_dir=f"{tmp}/{name}", log_every=1, **kw),
                         mesh_factory, device=device)
            calls, replan = [], tr.monitor.maybe_replan

            def watched(step, *args):
                before = ops.LAUNCHES["ceft_relax"]
                sched, ev = replan(step, *args)
                calls.append((step, ops.LAUNCHES["ceft_relax"] - before, ev is not None))
                return sched, ev
            tr.monitor.maybe_replan = watched
            t = time.perf_counter()
            metrics = tr.run()
            return tr, metrics, time.perf_counter() - t, calls

        _, ma, sa, _ = run("a")
        tb, mb, sb, _ = run("b", fail_at_steps=(G3_FAIL,))
        la = {m["step"]: m["loss"] for m in ma if "loss" in m}
        lb = {m["step"]: m["loss"] for m in mb if "loss" in m}
        restarts = [m for m in mb if "restart" in str(m.get("event"))]
        check(tb.restarts == 1 and len(restarts) == 1 and max(lb) == G3_STEPS,
              f"recovery: {tb.restarts} restarts, {restarts}, steps {sorted(lb)}")
        errs = {s: abs(la[s] - lb[s]) / abs(la[s]) for s in range(G3_FAIL + 1, G3_STEPS + 1)}
        check(all(e <= 2e-4 for e in errs.values()), f"recovered losses off by {errs}")
        _, mc, sc, calls = run("c", straggler_sim=G3_SLOW)
        ev = [m for m in mc if m.get("event") == "straggler_replan"]
        first = next((c for c in calls if c[2]), None)
        check(len(ev) >= 1 and first is not None and first[1] >= 1,
              f"straggler: events {ev}, re-plan calls (step, ceft_relax, event) {calls}")
        check(os.path.isdir(tmp), "the checkpoint directory is gone")
    check(not os.path.exists(tmp), "the checkpoint directory was not removed")
    out = dict(steps=G3_STEPS, fail_at=G3_FAIL, losses=la, recovered_losses=lb,
               recovery_rel_err=errs, run_s=[sa, sb, sc], straggler_events=ev,
               replan_calls=calls, mesh=None if tb.mesh is None else list(tb.mesh.mesh.shape))
    log(f"phase {phase}: Trainer on the card, {cfg.name}: unfailed {sa:.2f} s, failure at step "
        f"{G3_FAIL} recovered from step 4 in {sb:.2f} s, losses after it off by {errs} "
        f"(bound 2e-4); straggler run {sc:.2f} s: {len(ev)} straggler_replan events, the "
        f"first {ev[0]}; re-plan calls (step, ceft_relax launches, event) {calls}")
    return out


def training_path(device) -> dict:
    """Phase g: training (g1, g2, g3)."""
    return dict(g1=train_card_vs_cpu(device), g2=train_full_width(device),
                g3=trainer_loop(device))


def x1_quickstart() -> dict:
    """Phase x1: the quickstart, host work as in the reference (the CPU
    tests hold its figures to the reference's)."""
    t = time.perf_counter()
    out = quickstart.run()
    seconds = time.perf_counter() - t
    spans = [s["makespan"] for s in out["schedules"].values()]
    check(all(math.isfinite(x) and x > 0 for x in [out["cpl"], out["cpop_cpl"], *spans])
          and out["cpl"] <= out["cpop_cpl"] and min(spans) >= out["cpl"],
          f"quickstart's figures: {out}")
    log(f"phase x1: quickstart on the card's host in {seconds:.3f} s: CEFT critical path "
        f"{out['cpl']:.1f}, CPOP's realized {out['cpop_cpl']:.1f}, path head "
        f"{out['path'][:6]}; " + ", ".join(
            f"{k} makespan {v['makespan']:.1f} speedup {v['speedup']:.2f} SLR {v['slr']:.2f} "
            f"slack {v['slack']:.1f}" for k, v in out["schedules"].items()))
    return dict(out, path=out["path"][:6], seconds=seconds)


def x2_pipeline(device) -> dict:
    """Phase x2: the heterogeneous pipeline example; its plans (host work)
    once, its glm4-9b straggler scenario with the monitor's re-plans
    sweeping on the card and again on the CPU: the event (step, class,
    slowdown, old and new makespan) and the classes in use bit-equal."""
    t = time.perf_counter()
    plans = heterogeneous_pipeline.plans()
    plan_s = time.perf_counter() - t
    before = ops.LAUNCHES["ceft_relax"]
    t = time.perf_counter()
    card = heterogeneous_pipeline.straggler(device)
    card_s = time.perf_counter() - t
    launches = ops.LAUNCHES["ceft_relax"] - before
    t = time.perf_counter()
    cpu = heterogeneous_pipeline.straggler("cpu")
    cpu_s = time.perf_counter() - t
    check(card is not None and card == cpu, f"the straggler's re-plan: card {card}, CPU {cpu}")
    check(launches > 0, "the straggler's re-plans launched no ceft_relax")
    check(all(p["makespan"] >= p["cpl"] * 0.999 for p in plans.values()),
          f"a plan's makespan below its critical path: {plans}")
    log(f"phase x2: heterogeneous_pipeline: {len(plans)} plans in {plan_s:.2f} s (host); "
        f"{heterogeneous_pipeline.STRAGGLER_ARCH} straggler on the card in {card_s:.3f} s "
        f"({launches} ceft_relax launches), on the CPU in {cpu_s:.3f} s, bit-equal: step "
        f"{card['step']}, class {card['device_class']}, slowdown {card['slowdown']!r}, "
        f"makespan {card['old_makespan']!r} -> {card['new_makespan']!r}, classes in use "
        f"{card['classes']}")
    return dict(plans={f"{a}/{c}": p for (a, c), p in plans.items()}, plan_s=plan_s,
                straggler=card, card_s=card_s, cpu_s=cpu_s, ceft_relax_launches=launches)


def x3_serve(device) -> dict:
    """Phase x3: the batched-serving example's three engines (the demo
    dense model, mixtral smoke's ring cache, mamba2 smoke's state) in float32
    (TF32 off) on the card and on the CPU from the same weights, made on the
    CPU: equal output shapes, every sequence EOS-padded after its first EOS,
    and the card's prefill and decode logits, teacher-forced on the CPU
    run's tokens, within 1e-4 relative of the CPU's."""
    tf32_off()
    cfgs = serve_batched.engine_configs("float32")
    params = {k: build(c).init(torch.Generator().manual_seed(X3_SEED), "cpu")
              for k, c in cfgs.items()}
    on_card = {k: tree_to(p, device) for k, p in params.items()}
    card = serve_batched.run(device, on_card, "float32")
    cpu = serve_batched.run("cpu", params, "float32")
    out = {}
    for name, (prompts, _) in serve_batched.prompts().items():
        got, want = card[name]["tokens"], cpu[name]["tokens"]
        check(got.shape == want.shape, f"x3 {name}: card {got.shape}, CPU {want.shape}")
        for toks in (got, want):
            for row in toks[:, prompts.shape[1]:]:
                hit = np.flatnonzero(row == serve_batched.EOS)
                check(not hit.size or bool((row[hit[0]:] == serve_batched.EOS).all()),
                      f"x3 {name}: a sequence goes on past EOS: {row}")
        forced = want[:, prompts.shape[1]:]
        errs = [rel_err(g, w) for g, w in zip(
            forced_logits(Engine(cfgs[name], params=on_card[name], device=device), prompts,
                          forced),
            forced_logits(Engine(cfgs[name], params=params[name], device="cpu"), prompts,
                          forced))]
        check(max(errs) < 1e-4, f"x3 {name}: card logits off the CPU's by {errs} (bound 1e-4)")
        out[name] = dict(shape=list(got.shape), tokens_identical=bool(np.array_equal(got, want)),
                         prefill_rel_err=errs[0], decode_rel_err=max(errs[1:]), bound=1e-4,
                         card_s=card[name]["seconds"], cpu_s=cpu[name]["seconds"])
    del on_card
    torch.cuda.empty_cache()
    log("phase x3: serve_batched, float32 (TF32 off), card against CPU: " + "; ".join(
        f"{k} {v['shape']} prefill rel err {v['prefill_rel_err']:.3e}, teacher-forced decode "
        f"{v['decode_rel_err']:.3e} (bound 1e-4), greedy tokens identical "
        f"{v['tokens_identical']}, generate {v['card_s']:.3f} s (first call; CPU "
        f"{v['cpu_s']:.3f} s)" for k, v in out.items()))
    return out


def x4_train(device) -> dict:
    """Phase x4: the 100M-parameter training example at full width
    (``CFG_100M``, its (8, 256) batch) through ``train_100m.main`` on a
    one-rank NCCL mesh, checkpoints under a temporary directory: a node
    lost at step X4_FAIL restores step X4_RESTORE's checkpoint and the run
    finishes; the loss falls; step ms, tokens/s and the peak."""
    restored, restore = [], Trainer._restore_latest

    def watched(self, *args):
        start, tree = restore(self, *args)
        restored.append(None if tree is None else start - 1)
        return start, tree
    Trainer._restore_latest = watched
    try:
        with tempfile.TemporaryDirectory() as tmp:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            out = train_100m.main([*X4_ARGS, "--fail-at", str(X4_FAIL), "--ckpt", f"{tmp}/ckpt",
                                   "--device", device])
            wall = time.perf_counter() - t
    finally:
        Trainer._restore_latest = restore
    peak = torch.cuda.max_memory_allocated()
    losses = out["losses"]
    restarts = [e for e in out["events"] if "restart" in str(e.get("event"))]
    check(out["restarts"] == 1 and [e["step"] for e in restarts] == [X4_FAIL]
          and restored == [X4_RESTORE] and losses[-1]["step"] == int(X4_ARGS[1]),
          f"x4 recovery: {out['restarts']} restarts {restarts}, restored {restored}, "
          f"logged steps {[m['step'] for m in losses]}")
    check(all(math.isfinite(m["loss"]) for m in losses) and losses[-1]["loss"] < losses[0]["loss"],
          f"x4: the loss did not fall: {losses}")
    step_ms = sorted(1e3 * m["time_s"] for m in losses)
    median_ms = step_ms[len(step_ms) // 2]
    tokens = out["batch"] * out["seq"]
    log(f"phase x4: train_100m at full width ({out['n_params'] / 1e6:.1f}M parameters, "
        f"({out['batch']}, {out['seq']})), {out['steps']} steps in {wall:.1f} s: loss "
        f"{losses[0]['loss']:.4f} at step {losses[0]['step']} -> {losses[-1]['loss']:.4f} at "
        f"step {losses[-1]['step']}; node lost at step {X4_FAIL}, restored from step "
        f"{restored[0]}; logged steps' ms {[round(x, 1) for x in step_ms]}, median "
        f"{median_ms:.1f} ms, {tokens / median_ms * 1e3:.0f} tokens/s; peak {peak} bytes; "
        f"events {out['events']}")
    return dict(out, wall_s=wall, step_ms=step_ms, median_step_ms=median_ms,
                tokens_per_s=tokens / median_ms * 1e3, max_memory_allocated=peak,
                restored_from=restored[0])


def examples_path(device) -> dict:
    """Phase x: the reference's four examples through the port's
    ``repro_torch.examples`` on the card, each one's seconds printed."""
    out, seconds = {}, {}
    for name, fn, args in (("x1", x1_quickstart, ()), ("x2", x2_pipeline, (device,)),
                           ("x3", x3_serve, (device,)), ("x4", x4_train, (device,))):
        t = time.perf_counter()
        out[name] = fn(*args)
        seconds[name] = time.perf_counter() - t
    log(f"phase x: the examples' seconds {({k: round(v, 1) for k, v in seconds.items()})}")
    return dict(out, seconds=seconds)


def meshed_full_width(device, g2: dict) -> dict:
    """Phase h1: minicpm-2b as published (all 40 layers, g2's generator
    seed, batches, schedule and rate) through ``build_train(model, mesh)``
    on a (data 1, model 1) mesh of the NCCL world of this one process: the
    state laid out by ``Model.shardings`` under the baseline profile, two
    ``ShardedTrainStep``s at (B, S) = (2, 4096).  Their losses within 1e-5
    relative and grad norms within 1e-4 of g2's first two (one rank computes
    what g2 computed; only the embedding backward's atomics may move a last
    bit).  Starts and ends with the card's memory free."""
    cfg = configs.get(TRAIN_ARCH)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    free0 = torch.cuda.memory_allocated()
    mesh = make_mesh((1, 1), ("data", "model"), device_type="cuda")
    model = build(cfg)
    step, opt, sh = build_train(model, mesh, G2_STEPS, G2_PEAK_LR)
    params = model.init(torch.Generator(device).manual_seed(LM_SEED), device)
    params = tree_map_sorted(distribute, params, sh["params"])
    state = opt.init(params)
    in_sh = input_shardings(model.input_specs(ShapeCell("h1", G2_S, G2_B, "train")), mesh)
    data = SyntheticLM(DataConfig(cfg.vocab, G2_S, G2_B, LM_SEED))
    rows = []
    for i in range(H1_STEPS):
        batch = data.sharded_batch(i, in_sh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch)
        loss, gn = m["loss"].item(), m["grad_norm"].item()
        torch.cuda.synchronize()
        rows.append(dict(loss=loss, grad_norm=gn, step_ms=(time.perf_counter() - t0) * 1e3))
    peak = torch.cuda.max_memory_allocated()
    errs = [dict(loss=abs(r["loss"] - w["loss"]) / abs(w["loss"]),
                 grad_norm=abs(r["grad_norm"] - w["grad_norm"]) / abs(w["grad_norm"]))
            for r, w in zip(rows, g2["steps"])]
    check(all(e["loss"] <= 1e-5 and e["grad_norm"] <= 1e-4 for e in errs),
          f"the meshed steps are off g2's by {errs}")
    placements = sorted({str(x.placements) for x in sorted_leaves(params)})
    del params, state, batch, m, step, opt, model
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() - free0
    check(held < 2**28, f"{held} bytes still held after h1")
    g2_ms = [r["fwd_bwd_ms"] + r["update_ms"] for r in g2["steps"][:H1_STEPS]]
    out = dict(backend=dist.get_backend(), world=dist.get_world_size(), mesh=[1, 1],
               steps=rows, rel_err=errs, g2_step_ms=g2_ms, max_memory_allocated=peak,
               g2_max_memory_allocated=g2["max_memory_allocated"], placements=placements)
    log(f"phase h1: {TRAIN_ARCH} as published through build_train(model, mesh) on a (data 1, "
        f"model 1) mesh, backend {out['backend']}, world {out['world']}: losses "
        f"{[r['loss'] for r in rows]}, grad norms {[r['grad_norm'] for r in rows]}, off g2's "
        f"by {errs} (bounds 1e-5, 1e-4); step ms {[round(r['step_ms'], 3) for r in rows]} "
        f"(g2's {[round(t, 3) for t in g2_ms]}); peak {peak / 1e9:.3f} GB (g2's "
        f"{g2['max_memory_allocated'] / 1e9:.3f}); placements {placements}")
    return out


def start_ranks(fn, world: int, tmp: str, *args):
    """Start ``fn(rank, world, init_method, tmp, *args)`` on ``world``
    spawned processes (killed by ``main`` if the check stops first).  The
    spawn's wall time is in the environment the ranks inherit (``joined``
    reads it)."""
    os.environ["CHIP_SMOKE_SPAWNED_AT"] = repr(time.time())
    ctx = torch.multiprocessing.start_processes(
        fn, args=(world, f"file://{tmp}/rendezvous", tmp, *args), nprocs=world, join=False,
        start_method="spawn")
    RANKS.append(ctx)
    return ctx


def finish_ranks(ctx, what: str, world: int, tmp: str, timeout: float) -> list:
    """Wait for ``start_ranks``' processes with a deadline (every process
    killed past it); returns each rank's result, read from
    ``tmp/rank{r}.pt``."""
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=5):
            check(time.monotonic() < deadline, f"{what} ran past {timeout} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
    return [torch.load(f"{tmp}/rank{r}.pt", weights_only=False) for r in range(world)]


def spawn_ranks(fn, world: int, tmp: str, *args, timeout: float = 300.0) -> list:
    """Run ``fn(rank, world, init_method, tmp, *args)`` on ``world`` spawned
    processes with a deadline (``start_ranks``, ``finish_ranks``)."""
    return finish_ranks(start_ranks(fn, world, tmp, *args), fn.__name__, world, tmp, timeout)


def joined(rank: int, world: int, init: str, device) -> float:
    """Join a spawned rank's gloo group on the card (TF32 off) and pass its
    first collective, a barrier; returns the seconds from the spawn to it
    (the process's start, its imports and the rendezvous)."""
    if device == "cuda":
        torch.cuda.set_device(0)
        tf32_off()
    init_group("gloo", rank, world, init)
    dist.barrier()
    return time.time() - float(os.environ["CHIP_SMOKE_SPAWNED_AT"])


def pipe_layer_params(cfg, layer: int, device):
    """Layer ``layer``'s parameters from a generator of its own."""
    return init_params(transformer.block_specs(cfg),
                       torch.Generator(device).manual_seed(H2_SEED + layer), device)


def pipe_top(cfg, device):
    """The embedding table and final norm (their own generator) and the
    tokens of phase h2."""
    specs = transformer.model_specs(cfg)
    top = init_params({k: specs[k] for k in ("embed", "final_norm")},
                      torch.Generator(device).manual_seed(H2_SEED - 1), device)
    tokens = torch.randint(cfg.vocab, (H2_B, H2_S), generator=torch.Generator().manual_seed(H2_SEED),
                           dtype=torch.int32).to(device)
    return top, tokens


def stack_trees(trees: list):
    if isinstance(trees[0], dict):
        return {k: stack_trees([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def pipeline_work(device, cfg) -> dict:
    """One pipe rank of phase h2 in the group: it makes its own layers from
    their seeds, then runs ``pipeline_forward`` twice (the second timed,
    between a barrier and a synchronize); rank 0 keeps the output."""
    rank, world = dist.get_rank(), dist.get_world_size()
    mesh = make_mesh((world,), ("pipe",), device_type=device)
    per = cfg.n_layers // world
    stage = stack_trees([pipe_layer_params(cfg, rank * per + i, device) for i in range(per)])
    blocks = tree_map_sorted(lambda t: DTensor.from_local(t, mesh, [Shard(0)], run_check=False),
                             stage)
    top, tokens = pipe_top(cfg, device)
    x = transformer.embed_tokens(top, cfg, tokens)
    times = []
    for _ in range(2):
        dist.barrier()
        t = time.perf_counter()
        h = pipeline_forward(cfg, blocks, x, mesh, n_micro=H2_MICRO)
        if device == "cuda":
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    out = dict(ms=times, backend=dist.get_backend(), world=world,
               layers=[rank * per + i for i in range(per)])
    if rank == 0:
        out["hidden"] = rmsnorm(top["final_norm"], h, cfg.norm_eps).cpu()
    del stage, blocks, top, x, h
    return out


def h2_config():
    return dataclasses.replace(configs.get(LM_ARCH), n_layers=H2_LAYERS,
                               compute_dtype="float32", remat="none")


def pipeline_reference(device) -> dict:
    """h2's plain stacked forward on the card from the same per-layer seeds
    (float32, TF32 off), twice, timed; the output kept on the host."""
    cfg = h2_config()
    tf32_off()
    top, tokens = pipe_top(cfg, device)
    params = dict(top, blocks=stack_trees([pipe_layer_params(cfg, i, device)
                                           for i in range(H2_LAYERS)]))
    plain_ms = []
    with torch.no_grad():
        for _ in range(2):
            torch.cuda.synchronize()
            t = time.perf_counter()
            want = transformer.forward_full(params, cfg, tokens=tokens)[0]
            torch.cuda.synchronize()
            plain_ms.append((time.perf_counter() - t) * 1e3)
    out = dict(hidden=want.cpu(), plain_ms=plain_ms)
    del params, want
    gc.collect()
    torch.cuda.empty_cache()
    return out


def pipeline_check(ref: dict, ranks: list) -> dict:
    """Phase h2: the GPipe forward at granite-3-8b's published widths, cut
    to H2_LAYERS of its 40 layers, over H2_STAGES pipe ranks of the group on
    the one card (gloo: NCCL refuses two ranks on one card; the activations
    cross through host copies), n_micro = H2_MICRO, (B, S) = (H2_B, H2_S),
    float32 with TF32 off.  Each rank makes its own layers on the card from a
    per-layer generator seed; the result is held within 1e-5 relative (the
    reference's bound) of the plain stacked forward on the card from the same
    seeds (``pipeline_reference``), and the two are timed."""
    got, want = ranks[0]["hidden"], ref["hidden"]
    err = rel_err(got, want)
    check(bool(torch.isfinite(got).all()) and err < 1e-5,
          f"the pipeline is off the plain forward by {err} (bound 1e-5)")
    out = dict(arch=LM_ARCH, layers=H2_LAYERS, stages=H2_STAGES, n_micro=H2_MICRO,
               batch=[H2_B, H2_S], backend=ranks[0]["backend"], world=ranks[0]["world"],
               rel_err=err, pipeline_ms=ranks[0]["ms"], plain_ms=ref["plain_ms"],
               stage_layers=[r["layers"] for r in ranks])
    log(f"phase h2: GPipe forward, {LM_ARCH} at its published widths cut to {H2_LAYERS} layers, "
        f"{H2_STAGES} pipe ranks on the card (backend {out['backend']}, world {out['world']}), "
        f"n_micro {H2_MICRO}, (B, S) = ({H2_B}, {H2_S}), float32, TF32 off: off the plain "
        f"stacked forward by {err:.3e} (bound 1e-5); pipeline ms "
        f"{[round(t, 3) for t in out['pipeline_ms']]}"
        f" (the second timed warm), plain ms {[round(t, 3) for t in ref['plain_ms']]}")
    return out


def psum_inputs(rank: int, device) -> torch.Tensor:
    """Pod ``rank``'s float32 part of phase h3 (heavy-tailed, its own seed)."""
    g = torch.Generator(device).manual_seed(H3_SEED + rank)
    return torch.randn(H3_NUMEL, generator=g, device=device).pow_(3).mul_(1.0 + 10.0 * rank)


def psum_rank(rank, world, init, tmp, device):
    """One pod rank of phase h3 on a gloo group: ``compressed_psum`` of its
    part (three calls timed), and the same formula in plain PyTorch on the
    card from every pod's part, made from their seeds."""
    startup = joined(rank, world, init, device)
    mesh = make_mesh((world,), ("pod",), device_type=device)
    x = DTensor.from_local(psum_inputs(rank, device), mesh, [Shard(0)], run_check=False)
    times = []
    for _ in range(3):
        dist.barrier()
        t = time.perf_counter()
        got = compressed_psum(x, mesh, "pod")
        if device == "cuda":
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    parts = [grad_compress._quant(psum_inputs(r, device)) for r in range(world)]
    want = torch.sum(torch.stack([q for q, _ in parts]).float()
                     * torch.stack([s for _, s in parts]).reshape(-1, 1), dim=0)
    out = dict(ms=times, backend=dist.get_backend(), world=dist.get_world_size(),
               equal=bool(torch.equal(got.view(torch.int32), want.view(torch.int32))),
               finite=bool(torch.isfinite(got).all()), startup_s=startup)
    torch.save(out, f"{tmp}/rank{rank}.pt")
    dist.destroy_process_group()


def compressed_psum_phase(device) -> dict:
    """Phase h3: ``compressed_psum`` over H3_PODS pod ranks spawned on the
    card (gloo), each part H3_NUMEL float32 (64 MiB): on every rank
    bit-equal to the same formula in plain PyTorch on the card; then
    ``ef_quantize``'s invariant over 50 rounds on the card
    (``tests/test_substrate.py``'s case)."""
    with tempfile.TemporaryDirectory() as tmp:
        ranks = spawn_ranks(psum_rank, H3_PODS, tmp, device)
    check(all(r["equal"] and r["finite"] for r in ranks),
          f"compressed_psum is not bit-equal to its formula on the card: {ranks}")
    g = torch.as_tensor(np.random.default_rng(0).normal(size=(512,)) * 10, dtype=torch.float32,
                        device=device)
    ef = torch.zeros(512, device=device)
    for _ in range(H3_ROUNDS):
        gh, ef2 = grad_compress.ef_quantize(g, ef)
        check(bool(torch.allclose(g + ef, gh + ef2, rtol=1e-5, atol=1e-4)),
              "the error-feedback invariant broke on the card")
        ef = ef2
    check(float(ef.abs().max()) < float(g.abs().max()) / 127 * 2, "the residual grew")
    wire = H3_NUMEL + 4
    out = dict(pods=H3_PODS, numel=H3_NUMEL, part_bytes=4 * H3_NUMEL, wire_bytes_per_rank=wire,
               float32_bytes_per_rank=4 * H3_NUMEL, backend=ranks[0]["backend"],
               world=ranks[0]["world"], ms=[r["ms"] for r in ranks], ef_rounds=H3_ROUNDS,
               startup_s=[r["startup_s"] for r in ranks])
    log(f"phase h3: compressed_psum over {H3_PODS} pod ranks on the card (backend "
        f"{out['backend']}, world {out['world']}), {4 * H3_NUMEL} bytes of float32 a rank, "
        f"{wire} bytes on the wire a rank: bit-equal to the plain formula on every rank; ms by "
        f"rank {out['ms']}; ef_quantize's invariant held over {H3_ROUNDS} rounds; spawn to "
        f"first collective by rank {[round(t, 2) for t in out['startup_s']]} s")
    return out


def h5_config(dtype: str, phase: str = "h5"):
    arch, layers = TRAIN_PHASES[phase][:2]
    return dataclasses.replace(configs.get(arch), n_layers=layers, compute_dtype=dtype,
                               **PHASE_CUTS.get(phase, {}))


def grid_positions(B: int, S: int, device) -> torch.Tensor:
    """(3, B, S) M-RoPE positions of an image grid: frames of GRID x GRID
    patches, each position's frame (temporal), frame + row (h) and frame +
    column (w), each batch row offset by its index."""
    s = torch.arange(S)
    frame = s // (GRID * GRID)
    grid = torch.stack([frame, frame + s % (GRID * GRID) // GRID, frame + s % GRID])
    return (grid[:, None] + torch.arange(B)[None, :, None]).to(torch.int32).to(device)


def moe_layers(cfg) -> int:
    """The MoE blocks one forward runs (``RouteRecorder``'s calls)."""
    return sum(ch == "moe" for _, ch in cfg.layer_pattern()) * (cfg.n_layers // cfg.period)


def train_batches(cfg, phase: str, device, shardings=None) -> list:
    """The phase's train batches on the card, or laid out by ``shardings``
    (``input_shardings``): ``SyntheticLM``'s tokens and labels from the
    phase's seed; a VLM's labels with embeds seeded normal on the card and
    ``grid_positions`` in place of the tokens; an encoder-decoder's frames
    seeded normal on the card beside them.  One batch for a phase of
    ``GRADS_ONLY``, else its ``TRAIN_STEPS`` (``H5_STEPS``)."""
    _, _, B, S, _, seed = TRAIN_PHASES[phase]
    data = SyntheticLM(DataConfig(cfg.vocab, S, B, seed))
    out = []
    for i in range(1 if phase in GRADS_ONLY else TRAIN_STEPS.get(phase, H5_STEPS)):
        batch = data.device_batch(i, device)
        g = torch.Generator(device).manual_seed(seed + i)
        if cfg.family == "vlm":
            batch = {"labels": batch["labels"], "positions": grid_positions(B, S, device),
                     "embeds": torch.randn((B, S, cfg.d_model), generator=g, device=device)}
        if cfg.family == "encdec":
            batch["frames"] = torch.randn((B, cfg.enc_seq, cfg.d_model), generator=g,
                                          device=device)
        out.append(batch if shardings is None else
                   {k: distribute(v, shardings[k]) for k, v in batch.items()})
    return out


def one_device_norm(grads) -> torch.Tensor:
    """The float32 global norm ``AdamW.update`` takes of a gradient tree."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in sorted_leaves(grads)))


def grad_steps(step, params, batches, sync, norm) -> list:
    """Step 1's loss and gradients of each batch and their global norm
    (``norm``) without the update (the phases of ``GRADS_ONLY``), each timed
    between a barrier (``sync``) and a synchronize."""
    rows = []
    for batch in batches:
        sync()
        t = time.perf_counter()
        loss, grads = step.loss_and_grads(params, batch)
        gn = norm(grads)
        loss, gn = loss.item(), gn.item()
        torch.cuda.synchronize()
        rows.append(dict(loss=loss, grad_norm=gn, ms=(time.perf_counter() - t) * 1e3))
        del grads
    return rows


def h5_steps(step, opt, params, batches, sync) -> list:
    """A step on each of ``batches``, each timed between a barrier
    (``sync``) and a synchronize; the loss, grad norm and ms of each."""
    state = opt.init(params)
    rows = []
    for batch in batches:
        sync()
        t = time.perf_counter()
        params, state, m = step(params, state, batch)
        loss, gn = m["loss"].item(), m["grad_norm"].item()
        torch.cuda.synchronize()
        rows.append(dict(loss=loss, grad_norm=gn, ms=(time.perf_counter() - t) * 1e3))
    return rows


def tensor_parallel_work(device, phase: str = "h5") -> dict:
    """One rank of phase h5 (h10, h12, h14, h16) in the group: per compute
    type and mesh (under its profile), the weights made on the card from the
    seed and laid out on the mesh, the phase's ``ShardedTrainStep``s (the
    tensor-parallel step, the SSM blocks head-parallel, the experts split,
    an encoder-decoder's frames on their own stream), the first forward's
    routing, and the rank's peak memory over them."""
    _, _, B, S, meshes, seed = TRAIN_PHASES[phase]
    out = {}
    for dtype in H5_BOUNDS:
        cfg = h5_config(dtype, phase)
        model = build(cfg)
        out[dtype] = {}
        for shape, profile in meshes:
            with sharding_profile(profile):
                mesh = make_mesh(shape, ("data", "model"), device_type=device)
                step, opt, sh = build_train(model, mesh, G2_STEPS, G2_PEAK_LR)
                params = model.init(torch.Generator(device).manual_seed(seed), device)
                params = tree_map_sorted(distribute, params, sh["params"])
                in_sh = input_shardings(model.input_specs(ShapeCell(phase, S, B, "train")), mesh)
                batches = train_batches(cfg, phase, device, in_sh)
                gc.collect()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                with RouteRecorder(moe_layers(cfg)) as routes:
                    if phase in GRADS_ONLY:
                        rows = grad_steps(step, params, batches, dist.barrier, step.global_norm)
                    else:
                        rows = h5_steps(step, opt, params, batches, dist.barrier)
                (tp, _, _), = step._plans.values()
                out[dtype][profile] = dict(
                    steps=rows, routes=routes.probs,
                    max_memory_allocated=torch.cuda.max_memory_allocated(),
                    plan=dict(seq=tp.seq_axes, qkv=tp.qkv_axes, q_local=tp.q_local,
                              q_slice=tp.q_slice_axes, ssm_heads=tp.ssm_head_axes,
                              ssm_columns=tp.ssm_in_axes,
                              experts=tp.expert_axes, frames=tp.encoder.seq_axes
                              if tp.enc_stream_spec is not None else None))
                del params, batches, step, opt
                gc.collect()
                torch.cuda.empty_cache()
    return out


def train_one_device(device, phase: str = "h5") -> dict:
    """A train phase's one-device reference on the card, run and freed
    before the group starts: per compute type the ``TrainStep``s from the
    same seeded weights and batches (loss, grad norm, ms, the first
    forward's routing, the peak)."""
    tf32_off()
    one = {}
    for dtype in H5_BOUNDS:
        cfg = h5_config(dtype, phase)
        model = build(cfg)
        step, opt, _ = build_train(model, None, G2_STEPS, G2_PEAK_LR)
        params = model.init(torch.Generator(device).manual_seed(TRAIN_PHASES[phase][5]), device)
        batches = train_batches(cfg, phase, device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with RouteRecorder(moe_layers(cfg)) as routes:
            if phase in GRADS_ONLY:
                rows = grad_steps(step, params, batches, torch.cuda.synchronize, one_device_norm)
            else:
                rows = h5_steps(step, opt, params, batches, torch.cuda.synchronize)
        one[dtype] = dict(steps=rows, routes=routes.probs,
                          max_memory_allocated=torch.cuda.max_memory_allocated())
        del params, batches, step, opt
        gc.collect()
        torch.cuda.empty_cache()
    return one


def depth(arch: str, layers: int) -> str:
    """How a phase runs ``arch``: ``at its published widths cut to N
    layers``, or ``as published`` where it keeps the whole depth."""
    if layers == configs.get(arch).n_layers:
        return "as published"
    return f"at its published widths cut to {layers} layers"


def check_train(phase: str, one: dict, ranks: list, card: str) -> dict:
    """Phase h5: the dense family's tensor- and sequence-parallel train step
    at granite-3-8b's published widths cut to H5_LAYERS layers, (B, S) =
    (H5_B, H5_S), on a (data 1, model 4) mesh of the group's 4 gloo ranks on
    the card (NCCL refuses two ranks on one card; the stream's collectives
    cross through host copies), so the sequence, the heads (the 8 kv heads
    too), the MLP's columns all split, and the vocabulary (49155) does not.
    h10: the SSM family's head-parallel step at mamba2-2.7b's published
    widths cut to H10_LAYERS layers, (H10_B, H10_S), on the same mesh: the
    sequence, the 80 heads and in_proj's columns on model (20 heads and 2644
    columns a rank), the vocabulary of 50280 whole.  h12: the hybrid at
    jamba's widths cut to an (attention, MLP) and an (SSM, MoE) layer, (1,
    4096): 8 q heads, 4 experts and 32 SSM heads a rank, the vocabulary of
    65536 on model.  h14: the VLM at qwen2-vl's widths cut to 1 layer, (2,
    4096) of seeded embeds and grid positions: 16 q heads, the 8 kv heads and
    the MLP's columns a rank's share.  h16: the encoder-decoder at
    whisper-tiny as published, (H16_B, H16_S) tokens and seeded (B, 1500,
    384) frames, on (1, 4) baseline (the sequence, 375 frames and the MLP's
    columns a rank; the 6 heads and the vocabulary of 51865 whole) and (2, 2)
    serve (the stream and the frames whole, the MLP's columns on (model,
    data)).  Against the one-device ``TrainStep`` on the card from the same
    seeded weights and batches (``train_one_device``): the first step's loss
    and grad norm within 1e-5 and 1e-4 relative in float32 (TF32 off),
    within g1's bf16 bound in bf16; with experts, every expert choice that
    differs from the one-device step's at a router probability gap below
    H8_GAP in float32.  Each rank's peak memory beside the one-device
    step's; the ms, gloo on one card, are not a speed."""
    arch, layers, B, S, meshes, _ = TRAIN_PHASES[phase]
    out = dict(arch=arch, layers=layers, batch=[B, S], card=card,
               grads_only=phase in GRADS_ONLY, cut=PHASE_CUTS.get(phase, {}))
    for dtype, (b_loss, b_gn) in H5_BOUNDS.items():
        want = one[dtype]["steps"][0]
        out[dtype] = {}
        for shape, profile in meshes:
            got = [r[dtype][profile] for r in ranks]
            errs = [dict(loss=abs(g["steps"][0]["loss"] - want["loss"]) / abs(want["loss"]),
                         grad_norm=abs(g["steps"][0]["grad_norm"] - want["grad_norm"])
                         / abs(want["grad_norm"])) for g in got]
            gaps = routing_gaps(one[dtype]["routes"], [g["routes"] for g in got],
                                configs.get(arch).top_k) if one[dtype]["routes"] else None
            o = out[dtype][profile] = dict(
                mesh=list(shape), rel_err=errs, bounds=dict(loss=b_loss, grad_norm=b_gn),
                routing=gaps, losses=[[st["loss"] for st in g["steps"]] for g in got],
                one_device_losses=[st["loss"] for st in one[dtype]["steps"]],
                grad_norms=[[st["grad_norm"] for st in g["steps"]] for g in got],
                one_device_grad_norms=[st["grad_norm"] for st in one[dtype]["steps"]],
                rank_max_memory_allocated=[g["max_memory_allocated"] for g in got],
                one_device_max_memory_allocated=one[dtype]["max_memory_allocated"],
                gloo_on_one_card_step_ms=[[st["ms"] for st in g["steps"]] for g in got],
                one_device_step_ms=[st["ms"] for st in one[dtype]["steps"]], plan=got[0]["plan"])
            routing = "" if gaps is None else (
                f"; routing: {gaps['differing']} of {gaps['tokens']} tokens choose other "
                f"experts, the largest one-device gap among them "
                f"{gaps['max_differing_gap']:.3e} (bound {H8_GAP} in float32), the least gap of "
                f"any token {gaps['min_gap']:.3e}")
            log(f"phase {phase}: {arch} {depth(arch, layers)}"
                f"{' ' + str(out['cut']) if out['cut'] else ''}, (B, S) = ({B}, {S}), {dtype}, "
                f"the {'loss and gradients' if out['grads_only'] else 'tensor-parallel step'} "
                f"(plan {o['plan']}) on a (data, model) = {shape} mesh under {profile} of 4 "
                f"gloo ranks on the card: step 1 off the one-device step by loss "
                f"{max(e['loss'] for e in errs):.3e}, grad norm "
                f"{max(e['grad_norm'] for e in errs):.3e} (bounds {b_loss}, {b_gn}){routing}; "
                f"losses {o['losses'][0]} (one device {o['one_device_losses']}); peak by rank "
                f"{o['rank_max_memory_allocated']} bytes (one device "
                f"{o['one_device_max_memory_allocated']}); step ms by rank, gloo on one card, "
                f"not a speed: {[[round(t, 1) for t in r] for r in o['gloo_on_one_card_step_ms']]}"
                f" (one device {[round(t, 1) for t in o['one_device_step_ms']]}); card {card}")
            check(all(math.isfinite(x) for g in got for st in g["steps"]
                      for x in (st["loss"], st["grad_norm"])),
                  f"{phase} {dtype} {profile}: a step is not finite")
            check(all(e["loss"] <= b_loss and e["grad_norm"] <= b_gn for e in errs),
                  f"{phase} {dtype} {profile}: the tensor-parallel step is off the one-device "
                  f"step by {errs} (bounds {b_loss}, {b_gn})")
            if gaps is not None and dtype == "float32":
                check(gaps["max_differing_gap"] < H8_GAP,
                      f"{phase}: an expert choice differs at a gap of "
                      f"{gaps['max_differing_gap']:.3e}: {gaps}")
    return out


def h6_steps(model, mesh, device) -> list:
    """``H1_STEPS`` steps of ``build_train(model, mesh)`` (the one-device
    step where ``mesh`` is None) from ``H6_SEED``'s weights and batches on
    the card (an encoder-decoder's frames seeded normal): the loss and grad
    norm of each.  A meshed step must have made its tensor-parallel plan."""
    cfg = model.cfg
    step, opt, sh = build_train(model, mesh, G2_STEPS, G2_PEAK_LR)
    params = model.init(torch.Generator(device).manual_seed(H6_SEED), device)
    data = SyntheticLM(DataConfig(cfg.vocab, H6_S, H6_B, H6_SEED))
    frames = [torch.randn((H6_B, cfg.enc_seq, cfg.d_model),
                          generator=torch.Generator().manual_seed(H6_SEED + i))
              for i in range(H1_STEPS)] if cfg.family == "encdec" else None
    if mesh is None:
        batches = [data.device_batch(i, device) for i in range(H1_STEPS)]
        for i, batch in enumerate(batches if frames else ()):
            batch["frames"] = frames[i].to(device)
    else:
        params = tree_map_sorted(distribute, params, sh["params"])
        in_sh = input_shardings(model.input_specs(ShapeCell("h6", H6_S, H6_B, "train")), mesh)
        batches = [data.sharded_batch(i, in_sh) for i in range(H1_STEPS)]
        for i, batch in enumerate(batches if frames else ()):
            batch["frames"] = distribute(frames[i], in_sh["frames"])
    state = opt.init(params)
    rows = []
    for batch in batches:
        params, state, m = step(params, state, batch)
        rows.append(dict(loss=m["loss"].item(), grad_norm=m["grad_norm"].item()))
    if mesh is not None:
        check(bool(step._plans), f"h6: {cfg.name}'s meshed step made no plan")
    del params, state, batches, step, opt
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def encdec_phase(device) -> dict:
    """Phase h6: the encoder-decoder's planned ``ShardedTrainStep`` on a
    (data 1, model 1) mesh of this process's one-rank NCCL world (h1's):
    each of ``H6_ARCHS`` (whisper-tiny as published) from the same seeded
    weights and batches as the one-device step on the card, every loss
    within 1e-5 relative and grad norm within 1e-4 (one rank computes what
    the one-device step computes)."""
    mesh = make_mesh((1, 1), ("data", "model"), device_type="cuda")
    out = {}
    for arch, smoke in H6_ARCHS:
        cfg = configs.get(arch, smoke=smoke)
        model = build(cfg)
        one, meshed = h6_steps(model, None, device), h6_steps(model, mesh, device)
        errs = [dict(loss=abs(r["loss"] - w["loss"]) / abs(w["loss"]),
                     grad_norm=abs(r["grad_norm"] - w["grad_norm"]) / abs(w["grad_norm"]))
                for r, w in zip(meshed, one)]
        check(all(math.isfinite(x) for r in meshed for x in r.values()),
              f"h6 {arch}: a step is not finite")
        check(all(e["loss"] <= 1e-5 and e["grad_norm"] <= 1e-4 for e in errs),
              f"h6 {arch}: the planned step is off the one-device step by {errs}")
        out[arch] = dict(family=cfg.family, layers=cfg.n_layers, smoke=smoke, steps=meshed,
                         one_device_steps=one, rel_err=errs)
        log(f"phase h6: {arch} ({cfg.family}{', smoke config' if smoke else ''}, {cfg.n_layers} "
            f"layers), (B, S) = ({H6_B}, {H6_S}), the planned step on a (data 1, model 1) mesh, "
            f"backend {dist.get_backend()}: losses {[r['loss'] for r in meshed]}, grad norms "
            f"{[r['grad_norm'] for r in meshed]}, off the one-device step by {errs} (bounds "
            f"1e-5, 1e-4)")
    return out


def h7_config(phase: str = "h7"):
    arch, layers = SERVE_PHASES[phase][:2]
    return dataclasses.replace(configs.get(arch), n_layers=layers, compute_dtype="float32",
                               **PHASE_CUTS.get(phase, {}))


def h7_prompts(cfg, device, phase: str = "h7") -> tuple[dict, torch.Tensor | None]:
    """A serving phase's prefill inputs and its decode steps' (3, B, new)
    M-RoPE positions (None without M-RoPE): seeded tokens (an
    encoder-decoder's with frames seeded normal on the card), or a VLM's
    embeds seeded normal on the card and the grid's positions, the decode's
    continuing it."""
    _, _, B, P, _, new, seed = SERVE_PHASES[phase]
    g = torch.Generator(device).manual_seed(seed)
    if cfg.family == "vlm":
        pos = grid_positions(B, P + new, device)
        return {"embeds": torch.randn((B, P, cfg.d_model), generator=g, device=device),
                "positions": pos[:, :, :P]}, pos[:, :, P:]
    rng = np.random.default_rng(seed)
    out = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (B, P)), dtype=torch.int32,
                                     device=device)}
    if cfg.family == "encdec":
        out["frames"] = torch.randn((B, cfg.enc_seq, cfg.d_model), generator=g, device=device)
    return out, None


def mesh_key(phase: str, shape: tuple, profile: str) -> str:
    """A serving phase's record key for one of its meshes: the profile, and
    the mesh's shape beside it where the phase runs the profile twice."""
    meshes = PHASE_MESHES.get(phase, H7_MESHES)
    if sum(p == profile for _, p in meshes) == 1:
        return profile
    return f"{profile} {'x'.join(map(str, shape))}"


def h7_run(prefill, decode, seed, params, prompts, sync, new: int = H7_NEW) -> dict:
    """Prefill ``prompts`` (``h7_prompts``' pair: the inputs and the decode
    positions), move the cache into the decode cache (``seed``), then
    ``new`` greedy steps: each step's logits (on the host) and tokens, the
    prefill's ms and each decode step's, each timed between ``sync`` and a
    synchronize; the peak memory of the prefill and the seeding (since the
    caller's reset) and of the decode steps alone.  A sharded step's logits
    (a ``DTensor`` on the rows and columns that computed them) are gathered
    whole after the timed call."""
    inputs, positions = prompts
    sync()
    t = time.perf_counter()
    pcache, logits = prefill(params, inputs)
    cache = seed(pcache)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t) * 1e3
    del pcache
    prefill_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    logits = gather_full(logits)
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    steps, decode_ms = [(logits.cpu(), tok.cpu())], []
    P = inputs["tokens" if "tokens" in inputs else "embeds"].shape[1]
    for i in range(new):
        step_in = {"tokens": tok[:, None], "pos": P + i}
        if positions is not None:
            step_in["positions"] = positions[:, :, i:i + 1]
        sync()
        t = time.perf_counter()
        tok, logits, cache = decode(params, cache, step_in)
        torch.cuda.synchronize()
        decode_ms.append((time.perf_counter() - t) * 1e3)
        steps.append((gather_full(logits).cpu(), tok.cpu()))
    return dict(steps=steps, prefill_ms=prefill_ms, decode_ms=decode_ms,
                prefill_peak=prefill_peak, decode_peak=torch.cuda.max_memory_allocated())


def serve_work(device, phase: str = "h7") -> dict:
    """One rank of phase h7 (h11, h13, h15, h17, h19) in the group: per mesh
    and profile, the weights made on the card from the seed and laid out on
    the mesh, the sharded prefill, ``seed_cache`` and the decode steps, and
    the rank's peak memory over them."""
    _, _, B, _, cache_len, new, seed = SERVE_PHASES[phase]
    model = build(h7_config(phase))
    prompts = h7_prompts(model.cfg, device, phase)
    out = {}
    for shape, profile in PHASE_MESHES.get(phase, H7_MESHES):
        with sharding_profile(profile):
            mesh = make_mesh(shape, ("data", "model"), device_type=device)
            fwd, psh = build_prefill(model, mesh)
            dec, dsh = build_decode(model, mesh, ShapeCell(phase, cache_len, B, "decode"))
            params = tree_map_sorted(
                distribute, model.init(torch.Generator(device).manual_seed(seed), device),
                psh["params"])
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            run = h7_run(fwd, dec, lambda c: seed_cache(c, dsh["cache"], cache_len), params,
                         prompts, dist.barrier, new)
            (tp, _), = dec._plans.values()
            (prefill_tp, _, _), = fwd._plans.values()
            out[mesh_key(phase, shape, profile)] = dict(
                run, max_memory_allocated=max(run["prefill_peak"], run["decode_peak"]),
                plan=dict(q_local=tp.q_local, kv_local=tp.kv_local,
                          q_slice=prefill_tp.q_slice_axes, qkv=tp.qkv_axes,
                          cache_rows=tp.cache_row_axes, cache_seq=tp.cache_seq_axes,
                          cross_seq=tp.cross_seq_axes, ssm_heads=tp.ssm_head_axes,
                          ssm_columns=tp.ssm_in_axes, cache_conv=tp.cache_conv_axes,
                          experts=tp.expert_axes, stationary=tp.stationary_axes,
                          tables=tp.table_axes, logit_cols=tp.logit_axes))
            del params, fwd, dec
            gc.collect()
            torch.cuda.empty_cache()
    return out


def one_device_cache(model, pcache, device, phase: str = "h7"):
    """The one-device decode cache of the phase's positions holding the
    prefill's k, v at positions [0, P), zeros beyond (the engine's seeding);
    an SSM's state and conv history as the prefill left them."""
    _, _, B, _, cache_len, _, _ = SERVE_PHASES[phase]
    cache = init_params(model.cache_specs(B, cache_len), None, device)
    for pos, entry in cache.items():
        for n, dst in entry.items():
            if n in ("k", "v"):
                dst[:, :, :pcache[pos][n].shape[2]] = pcache[pos][n]
            else:
                dst.copy_(pcache[pos][n])
    return cache


def serve_one_device(device, phase: str = "h7") -> dict:
    """A serving phase's one-device reference on the card, run and freed
    before the group starts: the prefill, the seeded decode cache and the
    greedy steps from the same seeded weights and prompts, and the peak;
    the prefill's float32 spread: the prompts prefilled whole against row by
    row (one row: alone against the row in a batch of H13_B)."""
    _, _, _, _, _, new, seed = SERVE_PHASES[phase]
    tf32_off()
    model = build(h7_config(phase))
    params = model.init(torch.Generator(device).manual_seed(seed), device)
    prompts = h7_prompts(model.cfg, device, phase)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    one = h7_run(PrefillStep(model), DecodeStep(model),
                 lambda c: one_device_cache(model, c, device, phase), params, prompts,
                 torch.cuda.synchronize, new)
    one["max_memory_allocated"] = max(one["prefill_peak"], one["decode_peak"])
    inputs = prompts[0]
    step = PrefillStep(model)
    if next(iter(inputs.values())).shape[0] == 1:
        rows = step(params, {k: torch.cat([v] * H13_B, 1 if k == "positions" else 0)
                             for k, v in inputs.items()})[1][:1].cpu()
    else:
        rows = torch.cat([step(params, {k: v[:, b:b + 1] if k == "positions" else v[b:b + 1]
                                        for k, v in inputs.items()})[1].cpu()
                          for b in range(next(iter(inputs.values())).shape[0])])
    one["spread"] = rel_err(rows, one["steps"][0][0])
    del params, prompts, inputs, rows
    gc.collect()
    torch.cuda.empty_cache()
    return one


def check_serve(phase: str, one: dict, ranks: list, card: str) -> dict:
    """Phase h7: the dense family's sharded ``PrefillStep`` and
    ``DecodeStep`` at granite-3-8b's published widths cut to H5_LAYERS
    layers, float32 (TF32 off), on the group's 4 gloo ranks on the card, on
    a (data 1, model 4) mesh under the baseline profile (the sequence, the
    heads and the 8 kv heads on model; the cache's sequence on model) and a
    (2, 2) mesh under serve (heads, kv heads and the MLP on (model, data),
    the stream whole, the cache's rows on data and its sequence on model):
    (B, prompt) = (H7_B, H7_P) prefilled, moved into a cache of H7_CACHE
    positions by ``seed_cache``, then H7_NEW greedy tokens.  Against the
    one-device steps on the card from the same seeded weights and prompts
    (``serve_one_device``): every step's logits within H7_RTOL relative on
    every rank, every token identical.  Each rank's peak beside the
    one-device run's; the steps' ms, gloo on one card, are not a speed.
    h11: the SSM family at mamba2-2.7b's widths cut to H10_LAYERS layers, a
    (H11_B, H11_P) prompt (15 chunks of 64 and a ragged one) on the same
    meshes (the heads and the cache's state heads on model, in_proj's
    columns on model, under serve the conv weights, norm and out_proj on
    (model, data), the cache's rows on data).  h13: the hybrid at h12's cut,
    a (H13_B, H13_P) prompt into H13_P + H13_NEW positions (its attention
    and SSM caches in one decode cache), its logits held within H7_RTOL
    beyond the one-device prefill's spread (``SPREAD_BOUND``), which every
    phase prints.  h15: the VLM at h14's cut from
    (H15_B, H15_P) seeded embeds and grid positions, decoding with (3, B, 1)
    positions.  h17: the encoder-decoder at whisper-tiny as published, a
    (H17_B, H17_P) prompt with its seeded frames into H17_P + H17_NEW
    self-cache positions, the cross cache carried over its 1500 frames.
    h19: h11's and h13's models serving one row on H19_MESHES, the decode
    plan's weights on their data shards (its stationary axes printed with
    the plan)."""
    arch, layers, B, P, cache_len, new, _ = SERVE_PHASES[phase]
    bound = H7_RTOL + one["spread"] if phase in SPREAD_BOUND else H7_RTOL
    out = dict(arch=arch, layers=layers, batch=B, prompt=P, cache=cache_len, new=new, card=card,
               cut=PHASE_CUTS.get(phase, {}), one_device_spread=one["spread"], bound=bound,
               one_device=dict(prefill_ms=one["prefill_ms"], decode_ms=one["decode_ms"],
                               max_memory_allocated=one["max_memory_allocated"]))
    want_tokens = [tok for _, tok in one["steps"]]
    for shape, profile in PHASE_MESHES.get(phase, H7_MESHES):
        key = mesh_key(phase, shape, profile)
        by_step = [max(rel_err(r[key]["steps"][i][0], w) for r in ranks)
                   for i, (w, _) in enumerate(one["steps"])]
        errs = [max(rel_err(lg, w) for (lg, _), (w, _) in zip(r[key]["steps"], one["steps"]))
                for r in ranks]
        same = [all(tok.equal(w) for (_, tok), w in zip(r[key]["steps"], want_tokens))
                for r in ranks]
        row = dict(mesh=list(shape), plan=ranks[0][key]["plan"], rel_err=errs,
                   rel_err_by_step=by_step, tokens_identical=same, bound=bound,
                   rank_max_memory_allocated=[r[key]["max_memory_allocated"] for r in ranks],
                   rank_decode_peak=[r[key]["decode_peak"] for r in ranks],
                   gloo_on_one_card_prefill_ms=[r[key]["prefill_ms"] for r in ranks],
                   gloo_on_one_card_decode_ms=[r[key]["decode_ms"] for r in ranks])
        out[key] = row
        log(f"phase {phase}: {arch} {depth(arch, layers)}"
            f"{' ' + str(out['cut']) if out['cut'] else ''}, float32, prefill ({B}, {P}) into a "
            f"{cache_len}-position cache and {new} greedy tokens, sharded on a (data, model) = "
            f"{shape} mesh under {profile} (plan {row['plan']}) of 4 gloo ranks on the card: "
            f"logits off the one-device steps by {max(errs):.3e} at most (bound {bound:.3e}; "
            f"prefill {by_step[0]:.3e}, decode steps {[float(f'{e:.3e}') for e in by_step[1:]]}), "
            f"tokens identical on every rank: {all(same)}; the one-device prefill's own "
            f"spread (whole batch against row by row) {one['spread']:.3e}; peak by rank "
            f"{row['rank_max_memory_allocated']} bytes (one device "
            f"{one['max_memory_allocated']}); ms by rank, gloo on one card, not a speed: "
            f"prefill {[round(t, 1) for t in row['gloo_on_one_card_prefill_ms']]}, decode "
            f"mean {[round(sum(t) / len(t), 2) for t in row['gloo_on_one_card_decode_ms']]} "
            f"(one device: prefill {one['prefill_ms']:.1f}, decode mean "
            f"{sum(one['decode_ms']) / len(one['decode_ms']):.2f}); card {card}")
        check(all(math.isfinite(float(lg.abs().max())) for r in ranks
                  for lg, _ in r[key]["steps"]), f"{phase} {key}: logits not finite")
        check(all(e <= bound for e in errs),
              f"{phase} {key}: the sharded steps are off the one-device steps by {errs} "
              f"(bound {bound})")
        check(all(same), f"{phase} {key}: the sharded steps' tokens differ: {same}")
        if phase.startswith("h19"):   # the weights stayed on their data shards
            check(all(r[key]["plan"]["stationary"] == ("data",) for r in ranks),
                  f"{phase} {key}: the decode plan's stationary axes are "
                  f"{[r[key]['plan']['stationary'] for r in ranks]}, not ('data',)")
        if B > 1 and shape[0] > 1 and profile == "baseline":   # the rows split over data
            check(all(r[key]["plan"]["tables"] == ("data",) for r in ranks),
                  f"{phase} {key}: the decode plan's table axes are "
                  f"{[r[key]['plan']['tables'] for r in ranks]}, not ('data',)")
    return out


class RouteRecorder:
    """Within ``with``: the router probabilities of the first ``n`` calls of
    ``models.moe._route`` (the forward's layers, before a recompute), each
    (rows, tokens, E) on the host; the routing is what the step computes,
    the recorder only reads it."""

    def __init__(self, n: int):
        self.n, self.probs = n, []

    def __enter__(self):
        self.route = moe_module._route

        def recorded(xg, router, cfg, tp=None):
            out = self.route(xg, router, cfg, tp)
            if len(self.probs) < self.n:
                self.probs.append(out[0].detach().flatten(1, 2).float().cpu())
            return out
        moe_module._route = recorded
        return self

    def __exit__(self, *exc):
        moe_module._route = self.route


def routing_gaps(one: list, ranks: list, K: int) -> dict:
    """Each rank's top-K expert choices (``RouteRecorder`` probabilities of
    its rows, every row, and its chunk of the sequence: chunk index = rank
    modulo the chunks, the whole sequence where the tokens are replicated,
    as under serve) against the one-device step's on the same tokens: how
    many tokens choose another set of experts, the largest one-device
    probability gap (the K-th largest less the (K+1)-th) among them, and the
    least gap of any token."""
    out = dict(tokens=0, differing=0, max_differing_gap=0.0, min_gap=float("inf"))
    for layer, probs in enumerate(one):
        top, idx = moe_module.top_k_first_index(probs, K + 1)
        gap = top[..., K - 1] - top[..., K]
        want = idx[..., :K].sort(-1).values
        out["min_gap"] = min(out["min_gap"], float(gap.min()))
        for r, rank in enumerate(ranks):
            got = moe_module.top_k_first_index(rank[layer], K)[1].sort(-1).values
            chunk = r % (want.shape[1] // got.shape[1])
            own = slice(chunk * got.shape[1], (chunk + 1) * got.shape[1])
            differ = (got != want[:, own]).any(-1)
            out["tokens"] += differ.numel()
            out["differing"] += int(differ.sum())
            if differ.any():
                out["max_differing_gap"] = max(out["max_differing_gap"],
                                               float(gap[:, own][differ].max()))
    return out


def h8_config(dtype: str):
    return dataclasses.replace(configs.get(H8_ARCH), n_layers=H8_LAYERS, compute_dtype=dtype)


def h8_one_device(device, B: int = H8_B, serve: bool = True) -> dict:
    """The one-device references of h8 and h9 on the card, each run and
    freed before the ranks spawn: per compute type the first ``H8_STEPS``
    train steps at (B, H8_S) (loss, grad norm, ms, the first forward's
    routing, the peak); with ``serve``, the float32 prefill, ring-seeded
    cache and decode steps."""
    out = {}
    for dtype in H5_BOUNDS:
        cfg = h8_config(dtype)
        model = build(cfg)
        step, opt, _ = build_train(model, None, G2_STEPS, G2_PEAK_LR)
        params = model.init(torch.Generator(device).manual_seed(H8_SEED), device)
        data = SyntheticLM(DataConfig(cfg.vocab, H8_S, B, H8_SEED))
        batches = [data.device_batch(i, device) for i in range(H8_STEPS)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with RouteRecorder(H8_LAYERS) as routes:
            rows = h5_steps(step, opt, params, batches, torch.cuda.synchronize)
        out[dtype] = dict(steps=rows, routes=routes.probs,
                          max_memory_allocated=torch.cuda.max_memory_allocated())
        del params, batches, step, opt
        gc.collect()
        torch.cuda.empty_cache()
    if not serve:
        return out
    model = build(h8_config("float32"))
    params = model.init(torch.Generator(device).manual_seed(H9_SEED), device)
    prompts = h9_prompts(model.cfg, device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with RouteRecorder(H8_LAYERS) as routes:
        run = h7_run(PrefillStep(model), DecodeStep(model),
                     lambda c: ring_cache(model, c, device), params, ({"tokens": prompts}, None),
                     torch.cuda.synchronize, H9_NEW)
    out["serve"] = dict(run, routes=routes.probs,
                        max_memory_allocated=max(run["prefill_peak"], run["decode_peak"]))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def h9_prompts(cfg, device) -> torch.Tensor:
    rng = np.random.default_rng(H9_SEED)
    return torch.as_tensor(rng.integers(0, cfg.vocab, (H9_B, H9_P)), dtype=torch.int32,
                           device=device)


def ring_cache(model, pcache, device):
    """The one-device decode cache of ``H9_P + H9_NEW`` positions (the
    window's ring) seeded as the engine seeds it: the prompt's last window
    positions at their ring slots."""
    cache = init_params(model.cache_specs(H9_B, H9_P + H9_NEW), None, device)
    for pos, entry in cache.items():
        for n, dst in entry.items():
            where = ring_positions(H9_P, dst.shape[2], model.cfg.window).to(device)
            held = (where >= 0).nonzero()[:, 0]
            dst[:, :, held] = pcache[pos][n][:, :, where[held]]
    return cache


def moe_work(device, meshes=H8_MESHES, B: int = H8_B) -> dict:
    """One rank of phases h8 and h9 (h18: ``H18_MESHES``, ``H18_B``) in the
    group: per mesh and profile, h8's ``H8_STEPS`` sharded train steps at
    (B, H8_S) in each compute type (the first forward's routing, the peak),
    then h9's sharded prefill, ``seed_cache`` into the ring and decode steps
    in float32."""
    out = {}
    for shape, axes, profile in meshes:
        with sharding_profile(profile):
            mesh = make_mesh(shape, axes, device_type=device)
            for dtype in H5_BOUNDS:
                cfg = h8_config(dtype)
                model = build(cfg)
                step, opt, sh = build_train(model, mesh, G2_STEPS, G2_PEAK_LR)
                params = model.init(torch.Generator(device).manual_seed(H8_SEED), device)
                params = tree_map_sorted(distribute, params, sh["params"])
                in_sh = input_shardings(model.input_specs(ShapeCell("h8", H8_S, B, "train")),
                                        mesh)
                data = SyntheticLM(DataConfig(cfg.vocab, H8_S, B, H8_SEED))
                batches = [data.sharded_batch(i, in_sh) for i in range(H8_STEPS)]
                gc.collect()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                with RouteRecorder(H8_LAYERS) as routes:
                    rows = h5_steps(step, opt, params, batches, dist.barrier)
                (tp, _, _), = step._plans.values()
                out[profile, dtype] = dict(
                    steps=rows, routes=routes.probs,
                    max_memory_allocated=torch.cuda.max_memory_allocated(),
                    plan=dict(experts=tp.expert_axes, expert_ffn=tp.expert_ffn_axes,
                              seq=tp.seq_axes))
                del params, batches, step, opt
                gc.collect()
                torch.cuda.empty_cache()
            model = build(h8_config("float32"))
            fwd, psh = build_prefill(model, mesh)
            dec, dsh = build_decode(model, mesh,
                                    ShapeCell("h9", H9_P + H9_NEW, H9_B, "decode"))
            params = tree_map_sorted(
                distribute, model.init(torch.Generator(device).manual_seed(H9_SEED), device),
                psh["params"])
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            with RouteRecorder(H8_LAYERS) as routes:
                run = h7_run(fwd, dec, lambda c: seed_cache(c, dsh["cache"], H9_P + H9_NEW,
                                                            model.cfg.window),
                             params, ({"tokens": h9_prompts(model.cfg, device)}, None),
                             dist.barrier, H9_NEW)
            out[profile, "serve"] = dict(run, routes=routes.probs,
                                         max_memory_allocated=max(run["prefill_peak"],
                                                                  run["decode_peak"]))
            del params, fwd, dec
            gc.collect()
            torch.cuda.empty_cache()
    return out


def check_moe(one: dict, ranks: list, card: str, meshes=H8_MESHES,
              phases=("h8", "h9"), B: int = H8_B) -> tuple[dict, dict]:
    """Phases h8 and h9: the MoE family's sharded train step, prefill and
    decode at mixtral-8x22b's published widths cut to H8_LAYERS layer(s),
    on the group's 4 gloo ranks on the card under each of H8_MESHES (the
    sequence, the heads, the vocabulary and the experts split; under
    moe_ep the experts' hidden columns on tp), against the one-device steps
    on the card from the same seeded weights and inputs: h8's first step's
    loss and grad norm at h5's bounds in float32 (TF32 off) and bf16, and
    the routing: every expert choice a rank makes that differs from the
    one-device step's must sit at a probability gap below H8_GAP in float32
    (bf16's own rounding of the stream, 2^-8 relative, moves choices at far
    larger gaps: reported, not held); h9's logits within H7_RTOL on every
    rank and every token identical.  Each rank's peak beside the one-device
    run's; ms on gloo on one card are not a speed.  ``one`` is
    ``h8_one_device``'s, run before the group starts; h18 is h8 at
    (``H18_B``, H8_S) and h9 on ``H18_MESHES``, named by ``phases``."""
    train, serve = phases
    K = configs.get(H8_ARCH).top_k
    h8 = dict(arch=H8_ARCH, layers=H8_LAYERS, batch=[B, H8_S], card=card)
    for shape, _, profile in meshes:
        for dtype, (b_loss, b_gn) in H5_BOUNDS.items():
            want = one[dtype]["steps"][0]
            errs = [dict(loss=abs(r[profile, dtype]["steps"][0]["loss"] - want["loss"])
                         / abs(want["loss"]),
                         grad_norm=abs(r[profile, dtype]["steps"][0]["grad_norm"]
                                       - want["grad_norm"]) / abs(want["grad_norm"]))
                    for r in ranks]
            gaps = routing_gaps(one[dtype]["routes"],
                                [r[profile, dtype]["routes"] for r in ranks], K)
            row = dict(mesh=list(shape), plan=ranks[0][profile, dtype]["plan"], rel_err=errs,
                       bounds=dict(loss=b_loss, grad_norm=b_gn), routing=gaps,
                       losses=[[s["loss"] for s in r[profile, dtype]["steps"]] for r in ranks],
                       one_device_losses=[s["loss"] for s in one[dtype]["steps"]],
                       rank_max_memory_allocated=[r[profile, dtype]["max_memory_allocated"]
                                                  for r in ranks],
                       one_device_max_memory_allocated=one[dtype]["max_memory_allocated"],
                       gloo_on_one_card_step_ms=[[s["ms"] for s in r[profile, dtype]["steps"]]
                                                 for r in ranks],
                       one_device_step_ms=[s["ms"] for s in one[dtype]["steps"]])
            h8[f"{profile}/{dtype}"] = row
            log(f"phase {train}: {H8_ARCH} at its published widths cut to {H8_LAYERS} layer(s), "
                f"(B, S) = ({B}, {H8_S}), {dtype}, the sharded train step on a {shape} mesh "
                f"under {profile} (plan {row['plan']}) of 4 gloo ranks "
                f"on the card: step 1 off the one-device step by loss "
                f"{max(e['loss'] for e in errs):.3e}, grad norm "
                f"{max(e['grad_norm'] for e in errs):.3e} (bounds {b_loss}, {b_gn}); routing: "
                f"{gaps['differing']} of {gaps['tokens']} tokens choose other experts than in "
                f"the one-device step, the largest one-device probability gap among them "
                f"{gaps['max_differing_gap']:.3e} (bound {H8_GAP} in float32), the least gap "
                f"of any token {gaps['min_gap']:.3e}; losses {row['losses'][0]} (one device "
                f"{row['one_device_losses']}); peak by rank {row['rank_max_memory_allocated']} "
                f"bytes (one device {row['one_device_max_memory_allocated']}); step ms by "
                f"rank, gloo on one card, not a speed: "
                f"{[[round(t, 1) for t in r] for r in row['gloo_on_one_card_step_ms']]} (one "
                f"device {[round(t, 1) for t in row['one_device_step_ms']]}); card {card}")
            check(all(math.isfinite(x) for r in ranks for s in r[profile, dtype]["steps"]
                      for x in (s["loss"], s["grad_norm"])),
                  f"{train} {profile} {dtype}: not finite")
            check(all(e["loss"] <= b_loss and e["grad_norm"] <= b_gn for e in errs),
                  f"{train} {profile} {dtype}: the sharded step is off the one-device step by "
                  f"{errs} (bounds {b_loss}, {b_gn})")
            if dtype == "float32":
                check(gaps["max_differing_gap"] < H8_GAP,
                      f"{train} {profile}: an expert choice differs at a gap of "
                      f"{gaps['max_differing_gap']:.3e}: {gaps}")
    h9 = dict(arch=H8_ARCH, layers=H8_LAYERS, batch=H9_B, prompt=H9_P,
              window=configs.get(H8_ARCH).window, new=H9_NEW, card=card,
              one_device=dict(prefill_ms=one["serve"]["prefill_ms"],
                              decode_ms=one["serve"]["decode_ms"],
                              max_memory_allocated=one["serve"]["max_memory_allocated"]))
    want_steps = one["serve"]["steps"]
    for shape, _, profile in meshes:
        runs = [r[profile, "serve"] for r in ranks]
        errs = [max(rel_err(lg, w) for (lg, _), (w, _) in zip(run["steps"], want_steps))
                for run in runs]
        same = [all(tok.equal(w) for (_, tok), (_, w) in zip(run["steps"], want_steps))
                for run in runs]
        gaps = routing_gaps(one["serve"]["routes"], [run["routes"] for run in runs], K)
        row = dict(mesh=list(shape), rel_err=errs, tokens_identical=same, bound=H7_RTOL,
                   routing=gaps,
                   rank_max_memory_allocated=[run["max_memory_allocated"] for run in runs],
                   gloo_on_one_card_prefill_ms=[run["prefill_ms"] for run in runs],
                   gloo_on_one_card_decode_ms=[run["decode_ms"] for run in runs])
        h9[profile] = row
        log(f"phase {serve}: {H8_ARCH} at its published widths cut to {H8_LAYERS} layer(s), "
            f"float32, prefill ({H9_B}, {H9_P}) (window {h9['window']}) seeded into the ring "
            f"and {H9_NEW} greedy tokens, sharded on a {shape} mesh under {profile}: logits "
            f"off the one-device steps by {max(errs):.3e} at most (bound {H7_RTOL}), tokens "
            f"identical on every rank: {all(same)}; routing of the prompt: "
            f"{gaps['differing']} of {gaps['tokens']} tokens choose other experts (largest gap "
            f"among them {gaps['max_differing_gap']:.3e}, least gap {gaps['min_gap']:.3e}); peak "
            f"by rank {row['rank_max_memory_allocated']} bytes (one device "
            f"{h9['one_device']['max_memory_allocated']}); ms by rank, gloo on one card, not a "
            f"speed: prefill {[round(t, 1) for t in row['gloo_on_one_card_prefill_ms']]}, "
            f"decode mean {[round(sum(t) / len(t), 2) for t in row['gloo_on_one_card_decode_ms']]}"
            f" (one device: prefill {h9['one_device']['prefill_ms']:.1f}, decode mean "
            f"{sum(h9['one_device']['decode_ms']) / len(h9['one_device']['decode_ms']):.2f}); "
            f"card {card}")
        check(all(math.isfinite(float(lg.abs().max())) for run in runs for lg, _ in run["steps"]),
              f"{serve} {profile}: logits not finite")
        check(gaps["max_differing_gap"] < H8_GAP, f"{serve} {profile}: an expert choice differs at "
              f"a gap of {gaps['max_differing_gap']:.3e}")
        check(all(e <= H7_RTOL for e in errs),
              f"{serve} {profile}: the sharded steps are off the one-device steps by {errs}")
        check(all(same), f"{serve} {profile}: the sharded steps' tokens differ: {same}")
    return h8, h9


def group_work(name: str, device) -> dict:
    """One rank's share of a phase of ``GROUP_PHASES``."""
    if name == "h2":
        return pipeline_work(device, h2_config())
    if name == "h8":
        return moe_work(device)
    if name == "h18":
        return moe_work(device, H18_MESHES, H18_B)
    if name in TRAIN_PHASES:
        return tensor_parallel_work(device, name)
    return serve_work(device, name)


def group_rank(rank, world, init, tmp, device, phases):
    """One rank of the group on the card: it joins once (its spawn-to-first-
    collective seconds kept) and waits for ``group_phases`` to free the card
    (the file ``tmp/go``), then runs each of ``phases`` in turn, timed
    between barriers, its memory freed between them."""
    out = dict(startup_s=joined(rank, world, init, device), backend=dist.get_backend(),
               world=dist.get_world_size(), seconds={})
    go, deadline = Path(tmp) / "go", time.monotonic() + GROUP_TIMEOUT_S
    while not go.exists():
        check(time.monotonic() < deadline, f"rank {rank}: no go in {GROUP_TIMEOUT_S} s")
        time.sleep(0.05)
    dist.barrier()
    for name in phases:
        t = time.perf_counter()
        out[name] = group_work(name, device)
        gc.collect()
        torch.cuda.empty_cache()
        dist.barrier()
        out["seconds"][name] = time.perf_counter() - t
    torch.save(out, f"{tmp}/rank{rank}.pt")
    dist.destroy_process_group()


def start_group(device) -> dict:
    """The group of GROUP_WORLD gloo ranks for phases h2, h5 and h7-h19,
    spawned ahead of phase h (at phase x) so that its start and its
    rendezvous overlap the phases before it; its ranks wait for
    ``group_phases``."""
    tmp = tempfile.mkdtemp()
    return dict(tmp=tmp, spawned=time.monotonic(),
                ctx=start_ranks(group_rank, GROUP_WORLD, tmp, device, GROUP_PHASES))


def group_phases(device, group: dict) -> dict:
    """Phases h2, h5, h7-h19 on the group ``start_group`` spawned on the
    card: the one-device references first, each run and freed in this
    process (so the ranks have the card), then the ranks run every phase in
    turn; each phase is checked against its reference after."""
    card = smi("name,power.limit")
    refs, ref_s = {}, {}
    t_refs = time.perf_counter() - _T0
    for name in GROUP_PHASES:
        t = time.perf_counter()
        if name == "h2":
            refs[name] = pipeline_reference(device)
        elif name == "h8":
            tf32_off()
            refs[name] = h8_one_device(device)
        elif name == "h18":
            refs[name] = dict(h8_one_device(device, H18_B, serve=False),
                              serve=refs["h8"]["serve"])
        elif name in TRAIN_PHASES:
            refs[name] = train_one_device(device, name)
        else:
            refs[name] = serve_one_device(device, name)
        ref_s[name] = time.perf_counter() - t
    SPANS["h refs"] = (t_refs, time.perf_counter() - _T0)
    log(f"phase h: the one-device references of {list(GROUP_PHASES)} in "
        f"{sum(ref_s.values()):.1f} s: {({k: round(v, 1) for k, v in ref_s.items()})}")
    torch.cuda.empty_cache()
    t = time.perf_counter()
    try:
        (Path(group["tmp"]) / "go").touch()
        # the group's GROUP_TIMEOUT_S counts from its spawn, its wait included
        ranks = finish_ranks(group["ctx"], "group_rank", GROUP_WORLD, group["tmp"],
                             GROUP_TIMEOUT_S - (time.monotonic() - group["spawned"]))
    finally:
        shutil.rmtree(group["tmp"], ignore_errors=True)
    wall = time.perf_counter() - t
    SPANS["h ranks"] = (t - _T0, t - _T0 + wall)
    seconds = {k: max(r["seconds"][k] for r in ranks) for k in GROUP_PHASES}
    startup = [r["startup_s"] for r in ranks]
    log(f"phase h: one group of {GROUP_WORLD} {ranks[0]['backend']} ranks on the card ran "
        f"{list(GROUP_PHASES)} in {wall:.1f} s: spawn (at phase x) to first collective by "
        f"rank {[round(x, 2) for x in startup]} s, each phase's seconds "
        f"{({k: round(v, 1) for k, v in seconds.items()})}")
    sliced = [k for k in H_PARENT_S if k in seconds]
    if sliced:
        log(f"phase h: {sliced}, whisper-tiny's 6 q heads unsplit on 4 ranks, each rank "
            f"attending with its query slice: {[round(seconds[k], 1) for k in sliced]} s (the "
            f"one-device references' {[round(ref_s[k], 1) for k in sliced]} s) against the "
            f"parent tree's {[H_PARENT_S[k] for k in sliced]} s (every rank ran every head over "
            f"the whole sequence; its references' {[H_PARENT_REF_S[k] for k in sliced]} s)")
    out = {}
    for name in GROUP_PHASES:
        got = [r[name] for r in ranks]
        if name == "h2":
            out["h2"] = pipeline_check(refs[name], got)
        elif name == "h8":
            out["h8"], out["h9"] = check_moe(refs[name], got, card)
        elif name == "h18":
            out["h18"], out["h18_serve"] = check_moe(refs[name], got, card, H18_MESHES,
                                                     ("h18", "h18"), H18_B)
        elif name in TRAIN_PHASES:
            out[name] = check_train(name, refs[name], got, card)
        else:
            out[name] = check_serve(name, refs[name], got, card)
    for one, four in (("h19-mamba2", "h11"), ("h19-jamba", "h13")):
        if one in out and four in out:
            log(f"phase {one}: one row on {H19_MESHES[0]} beside {four}'s four rows on "
                f"{[list(m) for m, _ in H7_MESHES]}: peak by rank "
                f"{out[one]['baseline']['rank_max_memory_allocated']} against "
                f"{[out[four][p]['rank_max_memory_allocated'] for _, p in H7_MESHES]} bytes, "
                f"the decode steps' own {out[one]['baseline']['rank_decode_peak']} against "
                f"{[out[four][p]['rank_decode_peak'] for _, p in H7_MESHES]}; "
                f"decode mean ms by rank (gloo on one card, not a speed) "
                f"{mean_ms(out[one]['baseline'])} against "
                f"{[mean_ms(out[four][p]) for _, p in H7_MESHES]}; card {card}")
    out["group"] = dict(world=GROUP_WORLD, backend=ranks[0]["backend"], wall_s=wall,
                        startup_s=startup, phase_s=seconds, one_device_s=ref_s)
    return out


def mean_ms(row: dict) -> list:
    """A serving phase's mean decode ms by rank (``check_serve``'s row)."""
    return [round(sum(t) / len(t), 2) for t in row["gloo_on_one_card_decode_ms"]]


def distributed_path(device, g2: dict, group: dict) -> dict:
    """Phase h: the distribution substrate on the card (h1 in this
    process's one-rank NCCL world, which h4 reuses through
    ``make_test_mesh`` and h6 through a mesh of its own; h3 in a spawned
    gloo world of 2; h2, h5 and h7-h19 in one spawned gloo group of 4,
    ``group``)."""
    init_group("nccl")
    try:
        h1 = spanned("h1", meshed_full_width, device, g2)
        h3 = spanned("h3", compressed_psum_phase, device)
        h4 = spanned("h4", trainer_loop, device, "h4", make_test_mesh)
        h4.update(backend=dist.get_backend(), world=dist.get_world_size())
        log(f"phase h4: the meshed Trainer ran on backend {h4['backend']}, world "
            f"{h4['world']}, mesh {h4['mesh']}")
        h6 = spanned("h6", encdec_phase, device)
        group = group_phases(device, group)
    finally:
        dist.destroy_process_group()
    return dict(h1=h1, h3=h3, h4=h4, h6=h6, **group)


class Trace:
    """One phase i trace: a command whose process ``TraceQueue`` starts (at
    the lowest priority, 19, one thread for the host's matrix code) when a
    slot frees;
    ``wait``, ``poll``, ``kill`` and ``returncode`` as a
    ``subprocess.Popen``'s (a trace killed before it started returns -9)."""

    def __init__(self, key, cmd: list, log_path: Path, cost_s: float):
        self.key, self.cmd, self.log_path, self.cost_s = key, cmd, log_path, cost_s
        self.proc: subprocess.Popen | None = None
        self.killed = False
        self.started_s = self.ended_s = None
        self.done = threading.Event()
        self.lock = threading.Lock()

    def run(self) -> None:
        root = Path(__file__).resolve().parent
        with self.lock:
            if self.killed:
                return
            self.started_s = time.perf_counter() - _T0
            with open(self.log_path, "w") as log_file:
                self.proc = subprocess.Popen(
                    self.cmd, cwd=root, stdout=log_file, stderr=subprocess.STDOUT,
                    env=dict(os.environ, PYTHONPATH=str(root / "src"), OMP_NUM_THREADS="1"),
                    preexec_fn=lambda: os.nice(19))
        self.proc.wait()
        self.ended_s = time.perf_counter() - _T0
        self.done.set()

    @property
    def returncode(self) -> int | None:
        if self.proc is None:
            return -9 if self.killed else None
        return self.proc.returncode

    def wait(self, timeout: float | None = None) -> int | None:
        if not self.done.wait(timeout):
            raise subprocess.TimeoutExpired(self.cmd, timeout)
        return self.returncode

    def poll(self) -> int | None:
        return self.returncode if self.done.is_set() else None

    def kill(self) -> None:
        with self.lock:
            self.killed = True
            if self.proc is None:
                self.done.set()
            else:
                self.proc.kill()


class TraceQueue:
    """Phase i's traces, started with the check: the longest first (by
    ``TRACE_COST_S``), at most ``slots`` at once, the host's cores less
    those the serial chain and phase 3's realize take (``TRACE_CORES_HELD``),
    each on one core.  ``traces`` by key; ``summary`` once all ended."""

    def __init__(self, traces: list[Trace]):
        self.traces = {t.key: t for t in traces}
        self.pending = sorted(traces, key=lambda t: -t.cost_s)
        self.slots = max(1, min(len(traces), (os.cpu_count() or 1) - TRACE_CORES_HELD))
        self.t0 = time.perf_counter()
        self.started_s = self.t0 - _T0
        self.lock = threading.Lock()
        for _ in range(self.slots):
            threading.Thread(target=self._work, daemon=True).start()

    def _work(self) -> None:
        while True:
            with self.lock:
                if not self.pending:
                    return
                trace = self.pending.pop(0)
            trace.run()

    def stop(self) -> None:
        """Kill every trace still queued or running."""
        with self.lock:
            self.pending = []
        for t in self.traces.values():
            if t.poll() is None:
                t.kill()
                t.wait()

    def summary(self) -> dict:
        ended = [t.ended_s for t in self.traces.values() if t.ended_s is not None]
        return dict(n=len(self.traces), slots=self.slots, cpu_count=os.cpu_count(),
                    started_s=self.started_s, ended_s=max(ended) if ended else None,
                    seconds={"/".join(k) if isinstance(k, tuple) else k:
                             round(t.ended_s - t.started_s, 1)
                             for k, t in self.traces.items() if t.ended_s is not None})


def start_dryrun(out: str, cell: str, layers: int = 0, arch: str = I3_ARCH,
                 mesh: str = I3_MESH, profile: str = "baseline", key=None) -> Trace:
    """A trace through the dry-run's command line (phases i3-i9):
    ``arch``'s ``cell`` as published (or cut to ``layers`` layers) on the
    production ``mesh`` under ``profile``, a fake fleet of 256 ranks of host
    (``--device cpu``) fake tensors in a process of its own (a process holds
    one default group; no CUDA context), its output in
    ``out/<arch>__<cell>__<mesh>.log``; queued under ``key`` (default:
    ``(arch, cell, mesh)``)."""
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--cell",
           cell, "--mesh", mesh, "--profile", profile, "--device", "cpu", "--out", out,
           "--layers", str(layers)]
    key = (arch, cell, mesh) if key is None else key
    return Trace(key, cmd, Path(out) / f"{arch}__{cell}__{mesh}.log",
                 TRACE_COST_S.get((arch, cell, mesh), 0.0))


def finish_dryrun(proc: subprocess.Popen, out: str, cell: str, what: str,
                  arch: str = I3_ARCH, mesh: str = I3_MESH, profile: str = "baseline",
                  timeout: float = I3_TIMEOUT_S) -> dict:
    """Wait for a ``start_dryrun`` process (killed past ``timeout``) and
    read its record."""
    try:
        proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    text = (Path(out) / f"{arch}__{cell}__{mesh}.log").read_text()
    check(proc.returncode == 0, f"{what}: the dry-run exited with {proc.returncode}: "
          f"{text[-4000:]}")
    tag = "" if profile == "baseline" else f"__{profile}"
    rec = json.loads((Path(out) / f"{arch}__{cell}__{mesh}{tag}.json").read_text())
    check(rec["ok"] and rec["collectives"]["collective_bytes"] > 0,
          f"{what}: ok {rec['ok']}, collectives {rec.get('collectives')}, error "
          f"{rec.get('error')}")
    check(rec["state_bytes_laid_out"] == rec["state_bytes_per_device"],
          f"{what}: laid-out state {rec['state_bytes_laid_out']} bytes, analytic "
          f"{rec['state_bytes_per_device']}")
    return rec


def below_parent(what: str, key: tuple, temp: int) -> None:
    """Fails unless a phase i cell's ``temp`` is below the parent's
    (``I_PARENT_TEMP[key]``)."""
    check(temp < I_PARENT_TEMP[key], f"{what}: temp {temp} not below the parent's "
          f"{I_PARENT_TEMP[key]}")


def check_i4(rec: dict, cell_name: str, layers: int, card_bytes: int, card: str) -> dict:
    """Phase i4's bounds on one serving cell's record, beside the
    reference's counts of the whole cell (a depth cut scales the collective
    bytes and the argument + temp + output bound by its share of the
    layers; the temp, one layer's working set and the weights gathered
    once, is held to the whole cell's bound)."""
    cfg = configs.get(I3_ARCH)
    share = 1.0
    if layers:
        share = layers / cfg.n_layers
        cfg = dataclasses.replace(cfg, n_layers=layers)
    cell = configs.SHAPES[cell_name]
    shape = rec["mesh_shape"]
    hand_fn = hand_decode_flops if cell.kind == "decode" else hand_prefill_flops
    hand = hand_fn(cfg, cell.global_batch, cell.seq_len, planned_parts(cfg, shape, cell))
    mem, coll, flops = rec["memory_analysis"], rec["collectives"], rec["cost_analysis"]["flops"]
    ref = I4_REFERENCE[cell_name]
    total = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"] + \
        mem["output_size_in_bytes"]
    out = dict(cell=cell_name, layers=cfg.n_layers, share=share, trace_s=rec["lower_s"],
               memory=mem, argument_temp_output=total, card_bytes=card_bytes,
               collective_bytes_per_device=coll["collective_bytes_per_device"],
               collective_by_kind=coll["collective_bytes_per_device_by_kind"],
               collective_ops=coll["op_counts"], flops=flops, hand_flops=hand,
               reference=ref, card=card, parent_temp=I_PARENT_TEMP[I3_ARCH, cell_name, I3_MESH],
               temp_over_reference=mem["temp_size_in_bytes"] / ref["temp"],
               collectives_over_reference=coll["collective_bytes_per_device"]
               / (ref["collective"] * share))
    log(f"phase i4: {I3_ARCH} {cell_name}{f' cut to {layers} layers' if layers else ''} on "
        f"the {shape} mesh of {math.prod(shape.values())} fake ranks, sharded: trace "
        f"{rec['lower_s']} s; argument {mem['argument_size_in_bytes']} / temp "
        f"{mem['temp_size_in_bytes']} / output {mem['output_size_in_bytes']} bytes a device "
        f"(the reference's {ref['argument']} / {ref['temp']} / {ref['output']}; temp "
        f"{out['temp_over_reference']:.4f} x), argument + temp + output {total} against "
        f"{card_bytes * share:.0f} (the card's {card_bytes}{' x ' + str(share) if layers else ''}"
        f"); collective bytes a device {coll['collective_bytes_per_device']:.0f} by kind "
        f"{coll['collective_bytes_per_device_by_kind']}, ops {coll['op_counts']}, "
        f"{out['collectives_over_reference']:.4f} x the reference's {ref['collective']}"
        f"{' x ' + str(share) if layers else ''} (its HLO's ops {ref['ops']}); product FLOPs "
        f"{flops:.6e}, the hand count {hand:.6e}; the parent's temp {out['parent_temp']}; "
        f"card {card}")
    below_parent(f"i4 {cell_name}", (I3_ARCH, cell_name, I3_MESH), mem["temp_size_in_bytes"])
    if cell.kind == "decode":
        same_as_cpu(f"i4 {cell_name}", (I3_ARCH, cell_name, I3_MESH), rec)
    if cell.kind == "decode":
        g = I4_GATHERED_DECODE
        log(f"phase i4: decode_32k before (the gathering step): temp {g['temp']}, collective "
            f"bytes a device {g['collective']}, FLOPs {g['flops']:.3e}; now "
            f"{mem['temp_size_in_bytes']}, {coll['collective_bytes_per_device']:.0f}, "
            f"{flops:.4e} ({g['flops'] / flops:.1f} x fewer)")
    check(total < card_bytes * share,
          f"i4 {cell_name}: argument + temp + output {total} above {card_bytes * share}")
    check(mem["temp_size_in_bytes"] <= I4_TEMP_OVER_REFERENCE * ref["temp"],
          f"i4 {cell_name}: temp {mem['temp_size_in_bytes']} above "
          f"{I4_TEMP_OVER_REFERENCE} x the reference's {ref['temp']}")
    check(out["collectives_over_reference"] <= I4_COLLECTIVE_OVER_REFERENCE[cell_name],
          f"i4 {cell_name}: collective bytes {out['collectives_over_reference']:.4f} x the "
          f"reference's, above {I4_COLLECTIVE_OVER_REFERENCE[cell_name]}")
    check(flops == hand, f"i4 {cell_name}: {flops} product FLOPs, the hand count {hand}")
    return out


def start_i5(out: str) -> dict:
    """Phase i5's traces, each in a process of its own at low priority."""
    return [start_dryrun(out, cell, layers, arch, mesh, profile)
            for arch, cell, mesh, profile, layers in I5_CELLS]


def check_i5(procs: dict, out: str, t0: float, card_bytes: int, card: str) -> dict:
    """Phase i5: each MoE cell's record against the reference's counts of
    the whole cell: argument + temp + output below the card's memory,
    collective bytes a device at most ``I5_COLLECTIVE_OVER_REFERENCE`` x the
    reference's (both scaled by the share of the layers where the depth is
    cut), product FLOPs equal to the hand count (``hand_*_flops`` with
    ``planned_parts``); the temp printed beside the reference's."""
    rows = {}
    for arch, cell_name, mesh, profile, layers in I5_CELLS:
        what = f"i5 {arch} {cell_name} {mesh}"
        rec = finish_dryrun(procs[arch, cell_name, mesh], out, cell_name, what, arch, mesh,
                            profile, timeout=max(1.0, I5_TIMEOUT_S - (time.perf_counter() - t0)))
        cfg = configs.get(arch)
        share = layers / cfg.n_layers if layers else 1.0
        if layers:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        cell = configs.SHAPES[cell_name]
        hand_fn = dict(train=hand_train_flops, prefill=hand_prefill_flops,
                       decode=hand_decode_flops)[cell.kind]
        with sharding_profile(profile):
            hand = hand_fn(cfg, cell.global_batch, cell.seq_len,
                           planned_parts(cfg, rec["mesh_shape"], cell))
        mem, coll, flops = rec["memory_analysis"], rec["collectives"], rec["cost_analysis"]["flops"]
        ref = I5_REFERENCE[arch, cell_name, mesh]
        total = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"] + \
            mem["output_size_in_bytes"]
        over = coll["collective_bytes_per_device"] / (ref["collective"] * share)
        row = dict(arch=arch, cell=cell_name, mesh=mesh, profile=profile, layers=cfg.n_layers,
                   share=share, trace_s=rec["lower_s"], memory=mem, argument_temp_output=total,
                   card_bytes=card_bytes, collective_bytes_per_device=coll[
                       "collective_bytes_per_device"],
                   collective_by_kind=coll["collective_bytes_per_device_by_kind"],
                   collective_ops=coll["op_counts"], flops=flops, hand_flops=hand,
                   reference=ref, before=I5_BEFORE.get((arch, cell_name, mesh)), card=card,
                   parent_temp=I_PARENT_TEMP[arch, cell_name, mesh],
                   temp_over_reference=mem["temp_size_in_bytes"] / ref["temp"],
                   collectives_over_reference=over)
        rows[f"{arch}/{cell_name}/{mesh}"] = row
        log(f"phase i5: {arch} {cell_name}{f' cut to {layers} layers' if layers else ''} on "
            f"the {rec['mesh_shape']} mesh under {profile} of "
            f"{math.prod(rec['mesh_shape'].values())} fake ranks, sharded: trace "
            f"{rec['lower_s']} s; argument {mem['argument_size_in_bytes']} / temp "
            f"{mem['temp_size_in_bytes']} / output {mem['output_size_in_bytes']} bytes a device "
            f"(the reference's {ref['argument']} / {ref['temp']} / {ref['output']}; temp "
            f"{row['temp_over_reference']:.4f} x), argument + temp + output {total} against "
            f"{card_bytes * share:.0f} (the card's {card_bytes}"
            f"{' x ' + str(share) if layers else ''}); collective bytes a device "
            f"{coll['collective_bytes_per_device']:.0f} by kind "
            f"{coll['collective_bytes_per_device_by_kind']}, ops {coll['op_counts']}, "
            f"{over:.4f} x the reference's {ref['collective']}"
            f"{' x ' + str(share) if layers else ''} (its HLO's ops {ref['ops']}); product "
            f"FLOPs {flops:.6e}, the hand count {hand:.6e}; before (ZeRO-3 or gathering): "
            f"{row['before']}; the parent's temp {row['parent_temp']}; card {card}")
        below_parent(what, (arch, cell_name, mesh), mem["temp_size_in_bytes"])
        if cell.kind == "decode":
            same_as_cpu(what, (arch, cell_name, mesh), rec)
        check(total < card_bytes * share,
              f"{what}: argument + temp + output {total} above {card_bytes * share}")
        check(over <= I5_COLLECTIVE_OVER_REFERENCE[cell.kind],
              f"{what}: collective bytes {over:.4f} x the reference's, above "
              f"{I5_COLLECTIVE_OVER_REFERENCE[cell.kind]}")
        check(flops == hand, f"{what}: {flops} product FLOPs, the hand count {hand}")
    log(f"phase i5: {time.perf_counter() - t0:.1f} s from the traces' start to their last "
        f"record")
    return rows


def start_i6(out: str) -> dict:
    """Phase i6's traces, each in a process of its own at low priority."""
    return [start_dryrun(out, cell, 0, I6_ARCH, I6_MESH) for cell in I6_CELLS]


def check_i6(procs: dict, out: str, t0: float, card_bytes: int, card: str) -> dict:
    """Phase i6: each SSM cell's record against the reference's counts:
    argument + temp + output below the card's memory, collective bytes a
    device at most ``I6_COLLECTIVE_OVER_REFERENCE`` x the reference's
    (long_500k: at most 1 / ``I_LONG_UNDER_PARENT`` of the parent tree's
    ``I_LONG_PARENT_COLLECTIVE``, printed beside the reference's), product
    FLOPs equal to the hand count
    (``hand_*_flops`` with ``planned_parts``), train_4k's at most
    1 / ``I6_TRAIN_FLOPS_UNDER_BEFORE`` of the ZeRO-3 step's; the temp
    printed beside the reference's."""
    rows = {}
    cfg = configs.get(I6_ARCH)
    for cell_name in I6_CELLS:
        what = f"i6 {I6_ARCH} {cell_name}"
        rec = finish_dryrun(procs[I6_ARCH, cell_name, I6_MESH], out, cell_name, what, I6_ARCH,
                            I6_MESH, timeout=max(1.0, I5_TIMEOUT_S - (time.perf_counter() - t0)))
        cell = configs.SHAPES[cell_name]
        hand_fn = dict(train=hand_train_flops, prefill=hand_prefill_flops,
                       decode=hand_decode_flops)[cell.kind]
        hand = hand_fn(cfg, cell.global_batch, cell.seq_len,
                       planned_parts(cfg, rec["mesh_shape"], cell))
        mem, coll, flops = rec["memory_analysis"], rec["collectives"], rec["cost_analysis"]["flops"]
        ref, before = I6_REFERENCE[cell_name], I6_BEFORE[cell_name]
        total = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"] + \
            mem["output_size_in_bytes"]
        got = coll["collective_bytes_per_device"]
        row = dict(arch=I6_ARCH, cell=cell_name, mesh=I6_MESH, trace_s=rec["lower_s"],
                   memory=mem, argument_temp_output=total, card_bytes=card_bytes,
                   collective_bytes_per_device=got,
                   collective_by_kind=coll["collective_bytes_per_device_by_kind"],
                   collective_ops=coll["op_counts"], flops=flops, hand_flops=hand,
                   reference=ref, before=before, card=card,
                   parent_temp=I_PARENT_TEMP[I6_ARCH, cell_name, I6_MESH],
                   temp_over_reference=mem["temp_size_in_bytes"] / ref["temp"],
                   collectives_over_reference=got / ref["collective"],
                   collectives_over_before=got / before["collective"])
        rows[cell_name] = row
        log(f"phase i6: {I6_ARCH} {cell_name} on the {rec['mesh_shape']} mesh of "
            f"{math.prod(rec['mesh_shape'].values())} fake ranks, head-parallel: trace "
            f"{rec['lower_s']} s; argument {mem['argument_size_in_bytes']} / temp "
            f"{mem['temp_size_in_bytes']} / output {mem['output_size_in_bytes']} bytes a device "
            f"(the reference's {ref['argument']} / {ref['temp']} / {ref['output']}; temp "
            f"{row['temp_over_reference']:.4f} x), argument + temp + output {total} against "
            f"the card's {card_bytes}; collective bytes a device {got:.0f} by kind "
            f"{coll['collective_bytes_per_device_by_kind']}, ops {coll['op_counts']}, "
            f"{row['collectives_over_reference']:.4f} x the reference's {ref['collective']} "
            f"(its HLO's ops {ref['ops']}), {row['collectives_over_before']:.4f} x the gathering "
            f"or ZeRO-3 step's {before['collective']}; product FLOPs {flops:.6e}, the hand "
            f"count {hand:.6e} (before: {before['flops']:.4e}); before: temp {before['temp']}; "
            f"the parent's temp {row['parent_temp']}; card {card}")
        below_parent(what, (I6_ARCH, cell_name, I6_MESH), mem["temp_size_in_bytes"])
        if cell.kind == "decode":
            same_as_cpu(what, (I6_ARCH, cell_name, I6_MESH), rec)
        check(total < card_bytes, f"{what}: argument + temp + output {total} above {card_bytes}")
        if cell_name in I6_COLLECTIVE_OVER_REFERENCE:
            check(row["collectives_over_reference"] <= I6_COLLECTIVE_OVER_REFERENCE[cell_name],
                  f"{what}: collective bytes {row['collectives_over_reference']:.4f} x the "
                  f"reference's, above {I6_COLLECTIVE_OVER_REFERENCE[cell_name]}")
        else:
            check_long(what, I6_ARCH, got)
        check(flops == hand, f"{what}: {flops} product FLOPs, the hand count {hand}")
        if cell.kind == "train":
            check(flops <= before["flops"] / I6_TRAIN_FLOPS_UNDER_BEFORE,
                  f"{what}: {flops} product FLOPs above 1/{I6_TRAIN_FLOPS_UNDER_BEFORE} of the "
                  f"ZeRO-3 step's {before['flops']}")
    log(f"phase i6: {time.perf_counter() - t0:.1f} s from the traces' start to their last "
        f"record")
    return rows


def check_long(what: str, arch: str, got: float) -> None:
    """A long_500k cell's collective bytes a device: at most 1 /
    ``I_LONG_UNDER_PARENT`` of the parent tree's, printed with the ratio."""
    parent = I_LONG_PARENT_COLLECTIVE[arch]
    log(f"{what}: collective bytes a device {got:.0f}, {got / parent:.6f} x the parent tree's "
        f"{parent} (bound {1 / I_LONG_UNDER_PARENT})")
    check(got * I_LONG_UNDER_PARENT <= parent,
          f"{what}: collective bytes {got} above 1/{I_LONG_UNDER_PARENT} of the parent tree's "
          f"{parent}")


def planned_parts(cfg, shape: dict, cell) -> dict:
    """The ranks each logical axis of a planned step splits over on a
    production mesh under the active profile, from the resolved specs (i3
    to i7's hand FLOP counts): the stream's rows and sequence (one
    token in decode), the attention's heads, the MLP's and the
    vocabulary's columns; the experts and their hidden columns (where the
    experts' axes split the sequence the tokens cross them instead: 1);
    ``in_proj``'s columns, the SSM heads (the decode cache's ``ssm`` leaf);
    the cache's rows and sequence, an encoder-decoder's cross cache's
    sequence (the frames'); a decode step's weights' embed axes that its
    rows leave whole (``embed``: the plan's stationary axes), wk's columns
    (``kv``) and the conv history's channels (``conv``); a decode step's
    tables' embed axes that its rows split (``table``) and, where the
    vocabulary does not split, the axes its logits' columns split over
    (``logits``)."""
    def axes(entry) -> tuple:
        return () if entry is None else entry if isinstance(entry, tuple) else (entry,)

    def n(entry) -> int:
        return math.prod(shape[ax] for ax in axes(entry))

    def spec(p):
        return resolve_spec(tuple(p.shape), p.logical, shape)
    model = build(cfg)
    B, S = cell.global_batch, 1 if cell.kind == "decode" else cell.seq_len
    stream = resolve_spec((B, S), ("batch", "seq"), shape)
    specs = model.specs()
    if cfg.family == "encdec":
        layer = dict(specs["dec_blocks"], attn=specs["dec_blocks"]["self_attn"])
    else:
        layer = {k: v for b in specs["blocks"].values() for k, v in b.items()}
    parts = dict(batch=n(stream[0]), seq=n(stream[1]), vocab=n(spec(specs["embed"])[0]))
    if "attn" in layer:
        parts["qkv"] = n(spec(layer["attn"]["wq"])[2])
    if "mlp" in layer:
        parts["ffn"] = n(spec(next(iter(layer["mlp"].values())))[2])
    if "moe" in layer:
        w = layer["moe"]["wg"]
        experts, ffn = (axes(spec(w)[w.logical.index(k)]) for k in ("experts", "ffn"))
        seq = set(axes(stream[1]))
        parts["experts"] = 1 if set(experts) & seq else n(experts)
        parts["expert_ffn"] = n(tuple(ax for ax in ffn if ax not in seq))
    if "ssm" in layer:
        w = layer["ssm"]["in_proj"]
        parts["ssm_inner"] = n(spec(w)[w.logical.index("ssm_inner")])
    caches = model.cache_specs(cell.global_batch, cell.seq_len)
    cache = {k: v for name, e in caches.items() if name != "cross" for k, v in e.items()}
    if "cross" in caches:
        parts["cross_seq"] = n(spec(caches["cross"]["k"])[2])
    if "k" in cache:
        parts.update(cache_batch=n(spec(cache["k"])[1]), cache_seq=n(spec(cache["k"])[2]))
    if "ssm" in cache:
        parts.update(cache_batch=n(spec(cache["ssm"])[1]), ssm_heads=n(spec(cache["ssm"])[2]),
                     conv=n(spec(cache["conv"])[3]))
    if "attn" in layer:
        parts["kv"] = n(spec(layer["attn"]["wk"])[2])
    embed = {ax for p in tree_leaves(specs) for e, lname in zip(spec(p), p.logical)
             if lname in ("embed", "embed_d") for ax in axes(e)}
    rows = axes(stream[0])
    parts["embed"] = n(tuple(ax for ax in shape if ax in embed and ax not in rows
                             and shape[ax] > 1)) if cell.kind == "decode" else 1
    if cell.kind == "decode":
        tables = set(axes(spec(specs["embed"])[1]))
        parts["table"] = n(tuple(ax for ax in rows if ax in tables))
        if parts["table"] > 1 and parts["vocab"] == 1:
            parts["logits"] = n(tuple(ax for ax in shape if ax not in rows))
    return parts


def start_i7(out: str) -> dict:
    """Phase i7's traces, each in a process of its own at low priority."""
    return [start_dryrun(out, cell, layers, arch, "single") for arch, cell, layers in I7_CELLS]


def check_i7(procs: dict, out: str, t0: float, card_bytes: int, card: str) -> dict:
    """Phase i7: each hybrid and VLM cell's record against the reference's
    counts of the whole cell: argument + temp + output below the card's
    memory, collective bytes a device at most ``I7_COLLECTIVE_OVER_REFERENCE``
    x the reference's (both scaled by the share of the layers where the depth
    is cut; long_500k: at most 1 / ``I_LONG_UNDER_PARENT`` of the parent
    tree's), product FLOPs equal to the hand count (``hand_*_flops`` with
    ``planned_parts``); the temp and the gathering or ZeRO-3 step's figures
    printed beside them."""
    rows = {}
    for arch, cell_name, layers in I7_CELLS:
        what = f"i7 {arch} {cell_name}"
        rec = finish_dryrun(procs[arch, cell_name, "single"], out, cell_name, what, arch,
                            "single", timeout=max(1.0, I5_TIMEOUT_S - (time.perf_counter() - t0)))
        cfg = configs.get(arch)
        share = layers / cfg.n_layers if layers else 1.0
        if layers:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        cell = configs.SHAPES[cell_name]
        hand_fn = dict(train=hand_train_flops, prefill=hand_prefill_flops,
                       decode=hand_decode_flops)[cell.kind]
        hand = hand_fn(cfg, cell.global_batch, cell.seq_len,
                       planned_parts(cfg, rec["mesh_shape"], cell))
        mem, coll, flops = rec["memory_analysis"], rec["collectives"], rec["cost_analysis"]["flops"]
        ref, before = I7_REFERENCE[arch, cell_name], I7_BEFORE.get((arch, cell_name))
        total = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"] + \
            mem["output_size_in_bytes"]
        got = coll["collective_bytes_per_device"]
        row = dict(arch=arch, cell=cell_name, layers=cfg.n_layers, share=share,
                   trace_s=rec["lower_s"], memory=mem, argument_temp_output=total,
                   card_bytes=card_bytes, collective_bytes_per_device=got,
                   collective_by_kind=coll["collective_bytes_per_device_by_kind"],
                   collective_ops=coll["op_counts"], flops=flops, hand_flops=hand,
                   reference=ref, before=before, card=card,
                   parent_temp=I_PARENT_TEMP[arch, cell_name, "single"],
                   temp_over_reference=mem["temp_size_in_bytes"] / ref["temp"],
                   collectives_over_reference=got / (ref["collective"] * share))
        rows[f"{arch}/{cell_name}"] = row
        log(f"phase i7: {arch} {cell_name}{f' cut to {layers} layers' if layers else ''} on the "
            f"{rec['mesh_shape']} mesh of {math.prod(rec['mesh_shape'].values())} fake ranks, "
            f"planned: trace {rec['lower_s']} s; argument {mem['argument_size_in_bytes']} / temp "
            f"{mem['temp_size_in_bytes']} / output {mem['output_size_in_bytes']} bytes a device "
            f"(the reference's {ref['argument']} / {ref['temp']} / {ref['output']}; temp "
            f"{row['temp_over_reference']:.4f} x), argument + temp + output {total} against "
            f"{card_bytes * share:.0f} (the card's {card_bytes}"
            f"{' x ' + str(share) if layers else ''}); collective bytes a device {got:.0f} by "
            f"kind {coll['collective_bytes_per_device_by_kind']}, ops {coll['op_counts']}, "
            f"{row['collectives_over_reference']:.4f} x the reference's {ref['collective']}"
            f"{' x ' + str(share) if layers else ''} (its HLO's ops {ref['ops']}); product FLOPs "
            f"{flops:.6e}, the hand count {hand:.6e}; before (the gathering or ZeRO-3 step): "
            f"{before if before else 'not traced'}; the parent's temp {row['parent_temp']}; "
            f"card {card}")
        below_parent(what, (arch, cell_name, "single"), mem["temp_size_in_bytes"])
        if cell.kind == "decode":
            same_as_cpu(what, (arch, cell_name, "single"), rec)
        check(total < card_bytes * share,
              f"{what}: argument + temp + output {total} above {card_bytes * share}")
        if cell_name == "long_500k":
            check_long(what, arch, got)
        else:
            check(row["collectives_over_reference"] <= I7_COLLECTIVE_OVER_REFERENCE[cell.kind],
                  f"{what}: collective bytes {row['collectives_over_reference']:.4f} x the "
                  f"reference's, above {I7_COLLECTIVE_OVER_REFERENCE[cell.kind]}")
        check(flops == hand, f"{what}: {flops} product FLOPs, the hand count {hand}")
    log(f"phase i7: {time.perf_counter() - t0:.1f} s from the traces' start to their last "
        f"record")
    return rows


def start_i8(out: str) -> dict:
    """Phase i8's traces, each in a process of its own at low priority."""
    return [start_dryrun(out, cell, 0, I8_ARCH, "single") for cell in I8_CELLS]


def check_i8(procs: dict, out: str, t0: float, card_bytes: int, card: str) -> dict:
    """Phase i8: each whisper-tiny cell's record against the reference's
    counts and the CPU's: sum, temp, collective bytes and FLOPs equal to
    ``I8_CPU`` to the byte, argument + temp + output below the card's
    memory, product FLOPs equal to the hand count (``hand_*_flops`` with
    ``planned_parts``), collective bytes a device at most the reference's
    (train, prefill) or, for decode_32k, below ``I8_DECODE_OVER_BEFORE`` of
    the gathering step's with its temp below ``I8_DECODE_TEMP``; the
    reference's and the parent's figures printed beside them."""
    rows = {}
    cfg = configs.get(I8_ARCH)
    for cell_name in I8_CELLS:
        what = f"i8 {I8_ARCH} {cell_name}"
        rec = finish_dryrun(procs[I8_ARCH, cell_name, "single"], out, cell_name, what, I8_ARCH,
                            "single", timeout=max(1.0, I5_TIMEOUT_S - (time.perf_counter() - t0)))
        cell = configs.SHAPES[cell_name]
        hand_fn = dict(train=hand_train_flops, prefill=hand_prefill_flops,
                       decode=hand_decode_flops)[cell.kind]
        hand = hand_fn(cfg, cell.global_batch, cell.seq_len,
                       planned_parts(cfg, rec["mesh_shape"], cell))
        mem, coll, flops = rec["memory_analysis"], rec["collectives"], rec["cost_analysis"]["flops"]
        ref, before, cpu = I8_REFERENCE[cell_name], I8_BEFORE[cell_name], I8_CPU[cell_name]
        total = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"] + \
            mem["output_size_in_bytes"]
        got = coll["collective_bytes_per_device"]
        here = dict(total=total, temp=mem["temp_size_in_bytes"], collective=got, flops=flops)
        row = dict(arch=I8_ARCH, cell=cell_name, trace_s=rec["lower_s"], memory=mem,
                   argument_temp_output=total, card_bytes=card_bytes,
                   collective_bytes_per_device=got,
                   collective_by_kind=coll["collective_bytes_per_device_by_kind"],
                   collective_ops=coll["op_counts"], flops=flops, hand_flops=hand,
                   reference=ref, before=before, cpu=cpu, card=card,
                   parent_temp=I_PARENT_TEMP[I8_ARCH, cell_name, "single"],
                   temp_over_reference=mem["temp_size_in_bytes"] / ref["temp"],
                   collectives_over_reference=got / ref["collective"],
                   collectives_over_before=got / before["collective"])
        rows[cell_name] = row
        log(f"phase i8: {I8_ARCH} {cell_name} on the {rec['mesh_shape']} mesh of "
            f"{math.prod(rec['mesh_shape'].values())} fake ranks, planned: trace "
            f"{rec['lower_s']} s; argument {mem['argument_size_in_bytes']} / temp "
            f"{mem['temp_size_in_bytes']} / output {mem['output_size_in_bytes']} bytes a device "
            f"(the reference's {ref['argument']} / {ref['temp']} / {ref['output']}; temp "
            f"{row['temp_over_reference']:.4f} x), argument + temp + output {total} against the "
            f"card's {card_bytes}; collective bytes a device {got:.0f} by kind "
            f"{coll['collective_bytes_per_device_by_kind']}, ops {coll['op_counts']}, "
            f"{row['collectives_over_reference']:.4f} x the reference's {ref['collective']} (its "
            f"HLO's ops {ref['ops']}), {row['collectives_over_before']:.4f} x before's; product "
            f"FLOPs {flops:.6e}, the hand count {hand:.6e}; the CPU's counts {cpu}; before (the "
            f"ZeRO-3 or gathering step): {before}; the parent's temp {row['parent_temp']}; "
            f"card {card}")
        check(here == cpu, f"{what}: {here}, not the CPU's counts {cpu}")
        below_parent(what, (I8_ARCH, cell_name, "single"), mem["temp_size_in_bytes"])
        check(total < card_bytes, f"{what}: argument + temp + output {total} above {card_bytes}")
        check(flops == hand, f"{what}: {flops} product FLOPs, the hand count {hand}")
        if cell.kind == "decode":
            check(got <= I8_DECODE_OVER_BEFORE * before["collective"]
                  and mem["temp_size_in_bytes"] < I8_DECODE_TEMP,
                  f"{what}: collective bytes {got} against {I8_DECODE_OVER_BEFORE} x the "
                  f"gathering step's {before['collective']}, temp {mem['temp_size_in_bytes']}")
        check(row["collectives_over_reference"] <= I8_COLLECTIVE_OVER_REFERENCE[cell_name],
              f"{what}: collective bytes {row['collectives_over_reference']:.4f} x the "
              f"reference's, above {I8_COLLECTIVE_OVER_REFERENCE[cell_name]}")
    log(f"phase i8: {time.perf_counter() - t0:.1f} s from the traces' start to their last "
        f"record")
    return rows


def start_i9(out: str) -> list:
    """Phase i9's trace, queued as the others."""
    return [start_dryrun(out, I9_CELL, I9_LAYERS, I9_ARCH, "single")]


def check_i9(procs: dict, out: str, t0: float, card_bytes: int, card: str) -> dict:
    """Phase i9: minicpm-2b's train_4k cut to I9_LAYERS layers, its q heads
    unsplit over the model axis: the record's sum, temp, collective bytes
    and FLOPs equal to the CPU's counts (``I9_CPU``) to the byte, the
    product FLOPs equal to ``hand_train_flops``, its argument + temp below
    the card's memory and below the reference's whole-cell temp; the
    parent tree's figures printed beside them."""
    cfg = dataclasses.replace(configs.get(I9_ARCH), n_layers=I9_LAYERS)
    what = f"i9 {I9_ARCH} {I9_CELL} at {I9_LAYERS} layers"
    rec = finish_dryrun(procs[I9_ARCH, I9_CELL, "single"], out, I9_CELL, what, I9_ARCH,
                        "single", timeout=max(1.0, I5_TIMEOUT_S - (time.perf_counter() - t0)))
    cell = configs.SHAPES[I9_CELL]
    parts = planned_parts(cfg, rec["mesh_shape"], cell)
    hand = hand_train_flops(cfg, cell.global_batch, cell.seq_len, parts)
    mem, coll, flops = rec["memory_analysis"], rec["collectives"], rec["cost_analysis"]["flops"]
    arg_temp = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    here = dict(total=arg_temp + mem["output_size_in_bytes"], temp=mem["temp_size_in_bytes"],
                collective=coll["collective_bytes_per_device"], flops=flops)
    row = dict(arch=I9_ARCH, cell=I9_CELL, layers=I9_LAYERS, trace_s=rec["lower_s"], memory=mem,
               argument_temp=arg_temp, card_bytes=card_bytes,
               collective_bytes_per_device=coll["collective_bytes_per_device"],
               collective_by_kind=coll["collective_bytes_per_device_by_kind"],
               collective_ops=coll["op_counts"], flops=flops, hand_flops=hand, parts=parts,
               reference=I9_REFERENCE, parent=I9_PARENT, cpu=I9_CPU, card=card,
               over_parent=arg_temp / I9_PARENT["argument_temp"])
    log(f"phase i9: {I9_ARCH} {I9_CELL} at {I9_LAYERS} of its 40 layers on the "
        f"{rec['mesh_shape']} mesh of {math.prod(rec['mesh_shape'].values())} fake ranks, "
        f"{cfg.n_heads} q heads on {parts['qkv']} ranks, each attending with its query slice: "
        f"trace {rec['lower_s']} s; argument {mem['argument_size_in_bytes']} / temp "
        f"{mem['temp_size_in_bytes']} / output {mem['output_size_in_bytes']} bytes a device, "
        f"argument + temp {arg_temp} against the card's {card_bytes} and the reference's "
        f"whole-cell temp {I9_REFERENCE['temp']} (the parent's {I9_PARENT['argument_temp']}: "
        f"{row['over_parent']:.4f} x); collective bytes a device "
        f"{coll['collective_bytes_per_device']:.0f} by kind "
        f"{coll['collective_bytes_per_device_by_kind']}, ops {coll['op_counts']}; product FLOPs "
        f"{flops:.6e}, the hand count {hand:.6e}; the CPU's counts {I9_CPU}; card {card}")
    check(here == I9_CPU, f"{what}: {here}, not the CPU's counts {I9_CPU}")
    check(flops == hand, f"{what}: {flops} product FLOPs, the hand count {hand}")
    check(arg_temp < card_bytes and arg_temp < I9_REFERENCE["temp"],
          f"{what}: argument + temp {arg_temp} not below the card's {card_bytes} and the "
          f"reference's whole-cell temp {I9_REFERENCE['temp']}")
    return row


def start_i10(out: str) -> list:
    """Phase i10's traces, queued as the others."""
    return [start_dryrun(out, cell, 0, arch, "single") for arch, cell in I10_CELLS]


def check_i10(procs: dict, out: str, t0: float, card_bytes: int, card: str) -> dict:
    """Phase i10: each cell's record against the reference's counts and the
    CPU's: sum, temp, collective bytes and FLOPs equal to ``I_DECODE_CPU``
    to the byte, argument + temp + output below the card's memory, product
    FLOPs equal to ``hand_decode_flops`` with ``planned_parts``, collective
    bytes a device at most ``I10_COLLECTIVE_OVER_REFERENCE`` x the
    reference's; the parent tree's temp printed beside them."""
    rows = {}
    for arch, cell_name in I10_CELLS:
        what = f"i10 {arch} {cell_name}"
        rec = finish_dryrun(procs[arch, cell_name, "single"], out, cell_name, what, arch,
                            "single", timeout=max(1.0, I5_TIMEOUT_S - (time.perf_counter() - t0)))
        cfg, cell = configs.get(arch), configs.SHAPES[cell_name]
        parts = planned_parts(cfg, rec["mesh_shape"], cell)
        hand = hand_decode_flops(cfg, cell.global_batch, cell.seq_len, parts)
        mem, coll, flops = rec["memory_analysis"], rec["collectives"], rec["cost_analysis"]["flops"]
        ref = I10_REFERENCE[arch, cell_name]
        total = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"] + \
            mem["output_size_in_bytes"]
        got = coll["collective_bytes_per_device"]
        row = dict(arch=arch, cell=cell_name, trace_s=rec["lower_s"], memory=mem,
                   argument_temp_output=total, card_bytes=card_bytes,
                   collective_bytes_per_device=got,
                   collective_by_kind=coll["collective_bytes_per_device_by_kind"],
                   collective_ops=coll["op_counts"], flops=flops, hand_flops=hand, parts=parts,
                   reference=ref, card=card, parent_temp=I_PARENT_TEMP[arch, cell_name, "single"],
                   temp_over_reference=mem["temp_size_in_bytes"] / ref["temp"],
                   collectives_over_reference=got / ref["collective"])
        rows[f"{arch}/{cell_name}"] = row
        log(f"phase i10: {arch} {cell_name} as published on the {rec['mesh_shape']} mesh of "
            f"{math.prod(rec['mesh_shape'].values())} fake ranks, planned: trace "
            f"{rec['lower_s']} s; argument {mem['argument_size_in_bytes']} / temp "
            f"{mem['temp_size_in_bytes']} / output {mem['output_size_in_bytes']} bytes a device "
            f"(the reference's {ref['argument']} / {ref['temp']} / {ref['output']}; temp "
            f"{row['temp_over_reference']:.4f} x), argument + temp + output {total} against the "
            f"card's {card_bytes}; collective bytes a device {got:.0f} by kind "
            f"{coll['collective_bytes_per_device_by_kind']}, ops {coll['op_counts']}, "
            f"{row['collectives_over_reference']:.4f} x the reference's {ref['collective']} (its "
            f"HLO's ops {ref['ops']}); product FLOPs {flops:.6e}, the hand count {hand:.6e}; "
            f"the parent's temp {row['parent_temp']}; card {card}")
        same_as_cpu(what, (arch, cell_name, "single"), rec)
        check(total < card_bytes, f"{what}: argument + temp + output {total} above {card_bytes}")
        check(flops == hand, f"{what}: {flops} product FLOPs, the hand count {hand}")
        check(row["collectives_over_reference"] <= I10_COLLECTIVE_OVER_REFERENCE,
              f"{what}: collective bytes {row['collectives_over_reference']:.4f} x the "
              f"reference's, above {I10_COLLECTIVE_OVER_REFERENCE}")
    return rows


def same_as_cpu(what: str, key: tuple, rec: dict) -> None:
    """A decode record's argument + temp + output, temp, collective bytes a
    device and product FLOPs equal to the CPU's counts (``I_DECODE_CPU``) to
    the byte."""
    mem = rec["memory_analysis"]
    here = dict(total=mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
                + mem["output_size_in_bytes"], temp=mem["temp_size_in_bytes"],
                collective=rec["collectives"]["collective_bytes_per_device"],
                flops=rec["cost_analysis"]["flops"])
    cpu = I_DECODE_CPU[key]
    log(f"{what}: {here}, the CPU's counts {cpu}")
    check(here == cpu, f"{what}: {here}, not the CPU's counts {cpu}")


def traced_train_flops(cfg, B: int, S: int) -> int:
    """The product FLOPs one train step of a swiglu decoder runs, as the
    dry-run counts them: ``train_bounds``' products, but every (q, k) tile
    of the chunked attention (the masked ones too), and each layer's down
    projection without its recompute (the non-reentrant checkpoint stops
    once the tensors the backward needs are back, and the block's last
    product saves none)."""
    d, V, L, hd = cfg.d_model, cfg.vocab, cfg.n_layers, cfg.hd
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    w_layer = d * hd * (hq + 2 * hkv) + hq * hd * d + 3 * d * cfg.d_ff
    qc, kc = min(512, S), min(1024, S)
    sq, sk = -(-S // qc) * qc, -(-S // kc) * kc
    fwd = 2 * B * S * (L * w_layer + d * V) + 4 * B * L * hq * hd * sq * sk
    return 4 * fwd - L * 2 * B * S * d * cfg.d_ff


def analysis_phase(device, g2: dict, e2: dict, procs: dict, out: str, t0: float) -> dict:
    """Phase i, after every timed phase: the records of the traces
    ``start_analysis`` queued at the check's start (``procs``, their output in
    ``out``): i1, the dry-run of g2's cell, then i2, the roofline of the
    cells g2 and e2 ran, on a one-rank fake world (this process's default
    group for i2 alone); i3, i4, i5, i6, i7, i8, i9 and i10."""
    card = smi("name,power.limit")
    t3 = time.perf_counter()
    i1, i2 = analysis_one_rank(device, g2, e2, card, procs["i1"], out)
    i3 = finish_dryrun(procs["i3"], out, I3_CELL, "i3")
    i3_wall = time.perf_counter() - t3
    i4 = {cell: finish_dryrun(procs[cell], out, cell, f"i4 {cell}") for cell, _ in I4_CELLS}
    i4_wall = time.perf_counter() - t3
    i3["wall_s"] = i3_wall
    mem, flops = i3["memory_analysis"], i3["cost_analysis"]["flops"]
    shape = i3["mesh_shape"]
    i3_cfg, i3_cell = configs.get(I3_ARCH), configs.SHAPES[I3_CELL]
    hand = hand_train_flops(i3_cfg, i3_cell.global_batch, i3_cell.seq_len,
                            planned_parts(i3_cfg, shape, i3_cell))
    card_bytes = torch.cuda.get_device_properties(0).total_memory
    coll = i3["collectives"]
    i3.update(hand_flops=hand, card_bytes=card_bytes,
              reference_temp_bytes=I3_REFERENCE_TEMP_BYTES,
              temp_over_reference=mem["temp_size_in_bytes"] / I3_REFERENCE_TEMP_BYTES,
              reference_collective_bytes_per_device=I3_REFERENCE_COLLECTIVE_BYTES,
              reference_collective_ops=I3_REFERENCE_COLLECTIVE_OPS,
              collectives_over_reference=coll["collective_bytes_per_device"]
              / I3_REFERENCE_COLLECTIVE_BYTES)
    log(f"phase i3: {I3_ARCH} {I3_CELL} on the {shape} mesh of "
        f"{math.prod(shape.values())} fake ranks: trace {i3['lower_s']} s "
        f"({i3_wall:.1f} s in phase i to read i1 to i3), state "
        f"{i3['state_bytes_per_device']} bytes a device as analytic, memory "
        f"{mem}, cost {i3['cost_analysis']}, collectives {coll}: "
        f"{coll['collective_bytes_per_device']:.0f} bytes a device, "
        f"{i3['collectives_over_reference']:.4f} x the reference's "
        f"{I3_REFERENCE_COLLECTIVE_BYTES} (its HLO's ops {I3_REFERENCE_COLLECTIVE_OPS}); temp "
        f"{mem['temp_size_in_bytes']} bytes a device, {i3['temp_over_reference']:.4f} x the "
        f"reference's {I3_REFERENCE_TEMP_BYTES} (its XLA compile count on 256 fake host "
        f"devices); argument + temp {mem['argument_size_in_bytes'] + mem['temp_size_in_bytes']} "
        f"bytes against the card's {card_bytes}; product FLOPs {flops:.6e}, the hand count "
        f"{hand:.6e}, {I3_ZERO3_FLOPS / flops:.2f} x under the ZeRO-3 step's {I3_ZERO3_FLOPS:.4e}; "
        f"the parent's temp {I_PARENT_TEMP[I3_ARCH, I3_CELL, I3_MESH]}")
    i3["parent_temp"] = I_PARENT_TEMP[I3_ARCH, I3_CELL, I3_MESH]
    below_parent("i3", (I3_ARCH, I3_CELL, I3_MESH), mem["temp_size_in_bytes"])
    check(mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"] < card_bytes,
          f"i3: {mem} does not fit the card's {card_bytes} bytes")
    check(mem["temp_size_in_bytes"] <= 2 * I3_REFERENCE_TEMP_BYTES,
          f"i3: temp {mem['temp_size_in_bytes']} above twice the reference's")
    check(flops == hand and flops <= I3_ZERO3_FLOPS / 12,
          f"i3: {flops} product FLOPs, the hand count {hand}")
    check(coll["collective_bytes_per_device"] <= I3_REFERENCE_COLLECTIVE_BYTES,
          f"i3: {coll['collective_bytes_per_device']} collective bytes a device, above the "
          f"reference's {I3_REFERENCE_COLLECTIVE_BYTES}")
    i4 = {cell: check_i4(i4[cell], cell, layers, card_bytes, card) for cell, layers in I4_CELLS}
    log(f"phase i4: {i4_wall:.1f} s in phase i to read i1 to i4, their traces queued at the "
        f"check's start, {t3 - t0:.1f} s before")
    i5 = check_i5(procs, out, t0, card_bytes, card)
    i6 = check_i6(procs, out, t0, card_bytes, card)
    i7 = check_i7(procs, out, t0, card_bytes, card)
    i8 = check_i8(procs, out, t0, card_bytes, card)
    i9 = check_i9(procs, out, t0, card_bytes, card)
    i10 = check_i10(procs, out, t0, card_bytes, card)
    return dict(i1=i1, i2=i2, i3=i3, i4=i4, i4_wall_s=i4_wall, i5=i5, i6=i6, i7=i7, i8=i8,
                i9=i9, i10=i10, card=card)


def i1_trace(out: str, device: str = "cuda") -> None:
    """Phase i1's trace in a process of its own: ``trace_step`` of g2's cell
    on a one-rank fake world, its record written to ``out/i1.json``."""
    init_group("fake", 0, 1, store=fake_store())
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device_type=device)
        t = time.perf_counter()
        rec = trace_step(configs.get(TRAIN_ARCH), ShapeCell("g2", G2_S, G2_B, "train"), mesh,
                         device)
        rec["wall_s"] = time.perf_counter() - t
    finally:
        dist.destroy_process_group()
    (Path(out) / "i1.json").write_text(json.dumps(rec, default=float))


def start_i1(out: str) -> Trace:
    """``i1_trace`` in a process of its own, fake CUDA tensors (the one trace
    that holds a CUDA context), its output in ``out/i1.log``."""
    return Trace("i1", [sys.executable, "-c",
                        "import sys, chip_smoke; chip_smoke.i1_trace(sys.argv[1])", out],
                 Path(out) / "i1.log", TRACE_COST_S["i1"])


def phase_i_traces(out: str) -> list[Trace]:
    """Phase i's traces, their output in ``out``: i1's, i3's, i4's, i5's,
    i6's, i7's, i8's and i9's."""
    traces = [start_i1(out), start_dryrun(out, I3_CELL, key="i3")]
    traces += [start_dryrun(out, cell, layers, key=cell) for cell, layers in I4_CELLS]
    return traces + start_i5(out) + start_i6(out) + start_i7(out) + start_i8(out) + \
        start_i9(out) + start_i10(out)


def start_analysis(out: str) -> TraceQueue:
    """Phase i's traces, queued at the check's start."""
    return TraceQueue(phase_i_traces(out))


def analysis_one_rank(device, g2: dict, e2: dict, card: str, proc: Trace,
                      out: str) -> tuple[dict, list]:
    """Phase i1 from its trace's record (``start_i1``), and i2 on a one-rank
    fake world."""
    train_cfg, lm_cfg = configs.get(TRAIN_ARCH), configs.get(LM_ARCH)
    g2_cell = ShapeCell("g2", G2_S, G2_B, "train")
    try:
        proc.wait(timeout=I3_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    check(proc.returncode == 0, f"i1: the trace exited with {proc.returncode}: "
          f"{(Path(out) / 'i1.log').read_text()[-4000:]}")
    rec = json.loads((Path(out) / "i1.json").read_text())
    wall = rec["wall_s"]
    init_group("fake", 0, 1, store=fake_store())
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device_type=device)
        mem = rec["memory_analysis"]
        predicted = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
        measured = g2["max_memory_allocated"]
        flops = rec["cost_analysis"]["flops"]
        hand = traced_train_flops(train_cfg, G2_B, G2_S)
        i1 = dict(cell=[G2_B, G2_S], predicted_bytes=predicted, measured_bytes=measured,
                  rel_err=predicted / measured - 1, flops=flops, traced_hand_flops=hand,
                  g2_flops=g2["fwd_bwd_flops"], flops_over_g2_hand=flops / g2["fwd_bwd_flops"],
                  trace_s=rec["lower_s"], wall_s=wall, record=rec)
        log(f"phase i1: dry-run of g2's cell: argument {mem['argument_size_in_bytes']} + temp "
            f"{mem['temp_size_in_bytes']} = {predicted} bytes predicted against "
            f"g2's max_memory_allocated {measured} ({i1['rel_err']:+.4f}); product FLOPs "
            f"{flops:.6e}, the hand count of the traced products {hand:.6e}, "
            f"{i1['flops_over_g2_hand']:.4f} x g2's hand count {i1['g2_flops']:.6e}; trace "
            f"{rec['lower_s']} s ({wall:.1f} s in all); card {card}")
        check(abs(i1["rel_err"]) <= I1_MEMORY_RTOL,
              f"i1 predicted {predicted} bytes, g2 measured {measured}")
        check(flops == hand, f"i1 traced {flops} product FLOPs, the hand count is {hand}")
        lo, hi = I1_FLOPS_OVER_HAND
        check(lo <= i1["flops_over_g2_hand"] <= hi,
              f"i1 traced {i1['flops_over_g2_hand']:.4f} x g2's hand count, outside [{lo}, {hi}]")
        cells = [("g2 train", train_cfg, g2_cell, g2["step_ms"], g2["step_bound_ms"]),
                 ("e2 prefill", lm_cfg, ShapeCell("e2_prefill", E2_PROMPTS[0], E2_BATCH,
                                                  "prefill"),
                  e2["prefill_ms"], e2["prefill_bound_ms"]),
                 ("e2 decode", lm_cfg, ShapeCell("e2_decode", I2_DECODE_CACHE, E2_BATCH,
                                                 "decode"),
                  e2["decode_ms_per_token"], e2["decode_bound_ms"])]
        i2 = []
        for name, cfg, cell, ms, hand_ms in cells:
            t = time.perf_counter()
            roof = analyze_cell(cfg, cell, mesh, device=device)
            row = dict(cell=name, terms=roof["terms"], dominant=roof["dominant"],
                       step_time_lower_bound_s=roof["step_time_lower_bound_s"],
                       roofline_fraction=roof["roofline_fraction"],
                       model_flops=roof["model_flops"], measured_ms=ms, hand_bound_ms=hand_ms,
                       components={k: {f: c[f] for f in ("flops", "bytes", "trips")}
                                   for k, c in roof["components"].items()},
                       analyze_s=time.perf_counter() - t)
            check(row["step_time_lower_bound_s"] > 0, f"i2 {name}: no bound")
            i2.append(row)
            log(f"phase i2: {name}: terms {roof['terms']} ({roof['dominant']}), lower bound "
                f"{roof['step_time_lower_bound_s'] * 1e3:.3f} ms, roofline_fraction "
                f"{roof['roofline_fraction']:.4f}; measured {ms:.3f} ms, hand bound "
                f"{hand_ms:.3f} ms; {row['analyze_s']:.1f} s; HW {HW}")
    finally:
        dist.destroy_process_group()
    return i1, i2


def bound(nbytes: int, n_ops: int, dtype=torch.float32) -> tuple[float, str]:
    """The least time the card could take (ms) for operations on ``dtype``
    outside the tensor cores, and what bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_ms(fn, kernel: str, reps: int = 20, attempts: int = 3) -> float:
    """The mean device time (ms) of the CUDA kernels whose name holds
    ``kernel`` in ``reps`` calls of ``fn``, from ``torch.profiler``.  The
    profiler's kernel records can come back incomplete (13 of 20 once on
    the H100): such a reading is taken again, up to ``attempts`` times, and
    never averaged over fewer launches than were made."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.name]
        if len(us) >= reps:
            return sum(us) / reps / 1e3
        log(f"device_ms: the profiler returned {len(us)} {kernel} kernels of {reps} calls "
            f"(attempt {attempt + 1} of {attempts})")
    check(False, f"the profiler saw {len(us)} {kernel} kernels in {reps} calls, {attempts} times")


def timed(kernel, plain, reps: int, plain_reps: int | None = None) -> dict:
    """Kernel and plain version timed in turns (plain, kernel, kernel, plain)."""
    pr = reps if plain_reps is None else plain_reps
    p1, k1, k2, p2 = (cuda_ms(f, n) for f, n in
                      ((plain, pr), (kernel, reps), (kernel, reps), (plain, pr)))
    return {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2}


def seg_levels(g, device) -> list:
    """The fused level's path shapes on the n = 16384 graph: the widest level of
    each segment-layout run with 1 plane, then the first run's with 8."""
    runs = plancache.device_state(g, device)[0]
    levels = [max(r.levels, key=lambda lv: lv.e_real) for r in runs if r.layout == "seg"]
    return [(1, lv) for lv in levels] + [(8, levels[0])]


def seg_args(inputs, B: int, lv):
    """A finished carry and the level's arguments with B planes.  The level
    writes only its own tasks' rows from parent rows it does not write, so
    calls on the finished carry repeat the same work and write the same
    values."""
    carry = tuple(c[None].expand(B, *c.shape).contiguous() for c in ct.csr_sweep(inputs))
    comp, L, bw = (t[None].expand(B, *t.shape).contiguous()
                   for t in (inputs[1], inputs[3], inputs[4]))
    return carry, (comp, L, bw, lv.tasks, lv.edge_src, lv.edge_data, lv.edge_seg,
                   lv.e_real, lv.width)


def seg_level_rows(g, inputs, device) -> list:
    """The fused level at its path shapes (``seg_levels``) beside its plain
    version, its bound, its issue floor and its launch shape."""
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    loop = sass_loop("edge_relax", "seg_level_kernelILi64E")
    out = []
    for B, lv in seg_levels(g, device):
        carry, args = seg_args(inputs, B, lv)
        e, w, P = lv.e_real, lv.tasks.shape[0], carry[0].shape[-1]
        # the parent rows read and the carry rows read and written, the level's
        # edge and task tables, the machine; the real edges' candidates
        nbytes = 4 * B * (e * P + w * P + 3 * w * P + P + P * P) + 20 * e + 8 * w
        t_min, by = bound(nbytes, OPS_PER_CANDIDATE * B * e * P * P)
        out.append(issue_floor(INSTR_PER_SEG_CANDIDATE * B * e * P * P, dict(
            shape=[B, e, P], edge_cap=lv.edge_src.shape[0], tasks=w, sass_loop=loop,
            launch=seg_level_grid(B, e, P, n_sm)._asdict(), bound_ms=t_min, bound_by=by,
            device_ms=device_ms(lambda: ops.seg_level(carry, *args), "seg_level_kernel"),
            **timed(lambda: ops.seg_level(carry, *args),
                    lambda: seg_level_plain(carry, *args), 100))))
    return out


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def sass_loop(source: str, kernel: str) -> dict:
    """The loop of ``kernel`` (a fragment of its mangled name) in the SASS of
    ``csrc/<source>.cu``'s library (``cuobjdump -sass``) whose body holds the
    most FMULs for its length: the relaxation's class loop, where each
    Markstein divide has one FMUL, so one FMUL is one candidate.  Returns
    the loop's instructions (loop control included), its FMULs and their
    ratio, the instructions a candidate really costs."""
    sass = subprocess.run([str(Path(ops._nvcc()).parent / "cuobjdump"), "-sass",
                           str(ops._lib_path(source))],
                          capture_output=True, text=True, check=True).stdout
    funcs, name, labels, pending = {}, None, {}, []
    for line in sass.splitlines():
        if m := re.match(r"\s*Function : (\S+)", line):
            name = m.group(1)
            funcs[name], labels[name] = [], {}
        elif name and (m := re.match(r"\s*(\.L_x_\d+):", line)):
            pending.append(m.group(1))           # the next instruction's address
        elif name and (m := re.match(r"\s*/\*([0-9a-f]+)\*/\s+([^;]*);", line)):
            addr = int(m.group(1), 16)
            labels[name].update((lab, addr) for lab in pending)
            pending.clear()
            funcs[name].append((addr, m.group(2).split()))
    (name, ins), = [(n, v) for n, v in funcs.items() if kernel in n]

    def opcode(words):
        return next(w for w in words if not w.startswith("@")).split(".")[0]

    best = None
    for end, words in ins:
        if opcode(words) != "BRA":
            continue
        target = words[-1].strip("`()")
        start = labels[name].get(target, int(target, 16) if target.startswith("0x") else None)
        if start is None or start > end:
            continue
        body = [opcode(w) for a, w in ins if start <= a <= end]
        fmul = body.count("FMUL")
        if fmul >= 16 and (best is None or fmul / len(body) > best["candidates"] / best["instructions"]):
            best = dict(function=name, instructions=len(body), candidates=fmul)
    check(best is not None, f"no relaxation loop found in the SASS of {kernel}")
    best["per_candidate"] = best["instructions"] / best["candidates"]
    return best


def issue_floor(n_instr: float, row: dict) -> dict:
    """The least time (ms) to issue ``n_instr`` lane-instructions on every SM
    at the largest SM clock, and the SM clock read just after the row was
    timed."""
    f_max = float(smi("clocks.max.sm").split()[0]) * 1e6
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    return dict(issue_floor_ms=n_instr / (n_sm * LANES_PER_SM * f_max) * 1e3,
                sm_clock_mhz_after=smi("clocks.sm"), sm_clock_max_mhz=smi("clocks.max.sm"),
                **row)


def kernel_report(by_path, errs, per_sweep, tables, g, inputs, device, usage) -> list:
    """Phase 7: each kernel at its path's shapes beside its plain version and
    its bound; the first shape is the one the path runs most.  ``by_path``
    holds each path's launch counts, read around that path alone; ``usage``
    each source's ``ptxas -v`` figures."""

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    loop = sass_loop("edge_relax", "edge_relax_kernelILi64E")
    edge_rows = []
    for E, P, B in EDGE_TIMED:
        pv, pdata, L, bw = edge_inputs((E, P), 7, device, None if B == 1 else B)
        lead = (lambda t: t[None]) if B == 1 else (lambda t: t)
        # pv, pdata, L, bw read once, minl and argl written once
        t_min, by = bound(4 * (3 * B * E * P + E + B * P + B * P * P),
                          OPS_PER_CANDIDATE * B * E * P * P)
        edge_rows.append(issue_floor(loop["per_candidate"] * B * E * P * P, dict(
            shape=[E, P] if B == 1 else [B, E, P], bound_ms=t_min, bound_by=by, sass_loop=loop,
            launch=edge_relax_grid(B, E, P, n_sm)._asdict(), device_ms=device_ms(
                lambda: ops.edge_relax(pv, pdata, L, bw), "edge_relax_kernel"), **timed(
                lambda: ops.edge_relax(pv, pdata, L, bw),
                lambda: edge_relax_plain(lead(pv), pdata, lead(L), lead(bw)), 100))))
    cell_rows = []
    for W, D, P in CELL_PATH_SHAPES:
        n_valid = 3999 if (W, D, P) == (1, 4096, 64) else None
        pv, pdata, validp, L, bw = cell_inputs((W, D, P), 8, device, n_valid)
        valid = int(validp.sum().item())       # the work depends on the mask
        t_min, by = bound(4 * (W * D * P + 2 * W * D + P + P * P + 3 * W * P),
                          OPS_PER_CANDIDATE * valid * P * P)
        cell_rows.append(dict(shape=[W, D, P], valid_parents=valid, bound_ms=t_min,
                              bound_by=by, device_ms=device_ms(
            lambda: ops.ceft_relax(pv, pdata, validp, L, bw), "ceft_relax_kernel"), **timed(
            lambda: ops.ceft_relax(pv, pdata, validp, L, bw),
            lambda: ceft_relax_plain(pv[None], pdata, validp, L[None], bw[None]), 10)))
    bf16_rows = []
    for W, D, P in CELL_PATH_SHAPES:
        n_valid = 3999 if (W, D, P) == (1, 4096, 64) else None
        pv, pdata, validp, L, bw = (t.to(torch.bfloat16) for t in
                                    cell_inputs((W, D, P), 8, device, n_valid))
        valid = int(validp.float().sum().item())
        # bf16 inputs and maxk, int32 argk and argl
        t_min, by = bound(2 * (W * D * P + 2 * W * D + P + P * P + W * P) + 8 * W * P,
                          OPS_PER_CANDIDATE * valid * P * P, torch.bfloat16)
        bf16_rows.append(dict(shape=[W, D, P], dtype="bfloat16", valid_parents=valid,
                              bound_ms=t_min, bound_by=by, device_ms=device_ms(
            lambda: ops.ceft_relax(pv, pdata, validp, L, bw), "ceft_relax_kernel"), **timed(
            lambda: ops.ceft_relax(pv, pdata, validp, L, bw),
            lambda: ceft_relax_plain(pv[None], pdata, validp, L[None], bw[None]), 10)))
    super_rows = []
    for pv, pdata, L, bw in tables:            # the n = 16384 graph's own runs
        R, E, P = pv.shape
        t_min, by = bound(4 * (3 * R * E * P + R * E + P + P * P),
                          OPS_PER_CANDIDATE * R * E * P * P)
        super_rows.append(issue_floor(INSTR_PER_CANDIDATE * R * E * P * P, dict(
            shape=[R, E, P], bound_ms=t_min, bound_by=by, device_ms=device_ms(
                lambda: ops.edge_relax_superstep(pv, pdata, L, bw), "edge_relax_superstep"),
            **timed(
                lambda: ops.edge_relax_superstep(pv, pdata, L, bw),
                lambda: edge_relax_superstep_plain(pv, pdata, L, bw), 20, 3))))
    minplus_rows = []
    for dtype in MINPLUS_DTYPES:
        a, b = minplus_inputs(MINPLUS_PATH_SHAPE, dtype, device, 600)
        M, K, N = MINPLUS_PATH_SHAPE
        t_min, by = bound(a.element_size() * (M * K + K * N + M * N), 2 * M * K * N, dtype)
        minplus_rows.append(issue_floor(INSTR_PER_MINPLUS_TRIPLE[dtype] * M * K * N, dict(
            shape=[M, K, N], dtype=str(dtype).replace("torch.", ""), bound_ms=t_min,
            bound_by=by, device_ms=device_ms(lambda: ops.minplus(a, b), "minplus_kernel", 5),
            **timed(lambda: ops.minplus(a, b), lambda: minplus_plain(a, b),
                                 10, 2))))
    rows = []
    for name, source, replaces, by_shape in (
            ("seg_level", "edge_relax", "src/repro/kernels/ceft_relax.py:67 "
             "(_edge_relax_kernel) with the segment max and carry scatter of "
             "src/repro/core/ceft_jax.py:227 (_superstep_impl)",
             seg_level_rows(g, inputs, device)),
            ("edge_relax", "edge_relax", "src/repro/kernels/ceft_relax.py:67 "
             "(_edge_relax_kernel)", edge_rows),
            ("ceft_relax", "ceft_relax", "src/repro/kernels/ceft_relax.py:30 (_relax_kernel)",
             cell_rows),
            ("ceft_relax_bf16", "ceft_relax",
             "src/repro/kernels/ceft_relax.py:30 (_relax_kernel), bf16", bf16_rows),
            ("edge_relax_superstep", "edge_relax_superstep",
             "src/repro/kernels/ceft_relax.py:85 (_edge_relax_superstep_kernel)", super_rows),
            ("minplus", "minplus", "src/repro/kernels/minplus.py:22 (_minplus_kernel)",
             minplus_rows)):
        paths = {path: counts[name] for path, counts in by_path.items() if counts[name]}
        rows.append(dict(
            name=name, route="cuda", source=f"src/repro_torch/csrc/{source}.cu",
            replaces=replaces, launches=sum(paths.values()), launches_by_path=paths,
            max_abs_err=errs[name], launches_per_rgg16384_sweep=per_sweep[name],
            library_ms=None, ptxas=usage[source],
            **{k: by_shape[0][k] for k in ("shape", "ms", "device_ms", "plain_ms", "bound_ms",
                                           "bound_by")},
            by_shape=by_shape))
    return rows


def other_tree_ops(src: Path):
    """The ``repro_torch.kernels.ops`` module of the tree under ``src``, loaded
    under a package name of its own (the kernel modules import one another
    relatively), so that it builds and loads that tree's kernel sources."""
    pkg = src / "repro_torch" / "kernels"
    spec = importlib.util.spec_from_file_location(
        "other_tree_kernels", pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod.ops


def sweep_busy_ms(fn, reps: int = 5) -> tuple[float, float]:
    """One sweep's device busy time (ms: every CUDA kernel it runs, from
    ``torch.profiler`` over ``reps`` sweeps) and its median host wall time
    (ms, unprofiled)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    return us / reps / 1e3, sorted(walls)[reps // 2] * 1e3


def turns(other_src: str) -> int:
    """``--turns OTHER_SRC``: kernels of the tree under ``OTHER_SRC`` (a ``src``
    directory holding ``repro_torch``, for example an unpacked ``git
    archive`` of an earlier commit) and of this one, timed in turns (other,
    this, this, other) on the same inputs on one card: the superstep on the
    n = 16384 graph's run tables and ``minplus`` at 4096^3 (float32 and
    bf16), kernel ms by CUDA events; ``edge_relax`` at ``EDGE_TIMED`` with
    this tree's launch shape, and ``seg_level`` at its path shapes
    (``seg_levels``), device ms by ``torch.profiler``; and the steady
    n = 16384 sweep at B = 1 and B = 8 with each tree's kernels, its device
    busy ms and host wall ms.  Both trees must give the same outputs and
    carries (inputs without NaN).  Prints one JSON line of times, then the
    card's name and power limit."""
    device = "cuda"
    other = other_tree_ops(Path(other_src).resolve())
    other.build_all()
    ops.build_all()
    wl = rgg("high", 16384, 64, np.random.default_rng(5), o=4, alpha=0.75, beta=50)
    g, comp, m = wl.graph, wl.comp, wl.machine
    inputs = ct.csr_device_inputs(g, comp, m, device=device)
    cases = [("edge_relax_superstep", list(t[0].shape), t, other.edge_relax_superstep,
              ops.edge_relax_superstep, 50)
             for t in run_tables(device, g, inputs, ct.csr_sweep(inputs)[0])]
    cases += [("minplus", list(MINPLUS_PATH_SHAPE),
               minplus_inputs(MINPLUS_PATH_SHAPE, dtype, device, 600), other.minplus,
               ops.minplus, 10) for dtype in MINPLUS_DTYPES]
    rows = []
    for name, shape, args, theirs, ours, reps in cases:
        outs = [f(*args) for f in (theirs, ours)]
        for a, b in zip(*(o if isinstance(o, tuple) else (o,) for o in outs)):
            check(torch.equal(a, b), f"{name} at {shape}: the trees differ")
        del outs
        o1, n1, n2, o2 = (cuda_ms(lambda: f(*args), reps) for f in (theirs, ours, ours, theirs))
        rows.append(dict(name=name, shape=shape, dtype=str(args[0].dtype).replace("torch.", ""),
                         other_ms=[o1, o2], this_ms=[n1, n2],
                         sm_clock_mhz_after=smi("clocks.sm")))
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for E, P, B in EDGE_TIMED:
        args = edge_inputs((E, P), 7, device, None if B == 1 else B)
        outs = [f(*args) for f in (other.edge_relax, ops.edge_relax)]
        check(all(torch.equal(a, b) for a, b in zip(*outs)),
              f"edge_relax at {(B, E, P)}: the trees differ")
        del outs
        o1, n1, n2, o2 = (device_ms(lambda: f(*args), "edge_relax_kernel", 50)
                          for f in (other.edge_relax, ops.edge_relax, ops.edge_relax,
                                    other.edge_relax))
        rows.append(dict(name="edge_relax", shape=[B, E, P], dtype="float32",
                         timer="torch.profiler device ms",
                         launch=edge_relax_grid(B, E, P, n_sm)._asdict(),
                         other_ms=[o1, o2], this_ms=[n1, n2],
                         sm_clock_mhz_after=smi("clocks.sm")))
    for B, lv in seg_levels(g, device):
        carry, args = seg_args(inputs, B, lv)
        mine = tuple(c.clone() for c in carry)
        other.seg_level(carry, *args)
        ops.seg_level(mine, *args)
        check(all(torch.equal(a, b) for a, b in zip(carry, mine)),
              f"seg_level at {(B, lv.e_real)}: the trees' carries differ")
        o1, n1, n2, o2 = (device_ms(lambda: f(carry, *args), "seg_level_kernel", 50)
                          for f in (other.seg_level, ops.seg_level, ops.seg_level,
                                    other.seg_level))
        rows.append(dict(name="seg_level", shape=[B, lv.e_real, carry[0].shape[-1]],
                         dtype="float32", timer="torch.profiler device ms",
                         launch=seg_level_grid(B, lv.e_real, carry[0].shape[-1], n_sm)._asdict(),
                         other_ms=[o1, o2], this_ms=[n1, n2],
                         sm_clock_mhz_after=smi("clocks.sm")))
    rng = np.random.default_rng(11)
    comps = comp[None] * rng.uniform(1.0, 2.0, (8, 1, m.P))
    binputs = ct.csr_batch_device_inputs(g, comps, np.repeat(m.L[None], 8, 0),
                                         np.repeat(m.bw[None], 8, 0), device=device)
    for B, sweep in ((1, lambda: ct.csr_sweep(inputs)), (8, lambda: ct.csr_batch_sweep(binputs))):
        def with_ops(mod):
            def run():
                ct.ops = mod     # the sweep's kernel calls go through this module
                try:
                    return sweep()
                finally:
                    ct.ops = ops
            return run
        theirs, ours = with_ops(other), with_ops(ops)
        check(all(torch.equal(a, b) for a, b in zip(theirs(), ours())),
              f"the B = {B} sweep: the trees' carries differ")
        (ob1, ow1), (nb1, nw1), (nb2, nw2), (ob2, ow2) = (
            sweep_busy_ms(f) for f in (theirs, ours, ours, theirs))
        rows.append(dict(name="steady_sweep_rgg16384", shape=[B, g.n, m.P],
                         other_busy_ms=[ob1, ob2], this_busy_ms=[nb1, nb2],
                         other_wall_ms=[ow1, ow2], this_wall_ms=[nw1, nw2],
                         sm_clock_mhz_after=smi("clocks.sm")))
    print(json.dumps({"turns": rows, "other": other_src,
                      "sm_clock_max_mhz": smi("clocks.max.sm")}), flush=True)
    print(smi("name,power.limit"), flush=True)
    return 0


def spanned(phase: str, fn, *args):
    """``fn(*args)``, its (start, end) kept in ``SPANS`` under ``phase``."""
    t = time.perf_counter() - _T0
    out = fn(*args)
    SPANS[phase] = (t, time.perf_counter() - _T0)
    return out


def counted(fn, *args):
    """Run one path with every launch count set to 0 just before it; returns
    its result and the counts read just after it (its span in ``SPANS``
    under its phase's label, ``PHASE_OF``)."""
    ops.reset_launches()
    out = spanned(PHASE_OF[fn.__name__], fn, *args)
    return out, dict(ops.LAUNCHES)


def chain_line(t_start: float, traces: TraceQueue) -> dict:
    """Where the check's time went: each phase's own seconds (``SPANS``),
    the end of the serial chain on the card (phases 1 to h) and of the trace
    chain (phase i's traces, started with the check), the host's cores, and
    the margin to the check's 1200 s limit."""
    total = time.perf_counter() - t_start
    tr = traces.summary()
    out = dict(own_s={k: round(b - a, 1) for k, (a, b) in SPANS.items()},
               serial_end_s=round(SPANS["h"][1], 1), trace_end_s=tr["ended_s"] and
               round(tr["ended_s"], 1), traces=tr["n"], trace_slots=tr["slots"],
               traces_started_s=round(tr["started_s"], 1), cpu_count=os.cpu_count(),
               whole_s=round(total, 1), margin_s=round(CHECK_LIMIT_S - total, 1),
               trace_s=tr["seconds"])
    log(f"chains: each phase's own seconds {out['own_s']}; the serial chain (phases 1-h) ends "
        f"at {out['serial_end_s']} s, the trace chain ({out['traces']} traces from "
        f"{out['traces_started_s']} s, at most {out['trace_slots']} at once) at "
        f"{out['trace_end_s']} s; os.cpu_count() {out['cpu_count']}; whole check "
        f"{out['whole_s']} s, {out['margin_s']} s inside {CHECK_LIMIT_S} s; each trace's "
        f"seconds {out['trace_s']}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check needs one NVIDIA GPU",
              file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--turns"] and len(sys.argv) == 3:
        return turns(sys.argv[2])
    if len(sys.argv) > 1:
        print(__doc__, file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    i_dir = tempfile.mkdtemp()
    traces = start_analysis(i_dir)
    try:
        return check_all(t_start, traces, i_dir)
    finally:
        traces.stop()
        for proc in CHILDREN:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for proc in (p for ctx in RANKS for p in ctx.processes):
            if proc.is_alive():
                proc.kill()
                proc.join()
        shutil.rmtree(i_dir, ignore_errors=True)


def check_all(t_start: float, traces: TraceQueue, i_dir: str) -> int:
    """Every phase in turn on the card (the serial chain), phase i's traces
    running beside it from the start (``traces``, their output in
    ``i_dir``); then the chain line and the report."""
    device = "cuda"
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    t = time.perf_counter()
    spanned("1", ops.build_all)
    log(f"phase 1: kernels built and loaded in {time.perf_counter() - t:.3f} s")
    usage = ops.resource_usage()
    for source, entries in usage.items():
        for u in entries:
            log(f"phase 1: ptxas {source}.cu {u['function']}: {u.get('registers')} registers, "
                f"{u.get('smem')} bytes static smem, {u.get('stack')} bytes stack, "
                f"{u.get('spill_stores')} / {u.get('spill_loads')} bytes spill stores / loads")
    errs = spanned("2", compare_kernels, device)
    by_path = {}
    bf16_calls, by_path["ceft_relax_bf16"] = counted(relax_bf16_path, device)
    errs["ceft_relax_bf16"] = check_relax_bf16(bf16_calls)
    del bf16_calls
    check(by_path["ceft_relax_bf16"]["ceft_relax_bf16"] > 0
          and by_path["ceft_relax_bf16"]["ceft_relax"] == 0,
          f"the bf16 path launched {by_path['ceft_relax_bf16']}")

    def planning_path():
        g, comp, m, inputs, realize = plan_large(device)
        batched(device, g, comp, m)
        layouts(device)
        straggler(device)
        return g, inputs, realize

    (g, inputs, realize), by_path["planning"] = counted(planning_path)
    log(f"planning path launches: {by_path['planning']}")
    check(by_path["planning"]["seg_level"] > 0 and by_path["planning"]["ceft_relax"] > 0,
          f"a kernel of the planning path never launched: {by_path['planning']}")

    ceft_pad = ct.csr_sweep(inputs)[0]
    (tables, outs, per_level), by_path["run_tables"] = counted(superstep_path, device, g,
                                                               inputs, ceft_pad)
    errs["edge_relax_superstep"], edge_err = check_superstep(device, tables, outs, per_level)
    errs["edge_relax"] = max(errs["edge_relax"], edge_err)
    del outs, per_level
    calls, by_path["minplus"] = counted(minplus_path, device)
    errs["minplus"] = check_minplus(calls)
    del calls
    check(by_path["run_tables"]["edge_relax_superstep"] > 0
          and by_path["run_tables"]["edge_relax"] > 0 and by_path["minplus"]["minplus"] > 0,
          f"a standalone kernel never launched: {by_path['run_tables']} {by_path['minplus']}")
    _, by_path["router"] = counted(router_path, device)
    chaos = start_chaos()
    lm, by_path["lm_serving"] = counted(lm_path, device)
    _, by_path["lm_ssm"] = counted(ssm_path, device)
    train, by_path["training"] = counted(training_path, device)
    replan_dense = sum(n for layout, n in train["g2"]["replan"]["layouts"] if layout == "dense")
    check(by_path["training"]["ceft_relax"] >= replan_dense,
          f"the training path launched ceft_relax {by_path['training']['ceft_relax']} times, "
          f"less than one re-plan's {replan_dense} dense levels")
    log(f"training path launches: {by_path['training']} (a re-plan of the g2 layer DAG "
        f"sweeps {replan_dense} dense levels)")
    train["realize"] = finish_realize(realize)
    _, by_path["chaos"] = finish_chaos(chaos)
    print(json.dumps({"training": train}), flush=True)
    group = start_group(device)
    examples, by_path["examples"] = counted(examples_path, device)
    check(by_path["examples"]["ceft_relax"] > 0,
          f"the examples launched no ceft_relax: {by_path['examples']}")
    log(f"examples path launches: {by_path['examples']} (ceft_relax: x2's and x4's "
        f"straggler re-plans)")
    print(json.dumps({"examples": examples}, default=float), flush=True)
    distributed, by_path["distributed"] = counted(distributed_path, device, train["g2"], group)
    check(by_path["distributed"]["ceft_relax"] > 0,
          f"the distributed path launched no ceft_relax: {by_path['distributed']}")
    log(f"distributed path launches: {by_path['distributed']} (ceft_relax "
        f"{by_path['distributed']['ceft_relax']}: h4's straggler re-plans)")
    print(json.dumps({"distributed": distributed}), flush=True)
    analysis, by_path["analysis"] = counted(analysis_phase, device, train["g2"], lm["e2"],
                                            traces.traces, i_dir, traces.t0)
    print(json.dumps({"analysis": analysis}, default=float), flush=True)
    log(f"launches by path: {by_path}")

    ops.reset_launches()
    ct.csr_sweep(inputs)
    per_sweep = dict(ops.LAUNCHES)
    runs = plancache.device_state(g, device)[0]
    n_seg = sum(len(r.levels) for r in runs if r.layout == "seg")
    n_dense = sum(len(r.levels) for r in runs if r.layout == "dense")
    check(per_sweep["seg_level"] == n_seg and per_sweep["ceft_relax"] == n_dense
          and per_sweep["edge_relax"] == 0,
          f"a sweep of {n_seg} segment-layout and {n_dense} dense levels launched {per_sweep}")
    log(f"launches per full n=16384 sweep: {per_sweep} ({n_seg} segment-layout levels, "
        f"one seg_level launch each; {n_dense} dense levels)")
    rows = spanned("report", kernel_report, by_path, errs, per_sweep, tables, g, inputs, device,
                   usage)
    print(json.dumps({"chains": chain_line(t_start, traces)}), flush=True)
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")

    card = smi("name,power.limit")
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
