"""The collective inventory of a traced step: byte counts of every
collective, the counterpart of the reference's HLO text analysis
(``src/repro/launch/hlo_stats.py``).

The reference parses the optimized per-device HLO, because XLA's cost
analysis has no collective figures.  Here the step runs eagerly under
:class:`repro_torch.substrate.CostCounter`, which sees every ``c10d`` and
functional (``_c10d_functional``) collective it issues, those ``DTensor``
issues to redistribute included, and records one event per execution:
``(kind, dtype, numel)``, the kind named as in the HLO and the type and
elements of its result.

Byte convention (ring cost model), as in the reference: per-device link
bytes ~= result bytes x factor, factor 2 for all-reduce (reduce-scatter +
all-gather phases), 1 otherwise.  ``collective_bytes`` is the global figure
(x n_devices), matching the roofline term collective_bytes / (chips x
link_bw).

No trip-count weighting: the reference weights a ``while`` body's
collectives by its trip count, and an eager trace executes every iteration,
so its sum is already execution-weighted.  The reference's
``collective_bytes_flat`` (the structural sum, each loop body counted once)
has no counterpart: an eager trace has no program structure to sum over.
"""
from __future__ import annotations

from collections import Counter
from typing import Iterable

import torch

DTYPE_BYTES = {
    torch.bool: 1, torch.int8: 1, torch.uint8: 1, torch.int16: 2, torch.uint16: 2,
    torch.bfloat16: 2, torch.float16: 2, torch.int32: 4, torch.uint32: 4,
    torch.float32: 4, torch.int64: 8, torch.uint64: 8, torch.float64: 8,
    torch.complex64: 8, torch.float8_e4m3fn: 1, torch.float8_e5m2: 1,
}

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
_FACTOR = {"all-reduce": 2.0}


def collective_stats(events: Iterable[tuple[str, torch.dtype, int]], n_devices: int) -> dict:
    """Per-device and global collective bytes, the per-device bytes of each
    kind and the executions of each kind, from ``CostCounter.collectives``
    events."""
    by_kind: Counter = Counter()
    counts: Counter = Counter()
    for kind, dtype, numel in events:
        if kind not in COLLECTIVES:
            continue
        by_kind[kind] += numel * DTYPE_BYTES[dtype] * _FACTOR.get(kind, 1.0)
        counts[kind] += 1
    per_device = float(sum(by_kind.values()))
    return {
        "collective_bytes": per_device * n_devices,
        "collective_bytes_per_device": per_device,
        "collective_bytes_per_device_by_kind": dict(by_kind),
        "op_counts": dict(counts),
    }
