"""Carrying state across from the reference package.

The planner's state is the task graph, the machine and the cost plane:
:func:`from_reference_arrays` turns the reference package's objects into this
package's, reading their fields by attribute as numpy arrays.  The models'
state is a parameter tree: :func:`params_from_reference` turns the
reference's (nested dicts of numpy arrays) into tensors, and
:func:`params_onto_mesh` lays them out on a mesh by ``Model.shardings``.  Both
packages then compute on the same inputs without this package importing the
reference.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.machine import Machine
from .core.taskgraph import TaskGraph
from .substrate import distribute

_GRAPH_FIELDS = ("cindptr", "cindices", "cdata", "pindptr", "pindices",
                 "pdata", "level")


def from_reference_arrays(graph=None, machine=None, comp=None):
    """(TaskGraph | None, Machine | None, comp ndarray | None) built from the
    reference package's ``TaskGraph`` (``n`` and the CSR / level arrays),
    ``Machine`` (``L``, ``bw``, ``counts``) and cost plane.  Arrays are
    copied with their dtypes; an argument left as None maps to None."""
    g = None
    if graph is not None:
        g = TaskGraph(int(graph.n), *(np.array(getattr(graph, f)) for f in _GRAPH_FIELDS))
    m = None
    if machine is not None:
        m = Machine(L=np.array(machine.L), bw=np.array(machine.bw),
                    counts=np.array(machine.counts))
    c = None if comp is None else np.array(comp)
    return g, m, c


def _tensor(a, device) -> torch.Tensor:
    a = np.array(a)                  # a writable copy, whatever the source
    if a.dtype.name == "bfloat16":   # ml_dtypes' bfloat16: carry the bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_reference(tree, device) -> dict:
    """A parameter (or cache) tree of this package from the reference's:
    nested dicts of arrays (``np.asarray`` of ``Model.init``'s leaves) to
    nested dicts of tensors on ``device``, with the same keys, shapes, dtypes
    and values."""
    if isinstance(tree, dict):
        return {k: params_from_reference(v, device) for k, v in tree.items()}
    return _tensor(tree, device)


def params_onto_mesh(tree, shardings) -> dict:
    """The reference's parameter (or cache) tree as ``DTensor``s laid out by
    ``shardings`` (``Model.shardings(mesh)`` or ``param_shardings``), a tree
    of the same keys: every rank holds the whole tree and keeps its shards."""
    if isinstance(tree, dict):
        return {k: params_onto_mesh(v, shardings[k]) for k, v in tree.items()}
    return distribute(_tensor(tree, "cpu"), shardings)
