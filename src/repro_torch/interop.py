"""Carrying state across from the reference package.

The planner has no weights: its state is the task graph, the machine and the
cost plane.  :func:`from_reference_arrays` turns the reference package's
objects into this package's, reading their fields by attribute as numpy
arrays, so both packages can compute on the same inputs without this package
importing the reference.
"""
from __future__ import annotations

import numpy as np

from .core.machine import Machine
from .core.taskgraph import TaskGraph

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
