import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

try:
    from hypothesis import settings
except ModuleNotFoundError:  # property tests auto-skip via tests/_hyp.py
    settings = None

REPO = Path(__file__).resolve().parent.parent


def run_isolated_script(body: str, *, fake_devices: int | None = None,
                        env: dict | None = None, timeout: int = 500,
                        marker: str | None = None):
    """Run ``body`` in a fresh interpreter with ``src/`` on PYTHONPATH.

    The shared bootstrap for every test that needs its own process — e.g.
    because the fake host-device count must be set before jax initializes
    (``fake_devices`` prepends the XLA_FLAGS override; the calling test
    process keeps its single real CPU device), or because it exercises the
    engine pool's subprocess workers end-to-end.  Asserts exit code 0 (and
    that ``marker`` appeared on stdout, when given); returns the completed
    process for further assertions.
    """
    prelude = ""
    if fake_devices is not None:
        prelude = (
            "import os\n"
            "os.environ['XLA_FLAGS'] = "
            f"'--xla_force_host_platform_device_count={int(fake_devices)}'\n")
    full_env = dict(os.environ)
    pp = full_env.get("PYTHONPATH", "")
    full_env["PYTHONPATH"] = str(REPO / "src") + (os.pathsep + pp if pp else "")
    full_env.update(env or {})
    r = subprocess.run(
        [sys.executable, "-c", prelude + textwrap.dedent(body)],
        env=full_env, capture_output=True, text=True, timeout=timeout)
    assert r.returncode == 0, r.stdout + r.stderr
    if marker is not None:
        assert marker in r.stdout, r.stdout + r.stderr
    return r


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one")


if settings is not None:
    # keep hypothesis fast on the 1-core CI box
    settings.register_profile("ci", max_examples=25, deadline=None)
    settings.load_profile("ci")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def make_random_dag(n, p_edge, rng, data_range=(0.5, 5.0)):
    """Random DAG over topologically-ordered ids; every non-root vertex gets
    at least one parent so level-0 is the only source frontier."""
    from repro.core import from_edges

    edges = []
    for i in range(n):
        for j in range(i + 1, n):
            if rng.random() < p_edge:
                edges.append((i, j, float(rng.uniform(*data_range))))
    have_parent = {d for _, d, _ in edges}
    for j in range(1, n):
        if j not in have_parent:
            i = int(rng.integers(0, j))
            edges.append((i, j, float(rng.uniform(*data_range))))
    return from_edges(n, edges)
