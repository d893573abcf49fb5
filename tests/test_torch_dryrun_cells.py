"""The dry-run (``repro_torch.launch.dryrun``) of the cells that
``chip_smoke.py`` phase i11 traces at their published widths, here at smoke
size on 8 fake ranks, against the reference's XLA counts of the same smoke
cells (``repro.launch.dryrun`` under ``REPRO_DRYRUN_DEVICES=8``) and against
the hand counts:

* llama3 smoke and glm4 smoke (one kv head on the smoke mesh's 2, as
  glm4-9b's 2 on the production mesh's 16) in ``train_4k``, ``prefill_32k``
  and ``decode_32k`` on (data 4, model 2), and granite smoke's ``train_4k``
  on the two-pod (pod 2, data 2, model 2) mesh, the gradients summed over
  ``pod`` too: product FLOPs equal to ``hand_train_flops`` /
  ``hand_prefill_flops`` / ``hand_decode_flops`` with the ranks each axis
  splits over (``_smoke_plan``), collective bytes a device at most the
  reference's, and a train step's arguments (parameters, bf16 AdamW moments
  for llama3, count, tokens and labels) the reference's bytes exactly;
* the premise of phase i11's cut cells: a train record is linear in the
  depth, so llama3 smoke's record at its 3 layers equals, to the byte, the
  projection ``X(2) + (X(2) - X(1))`` from its records at 1 and 2 layers;
* an SSM prefill under ``serve`` (mamba2 smoke on (data 4, model 2), the
  cache's rows split over ``data`` beyond the stream's): its temp grows a
  layer by no more than twice the cache it returns a layer, since each
  layer's cache shard owns its storage (a view of the whole state and conv
  history kept both alive to the prefill's end).
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from conftest import REPO  # noqa: E402
from test_torch_hybrid_vlm_parallel import _smoke_plan  # noqa: E402

CELLS = [(arch, cell, "single") for arch in ("llama3-405b", "glm4-9b")
         for cell in ("train_4k", "prefill_32k", "decode_32k")] + \
        [("granite-3-8b", "train_4k", "multi")]
DEPTHS = (1, 2, 3)          # llama3 smoke's train_4k, its 3 layers the last
GROWTH = ("mamba2-2.7b", "prefill_32k", "single", "serve")


def _spawn(body: str, env: dict | None = None) -> subprocess.Popen:
    full = dict(os.environ, PYTHONPATH=str(REPO / "src"), **(env or {}))
    return subprocess.Popen([sys.executable, "-c", textwrap.dedent(body)], env=full,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


@pytest.fixture(scope="module")
def recs(tmp_path_factory):
    """Both packages' records of ``CELLS`` on 8 fake ranks; the port's of
    llama3 smoke's train_4k at each of ``DEPTHS``; the port's of
    ``GROWTH`` at 1 and 2 layers.  The two packages trace side by side."""
    out = tmp_path_factory.mktemp("cells")
    ref = _spawn(f"""
        from pathlib import Path
        from repro.launch.dryrun import run_cell
        for arch, cell, mesh in {CELLS!r}:
            assert run_cell(arch, cell, mesh, True, Path({str(out / 'ref')!r}))
    """, env={"REPRO_DRYRUN_DEVICES": "8", "JAX_PLATFORMS": "cpu"})
    port = _spawn(f"""
        from pathlib import Path
        from repro_torch.launch.dryrun import run_cell
        out = Path({str(out)!r})
        for arch, cell, mesh in {CELLS!r}:
            assert run_cell(arch, cell, mesh, True, out / "port", device="cpu", devices=8)
        for n in {DEPTHS!r}:
            assert run_cell("llama3-405b", "train_4k", "single", True, out / f"L{{n}}",
                            device="cpu", devices=8, layers=n)
        arch, cell, mesh, profile = {GROWTH!r}
        for n in (1, 2):
            assert run_cell(arch, cell, mesh, True, out / f"G{{n}}", profile=profile,
                            device="cpu", devices=8, layers=n)
    """)
    for proc in (ref, port):
        text, _ = proc.communicate(timeout=400)
        assert proc.returncode == 0, text

    def load(where, arch, cell, mesh, tag=""):
        return json.loads((out / where / f"{arch}__{cell}__{mesh}{tag}.json").read_text())
    got = {case: (load("ref", *case), load("port", *case)) for case in CELLS}
    got["depths"] = {n: load(f"L{n}", "llama3-405b", "train_4k", "single") for n in DEPTHS}
    got["growth"] = {n: load(f"G{n}", *GROWTH[:3], f"__{GROWTH[3]}") for n in (1, 2)}
    return got


def _figures(rec) -> dict:
    mem = rec["memory_analysis"]
    return dict(total=mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
                + mem["output_size_in_bytes"], temp=mem["temp_size_in_bytes"],
                output=mem["output_size_in_bytes"],
                collective=rec["collectives"]["collective_bytes_per_device"],
                flops=rec["cost_analysis"]["flops"])


IDS = ["-".join(c) for c in CELLS]


@pytest.mark.parametrize("case", CELLS, ids=IDS)
def test_cell_flops_hand_count(recs, case):
    """The step's per-device product FLOPs equal the hand count with the
    ranks each logical axis splits over on its smoke mesh."""
    from repro_torch.models.tensor_parallel import (hand_decode_flops, hand_prefill_flops,
                                                    hand_train_flops)
    _, port = recs[case]
    assert port["ok"], port.get("error")
    plan = _smoke_plan(case[0], case[1], "baseline", case[2])
    c = plan["cell"]
    fn = dict(train=hand_train_flops, prefill=hand_prefill_flops, decode=hand_decode_flops)
    assert port["cost_analysis"]["flops"] == fn[c.kind](plan["cfg"], c.global_batch, c.seq_len,
                                                        plan["parts"])


@pytest.mark.parametrize("case", CELLS, ids=IDS)
def test_cell_collectives_within_reference(recs, case):
    """The step's collective bytes a device are at most the reference's XLA
    count of the same smoke cell."""
    ref, port = recs[case]
    got, want = (r["collectives"]["collective_bytes_per_device"] for r in (port, ref))
    print(case, got, want, got / want)
    assert 0 < got <= want


TRAIN = [c for c in CELLS if c[1] == "train_4k"]


@pytest.mark.parametrize("case", TRAIN, ids=["-".join(c) for c in TRAIN])
def test_train_arguments_equal_reference(recs, case):
    """A train step's arguments (parameters, AdamW moments in the config's
    dtype, count, tokens and labels on one device) are the reference's bytes
    exactly."""
    ref, port = recs[case]
    assert (port["memory_analysis"]["argument_size_in_bytes"]
            == ref["memory_analysis"]["argument_size_in_bytes"])


def test_train_record_is_its_depth_projection(recs):
    """llama3 smoke's train_4k at its 3 layers: argument + temp + output,
    temp, collective bytes and product FLOPs each equal the projection
    ``X(2) + (X(2) - X(1))`` from the records at 1 and 2 layers, to the
    byte, as phase i11 projects a cut cell to its published depth."""
    one, two, three = (_figures(recs["depths"][n]) for n in DEPTHS)
    assert recs["depths"][3]["n_layers"] == 3
    for key in ("total", "temp", "collective", "flops"):
        assert three[key] == two[key] + (two[key] - one[key]), key


def test_ssm_prefill_keeps_only_its_cache_shard(recs):
    """mamba2 smoke's prefill under ``serve``: the temp grows a layer by
    less than twice the cache the step returns a layer (20,228 bytes against
    4,576 in a parent tree's trace, 4,580 against 4,576 now)."""
    one, two = (_figures(recs["growth"][n]) for n in (1, 2))
    temp, cache = two["temp"] - one["temp"], two["output"] - one["output"]
    print(f"temp {temp} bytes a layer, the cache {cache}")
    assert 0 < cache and temp < 2 * cache
