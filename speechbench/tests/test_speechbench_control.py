"""The control: the reference's fp8 copy (one precision below the
configuration's bf16), judged in the program's place at the same positions
of the same served windows, must come out not correct under the cell's
limit. On the CPU at test-tiny, and on the card at each cell's own load and
sizes over a short window (``python -m pytest -m cuda speechbench/tests``).
The benchmark's own runs never run it."""

from __future__ import annotations

import asyncio
import json

import pytest

from speechbench.run import run_cell
from speechbench.spec import HERE, Spec
from speechbench.tests.conftest import run_tiny

CELLS = [w["name"] for w in json.loads((HERE.parent / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("cell", ["tiny-open", "tiny-closed"])
def test_fp8_control_is_not_correct_at_test_tiny(tiny_spec, cell):
    out = run_tiny(tiny_spec, cell, control="fp8")
    assert out["failed"] == 0
    assert not out["correct"], out["checks"]
    assert out["checks"]["max_logit_gap"]["value"] > out["checks"]["max_logit_gap"]["limit"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_fp8_control_is_not_correct(cuda_device, cell):
    out = asyncio.run(run_cell(Spec.load(), cell, 2**31 + 101, 20.0, False, cuda_device, "fp8"))
    assert out["failed"] == 0
    assert not out["correct"], out["checks"]
