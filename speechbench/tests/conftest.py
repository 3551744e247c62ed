"""Fixtures of the benchmark's own tests: a benchmark root with the test-tiny
configuration and tiny traffic (``tiny/``) beside the real metric readers,
driven on the CPU. Nothing here looks for a card at import time."""

from __future__ import annotations

import asyncio
import copy
import json
import shutil
from pathlib import Path

import pytest
import torch

from speechbench.run import run_cell
from speechbench.spec import HERE, Spec

TINY = Path(__file__).parent / "tiny"
SEED = 2**31 + 977


def tiny_bench() -> dict:
    """``BENCHMARK.json`` with its cells swapped for the tiny ones."""
    bench = copy.deepcopy(json.loads((HERE.parent / "BENCHMARK.json").read_text()))
    bench["workloads"] = [
        {"name": "tiny-open", "config": "test-tiny", "traffic": "tiny-open", "chips": 1,
         "why": "test-tiny, open loop"},
        {"name": "tiny-closed", "config": "test-tiny", "traffic": "tiny-closed", "chips": 1,
         "why": "test-tiny, closed loop"},
    ]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:  # every metric in both tiny cells, the generator's in the open one
            m["workloads"] = ["tiny-open"] if m["name"] == "gen.lag_p95_ms" else [
                "tiny-open", "tiny-closed"]
    return bench


@pytest.fixture
def tiny_root(tmp_path: Path) -> Path:
    root = tmp_path / "bench"
    shutil.copytree(HERE / "metrics", root / "metrics")
    for folder in ("configs", "traffic", "checks"):
        shutil.copytree(TINY / folder, root / folder)
    return root


@pytest.fixture
def tiny_spec(tiny_root: Path) -> Spec:
    return Spec(tiny_bench(), tiny_root)


@pytest.fixture(autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def run_tiny(spec: Spec, cell: str, seed: int = SEED, seconds: float = 1.5,
             trace: bool = False, control: str | None = None) -> dict:
    return asyncio.run(run_cell(spec, cell, seed, seconds, trace, device="cpu", control=control))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
