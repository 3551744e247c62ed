"""Finds everything a cell needs by the names ``BENCHMARK.json`` gives.

Under the benchmark's folder: ``configs/<config>.json``, ``traffic/<traffic>.json``,
``checks/<cell>.json`` (the limits that decide ``correct``),
``metrics/<metric>.py`` (a module with ``read(run) -> float | None``) and
``entries/<entry>.py`` (the call a traffic file's ``entry`` names). A later
cell, mix or metric is a new file and a new entry in ``BENCHMARK.json``.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


class Spec:
    def __init__(self, bench: dict, root: Path = HERE) -> None:
        self.bench = bench
        self.root = Path(root)
        self._metrics: dict[str, object] = {}

    @classmethod
    def load(cls, path: Path = HERE.parent / "BENCHMARK.json") -> "Spec":
        with open(path) as f:
            return cls(json.load(f))

    def _json(self, folder: str, name: str) -> dict:
        with open(self.root / folder / f"{name}.json") as f:
            return json.load(f)

    def cell(self, name: str) -> dict:
        for cell in self.bench["workloads"]:
            if cell["name"] == name:
                return cell
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        return self._json("configs", name)

    def traffic(self, name: str) -> dict:
        return self._json("traffic", name)

    def checks(self, cell: str) -> dict:
        return self._json("checks", cell)

    def metrics(self, cell: str, trace: bool) -> list[dict]:
        """The cell's end-to-end metrics (``trace`` false) or per-layer ones."""
        group = self.bench["per_layer" if trace else "end_to_end"]
        return [m for m in group if cell in m.get("workloads", [cell])]

    def metric(self, name: str):
        if name not in self._metrics:
            path = self.root / "metrics" / f"{name}.py"
            spec = importlib.util.spec_from_file_location(f"speechbench_metric_{name}", path)
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            self._metrics[name] = module
        return self._metrics[name]

    @staticmethod
    def entry(name: str):
        return importlib.import_module(f"speechbench.entries.{name}")
