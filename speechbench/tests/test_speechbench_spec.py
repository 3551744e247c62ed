"""``BENCHMARK.json`` against the contract's shapes, discovery of every file
it names, and a later cell's traffic and metric taken as data: new files,
no edit."""

from __future__ import annotations

import json
import re
import subprocess
import sys
import textwrap

from speechbench.spec import HERE, Spec
from speechbench.tests.conftest import run_tiny

ROOT = HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_names_and_units():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["speechbench"] and 1 <= BENCH["run_seconds"] <= 51
    assert all(_line(w) for w in BENCH["command"])
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and _line(m["layer"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_named_file_is_found():
    spec = Spec.load()
    used = set()
    for cell in BENCH["workloads"]:
        assert cell["chips"] == 1 and _line(cell["why"])
        config, traffic = spec.config(cell["config"]), spec.traffic(cell["traffic"])
        assert config["name"] == cell["config"]
        assert spec.entry(traffic["entry"]).Entry
        checks = spec.checks(cell["name"])
        assert checks["sample"] >= 4 and checks["limits"]["failed"] == 0
        assert checks["limits"]["over_budget"] == 0 and checks["limits"]["max_logit_gap"] > 0
        used.add(cell["config"])
        for trace in (False, True):
            assert spec.metrics(cell["name"], trace)
    for c in BENCH["configs"]:
        assert c["name"] in used and c["reduced"] == []
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("speechbench/")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(spec.metric(m["name"]).read)


def test_a_new_traffic_file_and_metric_file_are_run_as_data(tiny_spec, tiny_root):
    (tiny_root / "traffic" / "tiny-burst.json").write_text(json.dumps({
        "entry": "stt_batched", "loop": "open", "rate_per_s": 20.0,
        "audio_s": {"uniform": [0.5, 1.0]}, "slots": 8, "trace_s": 0.5}))
    (tiny_root / "checks" / "tiny-burst.json").write_text(json.dumps(
        {"sample": 8, "limits": {"max_logit_gap": 0.1, "over_budget": 0, "failed": 0}}))
    (tiny_root / "metrics" / "requests.answered.py").write_text(textwrap.dedent('''
        def read(run):
            return float(sum(r.served is not None for r in run.requests))
    '''))
    tiny_spec.bench["workloads"].append({"name": "tiny-burst", "config": "test-tiny",
                                         "traffic": "tiny-burst", "chips": 1, "why": "new"})
    tiny_spec.bench["end_to_end"].append({"name": "requests.answered", "unit": "requests",
                                          "better": "higher", "bound": 0.05,
                                          "source": "host_clock", "workloads": ["tiny-burst"]})
    out = run_tiny(tiny_spec, "tiny-burst", seconds=1.0)
    assert out["correct"]
    assert out["metrics"]["requests.answered"]["value"] == out["attempted"] > 5
    assert "requests.answered" not in run_tiny(tiny_spec, "tiny-open", seconds=0.5)["metrics"]


def test_the_run_refuses_without_cards():
    # this sandbox has no card: the command exits non-zero and prints no result
    code = ("import sys, torch; from speechbench import run; "
            "torch.cuda.is_available = lambda: False; "
            "sys.exit(run.main(['--workload', 'turbo-commands-64', '--seed', '1', "
            "'--seconds', '1', '--trace', '0']))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr
