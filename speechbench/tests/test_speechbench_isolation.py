"""Nothing the benchmark runs holds JAX or the JAX package, by top-level
module names compared whole: ``open_speech_tpu_torch`` begins with the JAX
package's name and is neither."""

from __future__ import annotations

import subprocess
import sys
import types

from speechbench.run import forbidden_modules
from speechbench.spec import HERE

_PROBE = """
import json, sys
from speechbench import run
from speechbench.spec import Spec
from speechbench.tests.conftest import TINY
spec = Spec.load()
for m in spec.bench["end_to_end"] + spec.bench["per_layer"]:
    spec.metric(m["name"])
for cell in spec.bench["workloads"]:
    spec.entry(spec.traffic(cell["traffic"])["entry"])
import open_speech_tpu_torch.runtime.batcher_pool, open_speech_tpu_torch.backends.torch_whisper
print(json.dumps(run.forbidden_modules()))
"""


def test_the_harness_and_the_port_path_import_no_jax():
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=HERE.parent, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_top_level_names_are_compared_whole(monkeypatch):
    for name in ("open_speech_tpu_torch.fake", "jaxtyping_fake", "flaxen_fake"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert forbidden_modules() == []
    for name in ("open_speech_tpu", "open_speech_tpu.ops.fake", "jax", "jaxlib", "flax.linen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert forbidden_modules() == sorted(["open_speech_tpu", "open_speech_tpu.ops.fake", "jax",
                                          "jaxlib", "flax.linen"])
