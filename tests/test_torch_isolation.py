"""The PyTorch port stands alone: no jax, no aiohttp, nothing of
open_speech_tpu.

``open_speech_tpu_torch`` runs where JAX and aiohttp are not installed, so
importing it (and every submodule, the streaming session, the continuous
batcher, its pool and batched long-form included) must
pull in neither ``jax``, ``aiohttp`` nor any module of the JAX package. The check runs in a fresh interpreter, because this test
process already imported both.
"""

from __future__ import annotations

import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "open_speech_tpu_torch"

_PROBE = """
import importlib, pkgutil, sys
import open_speech_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    open_speech_tpu_torch.__path__, "open_speech_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "aiohttp" or m.startswith("aiohttp.")
             or m == "open_speech_tpu" or m.startswith("open_speech_tpu."))
want = ("server.streaming", "runtime.batcher", "runtime.batcher_pool", "models.whisper.batched")
print(len(names), ",".join(bad), int(all("open_speech_tpu_torch." + w in names for w in want)))
"""


def test_import_pulls_in_no_jax_and_no_jax_package():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=ROOT, capture_output=True,
        text=True, timeout=120, check=True,
    ).stdout.split()
    n_modules, named = int(out[0]), out[-1]
    bad = out[1] if len(out) == 3 else ""
    assert n_modules >= 30, "walk_packages should find every submodule"
    assert named == "1", "the streaming session, both batchers and batched long-form must be among them"
    assert bad == "", f"port imported: {bad}"


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+jaxlib\b|"
    r"import\s+aiohttp\b|from\s+aiohttp\b|"
    r"import\s+open_speech_tpu(\.|\s|$)|from\s+open_speech_tpu(\.|\s))",
    re.MULTILINE,
)


def test_source_names_no_jax_import():
    files = sorted(PKG.rglob("*.py"))
    assert files
    hits = [
        f"{p.relative_to(ROOT)}: {m.group(0).strip()}"
        for p in files
        for m in _FORBIDDEN.finditer(p.read_text(encoding="utf-8"))
    ]
    assert hits == []


def test_cuda_request_without_cuda_raises():
    import torch

    from open_speech_tpu_torch.backends.torch_whisper import TorchWhisperBackend
    from open_speech_tpu_torch.config import Settings

    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the check is for hosts without it")
    assert Settings({}).stt_device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TorchWhisperBackend(device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TorchWhisperBackend()  # the default device is the card
    assert TorchWhisperBackend(device="cpu").device.type == "cpu"


def test_int8_compute_names_its_later_slice():
    from open_speech_tpu_torch.backends.torch_whisper import TorchWhisperBackend

    with pytest.raises(NotImplementedError, match="int8"):
        TorchWhisperBackend(device="cpu", compute_type="int8")
