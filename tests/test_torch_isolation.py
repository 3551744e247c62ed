"""The PyTorch port stands alone: no jax, no aiohttp, nothing of
open_speech_tpu.

``open_speech_tpu_torch`` runs where JAX and aiohttp are not installed, so
importing it (and every submodule, the streaming session, the continuous
batcher, its pool, batched long-form, int8 quantization, speculative
decoding, Kokoro's model and converter, the
vocoder ops, Piper's model, converter and backend, the effects DSP and
chain, the spectral report, Kokoro serving (the TTS router,
backend and batcher, G2P, and the speech handler's body), and the server
(the app, its HTTP/multipart/WebSocket shell, errors, middleware, TLS
bootstrap and ``__main__``), the realtime socket, the Wyoming server, the
model catalog, the model manager, its lifecycle and the serving metrics
included) must pull in neither ``jax``,
``aiohttp``, ``pydantic`` nor any module of the JAX package. The check runs
in a fresh interpreter, because this test process already imported them.
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
             or m == "pydantic" or m.startswith("pydantic.")
             or m == "open_speech_tpu" or m.startswith("open_speech_tpu."))
want = ("server.streaming", "runtime.batcher", "runtime.batcher_pool", "models.whisper.batched",
        "models.kokoro.model", "models.kokoro.convert", "ops.vocoder", "models.piper.convert",
        "tts.router", "tts.backends.kokoro_backend", "runtime.tts_batcher", "text.g2p",
        "runtime.speech", "models.whisper.quantize", "models.whisper.speculative",
        "server.app", "server.http", "server.multipart", "server.websocket", "server.errors",
        "server.middleware", "server.ssl_utils", "server.__main__", "server.realtime",
        "server.realtime.server", "server.realtime.events", "server.realtime.session",
        "server.realtime.audio_buffer", "server.wyoming", "server.wyoming.server",
        "server.wyoming.protocol", "runtime.registry", "server.metrics", "runtime.model_manager",
        "runtime.lifecycle", "models.piper.model", "tts.backends.piper_torch", "ops.effects",
        "audio.effects", "audio.spectral")
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
    assert named == "1", ("the streaming session, the batchers, batched long-form, "
                          "Kokoro's model and serving modules, the server, the realtime socket, "
                          "Wyoming, model management, Piper and the effects must be among them")
    assert bad == "", f"port imported: {bad}"


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+jaxlib\b|"
    r"import\s+aiohttp\b|from\s+aiohttp\b|import\s+pydantic\b|from\s+pydantic\b|"
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


def test_int8_compute_names_its_later_slice(monkeypatch):
    """STT_COMPUTE_TYPE=int8 is served now: the backend loads test-tiny
    with int8 packs and reports the compute type, as the JAX backend's
    test_backend_int8_compute_type checks."""
    import torch

    from open_speech_tpu_torch.backends.torch_whisper import TorchWhisperBackend
    from open_speech_tpu_torch.config import settings
    from open_speech_tpu_torch.models.whisper.model import QuantEmbedding, QuantLinear

    monkeypatch.setattr(settings, "stt_model_dir", str(ROOT / "tests" / "fixtures"))
    monkeypatch.setattr(settings, "os_precompile_on_load", False)
    backend = TorchWhisperBackend(device="cpu", compute_type="int8")
    backend.load_model("test-tiny")
    model = backend._models["test-tiny"]["model"]
    assert isinstance(model.decoder.tok_emb, QuantEmbedding)
    assert model.decoder.tok_emb.q.dtype == torch.int8
    assert isinstance(model.encoder.blocks[0].attn.q, QuantLinear)
    assert backend.loaded_models()[0].compute_type == "int8"


# host modules the port keeps as copies of the JAX package's (jax-free) ones
_COPIES = [
    "text/g2p.py", "text/g2p_langs.py", "text/cjk_lexicon.py", "text/ja_lexicon.py",
    "text/zh_lexicon.py", "text/pronunciation.py", "tts/voices.py",
    "audio/postprocessing.py", "audio/encode.py", "models/kokoro/vocab.json",
    "server/ssl_utils.py", "server/realtime/__init__.py", "server/realtime/events.py",
    "server/realtime/session.py", "server/realtime/audio_buffer.py", "server/wyoming/__init__.py",
    "server/wyoming/protocol.py", "runtime/registry.py", "server/metrics.py",
    "runtime/model_manager.py", "runtime/lifecycle.py",
]


@pytest.mark.parametrize("rel", _COPIES)
def test_copies_equal_their_jax_originals(rel):
    """A copied module equals its original once the package name, and the
    Piper backend's module name it cites, are normalised, so the copies
    cannot drift."""
    original = (ROOT / "open_speech_tpu" / rel).read_text(encoding="utf-8")
    copy = (PKG / rel).read_text(encoding="utf-8")
    normalised = copy.replace("open_speech_tpu_torch", "open_speech_tpu")
    assert normalised.replace("backends/piper_torch.py", "backends/piper_jax.py") == original


# the server's settings: the JAX package's names, env variables and defaults
_SERVER_SETTINGS = [
    "os_host", "os_port", "os_api_key", "os_auth_required", "os_cors_origins",
    "os_ws_allowed_origins", "os_trust_proxy", "os_max_upload_mb", "os_rate_limit",
    "os_rate_limit_burst", "os_ssl_enabled", "os_ssl_certfile", "os_ssl_keyfile",
    "stt_preload_models", "tts_preload_models", "stt_diarize_enabled", "stt_noise_reduce",
    "stt_port", "stt_host", "stt_api_key", "stt_cors_origins", "stt_trust_proxy",
    "stt_ws_allowed_origins", "stt_max_upload_mb", "stt_rate_limit", "stt_rate_limit_burst",
    "stt_ssl_enabled", "stt_ssl_certfile", "stt_ssl_keyfile",
    "os_realtime_enabled", "os_realtime_max_buffer_mb", "os_realtime_idle_timeout_s",
    "os_wyoming_enabled", "os_wyoming_host", "os_wyoming_port",
    "stt_vad_min_speech_ms", "stt_vad_silence_ms",
    "os_model_ttl", "os_max_loaded_models", "os_profile_dir", "os_effects_enabled",
    "stt_model_ttl", "stt_max_loaded_models",
]


@pytest.mark.parametrize("name", _SERVER_SETTINGS)
def test_server_settings_match_the_jax_defaults(name):
    """Defaults with an empty environment, and a value read from the env
    variable of the field's name, equal the JAX package's."""
    from open_speech_tpu.config import _DEFAULTS as JAX_FIELDS
    from open_speech_tpu.config import Settings as JaxSettings
    from open_speech_tpu_torch.config import Settings

    assert getattr(Settings({}), name) == getattr(JaxSettings({}), name)
    field = name if name in JAX_FIELDS else "os_" + name[4:]  # an alias reads its os_ field
    raw = {bool: "true", int: "7", str: "x"}[type(getattr(JaxSettings({}), field))]
    env = {field.upper(): raw}
    assert getattr(Settings(env), name) == getattr(JaxSettings(env), name)
