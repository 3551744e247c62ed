"""Model management and the TTL/LRU lifecycle of the port, held against the
JAX package on the CPU.

- **The manager.** Every case of ``tests/test_runtime.py``'s model-manager,
  lifecycle and batcher-pool section runs against both packages'
  ``ModelManager`` (and lifecycle, registry and batcher pool) over the same
  fake routers: the cases are parametrised over the package.
- **The lifecycle** on the port's real ``BackendRouter`` (CPU, float32)
  with ``tests/fixtures/test-tiny-eot`` loaded, on a stubbed wall clock: the
  victim re-check, the TTL and LRU sweeps, TTS eviction through the
  manager, ``retire_stale`` of a real continuous batcher, and the app's
  startup and cleanup of the lifecycle.
- **The routes.** The JAX app and the port's app serve the same requests
  through ``tests/test_torch_server.py``'s harness and normalisation (the
  backend's name; floats within 1e-4). Besides: timestamps
  (``loaded_at``, ``last_used_at``, ``ttl_remaining``) within
  ``STAMP_TOL`` seconds, and artifact paths relative to each side's cache
  root. Both apps serve the fixture STT backend on the CPU. The JAX app's
  TTS router is held to the providers the port has (Kokoro and Piper;
  Pocket is a later slice, so the port lists its catalog row without
  capabilities where the held JAX router shows the Kokoro fallback's), its
  backends report the CPU, where they run here, and both Piper backends
  make their voices at ``tests/test_torch_piper.py``'s small geometry.
  Kokoro is marked loaded without weights: no route here synthesizes. A download is a load then an unload of a fixture
  checkpoint on disk: nothing is fetched.
- **The profiler's 409 guards**, and the port's refusal to start without
  the card's activity when its routers are on the card.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import time
from pathlib import Path
from types import SimpleNamespace

import pytest

import open_speech_tpu.runtime.batcher_pool as JBP
import open_speech_tpu.runtime.lifecycle as JL
import open_speech_tpu.runtime.model_manager as JMM
import open_speech_tpu.runtime.registry as JREG
import open_speech_tpu.schemas as JSCH
import open_speech_tpu.server.metrics as JMET
import open_speech_tpu.tts.backends.base as JTB
import open_speech_tpu_torch.backends.torch_whisper as TW
import open_speech_tpu_torch.runtime.batcher_pool as TBP
import open_speech_tpu_torch.runtime.lifecycle as TL
import open_speech_tpu_torch.runtime.model_manager as TMM
import open_speech_tpu_torch.runtime.registry as TREG
import open_speech_tpu_torch.schemas as TSCH
import open_speech_tpu_torch.server.metrics as TMET
import open_speech_tpu_torch.tts.backends.base as TTB
from open_speech_tpu.config import settings as jax_settings
from open_speech_tpu.models.piper.model import PiperConfig as JPiperConfig
from open_speech_tpu.runtime.router import router as jax_router
from open_speech_tpu.server import app as JAPP
from open_speech_tpu_torch.config import settings as torch_settings
from open_speech_tpu_torch.models.piper import PiperConfig as TPiperConfig
from open_speech_tpu_torch.runtime.router import BackendRouter
from open_speech_tpu_torch.server import app as TAPP
from open_speech_tpu_torch.tts.router import TTSRouter
from tests.test_torch_server import _ask_both, _same

ROOT = Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "tests" / "fixtures"
MODEL = "test-tiny-eot"
STAMP_TOL = 5.0  # seconds between the two servers' clocks for one call
# Piper voices made at a small geometry: a load through the routes stays cheap
PIPER_CFG = JPiperConfig(hidden=32, ffn_filter=64, n_layers=2, dp_filter=32, flow_layers=2,
                         upsample_rates=(4, 4), upsample_kernels=(8, 8), upsample_initial=64,
                         resblock_kernels=(3,), resblock_dilations=((1, 3),), max_phonemes=16, max_frames=64)

PACKAGES = {
    "jax": SimpleNamespace(settings=jax_settings, mm=JMM, lifecycle=JL, registry=JREG, pool=JBP,
                           LoadedModelInfo=JSCH.LoadedModelInfo,
                           TTSLoadedModelInfo=JTB.TTSLoadedModelInfo),
    "torch": SimpleNamespace(settings=torch_settings, mm=TMM, lifecycle=TL, registry=TREG, pool=TBP,
                             LoadedModelInfo=TSCH.LoadedModelInfo,
                             TTSLoadedModelInfo=TTB.TTSLoadedModelInfo),
}


# ── the manager over fake routers (tests/test_runtime.py's cases) ───────


class FakeSTTBackend:
    name = "jax-whisper"

    def __init__(self, pkg):
        self._pkg = pkg
        self._models = {}
        self._last_used = {}

    def load_model(self, model_id):
        self._models[model_id] = object()
        self._last_used[model_id] = time.time()

    def unload_model(self, model_id):
        self._models.pop(model_id, None)
        self._last_used.pop(model_id, None)

    def loaded_models(self):
        return [
            self._pkg.LoadedModelInfo(
                model=m, backend=self.name, device="cpu", compute_type="bf16",
                loaded_at=0.0, last_used_at=self._last_used.get(m),
            )
            for m in self._models
        ]

    def is_model_loaded(self, model_id):
        return model_id in self._models

    def list_cached_models(self):
        return []


class FakeSTTRouter:
    def __init__(self, pkg):
        self._default_backend = FakeSTTBackend(pkg)
        self._backends = {"jax-whisper": self._default_backend}
        self._lock = asyncio.Lock()

    def __getattr__(self, item):
        return getattr(self._default_backend, item)


class FakeTTSBackend:
    name = "kokoro"

    def __init__(self, pkg):
        self._pkg = pkg
        self._loaded = set()
        self._last_used = {}

    def load_model(self, model_id):
        self._loaded.add(model_id)
        self._last_used[model_id] = time.time()

    def unload_model(self, model_id):
        self._loaded.discard(model_id)
        self._last_used.pop(model_id, None)

    def is_model_loaded(self, model_id):
        return model_id in self._loaded

    def loaded_models(self):
        return [
            self._pkg.TTSLoadedModelInfo(model=m, backend=self.name, device="cpu", loaded_at=0.0,
                                         last_used_at=self._last_used.get(m))
            for m in self._loaded
        ]


class FakeTTSRouter:
    def __init__(self, pkg):
        self._backends = {"kokoro": FakeTTSBackend(pkg), "piper": FakeTTSBackend(pkg)}
        self._kokoro = self._backends["kokoro"]

    def load_model(self, model_id):
        self._kokoro.load_model(model_id)

    def unload_model(self, model_id):
        self._kokoro.unload_model(model_id)

    def is_model_loaded(self, model_id):
        return self._kokoro.is_model_loaded(model_id)

    def loaded_models(self):
        return self._kokoro.loaded_models()


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


@pytest.fixture
def manager(pkg):
    return pkg.mm.ModelManager(FakeSTTRouter(pkg), FakeTTSRouter(pkg))


def test_registry_contains_core_models(pkg):
    ids = {m["id"] for m in pkg.registry.get_known_models()}
    assert "whisper-large-v3-turbo" in ids
    assert "deepdml/faster-whisper-large-v3-turbo-ct2" in ids
    assert "kokoro" in ids
    assert "piper/en_US-lessac-medium" in ids
    assert pkg.registry.get_known_model("whisper-tiny")["type"] == "stt"
    assert pkg.registry.get_known_model("nonexistent") is None


def test_load_and_status(pkg, manager):
    info = manager.load("whisper-tiny")
    assert info.state == pkg.mm.ModelState.LOADED
    assert info.type == "stt"
    assert manager.status("whisper-tiny").state == pkg.mm.ModelState.LOADED


def test_load_evicts_same_type(manager):
    manager.load("whisper-tiny")
    manager.load("whisper-base")
    assert [m.id for m in manager.list_loaded() if m.type == "stt"] == ["whisper-base"]


def test_load_does_not_evict_other_type(manager):
    manager.load("whisper-tiny")
    manager.load("kokoro")
    assert {m.type for m in manager.list_loaded()} == {"stt", "tts"}


def test_download_loads_then_unloads(manager):
    info = manager.download("whisper-tiny")
    assert not manager._stt.is_model_loaded("whisper-tiny")
    assert info.id == "whisper-tiny"


def test_resolve_type_tts_prefixes(manager):
    assert manager._resolve_type("kokoro") == "tts"
    assert manager._resolve_type("piper/en_US-amy-medium") == "tts"
    assert manager._resolve_type("whisper-tiny") == "stt"


def test_provider_resolution(manager):
    assert manager.resolve_provider("kokoro") == "kokoro"
    assert manager.resolve_provider("piper/en_US-amy-medium") == "piper"
    assert manager.resolve_provider("whisper-large-v3") == "jax-whisper"
    assert manager.resolve_provider("arbitrary/unknown-model") == "jax-whisper"


def test_list_all_merges_catalog(pkg, manager):
    manager.load("whisper-tiny")
    all_models = {m.id: m for m in manager.list_all()}
    assert all_models["whisper-tiny"].state == pkg.mm.ModelState.LOADED
    assert all_models["kokoro"].state != pkg.mm.ModelState.LOADED
    assert len(all_models) >= 40


def test_delete_artifacts_not_found(manager):
    result = manager.delete_artifacts("whisper-tiny")
    assert result["status"] == "not_found"
    assert result["model"] == "whisper-tiny"


def test_ttl_eviction(pkg, manager, monkeypatch):
    manager.load("whisper-tiny")
    backend = manager._stt._default_backend
    backend._last_used["whisper-tiny"] = time.time() - 10_000
    monkeypatch.setattr(pkg.settings, "os_model_ttl", 300)
    monkeypatch.setattr(pkg.settings, "stt_model", "whisper-large-v3-turbo")  # default exempt
    manager.check_ttl()
    assert not backend.is_model_loaded("whisper-tiny")


def test_ttl_default_exempt(pkg, manager, monkeypatch):
    monkeypatch.setattr(pkg.settings, "stt_model", "whisper-tiny")
    manager.load("whisper-tiny")
    backend = manager._stt._default_backend
    backend._last_used["whisper-tiny"] = time.time() - 10_000
    manager.check_ttl()
    assert backend.is_model_loaded("whisper-tiny")


def test_evict_lru(pkg, manager, monkeypatch):
    monkeypatch.setattr(pkg.settings, "stt_model", "whisper-large-v3-turbo")
    manager.load("whisper-tiny")
    manager.load("kokoro")
    backend = manager._stt._default_backend
    backend._last_used["whisper-tiny"] = time.time() - 500
    manager.evict_lru()
    assert not backend.is_model_loaded("whisper-tiny")


def test_lifecycle_error_shape(pkg):
    err = pkg.mm.ModelLifecycleError(message="m", code="load_failed", model_id="x", provider="p",
                                     action="load")
    d = err.to_dict()
    assert d["code"] == "load_failed" and d["model"] == "x"


def test_unload_stt_and_tts(manager):
    manager.load("whisper-tiny")
    manager.unload("whisper-tiny")
    assert all(m.id != "whisper-tiny" for m in manager.list_loaded())
    manager.load("kokoro")
    manager.unload("kokoro")
    assert manager.list_loaded() == []


def test_status_not_loaded_tts(pkg, manager):
    info = manager.status("pocket-tts")
    assert info.state in (pkg.mm.ModelState.AVAILABLE, pkg.mm.ModelState.PROVIDER_MISSING)
    assert info.type == "tts"


def test_status_default_flag(pkg, manager, monkeypatch):
    monkeypatch.setattr(pkg.settings, "stt_model", "whisper-tiny")
    assert manager.status("whisper-tiny").is_default


def test_provider_missing_marked(pkg, manager):
    manager._tts._backends.pop("piper", None)
    info = manager.status("piper/en_US-lessac-medium")
    assert info.state == pkg.mm.ModelState.PROVIDER_MISSING
    assert info.provider_available is False
    with pytest.raises(pkg.mm.ModelLifecycleError):
        manager.load("piper/en_US-lessac-medium")


def test_load_missing_provider_does_not_evict(pkg, manager):
    manager.load("kokoro")
    manager._tts._backends.pop("piper", None)
    with pytest.raises(pkg.mm.ModelLifecycleError):
        manager.load("piper/en_US-lessac-medium")
    assert any(m.id == "kokoro" for m in manager.list_loaded())


def test_evict_lru_skips_default(pkg, manager, monkeypatch):
    monkeypatch.setattr(pkg.settings, "stt_model", "whisper-tiny")
    manager.load("whisper-tiny")
    assert manager.list_loaded()[0].is_default
    manager.evict_lru()  # nothing evictable: only the default is loaded
    assert any(m.id == "whisper-tiny" for m in manager.list_loaded())


def test_model_info_to_dict_shape(manager):
    d = manager.load("whisper-tiny").to_dict()
    for key in ("id", "type", "provider", "state", "is_default"):
        assert key in d
    assert d["state"] == "loaded"


def test_piper_artifact_paths_match_backend_cache(manager, tmp_path, monkeypatch):
    monkeypatch.setenv("OS_PIPER_VOICES_DIR", str(tmp_path))
    voice = tmp_path / "en_US-amy-medium.onnx"
    voice.write_bytes(b"onnx")
    (tmp_path / "en_US-amy-medium.onnx.json").write_text("{}")
    assert voice in manager._candidate_artifact_paths("piper/en_US-amy-medium", "piper")
    result = manager.delete_artifacts("piper/en_US-amy-medium")
    assert result["status"] == "deleted"
    assert not voice.exists()
    assert not (tmp_path / "en_US-amy-medium.onnx.json").exists()


def test_pocket_artifact_paths_cover_kyutai_cache(manager):
    paths = manager._candidate_artifact_paths("pocket-tts", "pocket-tts")
    assert any("models--kyutai--pocket-tts" in str(p) for p in paths)


def test_cached_stt_infos_include_off_catalog(pkg, manager):
    manager._stt.list_cached_models = lambda: [
        {"model": "someorg/custom-whisper-ct2", "backend": "jax-whisper"}
    ]
    infos = manager._cached_stt_infos({"kokoro": "tts"})
    assert any(i.id == "someorg/custom-whisper-ct2" for i in infos)
    assert all(i.state == pkg.mm.ModelState.DOWNLOADED for i in infos)


def test_lifecycle_recheck_spares_bumped_model(pkg, manager, monkeypatch):
    monkeypatch.setattr(pkg.settings, "os_model_ttl", 300)
    monkeypatch.setattr(pkg.settings, "stt_model", "whisper-large-v3-turbo")
    router = manager._stt
    backend = router._default_backend
    backend.load_model("whisper-tiny")
    backend._last_used["whisper-tiny"] = time.time() - 10_000
    lm = pkg.lifecycle.ModelLifecycleManager(router)
    assert lm._idle_victims(backend, time.time()) == ["whisper-tiny"]
    backend._last_used["whisper-tiny"] = time.time()  # a request after the selection
    asyncio.run(lm._unload_if_still_victim(backend, "whisper-tiny", "TTL"))
    assert backend.is_model_loaded("whisper-tiny")
    backend._last_used["whisper-tiny"] = time.time() - 10_000
    asyncio.run(lm._unload_if_still_victim(backend, "whisper-tiny", "TTL"))
    assert not backend.is_model_loaded("whisper-tiny")


def test_lifecycle_sweep_evicts_idle_tts_via_manager(pkg, manager, monkeypatch):
    monkeypatch.setattr(pkg.settings, "os_model_ttl", 300)
    monkeypatch.setattr(pkg.settings, "tts_model", "pocket-tts")
    manager.load("kokoro")
    tts_backend = manager._tts._backends["kokoro"]
    tts_backend._last_used["kokoro"] = time.time() - 10_000
    lm = pkg.lifecycle.ModelLifecycleManager(manager._stt, manager=manager)
    asyncio.run(lm._sweep())
    assert not tts_backend.is_model_loaded("kokoro")


class _FakeBatcher:
    """A batcher made from ``weights``: JAX's pool compares its source
    params, the port's its model object."""

    occupancy = 0

    class _Q:
        @staticmethod
        def empty():
            return True

    _queue = _Q()

    def __init__(self, weights, stopped=None):
        self.params = dict(weights)  # re-sharded: another pytree
        self._source_params = self.model = weights
        self._stopped = stopped

    async def stop(self):
        self._stopped.append(self)


def _entry(weights):
    return {"params": weights, "model": weights}


def test_batcher_pool_is_current_uses_source_params(pkg):
    weights = {"w": 1}
    backend = FakeSTTBackend(pkg)
    backend._models["m"] = _entry(weights)
    b = _FakeBatcher(weights)
    assert pkg.pool._is_current(b, backend, "m")
    backend._models["m"] = _entry({"w": 2})  # the model reloaded
    assert not pkg.pool._is_current(b, backend, "m")


def test_batcher_pool_retire_stale(pkg):
    weights = {"w": 1}
    backend = FakeSTTBackend(pkg)
    backend._models["m"] = _entry(weights)
    stopped = []

    async def run():
        pkg.pool._batchers[("m", "en", "transcribe")] = _FakeBatcher(weights, stopped)
        assert await pkg.pool.retire_stale(backend) == 0  # current: nothing retired
        backend._models.pop("m")  # evicted: the batcher goes
        assert await pkg.pool.retire_stale(backend) == 1
        assert not pkg.pool._batchers
        await asyncio.sleep(0.3)  # the drain task stops it
        assert stopped

    try:
        asyncio.run(run())
    finally:
        pkg.pool.reset_pool()


# ── the lifecycle on the port's real router ────────────────────────────


@pytest.fixture
def clock(monkeypatch):
    """The wall clock the lifecycle, the manager and the backends read."""
    now = [1_000_000.0]
    fake = SimpleNamespace(time=lambda: now[0])
    import open_speech_tpu_torch.tts.backends.kokoro_backend as KB

    for module in (TL, TMM, TW, KB):
        monkeypatch.setattr(module, "time", fake)
    return now


@pytest.fixture
def real(monkeypatch, clock):
    """The port's CPU router with the fixture loaded at the stubbed clock,
    no default among the loaded models, TTL 300 s, no LRU limit."""
    for key, value in (("stt_model_dir", str(FIXTURES)), ("os_precompile_on_load", False),
                       ("stt_model", "whisper-large-v3-turbo"), ("os_model_ttl", 300),
                       ("os_max_loaded_models", 0), ("tts_model", "kokoro")):
        monkeypatch.setattr(torch_settings, key, value)
    router = BackendRouter(device="cpu", compute_type="float32")
    router.load_model(MODEL)
    return router


def test_sweep_ttl_rechecks_its_victim_on_the_real_router(real, clock):
    backend = real._default_backend
    lm = TL.ModelLifecycleManager(real)
    clock[0] += 301
    assert lm._idle_victims(backend, clock[0]) == [MODEL]
    backend._ensure_model(MODEL)  # a request after the selection bumps its clock
    asyncio.run(lm._unload_if_still_victim(backend, MODEL, "TTL"))
    assert real.is_model_loaded(MODEL)
    clock[0] += 299
    asyncio.run(lm._sweep())
    assert real.is_model_loaded(MODEL)  # not idle past the TTL yet
    with backend._load_lock:  # a load in flight: nothing is evicted
        clock[0] += 2
        assert lm._idle_victims(backend, clock[0]) == []
    asyncio.run(lm._sweep())
    assert not real.is_model_loaded(MODEL)


def test_sweep_ttl_spares_the_default_model(real, clock, monkeypatch):
    monkeypatch.setattr(torch_settings, "stt_model", MODEL)
    clock[0] += 10_000
    asyncio.run(TL.ModelLifecycleManager(real)._sweep())
    assert real.is_model_loaded(MODEL)


@pytest.mark.parametrize("default", [None, MODEL])
def test_sweep_trims_to_max_loaded_models_oldest_first(real, clock, monkeypatch, default):
    """Two loaded, a limit of one: the older non-default model goes (the
    newer one when the older is the default)."""
    monkeypatch.setattr(torch_settings, "os_model_ttl", 0)
    monkeypatch.setattr(torch_settings, "os_max_loaded_models", 1)
    if default:
        monkeypatch.setattr(torch_settings, "stt_model", default)
    clock[0] += 10
    real.load_model("test-tiny")  # newer than the fixture
    asyncio.run(TL.ModelLifecycleManager(real)._sweep())
    kept = "test-tiny" if default is None else MODEL
    assert [m.model for m in real.loaded_models()] == [kept]


def test_sweep_evicts_an_idle_tts_model_through_the_manager(real, clock, monkeypatch):
    monkeypatch.setattr(torch_settings, "tts_model", "pocket-tts")
    tts = TTSRouter(device="cpu")
    kokoro = tts.get_backend("kokoro")
    kokoro._model = object()  # marked loaded: nothing here synthesizes
    kokoro._loaded_at = kokoro._last_used = clock[0]
    lm = TL.ModelLifecycleManager(real, manager=TMM.ModelManager(real, tts))
    clock[0] += 200
    asyncio.run(lm._sweep())
    assert tts.is_model_loaded("kokoro")
    clock[0] += 200
    asyncio.run(lm._sweep())
    assert not tts.is_model_loaded("kokoro")
    assert not real.is_model_loaded(MODEL)  # the STT fixture went in the same sweep


def test_sweep_retires_the_evicted_models_batcher(real, clock):
    backend = real._default_backend
    lm = TL.ModelLifecycleManager(real)

    async def run():
        batcher = await TBP.get_batcher(backend, MODEL, "en")
        assert list(TBP.pool_stats()) == [f"{MODEL}/en/transcribe"]
        await lm._sweep()
        assert TBP.pool_stats() != {}  # not idle yet: kept, and current
        clock[0] += 301
        await lm._sweep()
        assert not real.is_model_loaded(MODEL)
        assert TBP.pool_stats() == {}
        await asyncio.wait_for(asyncio.gather(*TBP._retiring), 30)
        assert batcher._task is None or batcher._task.done()

    try:
        asyncio.run(run())
    finally:
        TBP.reset_pool()


def test_the_app_starts_and_stops_its_lifecycle(real):
    async def run():
        app = TAPP.create_app(stt_router=real, tts_router=TTSRouter(device="cpu"))
        await app.startup()
        lifecycle = app["lifecycle"]
        task = lifecycle._task
        assert lifecycle._router is real and lifecycle._manager is app["model_manager"]
        assert task is not None and not task.done()
        await app.cleanup()
        assert lifecycle._task is None and task.cancelled()

    asyncio.run(run())


def test_every_catalog_stt_id_finds_its_provider(real):
    """The catalog names every STT row's provider ``jax-whisper``; the
    port's router answers to that name, so no load is ``provider_missing``."""
    manager = TMM.ModelManager(real, TTSRouter(device="cpu"))
    rows = [r for r in TREG.get_known_models() if r["type"] == "stt"]
    assert rows and {r["provider"] for r in rows} == {"jax-whisper"}
    for row in rows:
        assert manager._provider_registered("stt", row["provider"]), row["id"]
        assert manager.status(row["id"]).state != TMM.ModelState.PROVIDER_MISSING
    assert manager.load(MODEL).state == TMM.ModelState.LOADED


# ── the routes, on both apps ───────────────────────────────────────────


@pytest.fixture(scope="module")
def routers():
    from open_speech_tpu.backends.jax_whisper import JaxWhisperBackend

    with pytest.MonkeyPatch.context() as mp:
        for s in (jax_settings, torch_settings):
            mp.setattr(s, "stt_model_dir", str(FIXTURES))
            mp.setattr(s, "os_precompile_on_load", False)
            mp.setattr(s, "stt_compute_type", "float32")
        yield JaxWhisperBackend(), BackendRouter(device="cpu")


def _kokoro_loaded(monkeypatch, jkokoro, tkokoro) -> None:
    """Kokoro marked loaded on both sides, without weights."""
    now = time.time()
    for backend, attr in ((jkokoro, "_params"), (tkokoro, "_model")):
        monkeypatch.setattr(backend, attr, object())
        monkeypatch.setattr(backend, "_loaded_at", now)
        monkeypatch.setattr(backend, "_last_used", now)


@pytest.fixture
def served(routers, monkeypatch, tmp_path):
    """Both apps' routers with only the fixture loaded, the JAX app's TTS
    router held to Kokoro, fresh download progress and metrics. Returns
    (port STT router, port TTS router, settings changer, kokoro marker)."""
    jb, trouter = routers
    for key, value in (("stt_model_dir", str(FIXTURES)), ("os_precompile_on_load", False),
                       ("stt_compute_type", "float32"), ("stt_model", "whisper-large-v3-turbo"),
                       ("tts_model", "kokoro"), ("tts_enabled", True), ("os_model_ttl", 300),
                       ("os_profile_dir", str(tmp_path / "profile"))):
        for s in (jax_settings, torch_settings):
            monkeypatch.setattr(s, key, value)
    monkeypatch.setattr(jax_settings, "os_history_enabled", False)
    monkeypatch.setattr(jax_router, "_default_backend", jb)
    for key in list(jax_router._backends):
        monkeypatch.setitem(jax_router._backends, key, jb)
    jkokoro, jpiper = JAPP.tts_router.get_backend("kokoro"), JAPP.tts_router.get_backend("piper")
    monkeypatch.setattr(JAPP.tts_router, "_backends", {"kokoro": jkokoro, "piper": jpiper})
    monkeypatch.setattr(jkokoro, "_device_arg", "cpu")
    monkeypatch.setattr(jkokoro, "_params", None)
    monkeypatch.setattr(jpiper, "_device_arg", "cpu")
    monkeypatch.setattr(jpiper, "_cfg", PIPER_CFG)
    for attr in ("_models", "_loaded_at", "_last_used"):
        monkeypatch.setattr(jpiper, attr, {})
    monkeypatch.setattr(JAPP, "_download_progress", {})
    monkeypatch.setattr(JAPP, "_profiler_active", {})
    monkeypatch.setattr(JAPP, "metrics", JMET.Metrics())
    monkeypatch.setattr(TAPP, "metrics", TMET.Metrics())
    tts = TTSRouter(device="cpu")
    tts.get_backend("piper")._cfg = TPiperConfig(**dataclasses.asdict(PIPER_CFG))
    backends = (jb, trouter._default_backend)
    for backend in backends:
        for mid in list(backend._models):
            backend.unload_model(mid)
        backend.load_model(MODEL)

    def change(**values):
        for s in (jax_settings, torch_settings):
            for key, value in values.items():
                monkeypatch.setattr(s, key, value)

    yield trouter, tts, change, lambda: _kokoro_loaded(monkeypatch, jkokoro, tts.get_backend("kokoro"))
    for backend in backends:  # the module's routers go back to the fixture alone
        for mid in list(backend._models):
            backend.unload_model(mid)
        backend.load_model(MODEL)


STAMPS = ("loaded_at", "last_used_at", "ttl_remaining")


def _stamped(got, want):
    """``got`` with each timestamp within STAMP_TOL of ``want``'s set to it."""
    if isinstance(got, dict) and isinstance(want, dict):
        return {k: (want[k] if k in STAMPS and isinstance(v, (int, float)) and isinstance(
                    want.get(k), (int, float)) and abs(v - want[k]) <= STAMP_TOL
                    else _stamped(v, want.get(k))) for k, v in got.items()}
    if isinstance(got, list) and isinstance(want, list):
        return [_stamped(g, w) for g, w in zip(got, want)] + got[len(want):]
    return got


def _same_stamped(jax, port):
    jax = _pocket_unported(jax)
    (js, jh, jbody), (ts, th, tbody) = jax, port
    if jbody and tbody and jh.get("Content-Type", "").startswith("application/json"):
        tbody = json.dumps(_stamped(json.loads(tbody), json.loads(jbody))).encode()
    _same(jax, (ts, th, tbody))


def _pocket_unported(answer):
    """The JAX answer with the catalog's ``pocket-tts`` row as the port lists
    it: no capabilities, since its router refuses to resolve a backend it
    has not ported (the held JAX router would show the Kokoro fallback's)."""
    status, headers, body = answer
    if not body or not headers.get("Content-Type", "").startswith("application/json"):
        return answer
    data = json.loads(body)
    rows = data.get("models") if isinstance(data, dict) else None
    if not isinstance(rows, list) or not any(isinstance(r, dict) and r.get("id") == "pocket-tts" for r in rows):
        return answer
    for row in rows:
        if row.get("id") == "pocket-tts" and "capabilities" in row:
            row["capabilities"] = {}
    return status, headers, json.dumps(data).encode()


def _post(path, body=None):
    return ("POST", path, None, {} if body is None else {"json": body})


def _get(path):
    return ("GET", path, None, {})


def _delete(path):
    return ("DELETE", path, None, {})


M = "/api/models"
PIPER = "piper/en_US-lessac-medium"
# (id, calls, settings changed on both sides, kokoro marked loaded)
ROUTE_CASES = [
    ("ps", [_get("/api/ps")], {}, False),
    ("ps-load-unload", [_post("/api/ps/test-tiny"), _get("/api/ps"), _delete("/api/ps/test-tiny"),
                        _delete("/api/ps/test-tiny"), _get("/api/ps")], {}, False),
    ("ps-load-unknown", [_post("/api/ps/nope-model"), _get("/api/ps")], {}, False),
    ("models", [_get(M)], {}, False),
    ("models-kokoro-loaded", [_get(M)], {}, True),
    ("tts-capabilities", [_get("/api/tts/capabilities"), _get("/api/tts/capabilities?model=kokoro"),
                          _get("/api/tts/capabilities?model=piper/en_US-lessac-medium")], {}, False),
    ("tts-capabilities-off", [_get("/api/tts/capabilities")], {"tts_enabled": False}, False),
    ("status-progress", [_get(f"{M}/{MODEL}/status"), _get(f"{M}/{MODEL}/progress"),
                         _get(f"{M}/test-tiny/status"), _get(f"{M}/test-tiny/progress"),
                         _get(f"{M}/kokoro/status"), _get(f"{M}/pocket-tts/status"),
                         _get(f"{M}/org/custom-model/status")], {}, False),
    ("load", [_post(f"{M}/test-tiny/load"), _get(f"{M}/test-tiny/progress"), _get(f"{M}/test-tiny/status"),
              _get(f"{M}/test-tiny/progress"), _get(f"{M}/{MODEL}/status"), _get("/api/ps")], {}, False),
    ("load-loaded", [_post(f"{M}/{MODEL}/load"), _get(f"{M}/{MODEL}/status")], {}, False),
    ("load-default", [_post(f"{M}/{MODEL}/load"), _get(M)], {"stt_model": MODEL}, False),
    ("load-kokoro", [_post(f"{M}/kokoro/load"), _get(f"{M}/kokoro/status")], {}, True),
    ("load-provider-missing", [_post(f"{M}/pocket-tts/load"), _get(f"{M}/pocket-tts/progress")], {}, False),
    ("load-piper", [_post(f"{M}/{PIPER}/load"), _get(f"{M}/{PIPER}/status"), _get("/api/ps"),
                    _get("/v1/audio/models"), _delete(f"{M}/{PIPER}"), _get(f"{M}/{PIPER}/status"),
                    _post("/v1/audio/models/load", {"model": PIPER}), _get("/v1/audio/models"),
                    _post("/v1/audio/models/unload", {"model": PIPER}), _get("/api/ps")], {}, False),
    ("load-failed", [_post(f"{M}/nope-model/load"), _get(f"{M}/nope-model/progress"), _get("/api/ps")],
     {}, False),
    ("download", [_post(f"{M}/test-tiny/download"), _get(f"{M}/test-tiny/progress"),
                  _get(f"{M}/test-tiny/status"), _get(f"{M}/test-tiny/status"), _get("/api/ps")], {}, False),
    ("download-loaded", [_post(f"{M}/{MODEL}/download"), _get("/api/ps")], {}, False),
    ("prefetch", [_post(f"{M}/test-tiny/prefetch"), _get(f"{M}/test-tiny/status")], {}, False),
    ("download-failed", [_post(f"{M}/nope-model/download"), _get("/api/ps")], {}, False),
    ("unload", [_delete(f"{M}/{MODEL}"), _delete(f"{M}/{MODEL}"), _get(f"{M}/{MODEL}/status"),
                _get("/api/ps")], {}, False),
    ("unload-kokoro", [_delete(f"{M}/kokoro"), _delete(f"{M}/kokoro")], {}, True),
    ("pull", [_post("/api/pull/test-tiny"), _get("/api/ps"), _post("/api/pull/nope-model")], {}, False),
    ("tts-models", [_get("/v1/audio/models")], {}, False),
    ("tts-models-loaded", [_get("/v1/audio/models")], {}, True),
    ("tts-load", [_post("/v1/audio/models/load", {}), _post("/v1/audio/models/load", {"model": "kokoro"}),
                  _post("/v1/audio/models/load"), _post("/v1/audio/models/load", {"model": 5}),
                  ("POST", "/v1/audio/models/load", None, {"data": b"{bad",
                                                           "headers": {"Content-Type": "application/json"}}),
                  _get("/v1/audio/models")], {}, True),
    ("tts-unload", [_post("/v1/audio/models/unload", {"model": "kokoro"}),
                    _post("/v1/audio/models/unload", {"model": "kokoro"}), _post("/v1/audio/models/unload"),
                    _post("/v1/audio/models/unload", {"model": []}), _get("/v1/audio/models")], {}, True),
    ("tts-off", [_get("/v1/audio/models"), _post("/v1/audio/models/load"), _post("/v1/audio/models/unload"),
                 _get("/v1/audio/voices")], {"tts_enabled": False}, False),
    ("voices", [_get("/v1/audio/voices"), _get("/v1/audio/voices?model=kokoro"),
                _get("/v1/audio/voices?model=kokoro/v1"), _get("/v1/audio/voices?model=piper")], {}, False),
    ("methods", [_get(f"{M}/{MODEL}"), _get("/api/pull/x"), _post("/api/ps"), _get("/api/profiler/start"),
                 _delete(M)], {}, False),
]

# the statuses both apps answer each case's calls with
ROUTE_STATUS = {
    "ps": [200], "ps-load-unload": [200, 200, 200, 404, 200], "ps-load-unknown": [500, 200],
    "models": [200], "models-kokoro-loaded": [200], "tts-capabilities": [200] * 3,
    "tts-capabilities-off": [404], "status-progress": [200] * 7, "load": [200] * 6,
    "load-loaded": [200, 200], "load-default": [200, 200], "load-kokoro": [200, 200],
    "load-provider-missing": [400, 200], "load-piper": [200] * 10, "load-failed": [500, 200, 200],
    "download": [200] * 5, "download-loaded": [200, 200], "prefetch": [200, 200],
    "download-failed": [400, 200], "unload": [200, 404, 200, 200], "unload-kokoro": [200, 404],
    "pull": [200, 200, 500], "tts-models": [200], "tts-models-loaded": [200],
    "tts-load": [200, 200, 200, 422, 200, 200], "tts-unload": [200, 404, 404, 422, 200],
    "tts-off": [404] * 4, "voices": [200] * 4, "methods": [405] * 5,
}


@pytest.mark.parametrize("name,calls,changed,kokoro", ROUTE_CASES, ids=[c[0] for c in ROUTE_CASES])
def test_management_routes_match_the_jax_app(served, name, calls, changed, kokoro):
    trouter, tts, change, kokoro_loaded = served
    change(**changed)
    if kokoro:
        kokoro_loaded()
    answers = _ask_both(trouter, calls, tts_router=tts)
    for jax, port in answers:
        _same_stamped(jax, port)
    assert [port[0] for _, port in answers] == ROUTE_STATUS[name]


def test_a_failed_tts_load_is_a_500_on_both(served, monkeypatch):
    trouter, tts, _, _ = served

    def boom(model_id="kokoro"):
        raise RuntimeError("disk gone")

    monkeypatch.setattr(JAPP.tts_router.get_backend("kokoro"), "load_model", boom)
    monkeypatch.setattr(tts.get_backend("kokoro"), "load_model", boom)
    [(jax, port)] = _ask_both(trouter, [_post("/v1/audio/models/load")], tts_router=tts)
    _same(jax, port)
    assert port[0] == 500 and json.loads(port[2])["error"]["message"] == "disk gone"


def _cache_root(root: Path) -> None:
    """An HF-style cache: a whisper snapshot, and a non-whisper repo."""
    snap = root / "models--openai--whisper-tiny" / "snapshots" / "abc"
    snap.mkdir(parents=True)
    (snap / "config.json").write_bytes(b"{}" * 600_000)
    (root / "models--someorg--not-a-whisper").mkdir()


def test_artifact_routes_match_the_jax_app(served, monkeypatch, tmp_path):
    """Listing and deleting a cached checkpoint, each app on a cache root of
    its own (``STT_MODEL_DIR`` under ``tmp_path``); paths compared relative
    to the root. Deletion touches nothing outside the root."""
    trouter, tts, _, _ = served
    roots = {"jax": tmp_path / "jax", "torch": tmp_path / "torch"}
    outside = tmp_path / "outside"
    outside.mkdir()
    for s, root in ((jax_settings, roots["jax"]), (torch_settings, roots["torch"])):
        _cache_root(root)
        (root / "nope").symlink_to(outside)  # a link out of the root is not followed
        monkeypatch.setattr(s, "stt_model_dir", str(root))
    calls = [_get(f"{M}/openai/whisper-tiny/status"), _get(M),
             _delete(f"{M}/openai/whisper-tiny/artifacts"), _delete(f"{M}/openai/whisper-tiny/artifacts"),
             _get(f"{M}/openai/whisper-tiny/status"), _delete(f"{M}/nope/artifacts")]
    answers = _ask_both(trouter, calls, tts_router=tts)
    for jax, port in answers:
        (js, jh, jbody), (ts, th, tbody) = jax, port
        jbody = jbody.replace(str(roots["jax"]).encode(), b"<root>")
        tbody = tbody.replace(str(roots["torch"]).encode(), b"<root>")
        _same_stamped((js, jh, jbody), (ts, th, tbody))
    status, _, body = answers[0][1]
    assert json.loads(body)["state"] == "downloaded" and json.loads(body)["size_mb"] == 1
    assert json.loads(answers[2][1][2])["status"] == "deleted"
    assert json.loads(answers[3][1][2])["status"] == "not_found"
    assert json.loads(answers[4][1][2])["state"] == "provider_installed"
    assert outside.is_dir() and (roots["torch"] / "models--someorg--not-a-whisper").is_dir()


def test_profiler_guards_match_the_jax_app(served, tmp_path):
    """409 without a trace, a start, 409 on a second start, a stop, 409
    again. The port records the CPU here (its routers are on the CPU): the
    trace it writes holds no device event."""
    trouter, tts, _, _ = served
    trace_dir = str(tmp_path / "trace")
    calls = [_post("/api/profiler/stop"), _post("/api/profiler/start", {"dir": trace_dir}),
             _post("/api/profiler/start", {"dir": trace_dir}), _post("/api/profiler/start"),
             _post("/api/profiler/stop"), _post("/api/profiler/stop")]
    answers = _ask_both(trouter, calls, tts_router=tts)
    for jax, port in answers:
        _same(jax, port)
    assert [port[0] for _, port in answers] == [409, 200, 409, 409, 200, 409]
    [trace] = Path(trace_dir).glob("open_speech_*.pt.trace.json")
    events = json.loads(trace.read_text())["traceEvents"]
    assert not [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]


def test_profiler_on_the_card_requires_device_activity(served, monkeypatch):
    """Routers on the card and a profiler that cannot record CUDA: the start
    fails with 500 and leaves no trace running."""
    trouter, tts, _, _ = served
    monkeypatch.setattr(TAPP, "_on_card", lambda app: True)
    monkeypatch.setattr("torch.profiler.supported_activities",
                        lambda: {__import__("torch").profiler.ProfilerActivity.CPU})

    async def run():
        app = TAPP.create_app(stt_router=trouter, tts_router=tts)
        from open_speech_tpu_torch.server.http import serve_app
        import aiohttp

        server = await serve_app(app, "127.0.0.1", 0)
        try:
            async with aiohttp.ClientSession() as session:
                out = []
                for path in ("/api/profiler/start", "/api/profiler/stop"):
                    async with session.post(f"http://127.0.0.1:{server.port}{path}") as resp:
                        out.append((resp.status, await resp.json()))
                return out, dict(app["profiler"])
        finally:
            await server.close()
            await app.cleanup()

    (start, stop), state = asyncio.run(run())
    assert start == (500, {"error": {
        "message": "Failed to start trace: this torch build's profiler cannot record CUDA activity",
        "code": "http_error"}})
    assert stop[0] == 409 and state == {}
