"""The application and its routes.

Counterpart of ``open_speech_tpu/server/app.py``, all 58 of its routes, on
the port's own HTTP shell (``server/http.py``; the card's machine has no
aiohttp and no pydantic):

- ``POST /v1/audio/transcriptions`` and ``/v1/audio/translations``;
- ``GET /v1/models``, ``GET /v1/models/{model}`` and ``GET /health``;
- ``GET /v1/audio/stream``, the streaming session's WebSocket;
- ``GET /v1/realtime``, the OpenAI Realtime socket (``server/realtime/``);
- ``POST /v1/audio/speech``, whole or with ``?stream=true`` in chunked
  transfer whose headers wait for the first chunk, and ``POST
  /v1/audio/speech/clone`` (multipart: the text, the model and a
  ``reference_audio`` file part or a ``voice_library_ref``);
- model management: the legacy ``/api/ps`` routes, ``/api/models`` and its
  per-model ``status``, ``progress``, ``load``, ``download``, ``prefetch``,
  ``artifacts`` and unload, ``/api/pull/{model}``,
  ``/api/tts/capabilities``, ``/v1/audio/models`` (list, load, unload) and
  ``/v1/audio/voices``, through ``runtime/model_manager.py``;
- serving metrics: ``GET /metrics`` (Prometheus text) and ``GET
  /api/stats`` (JSON), from ``server/metrics.py``'s counters, which the
  transcription and speech routes record;
- ``POST /api/profiler/start`` and ``/api/profiler/stop``: a
  ``torch.profiler`` trace of the whole process, CUDA kernels included when
  the routers are on the card, written as a Chrome trace into ``dir`` (or
  ``OS_PROFILE_DIR``);
- the Studio (``studio/``): the voice library (``/api/voices/library``),
  ``/api/voice-presets`` (``TTS_VOICES_CONFIG``'s YAML or the defaults),
  profiles, history, conversations (rendered turn by turn through the
  app's ``TTSRouter`` by ``_synthesize_array``, on the loop's executor) and
  the composer, and the web UI (``/web``, ``/static``).

Each handler keeps the JAX handler's order of checks, status codes,
messages and content types. Model calls, an upload's ingest, renders and
each pull of a speech stream run in the loop's executor, so a
transcription never blocks the loop that answers ``/health`` or a socket.
The routers are the app's (``create_app(stt_router=, tts_router=)``; by
default new ones on the settings' devices, the card unless the settings
say ``cpu``), and so are the model manager, the lock that model operations
take, the download progress, the profiler's state and the Studio's state:
its SQLite store, managers, voice library and TTS cache, made from the
settings of the moment ``create_app`` runs. The startup creates the
Studio's tables and starts the TTL/LRU lifecycle
(``runtime/lifecycle.py``) over the routers, and with
``TTS_CACHE_ENABLED`` the cache's 30 s size sweep; with
``OS_WYOMING_ENABLED`` it also opens the Wyoming TCP server
(``server/wyoming/``) on the same routers. The cleanup stops them.

With ``OS_HISTORY_ENABLED`` (on by default) a transcription (not a
translation) and a speech request, whole or streamed, each write a history
row; a failure to log is logged and swallowed. ``POST /v1/audio/speech``
serves a stored whole body with ``X-Cache: HIT`` under
``TTS_CACHE_ENABLED`` unless ``?cache=false`` (``runtime/speech.py``).

A transcription with ``diarize=true`` (and ``STT_DIARIZE_ENABLED``) also
runs the shared diarizer (``diarization.py``) on the preprocessed upload
and answers ``{"text", "segments"}`` with the words spread over the
speaker turns, whatever the ``response_format``.

Scale-out (``parallel/``): ``main`` joins the process group that
``OS_DIST_*`` describes before it builds the app, and ``/api/stats``
reports this process's replica. Data replicas serve on their own. Under a
model axis greater than 1 (``OS_TPU_MESH="d,m"``, m > 1) each model
group's coordinate-0 rank serves and the others follow its model calls
(``parallel/serving.py``); ``create_app`` refuses such a mesh with
``ModelAxisServingError`` unless its STT router runs on that leader.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import dataclasses
import functools
import inspect
import logging
import os
import time
from pathlib import Path

import numpy as np

from open_speech_tpu_torch import __version__
from open_speech_tpu_torch.audio.encode import encode_audio
from open_speech_tpu_torch.audio.postprocessing import process_tts_chunks
from open_speech_tpu_torch.cache.tts_cache import TTSCache
from open_speech_tpu_torch.config import settings
from open_speech_tpu_torch.runtime.batcher_pool import pool_stats, shutdown_batchers
from open_speech_tpu_torch.runtime.lifecycle import ModelLifecycleManager
from open_speech_tpu_torch.runtime.model_manager import (
    ModelLifecycleError,
    ModelManager,
    ModelState,
)
from open_speech_tpu_torch.runtime.router import (
    BackendRouter,
    backend_format,
    prepare_upload,
    render_result,
    transcription_body,
)
from open_speech_tpu_torch.runtime.pocket_batcher import pocket_batcher_stats, reset_pocket_batchers
from open_speech_tpu_torch.runtime.speech import SpeechError, feature_error, get_content_type, speech_response
from open_speech_tpu_torch.runtime.tts_batcher import reset_tts_batchers, tts_batcher_stats
from open_speech_tpu_torch.schemas import HealthResponse, ModelListResponse, ModelObject
from open_speech_tpu_torch.server.errors import ApiError, error_middleware
from open_speech_tpu_torch.server.http import (
    Application,
    Request,
    Response,
    StreamResponse,
    json_response,
    run_app,
)
from open_speech_tpu_torch.server.metrics import metrics
from open_speech_tpu_torch.server.middleware import (
    make_rate_limiter,
    security_middleware,
    verify_ws_api_key,
    verify_ws_origin,
)
from open_speech_tpu_torch.server.realtime.server import realtime_endpoint
from open_speech_tpu_torch.server.streaming import _active_sessions, streaming_endpoint
from open_speech_tpu_torch.server.websocket import WebSocketResponse
from open_speech_tpu_torch.studio.composer import MultiTrackComposer
from open_speech_tpu_torch.studio.conversation import ConversationManager
from open_speech_tpu_torch.studio.history import HistoryManager
from open_speech_tpu_torch.studio.profiles import ProfileManager
from open_speech_tpu_torch.studio.storage import Store
from open_speech_tpu_torch.studio.voice_library import VoiceLibraryManager, VoiceNotFoundError
from open_speech_tpu_torch.tts.backends.base import backend_sample_rate
from open_speech_tpu_torch.tts.router import TTSRouter

logger = logging.getLogger(__name__)

STATIC_DIR = Path(__file__).parent.parent / "static"


async def _in_executor(fn, *args, **kwargs):
    return await asyncio.get_running_loop().run_in_executor(
        None, functools.partial(fn, *args, **kwargs))


# ── request helpers ────────────────────────────────────────────────────


def _q(request: Request, name: str, default=None, cast=str):
    raw = request.query.get(name)
    if raw is None:
        return default
    if cast is bool:
        return raw.strip().lower() in ("1", "true", "yes", "on")
    try:
        return cast(raw)
    except (TypeError, ValueError):
        raise ApiError(422, f"Invalid value for query param '{name}': {raw!r}",
                       "validation_error")


def _form_float(form: dict, name: str, default: float) -> float:
    """Form-field float with 422 on garbage (a client mistake, not a 500)."""
    raw = form.get(name)
    if raw in (None, ""):
        return default
    try:
        return float(raw)
    except (TypeError, ValueError):
        raise ApiError(422, f"Invalid value for form field '{name}': {raw!r}",
                       "validation_error")


async def _json_body(request: Request) -> dict:
    try:
        body = await request.json()
    except Exception:  # noqa: BLE001 — as the JAX app: any unreadable body (413 included) is a 422
        raise ApiError(422, "Invalid JSON body", "validation_error")
    if not isinstance(body, dict):
        raise ApiError(422, "Body must be a JSON object", "validation_error")
    return body


def _upload(form: dict) -> tuple[bytes, str, str]:
    """The ``file`` part of the form; 422 without one."""
    if "file" not in form or not isinstance(form["file"], tuple):
        raise ApiError(422, "Missing 'file' upload field", "validation_error")
    return form["file"]


def _check_size(audio_bytes: bytes) -> None:
    max_bytes = settings.os_max_upload_mb * 1024 * 1024
    if len(audio_bytes) > max_bytes:
        raise ApiError(413, f"Upload too large. Max: {settings.os_max_upload_mb}MB")
    if len(audio_bytes) == 0:
        raise ApiError(400, "Empty audio file")


def _body_response(body, content_type: str) -> Response:
    if isinstance(body, dict):
        return json_response(body)
    return Response(text=body, content_type=content_type)


# ── OpenAI STT endpoints ───────────────────────────────────────────────


async def transcribe(request: Request) -> Response:
    form = await request.post()
    audio_bytes, filename, content_type = _upload(form)
    model = str(form.get("model") or settings.stt_model)
    language = form.get("language") or None
    prompt = form.get("prompt") or None
    response_format = str(form.get("response_format") or "json")
    temperature = _form_float(form, "temperature", 0.0)
    diarize = _q(request, "diarize", False, bool) or str(
        form.get("diarize", "")
    ).lower() in ("1", "true")

    _check_size(audio_bytes)
    if diarize and not settings.stt_diarize_enabled:
        raise ApiError(400, "Diarization is disabled. Set STT_DIARIZE_ENABLED=true")

    router: BackendRouter = request.app["stt_router"]
    audio = await _in_executor(prepare_upload, router, model, audio_bytes, content_type)
    t_start = time.monotonic()
    try:
        result = await _in_executor(
            router.transcribe,
            audio=audio,
            model=model,
            language=language,
            response_format=backend_format(response_format),
            temperature=temperature,
            prompt=prompt,
            # quality path: REST requests decode with the reference's
            # beam-5 default; streaming sessions stay greedy
            beam_size=settings.stt_rest_beam_size,
        )
    except ValueError as e:
        # unknown model id: 404 with a stable code, as the JAX route answers
        metrics.inc("stt_errors_total")
        raise ApiError(404, str(e), "model_not_found")
    except Exception as e:  # noqa: BLE001 — any other model failure is the server's
        metrics.inc("stt_errors_total")
        logger.exception("Transcription failed")
        raise ApiError(500, str(e))
    metrics.record_stt(
        audio_seconds=float(result.get("duration", 0.0) or 0.0),
        wall_seconds=time.monotonic() - t_start,
    )
    if settings.os_history_enabled:
        try:
            request.app["history"].log_stt(model=model, input_filename=filename or "",
                                           result_text=result.get("text", ""))
        except Exception:  # noqa: BLE001 — as the JAX route: history never fails a request
            logger.exception("Failed to log STT history entry")
    if diarize:
        from open_speech_tpu_torch.diarization import Diarizer, attach_text_to_speakers

        try:
            diarizer = Diarizer()
            dsegs = await _in_executor(diarizer.diarize, audio)
        except RuntimeError as e:
            raise ApiError(400, str(e))
        except Exception as e:  # noqa: BLE001 — as the JAX route answers it
            raise ApiError(500, f"Diarization failed: {e}")
        text = result.get("text", "")
        return json_response({"text": text, "segments": attach_text_to_speakers(text, dsegs)})
    return _body_response(*transcription_body(result, response_format))


async def translate(request: Request) -> Response:
    form = await request.post()
    audio_bytes, _filename, content_type = _upload(form)
    model = str(form.get("model") or settings.stt_model)
    prompt = form.get("prompt") or None
    response_format = str(form.get("response_format") or "json")
    temperature = _form_float(form, "temperature", 0.0)

    _check_size(audio_bytes)
    router: BackendRouter = request.app["stt_router"]
    audio = await _in_executor(prepare_upload, router, model, audio_bytes, content_type)
    try:
        result = await _in_executor(
            router.translate,
            audio=audio,
            model=model,
            response_format=response_format,
            temperature=temperature,
            prompt=prompt,
        )
    except ValueError as e:
        raise ApiError(404, str(e), "model_not_found")
    except Exception as e:  # noqa: BLE001 — any other model failure is the server's
        logger.exception("Translation failed")
        raise ApiError(500, str(e))
    return _body_response(*render_result(result))


# ── OpenAI models endpoints, health ────────────────────────────────────


async def list_models(request: Request) -> Response:
    loaded = request.app["stt_router"].loaded_models()
    models = [
        ModelObject(id=m.model, owned_by=f"open-speech/{m.backend}")
        for m in loaded
    ]
    loaded_ids = {m.model for m in loaded}
    if settings.stt_model not in loaded_ids:
        models.append(ModelObject(id=settings.stt_model))
    if settings.tts_enabled:
        tts_loaded = request.app["tts_router"].loaded_models()
        tts_loaded_ids = {m.model for m in tts_loaded}
        for m in tts_loaded:
            models.append(
                ModelObject(id=m.model, owned_by=f"open-speech/{m.backend}")
            )
        if settings.tts_model not in tts_loaded_ids:
            models.append(
                ModelObject(id=settings.tts_model, owned_by="open-speech/tts")
            )
    return json_response(ModelListResponse(data=models).model_dump())


async def get_model(request: Request) -> Response:
    return json_response(ModelObject(id=request.match_info["model"]).model_dump())


async def health(request: Request) -> Response:
    loaded = request.app["stt_router"].loaded_models()
    return json_response(
        HealthResponse(version=__version__, models_loaded=len(loaded)).model_dump()
    )


# ── legacy management ──────────────────────────────────────────────────


async def list_loaded_models(request: Request) -> Response:
    models = request.app["stt_router"].loaded_models()
    return json_response({"models": [dataclasses.asdict(m) for m in models]})


async def load_model_legacy(request: Request) -> Response:
    model = request.match_info["model"]
    router = request.app["stt_router"]
    for m in router.loaded_models():
        if m.model != model:
            try:
                router.unload_model(m.model)
            except Exception as e:  # noqa: BLE001 — as the JAX route: the load goes on
                logger.warning("Failed to auto-unload %s: %s", m.model, e)
    try:
        await _in_executor(router.load_model, model)
    except Exception as e:  # noqa: BLE001 — any load failure is a 500, as in the JAX route
        logger.exception("Failed to load model %s", model)
        raise ApiError(500, str(e))
    return json_response({"status": "loaded", "model": model})


async def unload_model_legacy(request: Request) -> Response:
    model = request.match_info["model"]
    router = request.app["stt_router"]
    if not router.is_model_loaded(model):
        raise ApiError(404, f"Model {model} is not loaded")
    router.unload_model(model)
    return json_response({"status": "unloaded", "model": model})


# ── unified management ─────────────────────────────────────────────────


def _tts_backend_name(app: Application, model_id: str) -> str:
    return getattr(app["tts_router"].get_backend(model_id), "name", model_id)


def _tts_capabilities(app: Application, model_id: str) -> dict:
    return dict(getattr(app["tts_router"].get_backend(model_id), "capabilities", {}))


async def list_all_models(request: Request) -> Response:
    models = [m.to_dict() for m in request.app["model_manager"].list_all()]
    for model in models:
        if model.get("type") == "tts":
            try:
                model["capabilities"] = _tts_capabilities(request.app, model["id"])
            except Exception:  # noqa: BLE001 — a listing never fails on one row
                model["capabilities"] = {}
    return json_response({"models": models})


async def get_tts_capabilities_route(request: Request) -> Response:
    if not settings.tts_enabled:
        raise ApiError(404, "TTS is disabled")
    model_id = request.query.get("model") or settings.tts_model
    return json_response({
        "backend": _tts_backend_name(request.app, model_id),
        "capabilities": _tts_capabilities(request.app, model_id),
    })


async def get_model_status(request: Request) -> Response:
    app, model_id = request.app, request.match_info["model_id"]
    result = app["model_manager"].status(model_id).to_dict()
    async with app["download_progress_lock"]:
        prog = app["download_progress"].get(model_id)
        if prog and prog.get("status") in ("downloaded", "ready"):
            # terminal entries are one-shot: dropping them here keeps the
            # overlay from overriding the real state forever
            app["download_progress"].pop(model_id, None)
    if prog:
        prog_status = prog.get("status", "")
        if prog_status in ("queued", "downloading", "loading"):
            result["state"] = prog_status
        elif prog_status in ("downloaded", "ready"):
            if result.get("state") != "loaded":
                result["state"] = "downloaded"
        result["progress"] = prog.get("progress", 0)
    return json_response(result)


async def get_model_progress(request: Request) -> Response:
    app, model_id = request.app, request.match_info["model_id"]
    async with app["download_progress_lock"]:
        if model_id in app["download_progress"]:
            return json_response(app["download_progress"][model_id])
    if app["model_manager"].status(model_id).state == ModelState.LOADED:
        return json_response({"status": "ready", "progress": 1.0})
    return json_response({"status": "idle", "progress": 0.0})


async def _set_progress(app: Application, model_id: str, entry: dict | None) -> None:
    async with app["download_progress_lock"]:
        if entry is None:
            app["download_progress"].pop(model_id, None)
        else:
            app["download_progress"][model_id] = entry


async def load_model_unified(request: Request) -> Response:
    app, model_id = request.app, request.match_info["model_id"]
    await _set_progress(app, model_id, {"status": "queued", "progress": 0.0})
    async with app["model_lock"]:
        await _set_progress(app, model_id, {"status": "loading", "progress": 0.5})
        try:
            info = await _in_executor(app["model_manager"].load, model_id)
            await _set_progress(app, model_id, {"status": "ready", "progress": 1.0})
        except ModelLifecycleError as e:
            await _set_progress(app, model_id, None)
            # load_failed wraps backend faults (out of memory, disk, a bad
            # checkpoint): the server's failure, not the client's
            status = 500 if e.code == "load_failed" else 400
            raise ApiError(status, {"message": e.message, "code": e.code})
        except Exception as e:  # noqa: BLE001 — any other failure is the server's
            await _set_progress(app, model_id, None)
            logger.exception("Failed to load model %s", model_id)
            raise ApiError(500, {"message": str(e), "code": "load_failed", "model": model_id})
    return json_response(info.to_dict())


async def download_model_unified(request: Request) -> Response:
    app, model_id = request.app, request.match_info["model_id"]
    await _set_progress(app, model_id, {"status": "queued", "progress": 0.0})
    async with app["model_lock"]:
        await _set_progress(app, model_id, {"status": "downloading", "progress": 0.1})
        try:
            info = await _in_executor(app["model_manager"].download, model_id)
            await _set_progress(app, model_id, {"status": "downloaded", "progress": 1.0})
            return json_response(info.to_dict())
        except ModelLifecycleError as e:
            await _set_progress(app, model_id, None)
            raise ApiError(400, {"message": e.message, "code": e.code})
        except Exception as e:  # noqa: BLE001 — any other failure is the server's
            await _set_progress(app, model_id, None)
            logger.exception("Failed to download model %s", model_id)
            raise ApiError(500, {"message": str(e), "code": "download_failed", "model": model_id})


async def unload_model_unified(request: Request) -> Response:
    app, model_id = request.app, request.match_info["model_id"]
    if app["model_manager"].status(model_id).state != ModelState.LOADED:
        raise ApiError(404, {"message": f"Model {model_id} is not loaded",
                             "code": "not_loaded", "model": model_id})
    async with app["model_lock"]:
        app["model_manager"].unload(model_id)
    return json_response({"status": "unloaded", "model": model_id})


async def delete_model_artifacts(request: Request) -> Response:
    async with request.app["model_lock"]:
        result = request.app["model_manager"].delete_artifacts(request.match_info["model_id"])
    return json_response(result)


async def pull_model(request: Request) -> Response:
    model = request.match_info["model"]
    router = request.app["stt_router"]
    try:
        await _in_executor(router.load_model, model)
        router.unload_model(model)
    except Exception as e:  # noqa: BLE001 — any failure is a 500, as in the JAX route
        logger.exception("Failed to pull model %s", model)
        raise ApiError(500, str(e))
    return json_response({"status": "downloaded", "model": model})


# ── TTS models and voices ──────────────────────────────────────────────


async def _tts_model_id(request: Request, schema: str) -> str:
    """The ``model`` of a /v1/audio/models load or unload body, checked as
    the JAX route's pydantic model checks it; the configured default when
    the body leaves it out, is empty, or is not JSON."""
    body = {}
    if request.can_read_body:
        try:
            body = await request.json()
        except Exception:  # noqa: BLE001 — as the JAX route: an unreadable body is no body
            body = {}
    if not isinstance(body, dict):
        raise ApiError(422, "Body must be a JSON object", "validation_error")
    if "model" not in body:
        return settings.tts_model
    if not isinstance(body["model"], str):
        raise ApiError(422, f"1 validation error for {schema}\nmodel\n  Input should be a valid string",
                       "validation_error")
    return body["model"]


async def load_tts_model(request: Request) -> Response:
    if not settings.tts_enabled:
        raise ApiError(404, "TTS is disabled")
    model_id = await _tts_model_id(request, "ModelLoadRequest")
    router = request.app["tts_router"]
    for m in router.loaded_models():
        if m.model != model_id:
            try:
                router.unload_model(m.model)
            except Exception as e:  # noqa: BLE001 — as the JAX route: the load goes on
                logger.warning("Failed to auto-unload TTS model %s: %s", m.model, e)
    try:
        await _in_executor(router.load_model, model_id)
    except Exception as e:  # noqa: BLE001 — any load failure is a 500, as in the JAX route
        logger.exception("Failed to load TTS model %s", model_id)
        raise ApiError(500, str(e))
    return json_response({"status": "loaded", "model": model_id})


async def unload_tts_model(request: Request) -> Response:
    if not settings.tts_enabled:
        raise ApiError(404, "TTS is disabled")
    model_id = await _tts_model_id(request, "ModelUnloadRequest")
    router = request.app["tts_router"]
    if not router.is_model_loaded(model_id):
        raise ApiError(404, f"TTS model {model_id} is not loaded")
    router.unload_model(model_id)
    return json_response({"status": "unloaded", "model": model_id})


async def list_tts_models(request: Request) -> Response:
    if not settings.tts_enabled:
        raise ApiError(404, "TTS is disabled")
    loaded = request.app["tts_router"].loaded_models()
    models = [
        {"model": m.model, "backend": m.backend, "device": m.device, "status": "loaded",
         "loaded_at": m.loaded_at, "last_used_at": m.last_used_at}
        for m in loaded
    ]
    if settings.tts_model not in {m.model for m in loaded}:
        models.append({"model": settings.tts_model, "backend": "kokoro", "status": "not_loaded"})
    return json_response({"models": models})


async def list_voices(request: Request) -> Response:
    if not settings.tts_enabled:
        raise ApiError(404, "TTS is disabled")
    model = request.query.get("model")
    router = request.app["tts_router"]
    if model:
        voices = router.list_voices(model.split("/")[0] if "/" in model else model)
    else:
        voices = router.list_voices()
    return json_response({"voices": [
        {"id": v.id, "name": v.name, "language": v.language, "gender": v.gender}
        for v in voices
    ]})


# ── metrics and stats ──────────────────────────────────────────────────


async def metrics_route(request: Request) -> Response:
    metrics.set_gauge("streaming_sessions_active", len(_active_sessions))
    for key, stats in pool_stats().items():
        metrics.set_gauge(f'batch_occupancy{{batcher="{key}"}}', stats["occupancy"])
    return Response(text=metrics.prometheus(), content_type="text/plain")


async def stats_route(request: Request) -> Response:
    snap = metrics.snapshot()
    snap["gauges"]["streaming_sessions_active"] = len(_active_sessions)
    snap["streaming_sessions"] = [
        {
            "id": s.session_id[:8],
            "model": s.model,
            "language": s.language,
            "detected_language": s._detected_language,
            "transcriptions": s._transcription_count,
            "interims_coalesced": s._interims_coalesced,
            "errors": s._error_count,
        }
        for s in list(_active_sessions.values())
    ]
    snap["batchers"] = pool_stats()
    snap["tts_batchers"] = tts_batcher_stats()
    snap["pocket_batchers"] = pocket_batcher_stats()
    from open_speech_tpu_torch.parallel.distributed import replica_info

    snap["replica"] = replica_info()
    return json_response(snap)


# ── the profiler ───────────────────────────────────────────────────────


def _on_card(app: Application) -> bool:
    import torch

    devices = (getattr(getattr(app["stt_router"], "_default_backend", None), "device", None),
               getattr(app["tts_router"], "_device", None))
    return any(d is not None and torch.device(d).type == "cuda" for d in devices)


def _start_trace(trace_dir: str, on_card: bool):
    """A started ``torch.profiler.profile``: CPU activity (of the thread
    that starts it), and with ``on_card`` every CUDA kernel of the process;
    a profiler that cannot record the card raises."""
    from torch.profiler import ProfilerActivity, profile, supported_activities

    activities = [ProfilerActivity.CPU]
    if on_card:
        if ProfilerActivity.CUDA not in supported_activities():
            raise RuntimeError("this torch build's profiler cannot record CUDA activity")
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    return prof


def _stop_trace(prof, trace_dir: str) -> None:
    prof.stop()
    prof.export_chrome_trace(os.path.join(trace_dir, f"open_speech_{time.time_ns()}.pt.trace.json"))


async def profiler_start(request: Request) -> Response:
    body = await request.json() if request.can_read_body else {}
    trace_dir = body.get("dir") or settings.os_profile_dir
    state = request.app["profiler"]
    # reserve the slot before the executor await: the guard and the
    # reservation must not straddle a suspension point, or two concurrent
    # starts would both reach the profiler
    if state:
        raise ApiError(409, "A profiler trace is already running")
    # one thread starts and stops the trace: torch.profiler's state belongs
    # to the thread that started it
    state.update(dir=trace_dir, thread=concurrent.futures.ThreadPoolExecutor(1, "profiler"))
    try:
        state["prof"] = await asyncio.get_running_loop().run_in_executor(
            state["thread"], _start_trace, trace_dir, _on_card(request.app))
    except Exception as e:  # noqa: BLE001 — reported to the caller, as the JAX route does
        state.pop("thread").shutdown(wait=False)
        state.clear()
        raise ApiError(500, f"Failed to start trace: {e}")
    return json_response({"status": "tracing", "dir": trace_dir})


async def profiler_stop(request: Request) -> Response:
    state = request.app["profiler"]
    if "prof" not in state:
        raise ApiError(409, "No profiler trace is running")
    trace_dir = state["dir"]
    try:
        await asyncio.get_running_loop().run_in_executor(
            state["thread"], _stop_trace, state["prof"], trace_dir)
    except Exception as e:  # noqa: BLE001 — the state stays, so a retry can reach the profiler again
        raise ApiError(500, f"Failed to stop trace: {e}")
    state.pop("thread").shutdown(wait=False)
    state.clear()
    return json_response({"status": "stopped", "dir": trace_dir})


# ── the streaming WebSocket ────────────────────────────────────────────


async def ws_stream(request: Request):
    if request.headers.get("upgrade", "").lower() != "websocket":
        return json_response(
            {
                "error": {
                    "message": (
                        "/v1/audio/stream is a WebSocket endpoint. Connect "
                        "with ws:// or wss:// using a WebSocket client."
                    ),
                    "code": "websocket_upgrade_required",
                }
            },
            status=426,
            headers={"Upgrade": "websocket"},
        )
    ws = WebSocketResponse()
    await ws.prepare(request)
    if not verify_ws_origin(request):
        await ws.close(code=1008, message=b"Origin not allowed")
        return ws
    if not verify_ws_api_key(request):
        await ws.close(code=4001, message=b"Invalid or missing API key")
        return ws
    await streaming_endpoint(
        ws,
        request.app["stt_router"],
        model=request.query.get("model"),
        language=request.query.get("language"),
        sample_rate=_q(request, "sample_rate", 16000, int),
        encoding=request.query.get("encoding", "pcm_s16le"),
        interim_results=_q(request, "interim_results", True, bool),
        endpointing=_q(request, "endpointing", 300, int),
        vad=(
            _q(request, "vad", None, bool)
            if request.query.get("vad") is not None
            else None
        ),
    )
    return ws


# ── the realtime WebSocket ─────────────────────────────────────────────


async def ws_realtime(request: Request):
    if request.headers.get("upgrade", "").lower() != "websocket":
        raise ApiError(426, "/v1/realtime is a WebSocket endpoint")
    if not settings.os_realtime_enabled:
        ws = WebSocketResponse()
        await ws.prepare(request)
        await ws.close(code=4004, message=b"Realtime API is disabled")
        return ws
    ws = WebSocketResponse(protocols=("realtime",))
    await ws.prepare(request)
    if not verify_ws_origin(request):
        await ws.close(code=1008, message=b"Origin not allowed")
        return ws
    if not verify_ws_api_key(request):
        await ws.close(code=4001, message=b"Invalid or missing API key")
        return ws
    await realtime_endpoint(
        ws, request.app["stt_router"], request.app["tts_router"],
        model=request.query.get("model") or "",
    )
    return ws


# ── TTS ────────────────────────────────────────────────────────────────


async def synthesize_speech(request: Request):
    if not settings.tts_enabled:
        raise ApiError(404, "TTS is disabled")
    try:
        body = await request.json()
    except Exception:  # noqa: BLE001 — as the JAX route: any unreadable body (413 included) is a 422
        raise ApiError(422, "Invalid JSON body", "validation_error")
    stream = _q(request, "stream", False, bool)
    cache = _q(request, "cache", True, bool) and settings.tts_cache_enabled
    app = request.app
    timing: dict = {}
    t_start = time.monotonic()
    try:
        content_type, audio = await _in_executor(
            speech_response, app["tts_router"], body, stream=stream, timing=timing,
            cache=app["tts_cache"] if cache else None,
            history=app["history"] if settings.os_history_enabled else None)
    except SpeechError as e:
        raise ApiError(e.status, e.message, e.code)
    if timing.get("cache") == "HIT":
        return Response(body=audio, content_type=content_type, headers={"X-Cache": "HIT"})
    if not stream:
        now = time.monotonic()
        # time to first audio: the first synthesized chunk, as the JAX route times it
        metrics.record_tts(
            ttfa_seconds=timing.get("first_chunk", now) - t_start,
            audio_seconds=timing["audio_seconds"],
            wall_seconds=now - t_start,
        )
        return Response(body=audio, content_type=content_type)

    # the first chunk is already produced: an error before it was a real
    # error response (above); one after it aborts the transfer, so the
    # client sees truncation rather than a clean end of stream
    resp = StreamResponse(status=200, headers={"Content-Type": content_type})
    ttfa_s, sent_bytes = None, 0
    try:
        while True:
            try:
                chunk = await _in_executor(next, audio, None)
            except SpeechError as e:
                logger.error("Streaming TTS failed mid-stream: %s", e.message)
                if request.transport is not None:
                    request.transport.abort()
                raise ApiError(e.status, e.message, e.code)
            if chunk is None:
                break
            await resp.prepare(request)
            if ttfa_s is None:  # the headers and the first chunk go out now
                ttfa_s = time.monotonic() - t_start
            sent_bytes += len(chunk)
            await resp.write(chunk)  # raises once the client has left
    finally:
        # a client that left, or a failure, closes the iterator: synthesis
        # stops before its next sentence
        await _in_executor(audio.close)
    await resp.prepare(request)
    await resp.write_eof()
    if ttfa_s is not None:
        # audio seconds are known for raw PCM16 only; other formats report
        # 0, and the RTFx summary skips the sample (as in the JAX route)
        metrics.record_tts(
            ttfa_seconds=ttfa_s,
            audio_seconds=(sent_bytes / (timing["rate"] * 2)
                           if timing["format"] == "pcm" else 0.0),
            wall_seconds=time.monotonic() - t_start,
        )
    return resp


def _clone_body(router: TTSRouter, model: str, text: str, voice: str, speed: float, language, transcript,
                ref_bytes: bytes | None, response_format: str) -> bytes:
    """The clone route's synthesis: the backend called with the reference
    audio and the transcript where its ``synthesize`` takes them, trimmed
    and normalised, encoded whole."""
    backend = router.get_backend(model)
    kwargs: dict = dict(text=text, voice=voice, speed=speed, lang_code=language)
    params = inspect.signature(backend.synthesize).parameters
    if "reference_audio" in params:
        kwargs["reference_audio"] = ref_bytes
    if transcript and "clone_transcript" in params:
        kwargs["clone_transcript"] = transcript
    native = backend_sample_rate(backend, model)
    chunks = list(process_tts_chunks(backend.synthesize(**kwargs), trim=settings.tts_trim_silence,
                                     normalize=settings.tts_normalize_output))
    samples = np.concatenate(chunks) if chunks else np.zeros(0, np.float32)
    return encode_audio(samples, native, response_format)


async def clone_speech(request: Request) -> Response:
    if not settings.tts_enabled:
        raise ApiError(404, "TTS is disabled")
    form = await request.post()
    text = str(form.get("input") or "")
    if not text.strip():
        raise ApiError(400, "Input text is empty")
    model = str(form.get("model") or "kokoro")
    voice = str(form.get("voice") or "Ryan")
    speed = _form_float(form, "speed", 1.0)
    response_format = str(form.get("response_format") or "mp3")
    voice_library_ref = form.get("voice_library_ref") or None
    ref_bytes = None
    if voice_library_ref and "reference_audio" not in form:
        try:
            ref_bytes, _meta = request.app["voice_library"].get(str(voice_library_ref))
        except VoiceNotFoundError:
            raise ApiError(404, f"Voice library entry '{voice_library_ref}' not found")
    ref = form.get("reference_audio")
    if isinstance(ref, tuple):
        ref_bytes = ref[0]
    router = request.app["tts_router"]
    if ref_bytes is not None:
        rejected = feature_error(router, model, reference_audio=b"provided")
        if rejected:
            raise ApiError(400, rejected)
        if len(ref_bytes) > settings.os_max_upload_mb * 1024 * 1024:
            raise ApiError(413, f"Upload too large. Max: {settings.os_max_upload_mb}MB")
        if len(ref_bytes) == 0:
            raise ApiError(400, "Reference audio is empty")
    content_type = get_content_type(response_format)
    try:
        body = await _in_executor(_clone_body, router, model, text, voice, speed,
                                  form.get("language") or None, form.get("transcript") or None,
                                  ref_bytes, response_format)
    except Exception as e:  # noqa: BLE001 — any synthesis failure is a 500, as in the JAX route
        logger.exception("Voice cloning synthesis failed")
        raise ApiError(500, str(e))
    return Response(body=body, content_type=content_type)


# ── the Studio's synthesis ─────────────────────────────────────────────


def _synthesize_array(router: TTSRouter, *, text, model, voice, speed, sample_rate=24000,
                      language=None) -> np.ndarray:
    """Synthesize to a float array AT ``sample_rate``: callers (the
    conversation render) encode the result at that rate, so the backend's
    native rate (Kokoro 24 kHz, Piper 22.05 kHz) is resampled, on the
    backend's device, not relabelled."""
    from open_speech_tpu_torch.ops.resample import resample_poly

    chunks = list(process_tts_chunks(
        router.synthesize(text=text, model=model, voice=voice, speed=speed, lang_code=language),
        trim=settings.tts_trim_silence, normalize=settings.tts_normalize_output))
    if not chunks:
        return np.zeros(0, dtype=np.float32)
    audio = np.concatenate(chunks).astype(np.float32, copy=False)
    backend = router.get_backend(model)
    native = backend_sample_rate(backend, model)
    if native != sample_rate and audio.size:
        import torch

        device = getattr(backend, "device", router._device)
        with torch.inference_mode():
            audio = resample_poly(torch.from_numpy(audio).to(device), sample_rate, native).cpu().numpy()
    return audio


# ── voice library ──────────────────────────────────────────────────────


async def upload_voice(request: Request) -> Response:
    form = await request.post()
    if "name" not in form or "audio" not in form or not isinstance(form["audio"], tuple):
        raise ApiError(422, "Fields 'name' and 'audio' are required", "validation_error")
    audio_bytes, _fn, content_type = form["audio"]
    if len(audio_bytes) > settings.os_max_upload_mb * 1024 * 1024:
        raise ApiError(413, f"Voice file too large. Max: {settings.os_max_upload_mb}MB")
    try:
        meta = request.app["voice_library"].save(str(form["name"]), audio_bytes,
                                                 content_type or "audio/wav")
    except ValueError as e:
        raise ApiError(422, str(e))
    return json_response(meta, status=201)


async def list_library_voices(request: Request) -> Response:
    return json_response(request.app["voice_library"].list_voices())


async def get_library_voice_meta(request: Request) -> Response:
    name = request.match_info["name"]
    try:
        _, meta = request.app["voice_library"].get(name)
    except VoiceNotFoundError:
        raise ApiError(404, f"Voice '{name}' not found")
    return json_response(meta)


async def delete_library_voice(request: Request) -> Response:
    name = request.match_info["name"]
    try:
        request.app["voice_library"].delete(name)
    except VoiceNotFoundError:
        raise ApiError(404, f"Voice '{name}' not found")
    return Response(status=204)


# ── voice presets ──────────────────────────────────────────────────────

DEFAULT_VOICE_PRESETS = [
    {
        "name": "Will",
        "voice": "am_puck(1)+am_liam(1)+am_onyx(0.5)",
        "speed": 1.2,
        "description": "Dry wit genius blend — Puck + Liam + Onyx",
    },
    {
        "name": "Female",
        "voice": "af_jessica(1)+af_heart(1)",
        "speed": 1.2,
        "description": "Warm female blend — Jessica + Heart",
    },
    {
        "name": "British Butler",
        "voice": "bm_george",
        "speed": 0.9,
        "description": "Refined British male",
    },
]


def _load_voice_presets() -> list[dict]:
    """The presets of the YAML file that ``TTS_VOICES_CONFIG`` names (read
    from the environment per request, as the JAX app reads it), or the
    defaults when it is unset, absent or unreadable."""
    import yaml  # outside the try: a missing PyYAML is an error, not the defaults

    config_path = os.environ.get("TTS_VOICES_CONFIG")
    if config_path and Path(config_path).exists():
        try:
            with open(config_path) as f:
                data = yaml.safe_load(f)
            if isinstance(data, dict) and "presets" in data:
                return data["presets"]
            if isinstance(data, list):
                return data
        except Exception as e:  # noqa: BLE001 — as the JAX app: a bad file serves the defaults
            logger.warning("Failed to load voice presets from %s: %s", config_path, e)
    return DEFAULT_VOICE_PRESETS


async def get_voice_presets(request: Request) -> Response:
    return json_response({"presets": _load_voice_presets()})


# ── studio: profiles ───────────────────────────────────────────────────


def _profile_payload(body: dict) -> dict:
    if "name" not in body or "backend" not in body or "voice" not in body:
        raise ApiError(422, "Fields 'name', 'backend', 'voice' are required", "validation_error")
    return {
        "name": body["name"],
        "backend": body["backend"],
        "model": body.get("model"),
        "voice": body["voice"],
        "speed": float(body.get("speed", 1.0)),
        "format": body.get("format", "mp3"),
        "blend": body.get("blend"),
        "reference_audio_id": body.get("reference_audio_id"),
        "effects": body.get("effects") or [],
    }


async def create_profile(request: Request) -> Response:
    payload = _profile_payload(await _json_body(request))
    try:
        return json_response(request.app["profiles"].create(**payload), status=201)
    except ValueError as e:
        raise ApiError(409, str(e))


async def list_profiles(request: Request) -> Response:
    profiles = request.app["profiles"]
    default_profile = profiles.get_default()
    return json_response({
        "profiles": profiles.list_all(),
        "default_profile_id": default_profile["id"] if default_profile else None,
    })


async def get_profile(request: Request) -> Response:
    profile = request.app["profiles"].get(request.match_info["profile_id"])
    if not profile:
        raise ApiError(404, "Profile not found")
    return json_response(profile)


async def update_profile(request: Request) -> Response:
    payload = _profile_payload(await _json_body(request))
    try:
        return json_response(request.app["profiles"].update(request.match_info["profile_id"], **payload))
    except KeyError:
        raise ApiError(404, "Profile not found")
    except ValueError as e:
        raise ApiError(409, str(e))


async def delete_profile(request: Request) -> Response:
    if not request.app["profiles"].delete(request.match_info["profile_id"]):
        raise ApiError(404, "Profile not found")
    return Response(status=204)


async def set_profile_default(request: Request) -> Response:
    profile_id = request.match_info["profile_id"]
    profiles = request.app["profiles"]
    try:
        profiles.set_default(profile_id)
    except KeyError:
        raise ApiError(404, "Profile not found")
    return json_response({"profiles": profiles.list_all(), "default_profile_id": profile_id})


# ── studio: history ────────────────────────────────────────────────────


async def list_history(request: Request) -> Response:
    return json_response(request.app["history"].list_entries(
        type_filter=request.query.get("type"),
        limit=_q(request, "limit", 50, int),
        offset=_q(request, "offset", 0, int),
    ))


async def delete_history_entry(request: Request) -> Response:
    if not request.app["history"].delete_entry(request.match_info["entry_id"]):
        raise ApiError(404, "History entry not found")
    return Response(status=204)


async def clear_history(request: Request) -> Response:
    return json_response({"deleted": request.app["history"].clear_all()})


# ── studio: conversations ──────────────────────────────────────────────


async def create_conversation(request: Request) -> Response:
    body = await _json_body(request)
    if "name" not in body:
        raise ApiError(422, "Field 'name' is required", "validation_error")
    return json_response(request.app["conversations"].create(body["name"], body.get("turns") or []),
                         status=201)


async def list_conversations(request: Request) -> Response:
    return json_response(request.app["conversations"].list_all(
        limit=_q(request, "limit", 50, int),
        offset=_q(request, "offset", 0, int),
    ))


async def get_conversation(request: Request) -> Response:
    item = request.app["conversations"].get(request.match_info["conversation_id"])
    if not item:
        raise ApiError(404, "Conversation not found")
    return json_response(item)


async def add_conversation_turn(request: Request) -> Response:
    body = await _json_body(request)
    if "speaker" not in body or "text" not in body:
        raise ApiError(422, "Fields 'speaker' and 'text' are required", "validation_error")
    try:
        return json_response(request.app["conversations"].add_turn(
            conversation_id=request.match_info["conversation_id"],
            speaker=body["speaker"],
            text=body["text"],
            profile_id=body.get("profile_id"),
            effects=body.get("effects"),
        ), status=201)
    except KeyError:
        raise ApiError(404, "Conversation not found")


async def delete_conversation_turn(request: Request) -> Response:
    ok = request.app["conversations"].delete_turn(request.match_info["conversation_id"],
                                                  request.match_info["turn_id"])
    if not ok:
        raise ApiError(404, "Turn not found")
    return Response(status=204)


async def render_conversation(request: Request) -> Response:
    body = await _json_body(request)
    conversations = request.app["conversations"]
    try:
        # the arguments are read in the executor too: a bad sample_rate is a 400
        result = await _in_executor(lambda: conversations.render(
            conversation_id=request.match_info["conversation_id"],
            format=body.get("format", "wav"),
            sample_rate=int(body.get("sample_rate", 24000)),
            save_turn_audio=bool(body.get("save_turn_audio", True)),
        ))
        return json_response(result)
    except KeyError:
        raise ApiError(404, "Conversation not found")
    except ValueError as e:
        raise ApiError(400, str(e))


def _audio_file(path: Path) -> Response:
    suffix = path.suffix.lower().lstrip(".")
    return Response(body=path.read_bytes(), content_type=get_content_type(suffix or "wav"))


async def get_conversation_audio(request: Request) -> Response:
    item = request.app["conversations"].get(request.match_info["conversation_id"])
    if not item:
        raise ApiError(404, "Conversation not found")
    output_path = item.get("render_output_path")
    if not output_path:
        raise ApiError(404, "Conversation has no rendered output")
    p = Path(output_path)
    if not p.exists():
        raise ApiError(404, "Rendered audio file not found")
    return _audio_file(p)


async def delete_conversation(request: Request) -> Response:
    if not request.app["conversations"].delete(request.match_info["conversation_id"]):
        raise ApiError(404, "Conversation not found")
    return Response(status=204)


# ── studio: composer ───────────────────────────────────────────────────


async def render_composer(request: Request) -> Response:
    body = await _json_body(request)
    if "tracks" not in body:
        raise ApiError(422, "Field 'tracks' is required", "validation_error")
    composer = request.app["composer"]
    try:
        result = await _in_executor(lambda: composer.render(
            tracks=body["tracks"],
            format=body.get("format", "wav"),
            sample_rate=int(body.get("sample_rate", 24000)),
            name=body.get("name"),
        ))
        return json_response(result)
    except PermissionError as e:
        raise ApiError(403, str(e))
    except ValueError as e:
        raise ApiError(400, str(e))


async def list_composer_renders(request: Request) -> Response:
    return json_response(request.app["composer"].list_renders(
        limit=_q(request, "limit", 100, int),
        offset=_q(request, "offset", 0, int),
    ))


async def get_composer_audio(request: Request) -> Response:
    item = request.app["composer"].get_render(request.match_info["composition_id"])
    if not item:
        raise ApiError(404, "Composition not found")
    output_path = item.get("render_output_path")
    if not output_path:
        raise ApiError(404, "Composition has no rendered output")
    p = Path(output_path)
    if not p.is_absolute():
        p = (Path.cwd() / p).resolve()
    if not p.exists():
        raise ApiError(404, "Rendered audio file not found")
    return _audio_file(p)


async def delete_composer_render(request: Request) -> Response:
    if not request.app["composer"].delete_render(request.match_info["composition_id"]):
        raise ApiError(404, "Composition not found")
    return Response(status=204)


# ── web UI ─────────────────────────────────────────────────────────────


async def web_ui(request: Request) -> Response:
    index = STATIC_DIR / "index.html"
    if index.exists():
        return Response(text=index.read_text(), content_type="text/html")
    return Response(text="<h1>Web UI not found</h1>", content_type="text/html", status=404)


# ── lifespan ───────────────────────────────────────────────────────────


def _model_ids(raw: str) -> list[str]:
    return [m.strip() for m in raw.split(",") if m.strip()]


async def _cache_cleanup_loop(cache: TTSCache) -> None:
    while True:
        await asyncio.sleep(30)
        try:
            await _in_executor(cache.cleanup)
        except Exception:  # noqa: BLE001 — the sweep keeps running, as in the JAX app
            logger.exception("TTS cache cleanup failed")


async def _on_startup(app: Application) -> None:
    app["studio_store"].bootstrap()
    if settings.os_api_key == "" and settings.os_auth_required:
        raise RuntimeError("OS_AUTH_REQUIRED=true but OS_API_KEY is not set")
    lifecycle = ModelLifecycleManager(app["stt_router"], manager=app["model_manager"])
    lifecycle.start()
    app["lifecycle"] = lifecycle
    if settings.tts_cache_enabled:
        app["tts_cache_task"] = asyncio.create_task(_cache_cleanup_loop(app["tts_cache"]))
    if settings.os_wyoming_enabled:
        from open_speech_tpu_torch.server.wyoming.server import start_wyoming_server

        app["wyoming"] = await start_wyoming_server(
            app["stt_router"], app["tts_router"],
            host=settings.os_wyoming_host, port=settings.os_wyoming_port,
        )
    for model_id in _model_ids(settings.stt_preload_models):
        try:
            await _in_executor(app["stt_router"].load_model, model_id)
        except Exception:  # noqa: BLE001 — a failed preload is logged; the server still starts
            logger.exception("Failed to preload STT model %s", model_id)
    if settings.tts_enabled:
        for model_id in _model_ids(settings.tts_preload_models):
            try:
                await _in_executor(app["tts_router"].load_model, model_id)
            except Exception:  # noqa: BLE001 — as above
                logger.exception("Failed to preload TTS model %s", model_id)


async def _on_cleanup(app: Application) -> None:
    if app.get("tts_cache_task") is not None:
        app["tts_cache_task"].cancel()
    if app.get("wyoming") is not None:
        app["wyoming"].close()
    if app.get("lifecycle") is not None:
        await app["lifecycle"].stop()
    # continuous batchers stop last: fails in-flight futures cleanly
    # instead of abandoning their tasks at loop teardown
    await shutdown_batchers()
    reset_tts_batchers()
    reset_pocket_batchers()
    app["studio_store"].close()


class ModelAxisServingError(RuntimeError):
    """An app asked to serve a model axis without a model group behind it."""


def _model_axis() -> int:
    from open_speech_tpu_torch.parallel.mesh import parse_mesh

    spec = (settings.os_tpu_mesh or "").strip()
    return parse_mesh(spec)[1] if spec else 1


def _refuse_model_axis(stt_router: BackendRouter | None) -> None:
    from open_speech_tpu_torch.parallel.serving import ModelGroupLeader

    model = _model_axis()
    if model > 1 and not (stt_router is not None and isinstance(
            stt_router.get_backend(settings.stt_model), ModelGroupLeader)):
        raise ModelAxisServingError(
            f"OS_TPU_MESH={settings.os_tpu_mesh!r} asks for a model axis of {model}: every "
            "rank of a model group must make each model call, so the app needs the "
            "group's leader behind its STT router. Start every rank with `python -m "
            "open_speech_tpu_torch.server` (torchrun and OS_DIST_AUTO=1, or OS_DIST_*)"
        )


def create_app(stt_router: BackendRouter | None = None,
               tts_router: TTSRouter | None = None) -> Application:
    _refuse_model_axis(stt_router)
    app = Application(
        middlewares=[error_middleware, security_middleware],
        client_max_size=settings.os_max_upload_mb * 1024 * 1024 * 2,
    )
    app["stt_router"] = stt_router if stt_router is not None else BackendRouter()
    app["tts_router"] = tts_router if tts_router is not None else TTSRouter()
    app["rate_limiter"] = make_rate_limiter()
    app["model_manager"] = ModelManager(app["stt_router"], app["tts_router"])
    app["model_lock"] = asyncio.Lock()  # one model operation at a time
    app["download_progress"] = {}
    app["download_progress_lock"] = asyncio.Lock()
    app["profiler"] = {}
    # the Studio's state, on the paths the settings name now
    store = app["studio_store"] = Store(settings.os_studio_db_path)
    app["profiles"] = ProfileManager(store)
    app["history"] = HistoryManager(store, max_entries=settings.os_history_max_entries,
                                    max_mb=settings.os_history_max_mb,
                                    retain_audio=settings.os_history_retain_audio)
    app["voice_library"] = VoiceLibraryManager(settings.voice_library_path,
                                               max_count=settings.voice_library_max_count)
    app["tts_cache"] = TTSCache(settings.tts_cache_dir, settings.tts_cache_max_mb,
                                settings.tts_cache_enabled)
    # renders run where the app's TTS router runs (a router without a
    # device of its own: the settings' TTS device)
    tts_device = getattr(app["tts_router"], "_device", settings.tts_effective_device)
    app["conversations"] = ConversationManager(
        store, output_dir=settings.os_conversations_dir, default_model=settings.tts_model,
        default_voice=settings.tts_voice, device=tts_device, profile_manager=app["profiles"],
        synthesize_fn=functools.partial(_synthesize_array, app["tts_router"]))
    app["composer"] = MultiTrackComposer(
        store, output_dir=settings.os_composer_dir, conversations_dir=settings.os_conversations_dir,
        voice_library_path=settings.voice_library_path, device=tts_device)
    r = app.router
    r.add_post("/v1/audio/transcriptions", transcribe)
    r.add_post("/v1/audio/translations", translate)
    r.add_get("/v1/models", list_models)
    r.add_get("/v1/models/{model:.+}", get_model)
    # legacy management
    r.add_get("/api/ps", list_loaded_models)
    r.add_post("/api/ps/{model:.+}", load_model_legacy)
    r.add_delete("/api/ps/{model:.+}", unload_model_legacy)
    # unified management
    r.add_get("/api/models", list_all_models)
    r.add_get("/api/tts/capabilities", get_tts_capabilities_route)
    r.add_get("/api/models/{model_id:.+}/status", get_model_status)
    r.add_get("/api/models/{model_id:.+}/progress", get_model_progress)
    r.add_post("/api/models/{model_id:.+}/load", load_model_unified)
    r.add_post("/api/models/{model_id:.+}/download", download_model_unified)
    r.add_post("/api/models/{model_id:.+}/prefetch", download_model_unified)
    r.add_delete("/api/models/{model_id:.+}/artifacts", delete_model_artifacts)
    r.add_delete("/api/models/{model_id:.+}", unload_model_unified)
    r.add_post("/api/pull/{model:.+}", pull_model)
    r.add_get("/health", health)
    r.add_get("/metrics", metrics_route)
    r.add_get("/api/stats", stats_route)
    r.add_post("/api/profiler/start", profiler_start)
    r.add_post("/api/profiler/stop", profiler_stop)
    r.add_get("/v1/audio/stream", ws_stream)
    r.add_get("/v1/realtime", ws_realtime)
    r.add_post("/v1/audio/speech", synthesize_speech)
    r.add_post("/v1/audio/speech/clone", clone_speech)
    r.add_post("/v1/audio/models/load", load_tts_model)
    r.add_post("/v1/audio/models/unload", unload_tts_model)
    r.add_get("/v1/audio/models", list_tts_models)
    r.add_get("/v1/audio/voices", list_voices)
    # voice library + presets
    r.add_post("/api/voices/library", upload_voice)
    r.add_get("/api/voices/library", list_library_voices)
    r.add_get("/api/voices/library/{name}", get_library_voice_meta)
    r.add_delete("/api/voices/library/{name}", delete_library_voice)
    r.add_get("/api/voice-presets", get_voice_presets)
    # studio
    r.add_post("/api/profiles", create_profile)
    r.add_get("/api/profiles", list_profiles)
    r.add_get("/api/profiles/{profile_id}", get_profile)
    r.add_put("/api/profiles/{profile_id}", update_profile)
    r.add_delete("/api/profiles/{profile_id}", delete_profile)
    r.add_post("/api/profiles/{profile_id}/default", set_profile_default)
    r.add_get("/api/history", list_history)
    r.add_delete("/api/history/{entry_id}", delete_history_entry)
    r.add_delete("/api/history", clear_history)
    r.add_post("/api/conversations", create_conversation)
    r.add_get("/api/conversations", list_conversations)
    r.add_get("/api/conversations/{conversation_id}/audio", get_conversation_audio)
    r.add_get("/api/conversations/{conversation_id}", get_conversation)
    r.add_post("/api/conversations/{conversation_id}/turns", add_conversation_turn)
    r.add_delete("/api/conversations/{conversation_id}/turns/{turn_id}", delete_conversation_turn)
    r.add_post("/api/conversations/{conversation_id}/render", render_conversation)
    r.add_delete("/api/conversations/{conversation_id}", delete_conversation)
    r.add_post("/api/composer/render", render_composer)
    r.add_get("/api/composer/renders", list_composer_renders)
    r.add_get("/api/composer/render/{composition_id}/audio", get_composer_audio)
    r.add_delete("/api/composer/render/{composition_id}", delete_composer_render)
    # web UI
    r.add_get("/web", web_ui)
    if STATIC_DIR.is_dir():
        r.add_static("/static", STATIC_DIR)
    app.on_startup.append(_on_startup)
    app.on_cleanup.append(_on_cleanup)
    return app


def main() -> None:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    # a process group before the app (a no-op unless OS_DIST_* is set; see
    # parallel/distributed.py for the replica topology)
    from open_speech_tpu_torch.parallel.distributed import maybe_init_distributed

    maybe_init_distributed()
    leader = None
    if _model_axis() > 1:
        from open_speech_tpu_torch.backends.torch_whisper import TorchWhisperBackend
        from open_speech_tpu_torch.parallel.mesh import mesh_from_settings
        from open_speech_tpu_torch.parallel.serving import serve_model_axis

        leader = serve_model_axis(TorchWhisperBackend(), mesh_from_settings())
        if leader is None:
            return  # a follower, whose leader has stopped
    try:
        _serve(create_app(stt_router=BackendRouter(backend=leader) if leader else None))
    finally:
        if leader is not None:
            leader.stop()


def _serve(app: Application) -> None:
    ssl_context = None
    if settings.os_ssl_enabled:
        import ssl as _ssl

        from open_speech_tpu_torch.server.ssl_utils import (
            DEFAULT_CERT_FILE,
            DEFAULT_KEY_FILE,
            ensure_ssl_certs,
        )

        cert = settings.os_ssl_certfile or DEFAULT_CERT_FILE
        key = settings.os_ssl_keyfile or DEFAULT_KEY_FILE
        ensure_ssl_certs(cert, key)
        ssl_context = _ssl.SSLContext(_ssl.PROTOCOL_TLS_SERVER)
        ssl_context.load_cert_chain(cert, key)
        logger.info("Listening on https://%s:%d", settings.os_host, settings.os_port)
    else:
        logger.info("Listening on http://%s:%d", settings.os_host, settings.os_port)
    run_app(app, host=settings.os_host, port=settings.os_port, ssl_context=ssl_context)
