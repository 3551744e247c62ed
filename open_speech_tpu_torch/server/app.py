"""The application and its routes.

Counterpart of ``open_speech_tpu/server/app.py`` for the routes the port
serves, on the port's own HTTP shell (``server/http.py``; the card's
machine has no aiohttp and no pydantic):

- ``POST /v1/audio/transcriptions`` and ``/v1/audio/translations``;
- ``GET /v1/models``, ``GET /v1/models/{model}`` and ``GET /health``;
- ``GET /v1/audio/stream``, the streaming session's WebSocket;
- ``GET /v1/realtime``, the OpenAI Realtime socket (``server/realtime/``);
- ``POST /v1/audio/speech``, whole or with ``?stream=true`` in chunked
  transfer whose headers wait for the first chunk;
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
  ``OS_PROFILE_DIR``).

Each handler keeps the JAX handler's order of checks, status codes,
messages and content types. Model calls, an upload's ingest, and each pull
of a speech stream run in the loop's executor, so a transcription never
blocks the loop that answers ``/health`` or a socket. The routers are the
app's (``create_app(stt_router=, tts_router=)``; by default new ones on
the settings' devices, the card unless the settings say ``cpu``), and so
are the model manager, the lock that model operations take, the download
progress and the profiler's state. The startup starts the TTL/LRU
lifecycle (``runtime/lifecycle.py``) over them; with
``OS_WYOMING_ENABLED`` it also opens the Wyoming TCP server
(``server/wyoming/``) on the same routers. The cleanup stops both.

Left out, each an item of ``ROADMAP.md``: the other routes of the JAX app
(an unknown path answers 404), history logging, and diarization
(``diarize=true`` with ``STT_DIARIZE_ENABLED`` raises a named error).
``/api/stats`` has no Pocket batchers (``{}``).
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import dataclasses
import functools
import logging
import os
import time

from open_speech_tpu_torch import __version__
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
from open_speech_tpu_torch.runtime.speech import SpeechError, speech_response
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
from open_speech_tpu_torch.tts.router import TTSRouter

logger = logging.getLogger(__name__)


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
    audio_bytes, _filename, content_type = _upload(form)
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
    if diarize:
        raise NotImplementedError(
            "speaker diarization is not ported yet: ROADMAP.md module item 2")

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


def _replica_info() -> dict:
    """This process's place among replicas, with the JAX route's keys:
    ``torch.distributed``'s rank and world size (0 and 1 when it is not
    initialised) and the cards this process sees. Counting the cards
    creates no CUDA context on the loop's thread."""
    import torch
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
    else:
        rank, world = 0, 1
    local = torch.cuda.device_count()
    return {"replica": rank, "replica_count": world,
            "local_devices": local, "global_devices": local * world}


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
    snap["pocket_batchers"] = {}  # Pocket is not ported
    snap["replica"] = _replica_info()
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
    timing: dict = {}
    t_start = time.monotonic()
    try:
        content_type, audio = await _in_executor(
            speech_response, request.app["tts_router"], body, stream=stream, timing=timing)
    except SpeechError as e:
        raise ApiError(e.status, e.message, e.code)
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


# ── lifespan ───────────────────────────────────────────────────────────


def _model_ids(raw: str) -> list[str]:
    return [m.strip() for m in raw.split(",") if m.strip()]


async def _on_startup(app: Application) -> None:
    if settings.os_api_key == "" and settings.os_auth_required:
        raise RuntimeError("OS_AUTH_REQUIRED=true but OS_API_KEY is not set")
    lifecycle = ModelLifecycleManager(app["stt_router"], manager=app["model_manager"])
    lifecycle.start()
    app["lifecycle"] = lifecycle
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
    if app.get("wyoming") is not None:
        app["wyoming"].close()
    if app.get("lifecycle") is not None:
        await app["lifecycle"].stop()
    # continuous batchers stop last: fails in-flight futures cleanly
    # instead of abandoning their tasks at loop teardown
    await shutdown_batchers()
    reset_tts_batchers()


def create_app(stt_router: BackendRouter | None = None,
               tts_router: TTSRouter | None = None) -> Application:
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
    r.add_post("/v1/audio/models/load", load_tts_model)
    r.add_post("/v1/audio/models/unload", unload_tts_model)
    r.add_get("/v1/audio/models", list_tts_models)
    r.add_get("/v1/audio/voices", list_voices)
    app.on_startup.append(_on_startup)
    app.on_cleanup.append(_on_cleanup)
    return app


def main() -> None:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    app = create_app()
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
