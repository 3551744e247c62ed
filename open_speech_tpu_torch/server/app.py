"""The application and its routes.

Counterpart of ``open_speech_tpu/server/app.py`` for the routes the port
serves, on the port's own HTTP shell (``server/http.py``; the card's
machine has no aiohttp and no pydantic):

- ``POST /v1/audio/transcriptions`` and ``/v1/audio/translations``;
- ``GET /v1/models``, ``GET /v1/models/{model}`` and ``GET /health``;
- ``GET /v1/audio/stream``, the streaming session's WebSocket;
- ``GET /v1/realtime``, the OpenAI Realtime socket (``server/realtime/``);
- ``POST /v1/audio/speech``, whole or with ``?stream=true`` in chunked
  transfer whose headers wait for the first chunk.

Each handler keeps the JAX handler's order of checks, status codes,
messages and content types. Model calls, an upload's ingest, and each pull
of a speech stream run in the loop's executor, so a transcription never
blocks the loop that answers ``/health`` or a socket. The routers are the
app's (``create_app(stt_router=, tts_router=)``; by default new ones on
the settings' devices, the card unless the settings say ``cpu``). With
``OS_WYOMING_ENABLED`` the startup also opens the Wyoming TCP server
(``server/wyoming/``) on the same routers, and the cleanup closes it.

Left out, each an item of ``ROADMAP.md``: every other route of the JAX app
(an unknown path answers 404), history logging and metrics, and
diarization (``diarize=true`` with ``STT_DIARIZE_ENABLED`` raises a named
error).
"""

from __future__ import annotations

import asyncio
import functools
import logging

from open_speech_tpu_torch import __version__
from open_speech_tpu_torch.config import settings
from open_speech_tpu_torch.runtime.batcher_pool import shutdown_batchers
from open_speech_tpu_torch.runtime.router import (
    BackendRouter,
    backend_format,
    prepare_upload,
    render_result,
    transcription_body,
)
from open_speech_tpu_torch.runtime.speech import SpeechError, speech_response
from open_speech_tpu_torch.runtime.tts_batcher import reset_tts_batchers
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
from open_speech_tpu_torch.server.middleware import (
    make_rate_limiter,
    security_middleware,
    verify_ws_api_key,
    verify_ws_origin,
)
from open_speech_tpu_torch.server.realtime.server import realtime_endpoint
from open_speech_tpu_torch.server.streaming import streaming_endpoint
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
            "speaker diarization is not ported yet: ROADMAP.md module item 6")

    router: BackendRouter = request.app["stt_router"]
    audio = await _in_executor(prepare_upload, router, model, audio_bytes, content_type)
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
        raise ApiError(404, str(e), "model_not_found")
    except Exception as e:  # noqa: BLE001 — any other model failure is the server's
        logger.exception("Transcription failed")
        raise ApiError(500, str(e))
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
    try:
        content_type, audio = await _in_executor(
            speech_response, request.app["tts_router"], body, stream=stream)
    except SpeechError as e:
        raise ApiError(e.status, e.message, e.code)
    if not stream:
        return Response(body=audio, content_type=content_type)

    # the first chunk is already produced: an error before it was a real
    # error response (above); one after it aborts the transfer, so the
    # client sees truncation rather than a clean end of stream
    resp = StreamResponse(status=200, headers={"Content-Type": content_type})
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
            await resp.write(chunk)  # raises once the client has left
    finally:
        # a client that left, or a failure, closes the iterator: synthesis
        # stops before its next sentence
        await _in_executor(audio.close)
    await resp.prepare(request)
    await resp.write_eof()
    return resp


# ── lifespan ───────────────────────────────────────────────────────────


def _model_ids(raw: str) -> list[str]:
    return [m.strip() for m in raw.split(",") if m.strip()]


async def _on_startup(app: Application) -> None:
    if settings.os_api_key == "" and settings.os_auth_required:
        raise RuntimeError("OS_AUTH_REQUIRED=true but OS_API_KEY is not set")
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
    r = app.router
    r.add_post("/v1/audio/transcriptions", transcribe)
    r.add_post("/v1/audio/translations", translate)
    r.add_get("/v1/models", list_models)
    r.add_get("/v1/models/{model:.+}", get_model)
    r.add_get("/health", health)
    r.add_get("/v1/audio/stream", ws_stream)
    r.add_get("/v1/realtime", ws_realtime)
    r.add_post("/v1/audio/speech", synthesize_speech)
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
