"""Error envelope helpers.

Counterpart of ``open_speech_tpu/server/errors.py``: every error response is
``{"error": {"message": ..., "code": ...}}``. ``ApiError`` is raised by the
handlers; the app-level middleware turns it, the router's 404/405, a body's
413, and unexpected exceptions into the envelope, with CORS headers.
"""

from __future__ import annotations

import logging

from open_speech_tpu_torch.server.http import HTTPError, Request, Response, json_response
from open_speech_tpu_torch.server.middleware import cors_headers

logger = logging.getLogger(__name__)


class ApiError(Exception):
    def __init__(self, status: int, message, code: str = "http_error"):
        super().__init__(message)
        self.status = status
        self.detail = message
        self.code = code


def error_response(status: int, message, code: str = "http_error") -> Response:
    if isinstance(message, dict):
        code = str(message.get("code") or code)
        message = str(message.get("message") or message.get("detail") or message)
    return json_response({"error": {"message": str(message), "code": code}}, status=status)


async def error_middleware(request: Request, handler):
    try:
        return await handler(request)
    except ApiError as e:
        return _with_cors(error_response(e.status, e.detail, e.code))
    except HTTPError as e:
        if e.status >= 400:
            return _with_cors(error_response(e.status, e.reason or "error"))
        raise
    except Exception as e:  # noqa: BLE001 — the boundary: every fault becomes a 500
        logger.exception("Unhandled error on %s %s", request.method, request.path)
        return _with_cors(error_response(500, str(e), "internal_error"))


def _with_cors(resp: Response) -> Response:
    """Browsers can only read an error body if the error carries CORS
    headers too (success responses get them from the security middleware,
    which this middleware wraps)."""
    for k, v in cors_headers().items():
        resp.headers.setdefault(k, v)
    return resp
