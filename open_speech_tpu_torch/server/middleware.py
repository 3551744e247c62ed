"""Security middleware: API key, rate limit, CORS.

Counterpart of ``open_speech_tpu/server/middleware.py``, with the same
semantics: constant-time bearer/query API-key auth with exempt paths,
per-IP token-bucket rate limiting with X-RateLimit headers and
probabilistic cleanup, X-Forwarded-For honored only behind
OS_TRUST_PROXY, CORS headers on every response and the ``OPTIONS``
preflight, WebSocket key/origin checks done in the endpoints (the
middleware skips upgrades to the WebSocket routes; the JAX middleware
skips an upgrade header on any route, which lets it past the key check).
The 401 and 429 bodies are the JAX app's,
without a ``code``. The limiter belongs to the app (``app["rate_limiter"]``,
``None`` when ``OS_RATE_LIMIT`` is 0) rather than to the module.
"""

from __future__ import annotations

import hmac
import logging
import random
import time

from open_speech_tpu_torch.config import settings
from open_speech_tpu_torch.server.http import Request, Response, json_response

logger = logging.getLogger(__name__)

AUTH_EXEMPT_PATHS = frozenset(
    {"/health", "/docs", "/openapi.json", "/redoc", "/web"}
)


WS_PATHS = frozenset({"/v1/audio/stream", "/v1/realtime"})  # check their own key and origin


def _is_auth_exempt(path: str) -> bool:
    if path in AUTH_EXEMPT_PATHS:
        return True
    return path.startswith("/web/") or path.startswith("/static/")


def _key_ok(provided: str | None) -> bool:
    return bool(provided) and hmac.compare_digest(provided, settings.stt_api_key)


def check_api_key(request: Request) -> bool:
    """True when auth passes (or is disabled / path exempt)."""
    if not settings.stt_api_key:
        return True
    if _is_auth_exempt(request.path):
        return True
    auth_header = request.headers.get("authorization", "")
    if auth_header.startswith("Bearer ") and _key_ok(auth_header[7:].strip()):
        return True
    query_key = request.query.get("api_key")
    if query_key and _key_ok(query_key):
        logger.warning(
            "API key in query string is deprecated — use Authorization: Bearer"
        )
        return True
    return False


def verify_ws_api_key(request: Request) -> bool:
    """WS handshake key check."""
    if not settings.stt_api_key:
        return True
    query_key = request.query.get("api_key")
    if query_key and _key_ok(query_key):
        logger.warning(
            "API key in query string is deprecated — use Authorization: Bearer"
        )
        return True
    auth_header = request.headers.get("authorization", "")
    return auth_header.startswith("Bearer ") and _key_ok(auth_header[7:].strip())


def _allowed_ws_origins() -> set[str]:
    raw = settings.os_ws_allowed_origins.strip()
    if not raw:
        return set()
    return {o.strip() for o in raw.split(",") if o.strip()}


def verify_ws_origin(request: Request) -> bool:
    allowed = _allowed_ws_origins()
    if not allowed:
        return True
    return request.headers.get("origin", "") in allowed


class RateLimiter:
    """Token bucket per IP."""

    def __init__(self, requests_per_minute: int, burst: int | None = None):
        self.rate = requests_per_minute / 60.0
        self.burst = burst or requests_per_minute
        self._buckets: dict[str, tuple[float, float]] = {}

    def _client_ip(self, request: Request) -> str:
        if settings.stt_trust_proxy:
            forwarded = request.headers.get("x-forwarded-for")
            if forwarded:
                return forwarded.split(",")[0].strip()
        return request.remote or "unknown"

    def check(self, request: Request) -> tuple[bool, dict[str, str]]:
        ip = self._client_ip(request)
        now = time.monotonic()
        if ip in self._buckets:
            tokens, last_time = self._buckets[ip]
            tokens = min(self.burst, tokens + (now - last_time) * self.rate)
        else:
            tokens = float(self.burst)
        headers = {
            "X-RateLimit-Limit": str(self.burst),
            "X-RateLimit-Remaining": str(max(0, int(tokens) - 1)),
        }
        if tokens >= 1.0:
            self._buckets[ip] = (tokens - 1.0, now)
            allowed = True
        else:
            self._buckets[ip] = (tokens, now)
            headers["Retry-After"] = str(int((1.0 - tokens) / self.rate) + 1)
            headers["X-RateLimit-Remaining"] = "0"
            allowed = False
        if random.random() < 0.01:
            self.cleanup()
        return allowed, headers

    def cleanup(self, max_age: float = 3600.0) -> None:
        now = time.monotonic()
        for ip in [
            ip for ip, (_, t) in self._buckets.items() if now - t > max_age
        ]:
            del self._buckets[ip]


def make_rate_limiter() -> RateLimiter | None:
    """The limiter the settings ask for; None when rate limiting is off."""
    if settings.stt_rate_limit <= 0:
        return None
    return RateLimiter(
        requests_per_minute=settings.stt_rate_limit,
        burst=settings.stt_rate_limit_burst or settings.stt_rate_limit,
    )


def cors_headers() -> dict[str, str]:
    origins = settings.os_cors_origins
    return {
        "Access-Control-Allow-Origin": origins if origins else "*",
        "Access-Control-Allow-Methods": "*",
        "Access-Control-Allow-Headers": "*",
    }


async def security_middleware(request: Request, handler):
    """auth -> rate limit -> handler, error envelope on failures."""
    if request.path in WS_PATHS and request.headers.get("upgrade", "").lower() == "websocket":
        return await handler(request)

    if request.method == "OPTIONS":  # CORS preflight
        return Response(status=204, headers=cors_headers())

    if not check_api_key(request):
        return json_response(
            {
                "error": {
                    "message": (
                        "Invalid or missing API key. Set Authorization: "
                        "Bearer <key> header."
                    )
                }
            },
            status=401,
            headers=cors_headers(),
        )

    rl_headers: dict[str, str] = {}
    limiter = request.app.get("rate_limiter")
    if limiter and not _is_auth_exempt(request.path):
        allowed, rl_headers = limiter.check(request)
        if not allowed:
            return json_response(
                {"error": {"message": "Rate limit exceeded. Try again later."}},
                status=429,
                headers={**rl_headers, **cors_headers()},
            )

    response = await handler(request)
    for k, v in {**rl_headers, **cors_headers()}.items():
        if k not in response.headers:
            response.headers[k] = v
    return response
