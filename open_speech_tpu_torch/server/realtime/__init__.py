"""OpenAI Realtime API support: WS endpoint, session state, event builders,
audio buffering with VAD turn detection (reference: src/realtime/).
"""

from open_speech_tpu_torch.server.realtime.server import RealtimeSession, realtime_endpoint
from open_speech_tpu_torch.server.realtime.session import SessionConfig

__all__ = ["RealtimeSession", "SessionConfig", "realtime_endpoint"]
