"""Server-side session logic. Counterpart of ``open_speech_tpu/server``; the
HTTP and WebSocket shell itself is a later slice of the port."""
