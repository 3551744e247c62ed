"""The HTTP and WebSocket server. Counterpart of ``open_speech_tpu/server``:
``app.py`` (routes), ``errors.py``, ``middleware.py``, ``ssl_utils.py`` and
``streaming.py`` (the ``/v1/audio/stream`` session), on the port's own
HTTP/1.1 (``http.py``), multipart (``multipart.py``) and RFC 6455
(``websocket.py``) shell. Start it with ``python -m open_speech_tpu_torch.server``."""
