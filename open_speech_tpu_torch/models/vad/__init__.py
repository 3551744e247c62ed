"""Voice activity detection (Silero VAD v5). Counterpart of
``open_speech_tpu/models/vad``."""
