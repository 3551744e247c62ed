"""TTS serving layer of the PyTorch/CUDA port (counterpart of
open_speech_tpu/tts): backend protocol, router, voices."""
