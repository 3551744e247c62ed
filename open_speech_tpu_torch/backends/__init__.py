"""backends of the PyTorch/CUDA port (counterpart of open_speech_tpu/backends)."""
