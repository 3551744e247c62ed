"""Scale-out of the PyTorch/CUDA port (counterpart of open_speech_tpu/parallel):
the process group (``distributed.py``) and the ("data", "model") mesh with
whisper's tensor-parallel rules (``mesh.py``)."""
