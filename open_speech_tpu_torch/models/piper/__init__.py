"""Piper (VITS) in PyTorch. Counterpart of ``open_speech_tpu/models/piper``;
this slice holds only the weight-norm folding that Kokoro's converter uses."""
