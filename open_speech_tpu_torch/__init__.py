"""Open Speech on PyTorch and CUDA (NVIDIA H100).

A port of ``open_speech_tpu`` that follows its layout and names module for
module. It imports torch and numpy, never jax, and nothing of the JAX
package. Entry points run on the card (``cuda``) unless the caller asks
for the CPU; the one TPU kernel on the served path is a hand-written CUDA
kernel (``kernels/csrc/flash_attention.cu``).
"""

__version__ = "0.1.0"  # the JAX package's: /health reports the same version
