"""Hand-written CUDA kernels for Hopper (sm_90a), built by ``build.py``."""
