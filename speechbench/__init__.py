"""The benchmark of the PyTorch and CUDA port (``open_speech_tpu_torch``).

``python -m speechbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json``; see ``run.py``. Nothing here imports
JAX or the JAX package.
"""
