"""Build the port's CUDA kernels with nvcc and load them through ctypes.

Each source under ``csrc/`` is compiled on its own into a shared library
with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o _build/<stem>-<hash>.so csrc/<stem>.cu

(``-Xptxas -v`` changes no code; it prints each kernel's registers, shared
memory and spills.)

The library name carries a hash of the sources and the flags, so an edit
rebuilds at first use and an unchanged tree reuses what is on disk. Builds
of several sources start together, one nvcc each. Nothing is compiled when
this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
SOURCES = ("flash_attention",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    candidates = [
        os.path.join(os.environ[v], "bin", "nvcc")
        for v in ("CUDA_HOME", "CUDA_PATH")
        if os.environ.get(v)
    ]
    candidates += ["/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]
    for c in candidates:
        if c and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the port's CUDA kernels are built "
        "from source at first use"
    )


def _digest(stem: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    # headers are shared between sources: any change rebuilds all
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{stem}.cu"]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path(stem: str) -> Path:
    return BUILD_DIR / f"{stem}-{_digest(stem)}.so"


def build(stems=SOURCES, *, force: bool = False) -> dict[str, str]:
    """Compile every source whose library is missing (every source with
    ``force``), all nvcc in parallel.

    Returns {stem: compiler output} for the sources compiled. Raises
    RuntimeError with the compiler's output when a build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for stem in stems:
        out = library_path(stem)
        if out.exists() and not force:
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{stem}.cu")]
        procs[stem] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out)
    logs: dict[str, str] = {}
    failed = []
    for stem, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[stem] = log
        if proc.returncode != 0:
            failed.append(f"{stem}.cu (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return logs


def load(stem: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<stem>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(stem)
        if lib is None:
            path = library_path(stem)
            if not path.exists():
                build((stem,))
            lib = ctypes.CDLL(str(path))
            _libs[stem] = lib
        return lib
