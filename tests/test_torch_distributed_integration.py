"""Two real processes through the port's launch entry.

``tests/test_torch_distributed.py`` covers the env wiring with
``init_process_group`` monkeypatched; this file runs
``parallel.distributed.maybe_init_distributed`` in two OS processes on a
localhost coordinator (gloo) and checks that a collective returns what
only both processes together can give (``tests/torch_dist_worker.py``):
the counterpart of ``tests/test_distributed_integration.py``.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

WORKER = Path(__file__).with_name("torch_dist_worker.py")
REPO = Path(__file__).resolve().parent.parent


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.slow
def test_two_process_all_reduce_over_localhost_coordinator():
    port = _free_port()
    procs = []
    try:
        for pid in (0, 1):
            env = dict(os.environ, OS_DIST_COORDINATOR=f"127.0.0.1:{port}",
                       OS_DIST_NUM_PROCESSES="2", OS_DIST_PROCESS_ID=str(pid),
                       STT_DEVICE="cpu", PYTHONPATH=str(REPO))
            procs.append(subprocess.Popen(
                [sys.executable, str(WORKER)], cwd=REPO, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        outs = []
        for p in procs:
            try:
                out, _ = p.communicate(timeout=180)
            except subprocess.TimeoutExpired:
                p.kill()
                out, _ = p.communicate()
                pytest.fail(f"distributed worker hung:\n{out[-2000:]}")
            outs.append(out)
            assert p.returncode == 0, out[-2000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()

    for pid, out in enumerate(outs):
        line = next((l for l in out.splitlines() if l.startswith("DIST_OK")), "")
        assert line, f"worker {pid} produced no DIST_OK line:\n{out[-2000:]}"
        assert f"pid={pid}" in line
        assert "allgather=3.0" in line, line
        assert "allreduce=6.0" in line, line
