"""The port's multi-process launch (``parallel/distributed.py``): the env
wiring, its idempotence and the no-op, with ``init_process_group``
monkeypatched (``tests/test_distributed.py``'s cases); ``replica_info``'s
keys against the JAX package's, and that it brings up neither CUDA nor a
process group (a fresh interpreter); ``/api/stats``'s replica through the
port's app on a socket; a model axis served by two ``python -m`` processes
(leader and follower); and ``create_app``'s refusal of a model axis with
no model group behind its router."""

from __future__ import annotations

import asyncio
import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import pytest
import torch.distributed as dist

from open_speech_tpu.parallel.distributed import replica_info as jax_replica_info
from open_speech_tpu_torch.config import settings
from open_speech_tpu_torch.parallel import distributed

ROOT = Path(__file__).resolve().parent.parent
_VARS = ("OS_DIST_COORDINATOR", "OS_DIST_NUM_PROCESSES", "OS_DIST_PROCESS_ID", "OS_DIST_AUTO", "LOCAL_RANK")


@pytest.fixture(autouse=True)
def _reset(monkeypatch):
    for var in _VARS:
        monkeypatch.delenv(var, raising=False)
    distributed._initialized = False
    yield
    distributed._initialized = False


@pytest.fixture
def calls(monkeypatch):
    """The arguments of every ``init_process_group``; the group they would
    make is rank 2 of 4."""
    seen = []
    monkeypatch.setattr(dist, "init_process_group", lambda *a, **kw: seen.append((a, kw)))
    monkeypatch.setattr(dist, "get_rank", lambda *a, **kw: 2)
    monkeypatch.setattr(dist, "get_world_size", lambda *a, **kw: 4)
    return seen


def test_noop_without_env(calls):
    assert distributed.maybe_init_distributed() is False
    assert calls == []  # one process never touches the group machinery


@pytest.mark.parametrize("device,backend", [("cpu", "gloo"), ("cuda", "nccl"), ("cuda:1", "nccl")])
def test_env_wiring_and_idempotence(calls, monkeypatch, device, backend):
    monkeypatch.setenv("OS_DIST_COORDINATOR", "10.0.0.2:8476")
    monkeypatch.setenv("OS_DIST_NUM_PROCESSES", "4")
    monkeypatch.setenv("OS_DIST_PROCESS_ID", "2")
    monkeypatch.setattr(settings, "stt_device", device)
    assert distributed.maybe_init_distributed() is True
    assert calls == [((backend,), {"init_method": "tcp://10.0.0.2:8476", "world_size": 4, "rank": 2})]
    # idempotent: a second call does not join again
    assert distributed.maybe_init_distributed() is True
    assert len(calls) == 1


@pytest.mark.parametrize("device,backend,cards", [("cpu", "gloo", []), ("cuda", "nccl", [3])])
def test_auto_reads_torchruns_environment(calls, monkeypatch, device, backend, cards):
    """torchrun's variables; under NCCL its LOCAL_RANK names the card."""
    import torch

    seen = []
    monkeypatch.setattr(torch.cuda, "set_device", seen.append)
    monkeypatch.setenv("OS_DIST_AUTO", "1")
    monkeypatch.setenv("LOCAL_RANK", "3")
    monkeypatch.setattr(settings, "stt_device", device)
    assert distributed.maybe_init_distributed() is True
    assert calls == [((backend,), {"init_method": "env://"})]
    assert seen == cards


def test_replica_info_starts_neither_cuda_nor_a_group():
    """A ``/api/stats`` poll on a fresh server must not be what creates a
    CUDA context or a group (the event loop would block on it). A fresh
    interpreter, so nothing earlier brought either up."""
    code = (
        "import torch, torch.distributed as dist\n"
        "from open_speech_tpu_torch.parallel.distributed import replica_info\n"
        "info = replica_info()\n"
        "assert not torch.cuda.is_initialized(), 'replica_info initialised CUDA'\n"
        "assert not dist.is_initialized(), 'replica_info made a group'\n"
        "n = torch.cuda.device_count()\n"
        "assert info == {'replica': 0, 'replica_count': 1, 'local_devices': n,"
        " 'global_devices': n}, info\n"
        "print('OK')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "OK", out.stderr[-2000:]


def test_replica_info_has_the_jax_keys_and_reads_the_group(monkeypatch):
    assert set(distributed.replica_info()) == set(jax_replica_info())
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda *a, **kw: 1)
    monkeypatch.setattr(dist, "get_world_size", lambda *a, **kw: 2)
    info = distributed.replica_info()
    assert info["replica"] == 1 and info["replica_count"] == 2


def test_api_stats_reports_the_replica(monkeypatch):
    """``/api/stats`` over a socket from the port's app: replica 0 of 1
    without a group, and this process's rank inside one."""
    from open_speech_tpu_torch.runtime.router import BackendRouter
    from open_speech_tpu_torch.server import app as TAPP
    from open_speech_tpu_torch.server.http import serve_app
    from open_speech_tpu_torch.tts.router import TTSRouter

    async def stats() -> dict:
        app = TAPP.create_app(stt_router=BackendRouter(device="cpu"), tts_router=TTSRouter(device="cpu"))
        server = await serve_app(app, "127.0.0.1", 0)
        try:
            url = f"http://127.0.0.1:{server.port}/api/stats"
            body = await asyncio.get_running_loop().run_in_executor(
                None, lambda: urllib.request.urlopen(url, timeout=30).read())
            return json.loads(body)
        finally:
            await server.close()
            await app.cleanup()

    got = asyncio.run(stats())["replica"]
    assert got == distributed.replica_info() and set(got) == set(jax_replica_info())
    assert (got["replica"], got["replica_count"]) == (0, 1)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda *a, **kw: 3)
    monkeypatch.setattr(dist, "get_world_size", lambda *a, **kw: 4)
    got = asyncio.run(stats())["replica"]
    assert (got["replica"], got["replica_count"]) == (3, 4)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_python_m_server_serves_a_model_axis():
    """Two ``python -m open_speech_tpu_torch.server`` processes under
    ``OS_TPU_MESH="1,2"`` (gloo on the CPU): rank 0 serves the fixture
    sharded over both and answers a transcription (beam 5) with the
    unsharded port's body; rank 1 serves nothing, and SIGTERM to rank 0
    ends both."""
    import numpy as np

    from open_speech_tpu_torch.client import OpenSpeechClient
    from open_speech_tpu_torch.ops import audio as codec
    from open_speech_tpu_torch.runtime.router import BackendRouter, transcription_response

    fixtures = ROOT / "tests" / "fixtures"
    rng = np.random.default_rng(11)
    clip = rng.normal(0, 0.003, 19200)
    t = np.arange(2400) / 16000
    clip[:2400] += 0.5 * np.sin(2 * np.pi * 440.0 * t) * np.hanning(2400)
    wav = codec.write_wav(clip.astype(np.float32), 16000)
    old = (settings.stt_model_dir, settings.os_precompile_on_load)
    settings.stt_model_dir, settings.os_precompile_on_load = str(fixtures), False
    try:
        router = BackendRouter(device="cpu", compute_type="float32")
        want = transcription_response(router, wav, model="test-tiny-eot")
    finally:
        settings.stt_model_dir, settings.os_precompile_on_load = old

    http, coordinator = _free_port(), _free_port()
    procs = []
    try:
        for rank in (0, 1):
            env = dict(os.environ, OS_DIST_COORDINATOR=f"127.0.0.1:{coordinator}",
                       OS_DIST_NUM_PROCESSES="2", OS_DIST_PROCESS_ID=str(rank), OS_TPU_MESH="1,2",
                       OS_PORT=str(http), OS_HOST="127.0.0.1", OS_SSL_ENABLED="false",
                       STT_DEVICE="cpu", STT_MODEL_DIR=str(fixtures), STT_PRELOAD_MODELS="test-tiny-eot",
                       STT_COMPUTE_TYPE="float32", OS_PRECOMPILE_ON_LOAD="false",
                       TTS_ENABLED="false", PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
            procs.append(subprocess.Popen([sys.executable, "-m", "open_speech_tpu_torch.server"],
                                          cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT))
        deadline = time.monotonic() + 120
        while True:
            try:
                health = json.loads(urllib.request.urlopen(
                    f"http://127.0.0.1:{http}/health", timeout=5).read())
                if health["models_loaded"] == 1:
                    break
            except OSError:
                pass
            assert time.monotonic() < deadline and all(p.poll() is None for p in procs), (
                "the model group did not come up")
            time.sleep(0.2)
        got = OpenSpeechClient(f"http://127.0.0.1:{http}").transcribe(wav, model="test-tiny-eot")
        procs[0].send_signal(signal.SIGTERM)
        outs = [p.communicate(timeout=60)[0].decode(errors="replace") for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert got == want and got["text"]
    assert [p.returncode for p in procs] == [0, 0], [o[-2000:] for o in outs]
    assert "Running on http://" in outs[0] and "Running on" not in outs[1]


@pytest.mark.parametrize("spec,refused", [("1,2", True), ("2,2", True), ("2,1", False), ("", False)])
def test_the_server_refuses_a_model_axis(monkeypatch, spec, refused):
    """A model axis above 1 is refused by name before the app exists; data
    replicas build their app."""
    from open_speech_tpu_torch.runtime.router import BackendRouter
    from open_speech_tpu_torch.server import app as TAPP
    from open_speech_tpu_torch.tts.router import TTSRouter

    monkeypatch.setattr(settings, "os_tpu_mesh", spec)
    make = lambda: TAPP.create_app(  # noqa: E731
        stt_router=BackendRouter(device="cpu"), tts_router=TTSRouter(device="cpu"))
    if refused:
        with pytest.raises(TAPP.ModelAxisServingError, match="model axis"):
            make()
    else:
        app = make()
        asyncio.run(app.cleanup())
