"""One rank of ``tests/test_torch_parallel.py``'s 2 x 2 gloo group.

Run as ``python tests/torch_parallel_worker.py INPUTS.npz OUT_DIR`` with
``OS_DIST_*`` set by the parent; it joins the group through the
production entry (``parallel.distributed.maybe_init_distributed``) and
imports no JAX: the parent hands every rank the same inputs and the JAX
package's trees through ``INPUTS.npz`` and compares what each rank writes
to ``OUT_DIR/rank<r>.npz`` with the JAX references.

What each rank runs on the ("data", "model") = (2, 2) mesh:
  - ``build_mesh``'s shapes and its ValueError;
  - tensor-parallel encode + greedy decode (4 tokens) of the bf16 and the
    int8 test-tiny trees;
  - beam 5 through ``TorchWhisperBackend`` under ``OS_TPU_MESH="2,2"`` and
    without it, on ``tests/fixtures/test-tiny-eot`` in float32, and one
    utterance through the batcher pool beside each;
  - the model axis served: each model group's coordinate-0 rank leads
    (``parallel/serving.py``) and the other follows its calls: a load, the
    two beam-5 transcriptions, a language probe, an utterance through the
    batcher pool, an unload;
  - the continuous batcher under the mesh (3 windows, 4 slots, 6 tokens);
  - a streaming encoder's interim states (float32) under the mesh against
    the unsharded encoder's;
  - one ``train_step`` under the mesh against one unsharded step on the
    whole batch: the loss, and every leaf's gradient and new value.
"""

from __future__ import annotations

import asyncio
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
LR = 1e-3


def _tree(npz, prefix: str) -> dict:
    """The nested dict saved flat as ``prefix/a/b/c`` keys."""
    out: dict = {}
    for key in npz.files:
        if key.startswith(prefix + "/"):
            *path, leaf = key[len(prefix) + 1:].split("/")
            d = out
            for p in path:
                d = d.setdefault(p, {})
            d[leaf] = npz[key]
    return out


def _meshes(out: dict):
    from open_speech_tpu_torch.parallel.mesh import build_mesh

    mesh = build_mesh(data=2, model=2)
    out["mesh_shape"] = np.array(mesh.shape)
    out["mesh_coords"] = np.array([mesh.get_local_rank("data"), mesh.get_local_rank("model")])
    out["default_shape"] = np.array(build_mesh().shape)
    out["model_only_shape"] = np.array(build_mesh(model=4).shape)
    bad = 0
    for kw in ({"data": 3, "model": 3}, {"n_devices": 8}):
        try:
            build_mesh(**kw)
        except ValueError:
            bad += 1
    out["value_errors"] = np.array(bad)
    return mesh


def _greedy(npz, mesh, out: dict) -> None:
    from open_speech_tpu_torch.models.whisper import FallbackTokenizer
    from open_speech_tpu_torch.models.whisper import model as TM
    from open_speech_tpu_torch.models.whisper.convert import params_from_jax_tree
    from open_speech_tpu_torch.models.whisper.decode import DecodeOptions, greedy_decode
    from open_speech_tpu_torch.parallel.mesh import shard_model

    cfg = TM.PRESETS["test-tiny"]
    sp = FallbackTokenizer(n_vocab=cfg.n_vocab, n_langs=cfg.n_langs).special
    prompt = np.array([sp.sot_sequence("en")] * 2, np.int32)
    for tag in ("bf16", "int8"):
        model = shard_model(params_from_jax_tree(_tree(npz, tag), cfg, torch.bfloat16), mesh)
        out[f"{tag}_heads"] = np.array([model.text_heads, model.audio_heads])
        with torch.no_grad():
            enc = TM.encode(model, torch.from_numpy(npz["mel"]), cfg)
        res = greedy_decode(model, cfg, sp, enc, prompt, DecodeOptions(max_new_tokens=4))
        out[f"{tag}_enc"] = enc.float().numpy()
        out[f"{tag}_tokens"] = np.asarray(res.tokens)


def _backend_beam(npz, out: dict) -> None:
    from open_speech_tpu_torch.backends.torch_whisper import TorchWhisperBackend
    from open_speech_tpu_torch.config import settings

    settings.stt_model_dir = str(ROOT / "tests" / "fixtures")
    settings.os_precompile_on_load = False
    from open_speech_tpu_torch.runtime import batcher_pool

    async def pooled(backend):
        """One utterance through the batcher pool, then the pool's heads."""
        try:
            body = await batcher_pool.transcribe_pcm_batched(
                backend, "test-tiny-eot", "en", npz["pool_pcm"])
            (batcher,) = batcher_pool._batchers.values()
            return body, batcher._self_kv.shape[3]
        finally:
            await batcher_pool.shutdown_batchers()

    answers = {}
    for spec in ("", "2,2"):
        settings.os_tpu_mesh = spec
        backend = TorchWhisperBackend(device="cpu", compute_type="float32")
        backend.load_model("test-tiny-eot")
        body, heads = asyncio.run(pooled(backend))
        answers[spec or "whole"] = {
            "tp_size": backend._models["test-tiny-eot"]["model"].tp_size,
            "responses": [
                backend.transcribe(npz[f"wav_{name}"].tobytes(), "test-tiny-eot", language="en",
                                   beam_size=5, response_format="verbose_json")
                for name in ("beeps3", "seek")
            ],
            "pool": body,
            "pool_heads": heads,
            "language": backend.detect_language_pcm("test-tiny-eot", npz["pool_pcm"]),
        }
    settings.os_tpu_mesh = ""
    out["backend"] = np.array(json.dumps(answers))


def _served(npz, mesh, out: dict) -> None:
    """The model axis served as ``python -m ...server`` serves it: the
    model-coordinate-0 rank leads, the other follows its calls."""
    import torch.distributed as dist

    from open_speech_tpu_torch.backends.torch_whisper import TorchWhisperBackend
    from open_speech_tpu_torch.config import settings
    from open_speech_tpu_torch.parallel import serving
    from open_speech_tpu_torch.runtime import batcher_pool

    settings.os_tpu_mesh = "2,2"
    serving.HEARTBEAT_S = 0.2  # idle gaps below are several heartbeats long
    backend = TorchWhisperBackend(device="cpu", compute_type="float32")
    group = mesh.get_group("model")
    if mesh.get_local_rank("model"):  # a follower: it returns when its leader stops
        calls = serving.follow(backend, group, dist.get_global_rank(group, 0))
        settings.os_tpu_mesh = ""
        out["followed"] = np.array(json.dumps(calls))
        return
    leader = serving.serve_model_axis(backend, mesh)

    async def pooled():
        try:
            body = await batcher_pool.transcribe_pcm_batched(leader, "test-tiny-eot", "en",
                                                             npz["pool_pcm"])
            (batcher,) = batcher_pool._batchers.values()
            return body, type(batcher).__name__
        finally:
            await batcher_pool.shutdown_batchers()

    try:
        leader.load_model("test-tiny-eot")
        time.sleep(1.0)  # idle: the followers take the leader's no-ops meanwhile
        served = {
            "tp_size": leader._models["test-tiny-eot"]["model"].tp_size,
            "responses": [
                leader.transcribe(npz[f"wav_{name}"].tobytes(), "test-tiny-eot", language="en",
                                  beam_size=5, response_format="verbose_json")
                for name in ("beeps3", "seek")
            ],
            "language": leader.detect_language_pcm("test-tiny-eot", npz["pool_pcm"]),
        }
        served["pool"], served["pool_batcher"] = asyncio.run(pooled())
        leader.unload_model("test-tiny-eot")
        served["unloaded"] = not leader.is_model_loaded("test-tiny-eot")
    finally:
        leader.stop()
        settings.os_tpu_mesh = ""
    out["served"] = np.array(json.dumps(served))


def _batcher(npz, mesh, out: dict) -> None:
    from open_speech_tpu_torch.models.whisper import FallbackTokenizer
    from open_speech_tpu_torch.models.whisper import model as TM
    from open_speech_tpu_torch.models.whisper.convert import params_from_jax_tree
    from open_speech_tpu_torch.runtime.batcher import ContinuousBatcher

    cfg = TM.PRESETS["test-tiny"]
    tok = FallbackTokenizer(n_vocab=cfg.n_vocab, n_langs=cfg.n_langs)
    model = params_from_jax_tree(_tree(npz, "f32"), cfg)
    batcher = ContinuousBatcher(model, cfg, tok.special, slots=4, max_new_tokens=6,
                                suppress_tokens=tuple(tok.non_speech_tokens), mesh=mesh)
    out["batcher_pool_heads"] = np.array(
        [batcher._self_kv.shape[3], batcher._cross_kv.shape[3], model.tp_size])

    async def serve():
        # every window is queued before the scheduler's first admission, so
        # every rank admits them as one batch and ticks in step
        batcher.start()
        try:
            return await asyncio.wait_for(asyncio.gather(
                *(batcher.transcribe_window(npz[f"window{i}"]) for i in range(3))), 120)
        finally:
            await batcher.stop()

    out["batcher"] = np.array(json.dumps(asyncio.run(serve())))


def _streaming(npz, mesh, out: dict) -> None:
    from open_speech_tpu_torch.models.whisper import model as TM
    from open_speech_tpu_torch.models.whisper.convert import params_from_jax_tree
    from open_speech_tpu_torch.models.whisper.streaming import StreamingWhisperEncoder
    from open_speech_tpu_torch.parallel.mesh import shard_model

    cfg = TM.PRESETS["test-tiny"]
    states = []
    for sharded in (False, True):
        model = params_from_jax_tree(_tree(npz, "f32"), cfg)
        if sharded:
            shard_model(model, mesh)
        enc = StreamingWhisperEncoder(model, cfg)
        enc.append_audio(npz["stream_pcm"])
        states.append(enc.interim_states()[0])
        out["stream_cache_heads"] = np.array(enc._kc.shape[2])
    out["stream_rel_l2"] = np.array(_rel_l2(states[1], states[0]))


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _train(npz, mesh, out: dict) -> None:
    from open_speech_tpu_torch import train as TT
    from open_speech_tpu_torch.models.whisper import model as TM
    from open_speech_tpu_torch.models.whisper.convert import params_from_jax_tree
    from open_speech_tpu_torch.parallel.mesh import shard_model, spec_for_path

    cfg = TM.PRESETS["test-tiny"]
    batch = {k: torch.from_numpy(npz[f"batch_{k}"]) for k in ("mel", "tokens", "mask")}
    ref = params_from_jax_tree(_tree(npz, "f32"), cfg)
    ref_loss = TT.train_step(ref, TT.make_optimizer(ref, lr=LR), batch, cfg)
    model = shard_model(params_from_jax_tree(_tree(npz, "f32"), cfg), mesh)
    loss = TT.train_step(model, TT.make_optimizer(model, lr=LR), batch, cfg, mesh=mesh)
    rank, m = mesh.get_local_rank("model"), mesh["model"].size()

    def leaves(mdl):
        return {**dict(mdl.named_parameters()), "encoder.pos": mdl.encoder.pos}

    want, got = leaves(ref), leaves(model)
    grad_err, value_err, flips = 0.0, 0.0, 0
    for name, t in got.items():
        r = want[name]
        dim = spec_for_path(name)
        if dim is not None:
            size = r.shape[dim] // m
            r = r.narrow(dim, rank * size, size)
            rg = want[name].grad.narrow(dim, rank * size, size)
        else:
            rg = want[name].grad
        grad_err = max(grad_err, _rel_l2(t.grad, rg))
        # step 1 of AdamW moves a leaf by about -lr * sign(g): where |g| is
        # within rounding of 0 the two updates may differ by up to 2 * lr
        big = rg.abs() > 1e-6
        diff = (t.detach() - r.detach()).abs()
        value_err = max(value_err, float(diff[big].max()) if big.any() else 0.0)
        flips += int((diff[~big] > 2 * LR).sum())
    out["train"] = np.array([float(loss), float(ref_loss), grad_err, value_err, flips, len(got)])


def main(inputs: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    import torch.distributed as dist

    from open_speech_tpu_torch.parallel.distributed import maybe_init_distributed

    if not maybe_init_distributed():
        raise SystemExit("OS_DIST_* not set")
    npz = np.load(inputs)
    out: dict = {"world": np.array([dist.get_rank(), dist.get_world_size()])}
    mesh = _meshes(out)
    _greedy(npz, mesh, out)
    _backend_beam(npz, out)
    _served(npz, mesh, out)
    _batcher(npz, mesh, out)
    _streaming(npz, mesh, out)
    _train(npz, mesh, out)
    np.savez(Path(out_dir) / f"rank{dist.get_rank()}.npz", **out)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
