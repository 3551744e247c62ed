"""Scale-out: the port's ("data", "model") mesh against the JAX package.

- ``spec_for_path`` gives, for every parameter and buffer of the port's
  test-tiny model (bf16 and int8), the dim that JAX's ``_spec_for_path``
  shards on the matching leaf of its tree, transposed to ``nn.Linear``'s
  [out, in] (JAX's weights are [in, out]).
- ``build_mesh`` refuses to run without a process group.
- One spawned 2 x 2 gloo group (``tests/torch_parallel_worker.py``, which
  imports no JAX; every rank gets the same inputs and the JAX trees through
  an ``.npz``) holds ``tests/test_parallel.py``'s claims:
    1. ``build_mesh``'s shapes and its ValueError;
    2. tensor-parallel greedy tokens equal JAX's unsharded greedy, bf16 and
       int8 (4 new tokens), the encoder within 0.1 (bf16 sums in another
       order: JAX's own bound);
    3. beam 5 through the backend under ``OS_TPU_MESH="2,2"`` equals the
       unsharded port (float32, the fixture ``test-tiny-eot``), and so does
       one utterance through the batcher pool, whose pools then hold H / m
       heads;
    4. the model axis served (each model group's leader and follower,
       ``parallel/serving.py``): the leader's transcriptions and pooled
       utterance equal the unsharded backend's;
    5. the batcher under the mesh gives the JAX batcher's tokens (3
       windows, 4 slots, 6 tokens, float32 weights, bf16 pools);
    6. a streaming encoder's interim states under the mesh equal the
       unsharded encoder's within relative L2 1e-5 (float32; K2's plain
       version at one head per rank);
    7. one data- and tensor-parallel ``train_step`` equals one unsharded
       step on the whole batch: the loss within relative 1e-5, every
       leaf's gradient within relative L2 1e-5, every new value within
       1e-5 where its gradient is not within rounding of 0.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_speech_tpu.models.whisper import FallbackTokenizer as JaxFallbackTokenizer
from open_speech_tpu.models.whisper.decode import DecodeOptions, greedy_decode
from open_speech_tpu.models.whisper.model import PRESETS, encode, init_params
from open_speech_tpu.models.whisper.quantize import quantize_whisper_params as jax_quantize
from open_speech_tpu.ops.mel import log_mel_spectrogram as jax_mel
from open_speech_tpu.parallel.mesh import _spec_for_path
from open_speech_tpu.runtime import batcher as JB
from open_speech_tpu_torch.models.whisper import model as TM
from open_speech_tpu_torch.models.whisper.quantize import quantize_whisper_params
from open_speech_tpu_torch.ops import audio as codec
from open_speech_tpu_torch.parallel import mesh as TMESH
from tests.test_torch_backend import SR, _assert_close, _clips

ROOT = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).with_name("torch_parallel_worker.py")
CFG = PRESETS["test-tiny"]
TCFG = TM.PRESETS["test-tiny"]


# ── the sharding rules ───────────────────────────────────────────────────


def _port_names(keystr: str, n_layers: dict) -> tuple[list[str], str]:
    """The port names of one JAX leaf (one per layer for stacked blocks),
    and its kind: "weight" ([in, out] -> [out, in]), "s" ([1, out] ->
    [out]) or "plain" (same layout)."""
    keys = [k.strip("[]'") for k in keystr.split("][")]
    side = keys[0]
    if keys[1] == "blocks":
        owner, rest = keys[2], keys[3:]
        if owner in ("attn", "cross"):
            owner, rest = f"{owner}.{rest[0]}", rest[1:]
        prefixes = [f"{side}.blocks.{i}.{owner}" for i in range(n_layers[side])]
    else:
        prefixes, rest = [f"{side}.{keys[1]}"], keys[2:]
    if rest == ["w", "q"]:
        leaf, kind = "q", "weight"
    elif rest == ["w", "s"]:
        leaf, kind = "s", "s"
    elif rest in (["q"], ["s"]):  # the int8 token embedding
        leaf, kind = rest[0], "plain"
    elif rest == ["w"]:
        leaf, kind = "weight", "weight"
    elif rest == ["g"]:
        leaf, kind = "weight", "plain"
    elif rest == ["b"]:
        leaf, kind = "bias", "plain"
    else:
        assert rest == [], keystr
        return prefixes, "plain"
    return [f"{p}.{leaf}" for p in prefixes], kind


def _want_dim(keystr: str, kind: str):
    """JAX's sharded dim of the leaf of one layer, in the port's layout."""
    spec = tuple(_spec_for_path(keystr))
    if "model" not in spec:
        return None
    dim = spec.index("model") - ("['blocks']" in keystr)  # drop the stacked L axis
    return {"weight": 1 - dim, "s": dim - 1, "plain": dim}[kind]


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
def test_spec_for_path_matches_jax_on_every_leaf(quantized):
    params = jax.eval_shape(lambda: init_params(jax.random.PRNGKey(0), CFG, dtype=jnp.bfloat16))
    model = TM.Whisper.empty(TCFG, torch.bfloat16, "cpu")
    if quantized:
        params = jax.eval_shape(jax_quantize, params)
        quantize_whisper_params(model)
    port = {**dict(model.named_parameters()), **dict(model.named_buffers())}
    layers = {"encoder": CFG.n_audio_layer, "decoder": CFG.n_text_layer}
    seen = set()
    for path, _ in jax.tree_util.tree_leaves_with_path(params):
        keystr = jax.tree_util.keystr(path)
        names, kind = _port_names(keystr, layers)
        want = _want_dim(keystr, kind)
        for name in names:
            assert name in port, (keystr, name)
            assert TMESH.spec_for_path(name) == want, (keystr, name, want)
            seen.add(name)
    assert seen == set(port)  # every port leaf has its JAX counterpart


def test_build_mesh_needs_a_process_group():
    import torch.distributed as dist

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        TMESH.build_mesh(data=1, model=1)


# ── the 2 x 2 gloo group ─────────────────────────────────────────────────


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _flat(tree: dict, prefix: str) -> dict:
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        key = "/".join(k.key for k in path)
        a = np.asarray(leaf)
        out[f"{prefix}/{key}"] = a.astype(np.float32) if a.dtype == jnp.bfloat16 else a
    return out


def _window(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    audio = rng.uniform(-0.3, 0.3, CFG.n_audio_ctx * 2 * 160).astype(np.float32)
    return np.asarray(jax_mel(jnp.asarray(audio), n_mels=CFG.n_mels))


def _batch() -> dict:
    """Four examples whose masks differ, so the global mean is not the
    mean of the data shards' means."""
    rng = np.random.default_rng(0)
    mask = np.ones((4, 8), np.int32)
    mask[1, 5:] = 0
    mask[2, 3:] = 0
    return {"mel": rng.standard_normal((4, CFG.n_mels, CFG.n_audio_ctx * 2)).astype(np.float32),
            "tokens": rng.integers(0, CFG.n_vocab, (4, 8)).astype(np.int32), "mask": mask}


def _run_batcher(params, tok, windows) -> list:
    import asyncio

    batcher = JB.ContinuousBatcher(params, CFG, tok.special, slots=4, max_new_tokens=6,
                                   suppress_tokens=tuple(tok.non_speech_tokens))

    async def go():
        batcher.start()
        try:
            return await asyncio.wait_for(
                asyncio.gather(*(batcher.transcribe_window(w) for w in windows)), 120)
        finally:
            await batcher.stop()

    return asyncio.run(go())


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """(JAX references, each rank's results) of one run of the group."""
    tmp = tmp_path_factory.mktemp("tp")
    tok = JaxFallbackTokenizer(n_vocab=CFG.n_vocab, n_langs=CFG.n_langs)
    sp = tok.special
    bf16 = init_params(jax.random.PRNGKey(0), CFG, dtype=jnp.bfloat16)
    f32 = init_params(jax.random.PRNGKey(0), CFG, dtype=jnp.float32)
    mel = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (2, CFG.n_mels, CFG.n_audio_ctx * 2)))
    prompt = np.array([sp.sot_sequence("en")] * 2, np.int32)
    ref = {}
    for tag, params in (("bf16", bf16), ("int8", jax_quantize(bf16))):
        enc = encode(params, jnp.asarray(mel), CFG)
        res = greedy_decode(params, CFG, sp, enc, prompt, DecodeOptions(max_new_tokens=4))
        ref[f"{tag}_enc"] = np.asarray(enc.astype(jnp.float32))
        ref[f"{tag}_tokens"] = np.asarray(res.tokens)
    windows = [_window(s) for s in (3, 7, 11)]
    ref["batcher"] = _run_batcher(f32, tok, windows)
    clips = _clips()
    inputs = {**_flat(bf16, "bf16"), **_flat(jax_quantize(bf16), "int8"), **_flat(f32, "f32"),
              "mel": mel.astype(np.float32),
              "stream_pcm": np.random.default_rng(5).uniform(-0.3, 0.3, 16000).astype(np.float32),
              "pool_pcm": clips["beeps3"],
              **{f"window{i}": w for i, w in enumerate(windows)},
              **{f"batch_{k}": v for k, v in _batch().items()},
              **{f"wav_{name}": np.frombuffer(codec.write_wav(clips[name], SR), np.uint8)
                 for name in ("beeps3", "seek")}}
    np.savez(tmp / "inputs.npz", **inputs)

    port = _free_port()
    procs = []
    try:
        for rank in range(4):
            env = dict(os.environ, OS_DIST_COORDINATOR=f"127.0.0.1:{port}",
                       OS_DIST_NUM_PROCESSES="4", OS_DIST_PROCESS_ID=str(rank),
                       STT_DEVICE="cpu", OS_TPU_MESH="", PYTHONPATH=str(ROOT),
                       OMP_NUM_THREADS="1")
            procs.append(subprocess.Popen(
                [sys.executable, str(WORKER), str(tmp / "inputs.npz"), str(tmp)],
                cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for p in procs:
            try:
                out, _ = p.communicate(timeout=240)
            except subprocess.TimeoutExpired:
                p.kill()
                out, _ = p.communicate()
                pytest.fail(f"a rank hung:\n{out[-3000:]}")
            assert p.returncode == 0, out[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return ref, [dict(np.load(tmp / f"rank{r}.npz")) for r in range(4)]


def test_group_and_mesh_shapes(group):
    _, ranks = group
    for r, got in enumerate(ranks):
        assert got["world"].tolist() == [r, 4]
        assert got["mesh_shape"].tolist() == [2, 2]
        assert got["mesh_coords"].tolist() == [r // 2, r % 2]  # data-major, as JAX lays out
        assert got["default_shape"].tolist() == [4, 1]  # all ranks data-parallel
        assert got["model_only_shape"].tolist() == [1, 4]
        assert int(got["value_errors"]) == 2  # 3 x 3 != 4, and 8 devices of 4


@pytest.mark.parametrize("tag", ["bf16", "int8"])
def test_tensor_parallel_greedy_matches_jax_unsharded(group, tag):
    ref, ranks = group
    for got in ranks:
        assert got[f"{tag}_heads"].tolist() == [1, 1]  # 2 heads over a model axis of 2
        err = float(np.abs(got[f"{tag}_enc"] - ref[f"{tag}_enc"]).max())
        assert err < 0.1, err
        np.testing.assert_array_equal(got[f"{tag}_tokens"], ref[f"{tag}_tokens"])


def test_backend_under_os_tpu_mesh_beam5_equals_unsharded(group):
    _, ranks = group
    for got in ranks:
        answers = json.loads(str(got["backend"]))
        assert answers["whole"]["tp_size"] == 1 and answers["2,2"]["tp_size"] == 2
        whole, sharded = answers["whole"]["responses"], answers["2,2"]["responses"]
        assert all(r["text"] for r in whole)
        _assert_close(sharded, whole)
        # the pool under OS_TPU_MESH: pools at H / m heads, the same text
        assert (answers["whole"]["pool_heads"], answers["2,2"]["pool_heads"]) == (2, 1)
        assert answers["whole"]["pool"]["text"] and answers["2,2"]["pool"] == answers["whole"]["pool"]


def test_served_model_axis_leader_and_follower_equal_unsharded(group):
    """Model coordinate 0 leads and 1 follows (``parallel/serving.py``):
    the leader's answers equal the unsharded backend's; followers return."""
    _, ranks = group
    for r, got in enumerate(ranks):
        if r % 2:  # a follower: it made the leader's calls and returned at its stop
            calls = json.loads(str(got["followed"]))
            assert calls["stop"] == 1 and calls["load_model"] == 1 and calls["unload_model"] == 1
            assert calls["transcribe"] == 2 and calls["batcher_new"] == 1 and calls["batcher"] >= 3
            assert calls["noop"] >= 2  # the idle second's heartbeats
            continue
        served = json.loads(str(got["served"]))
        whole = json.loads(str(got["backend"]))["whole"]
        assert served["tp_size"] == 2 and served["unloaded"]
        _assert_close(served["responses"], whole["responses"])
        assert served["pool_batcher"] == "LeaderBatcher" and served["pool"] == whole["pool"]
        assert served["language"] == whole["language"]


def test_batcher_under_mesh_matches_jax_batcher(group):
    ref, ranks = group
    for got in ranks:
        assert got["batcher_pool_heads"].tolist() == [1, 1, 2]  # pools at H / m heads
        assert json.loads(str(got["batcher"])) == ref["batcher"]


def test_streaming_encoder_under_mesh_equals_unsharded(group):
    _, ranks = group
    for got in ranks:
        assert int(got["stream_cache_heads"]) == 1
        assert float(got["stream_rel_l2"]) <= 1e-5


def test_data_and_tensor_parallel_train_step_equals_unsharded(group):
    _, ranks = group
    for got in ranks:
        loss, ref_loss, grad_err, value_err, flips, n_leaves = got["train"].tolist()
        assert abs(loss - ref_loss) <= 1e-5 * abs(ref_loss)
        assert grad_err <= 1e-5 and value_err <= 1e-5 and flips == 0
        assert n_leaves == len(list(TM.Whisper.empty(TCFG, torch.float32, "cpu").parameters())) + 1
