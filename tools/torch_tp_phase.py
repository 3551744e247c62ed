#!/usr/bin/env python3
"""Phase 19 of ``chip_smoke.py`` (scale-out: the ("data", "model") mesh)
on the card, and the rank programs it launches.

    python3 tools/torch_tp_phase.py            # phase 19 alone (~2 min)

Alone, it checks the device, builds the kernels and runs
``chip_smoke.phase_tp``, which launches this file as subprocesses (so the
calling process never joins a group) and checks what they report:

  --part ab --rank R --port P --out F   one of two gloo ranks sharing
      cuda:0 (NCCL refuses two ranks on one device; gloo reduces CUDA
      tensors through the host). 19a: whisper-large-v3-turbo at full width
      and depth (random weights from seed 0) on a (1, 2) mesh, 10 of its
      20 heads per rank, against the unsharded model on the same rank, in
      bf16 and in float32: the encoder of one 30 s window, the prompt's
      and the first decode step's logits and a streaming encoder's states
      (K2 and its combine at 10 heads), each as relative L2 beside the
      unsharded model's own floor (its run on inputs moved by a relative
      1e-6); K1's launches and shapes per window, ``decode_step`` ms and
      all-reduces per step, one all-reduce's ms, resident bytes. 19b:
      ``tests/fixtures/test-tiny-eot`` in float32 under (1, 2): REST greedy
      tokens (the backend under ``OS_TPU_MESH="1,2"``) and the batcher's
      tokens against the unsharded run's; then test-tiny float32
      ``train_step``s under (2, 1) and (1, 2) against one unsharded step
      on the whole batch (K1 forward and backward on the card).
  --part c --port P --out F   one NCCL rank through
      ``maybe_init_distributed`` (``OS_DIST_COORDINATOR``) with
      ``OS_TPU_MESH="1,1"``: a collective over the mesh's groups, then
      phase 4's request a on a turbo router (tokens and K1 launches).

Each rank writes one JSON object to its ``--out`` file.

    python3 tools/torch_tp_phase.py --served 4   # on four cards (~3 min)

serves a model axis over NCCL across cards, as a deployment would:
``torchrun --nproc-per-node 4 -m open_speech_tpu_torch.server`` with
``OS_TPU_MESH="1,4"`` and ``OS_DIST_AUTO=1``, float32, the fixture
``test-tiny-eot`` (2 heads: a model axis of 2 for it would be the most, so
the fixture is loaded on a second server of 2 cards) and
whisper-large-v3-turbo (5 of its 20 heads per card, seed 0), preloaded.
Each upload, sent twice, must give the unsharded model's body in this
process on cuda:0; both walls are printed (the first pays set-up). SIGTERM to the leader stops the
group, and every rank must exit 0.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

TURBO = "large-v3-turbo"
DECODE_STEPS = 48
ALL_REDUCES = 48
LR = 1e-3


def _rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


class _Counted:
    """Counts ``torch.distributed.all_reduce`` calls while entered (the
    row-parallel linears call it through the module)."""

    def __enter__(self):
        import torch.distributed as dist

        self.n, self.real = 0, dist.all_reduce

        def counted(*args, **kwargs):
            self.n += 1
            return self.real(*args, **kwargs)

        dist.all_reduce = counted
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        dist.all_reduce = self.real


def _host_ms(fn, n: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


# ── 19a: turbo at full width over a model axis of 2 ─────────────────────

def _outputs(model, cfg, mel, pcm, first=None) -> dict:
    """The encoder states of ``mel``, the prompt's last logits and the
    first decode step's logits (fed ``first``, else the prompt's pick), a
    streaming encoder's interim states of ``pcm``, and K2's launches."""
    import torch

    from open_speech_tpu_torch.models.whisper import get_tokenizer
    from open_speech_tpu_torch.models.whisper import model as TM
    from open_speech_tpu_torch.models.whisper.decode import _prefill
    from open_speech_tpu_torch.models.whisper.streaming import StreamingWhisperEncoder
    from open_speech_tpu_torch.ops import attention as A

    tok = get_tokenizer(n_vocab=cfg.n_vocab, n_langs=cfg.n_langs)
    prompt = torch.tensor([tok.special.sot_sequence("en")], device="cuda")
    with torch.no_grad():
        enc = TM.encode(model, mel, cfg)
        cross = TM.precompute_cross_kv(model, enc, cfg)
        kv = TM.init_self_kv(cfg, 1, 128, enc.dtype, "cuda", model.text_heads)
        logits, kv = _prefill(model, prompt, cross, kv, cfg)
        first = logits[-1].argmax(-1)[:, None] if first is None else first
        step, kv = TM.decode_step(model, first, prompt.shape[1], kv, cross, cfg)
        before = dict(A.launches)
        stream = StreamingWhisperEncoder(model, cfg)
        stream.append_audio(pcm)
        states, _ = stream.interim_states()
    torch.cuda.synchronize()
    return {"encoder": enc, "prefill": logits[-1], "step": step, "stream": states, "first": first,
            "cross": cross, "kv": kv, "p": prompt.shape[1],
            "stream_launches": {**{k: A.launches[k] - before[k]
                                   for k in ("flash_attention_varlen", "flash_combine")},
                                "block_encodes": stream.block_encodes + stream.tail_encodes}}


def _compare(tp: dict, whole: dict, noisy: dict) -> dict:
    """Relative L2 of the sharded run's outputs against the whole model's,
    beside the whole model's own floor (its run on moved inputs)."""
    return {key: {"tp": _rel_l2(tp[key], whole[key]), "floor": _rel_l2(noisy[key], whole[key])}
            for key in ("encoder", "prefill", "step", "stream")}


def _turbo(rank: int) -> dict:
    import numpy as np
    import torch
    import torch.distributed as dist

    import chip_smoke as c
    from open_speech_tpu_torch.models.whisper import model as TM
    from open_speech_tpu_torch.models.whisper.quantize import model_nbytes
    from open_speech_tpu_torch.ops import attention as A
    from open_speech_tpu_torch.ops.mel import log_mel_spectrogram, pad_or_trim
    from open_speech_tpu_torch.parallel.mesh import build_mesh, shard_model

    out: dict = {}
    mesh = build_mesh(data=1, model=2)
    cfg = TM.PRESETS[TURBO]
    audio = torch.from_numpy(c._speechlike(30.0, 4)).cuda()
    mel = log_mel_spectrogram(pad_or_trim(audio, cfg.n_audio_ctx * 2 * 160), n_mels=cfg.n_mels)[None]
    pcm = c._speechlike(6.0, 5)
    rng = np.random.default_rng(1)
    # the unsharded model's own rounding floor: its run on inputs moved by
    # a relative TP_NOISE
    mel_moved = mel * (1 + c.TP_NOISE * torch.from_numpy(rng.standard_normal(mel.shape, np.float32)).cuda())
    pcm_moved = pcm * (1 + c.TP_NOISE * rng.standard_normal(pcm.shape).astype(np.float32))
    for dtype in (torch.bfloat16, torch.float32):
        name = "bf16" if dtype == torch.bfloat16 else "f32"
        if dtype == torch.float32:  # float32 means float32: no TF32 anywhere
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False

        def turbo():
            return TM.init_params(torch.Generator("cuda").manual_seed(0), cfg, dtype, "cuda")

        whole, tp = turbo(), turbo()
        if name == "bf16":
            out["whole_bytes"] = model_nbytes(tp)
        shard_model(tp, mesh)
        torch.cuda.empty_cache()
        ref = _outputs(whole, cfg, mel, pcm)
        noisy = _outputs(whole, cfg, mel_moved, pcm_moved, ref["first"])
        shapes, real = [], TM.flash_attention

        def recorded(q, k, *args, **kwargs):
            shapes.append([*q.shape[:3], k.shape[2], q.shape[3]])
            return real(q, k, *args, **kwargs)

        A.launches["flash_attention"] = 0
        TM.flash_attention = recorded  # the encoder's and the prefill's calls
        try:
            got = _outputs(tp, cfg, mel, pcm, ref["first"])
        finally:
            TM.flash_attention = real
        out[name] = _compare(got, ref, noisy)
        out[name]["step_argmax_equal"] = bool(torch.equal(got["step"].argmax(-1), ref["step"].argmax(-1)))
        if name == "f32":
            break
        out["shard_bytes"] = model_nbytes(tp)
        out["heads"] = [tp.audio_heads, tp.text_heads]
        out["encoder_k1_shapes"] = sorted({tuple(s) for s in shapes if s[2] == cfg.n_audio_ctx})
        out["encoder_k1"] = sum(s[2] == cfg.n_audio_ctx for s in shapes)
        out["k1"] = A.launches["flash_attention"]
        out["stream_launches"] = got["stream_launches"]
        with _Counted() as counted:
            TM.decode_step(tp, ref["first"], got["p"] + 1, got["kv"], got["cross"], cfg)
        out["all_reduces_per_step"] = counted.n

        def steps(run):
            return lambda: [TM.decode_step(run["model"], ref["first"], run["p"] + 2 + i, run["kv"],
                                           run["cross"], cfg) for i in range(DECODE_STEPS)]

        # the unsharded step on rank 0 alone, then both ranks' sharded
        # steps together (they share the card)
        dist.barrier()
        if rank == 0:
            out["whole_step_ms"] = _host_ms(steps({**ref, "model": whole}), 1) / DECODE_STEPS
        dist.barrier()
        out["tp_step_ms"] = _host_ms(steps({**got, "model": tp}), 1) / DECODE_STEPS
        group = mesh.get_group("model")
        # the row-parallel shares are summed in float32 (models/whisper/model.py)
        x = torch.randn(1, 1, cfg.n_text_state, device="cuda")
        dist.barrier()
        out["all_reduce_ms"] = _host_ms(lambda: [dist.all_reduce(x, group=group)
                                                  for _ in range(ALL_REDUCES)], 1) / ALL_REDUCES
        big = torch.randn(1, cfg.n_audio_ctx, cfg.n_audio_state, device="cuda")
        dist.barrier()
        out["encoder_all_reduce_ms"] = _host_ms(lambda: dist.all_reduce(big, group=group), 8)
        out["peak_bytes"] = torch.cuda.max_memory_allocated()
        del whole, tp, ref, noisy, got
        torch.cuda.empty_cache()
    return out


# ── 19b: the fixture and training on the card under small meshes ─────────


def _fixture(rank: int) -> dict:
    import numpy as np
    import torch

    import chip_smoke as c
    from open_speech_tpu_torch.backends.torch_whisper import TorchWhisperBackend
    from open_speech_tpu_torch.config import settings
    from open_speech_tpu_torch.ops import audio as codec
    from open_speech_tpu_torch.ops.attention import launches
    from open_speech_tpu_torch.ops.mel import log_mel_spectrogram
    from open_speech_tpu_torch.runtime.batcher import ContinuousBatcher

    out: dict = {}
    model_id = "test-tiny-eot"
    settings.stt_model_dir = str(ROOT / "tests" / "fixtures")
    settings.os_precompile_on_load = False
    rng = np.random.default_rng(11)  # phase 6's clips
    clips = {k: c._beeps(k, rng) for k in (1, 3)}
    backends = {}
    for spec in ("", "1,2"):
        settings.os_tpu_mesh = spec
        backends[spec or "whole"] = b = TorchWhisperBackend(device="cuda", compute_type="float32")
        b.load_model(model_id)
    settings.os_tpu_mesh = ""
    entries = {k: b._ensure_model(model_id) for k, b in backends.items()}
    out["tp_size"] = entries["1,2"]["model"].tp_size
    rest = {}
    for name, b in backends.items():
        rest[name] = [[t for s in b.transcribe(codec.write_wav(clip, c.SR), model_id, language="en",
                                               beam_size=1, fallback=False,
                                               response_format="verbose_json")["segments"]
                       for t in s["tokens"]] for clip in clips.values()]
    out["rest_tokens"] = rest

    cfg, tok = entries["whole"]["cfg"], entries["whole"]["tok"]
    brng = np.random.default_rng(41)  # phase 6's batcher windows
    mels = [log_mel_spectrogram(torch.from_numpy(c._beeps(k, brng)), n_mels=cfg.n_mels)
            for k in (1, 2, 3)]

    async def serve(model):
        b = ContinuousBatcher(model, cfg, tok.special, slots=4, max_new_tokens=24,
                              suppress_tokens=tuple(tok.non_speech_tokens))
        b.start()
        try:
            return await asyncio.wait_for(asyncio.gather(*(b.transcribe_window(m) for m in mels)), 120)
        finally:
            await b.stop()

    out["batcher_tokens"] = {k: asyncio.run(serve(e["model"])) for k, e in entries.items()}
    before = dict(launches)
    out["train"] = {f"{d},{m}": _train_step(d, m) for d, m in ((2, 1), (1, 2))}
    out["train_launches"] = {k: launches[k] - before[k] for k in launches}
    return out


def _train_batch(cfg):
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    mask = np.ones((4, 8), np.int64)
    mask[1, 5:] = 0
    mask[2, 3:] = 0
    return {"mel": torch.from_numpy(rng.standard_normal(
                (4, cfg.n_mels, cfg.n_audio_ctx * 2)).astype(np.float32)).cuda(),
            "tokens": torch.from_numpy(rng.integers(0, cfg.n_vocab, (4, 8))).cuda(),
            "mask": torch.from_numpy(mask).cuda()}


def _train_step(data: int, model_axis: int) -> dict:
    """One test-tiny float32 step under a (data, model) mesh against one
    unsharded step on the whole batch (this rank's slice of each leaf)."""
    import torch

    from open_speech_tpu_torch import train as TT
    from open_speech_tpu_torch.models.whisper import model as TM
    from open_speech_tpu_torch.parallel.mesh import build_mesh, shard_model, spec_for_path

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = TM.PRESETS["test-tiny"]
    mesh = build_mesh(data=data, model=model_axis)
    batch = _train_batch(cfg)

    def fresh():
        return TM.init_params(torch.Generator("cuda").manual_seed(0), cfg, torch.float32, "cuda")

    ref = fresh()
    ref_loss = TT.train_step(ref, TT.make_optimizer(ref, lr=LR), batch, cfg)
    model = shard_model(fresh(), mesh)
    loss = TT.train_step(model, TT.make_optimizer(model, lr=LR), batch, cfg, mesh=mesh)
    rank, m = mesh.get_local_rank("model"), model_axis
    want = {**dict(ref.named_parameters()), "encoder.pos": ref.encoder.pos}
    got = {**dict(model.named_parameters()), "encoder.pos": model.encoder.pos}
    grad_err = value_err = 0.0
    flips = 0
    for name, t in got.items():
        r, rg = want[name].detach(), want[name].grad
        dim = spec_for_path(name) if m > 1 else None
        if dim is not None:
            size = r.shape[dim] // m
            r, rg = r.narrow(dim, rank * size, size), rg.narrow(dim, rank * size, size)
        grad_err = max(grad_err, _rel_l2(t.grad, rg))
        big = rg.abs() > 1e-6
        diff = (t.detach() - r).abs()
        if big.any():
            value_err = max(value_err, float(diff[big].max()))
        flips += int((diff[~big] > 2 * LR).sum())
    return {"loss": float(loss), "ref_loss": float(ref_loss), "grad_rel_l2": grad_err,
            "value_err": value_err, "flips": flips, "leaves": len(got)}


# ── 19c: one NCCL rank through the launch entry ──────────────────────────


def _nccl_rank() -> dict:
    import torch
    import torch.distributed as dist

    import chip_smoke as c
    from open_speech_tpu_torch.config import settings
    from open_speech_tpu_torch.ops import attention as A
    from open_speech_tpu_torch.ops import audio as codec
    from open_speech_tpu_torch.parallel.distributed import maybe_init_distributed
    from open_speech_tpu_torch.parallel.mesh import mesh_from_settings
    from open_speech_tpu_torch.runtime.router import BackendRouter, transcription_response

    out: dict = {"joined": maybe_init_distributed(), "backend": dist.get_backend(),
                 "world": dist.get_world_size()}
    mesh = mesh_from_settings()
    out["mesh"] = list(mesh.shape)
    x = torch.full((4,), 3.0, device="cuda")
    dist.all_reduce(x)
    dist.all_reduce(x, group=mesh.get_group("model"))
    dist.all_reduce(x, group=mesh.get_group("data"))
    out["all_reduce"] = x.tolist()
    settings.os_stt_batched_longform = True  # as phase 4 loads
    settings.os_precompile_on_load = False
    router = BackendRouter()
    router.load_model(c.MAIN_MODEL)
    out["tp_size"] = router.get_backend(c.MAIN_MODEL)._models[c.MAIN_MODEL]["model"].tp_size
    name, seconds, seed, kw = c.REQUEST_A
    wav = codec.write_wav(c._speechlike(seconds, seed), c.SR)
    A.launches["flash_attention"] = 0
    out["body"] = transcription_response(router, wav, model=c.MAIN_MODEL, **kw)
    torch.cuda.synchronize()
    out["k1"] = A.launches["flash_attention"]
    dist.destroy_process_group()
    return out


def _serve_group(cards: int, first_card: int, models: str, port: int):
    """``torchrun`` of the server over ``cards`` cards from ``first_card``."""
    import subprocess

    import chip_smoke as c

    env = dict(os.environ, OS_TPU_MESH=f"1,{cards}", OS_DIST_AUTO="1", STT_DEVICE="cuda",
               STT_COMPUTE_TYPE="float32", STT_MODEL_DIR=str(ROOT / "tests" / "fixtures"),
               STT_PRELOAD_MODELS=models, OS_PRECOMPILE_ON_LOAD="false", OS_SSL_ENABLED="false",
               OS_HOST="127.0.0.1", OS_PORT=str(port), TTS_ENABLED="false",
               CUDA_VISIBLE_DEVICES=",".join(str(first_card + i) for i in range(cards)))
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", f"--nproc-per-node={cards}",
         f"--master-port={c._free_port()}", "-m", "open_speech_tpu_torch.server"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True)


def _children(pid: int) -> list[int]:
    """The processes whose parent is ``pid`` (torchrun's ranks)."""
    out = []
    for entry in os.listdir("/proc"):
        if entry.isdigit():
            try:
                with open(f"/proc/{entry}/stat") as f:
                    fields = f.read().rsplit(")", 1)[1].split()
            except OSError:
                continue
            if int(fields[1]) == pid:
                out.append(int(entry))
    return out


def _twice(call):
    """(the second call's result, the two calls' walls): the first pays
    one-time set-up."""
    import torch

    walls, out = [], None
    for _ in range(2):
        t0 = time.perf_counter()
        out = call()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return out, walls


def served(cards: int) -> int:
    import signal
    import urllib.request

    import numpy as np
    import torch

    import chip_smoke as c
    from open_speech_tpu_torch.client import OpenSpeechClient
    from open_speech_tpu_torch.config import settings
    from open_speech_tpu_torch.ops import audio as codec
    from open_speech_tpu_torch.runtime.router import BackendRouter, transcription_response

    if torch.cuda.device_count() < cards:
        print(f"torch_tp_phase: --served {cards} needs {cards} cards", file=sys.stderr)
        return 1
    c.phase_device()
    c.phase_build()
    rng = np.random.default_rng(11)  # phase 6's clips
    uploads = {f"fixture beeps k={k}": ("test-tiny-eot", codec.write_wav(c._beeps(k, rng), c.SR))
               for k in (1, 3)}
    name, seconds, seed, _ = c.REQUEST_A
    uploads["turbo " + name] = (c.MAIN_MODEL, codec.write_wav(c._speechlike(seconds, seed), c.SR))
    # one server per model: turbo over every card, the fixture (2 heads)
    # over two
    groups = {c.MAIN_MODEL: (cards, 0, c._free_port()), "test-tiny-eot": (2, 0, c._free_port())}
    got = {}
    for model, (n, first, port) in groups.items():
        proc = _serve_group(n, first, model, port)
        try:
            client = OpenSpeechClient(f"http://127.0.0.1:{port}")
            deadline = time.monotonic() + 300
            while True:
                try:
                    health = json.loads(urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/health", timeout=5).read())
                    if health["models_loaded"] == 1:
                        break
                except OSError:
                    pass
                if time.monotonic() > deadline or proc.poll() is not None:
                    raise AssertionError(f"served {model}: the group did not come up:\n"
                                         f"{proc.communicate()[0][-3000:] if proc.poll() is not None else ''}")
                time.sleep(0.5)
            for label, (m, wav) in uploads.items():
                if m == model:
                    got[label] = _twice(lambda: client.transcribe(wav, model=m))
            # every rank gets SIGTERM: the leader stops the group, the
            # followers wait for its stop
            for pid in _children(proc.pid):
                os.kill(pid, signal.SIGTERM)
            out, _ = proc.communicate(timeout=120)
            if proc.returncode != 0:
                raise AssertionError(f"served {model}: torchrun exit {proc.returncode}\n{out[-3000:]}")
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.communicate()
    settings.stt_model_dir = str(ROOT / "tests" / "fixtures")
    settings.os_precompile_on_load = False
    router = BackendRouter(device="cuda:0", compute_type="float32")
    for label, (model, wav) in uploads.items():
        want, walls = _twice(lambda: transcription_response(router, wav, model=model))
        body, served_walls = got[label]
        c.log(f"served model axis {label}: over {groups[model][0]} cards (NCCL) wall first/second "
              f"{served_walls[0]:.3f}/{served_walls[1]:.3f} s, unsharded on one card "
              f"{walls[0]:.3f}/{walls[1]:.3f} s; body equal={body == want} ({body['text'][:40]!r})")
        # float32 over a split sum moves a logit by ~1e-6: the fixture's
        # decodes must not flip; random turbo's long ones are reported
        if body != want and model == "test-tiny-eot":
            raise AssertionError(f"served {label}: {body} != {want}")
    return 0


def _rank_main(args) -> int:
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    if args.part == "ab":
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{args.port}",
                                world_size=2, rank=args.rank)
        out = {"rank": args.rank, "19a": _turbo(args.rank), "19b": _fixture(args.rank)}
        dist.barrier()
        dist.destroy_process_group()
    else:
        out = _nccl_rank()
    Path(args.out).write_text(json.dumps(out))
    return 0


def main() -> int:
    import torch

    import chip_smoke as c

    if not torch.cuda.is_available():
        print("torch_tp_phase: no CUDA device", file=sys.stderr)
        return 1
    c.phase_device()
    c.phase_build()
    t0 = time.perf_counter()
    launches = c.phase_tp()
    c.log(json.dumps({"launches": launches}))
    c.log(f"phase 19 seconds: {time.perf_counter() - t0:.1f}")
    return 0


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--part", choices=("ab", "c"))
    parser.add_argument("--rank", type=int, default=0)
    parser.add_argument("--port", type=int)
    parser.add_argument("--out")
    parser.add_argument("--served", type=int, metavar="CARDS")
    args = parser.parse_args()
    os.chdir(ROOT)
    sys.exit(served(args.served) if args.served else _rank_main(args) if args.part else main())
