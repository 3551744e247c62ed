"""PyTorch Whisper STT backend, on the card unless asked for the CPU.

Counterpart of ``open_speech_tpu/backends/jax_whisper.py``: the same
protocol methods, model ids and aliases, checkpoint discovery, decode-budget
rounding and response formats. Weights load from disk when a checkpoint
directory exists (HF cache layout or STT_MODEL_DIR); otherwise the model
initialises random weights from a generator seeded 0, with a warning.

``device`` defaults to ``settings.stt_device`` (``cuda``). The backend never
falls back to the CPU by itself: a CUDA device that is missing raises.
Compute types: ``bfloat16`` (default), ``float16`` (runs as bf16, as in the
JAX package), ``float32``, and ``int8`` (a bf16 model whose linears and
token embedding are packed to int8 at load, ``models/whisper/quantize.py``).
With ``OS_STT_BATCHED_LONGFORM`` on, uploads longer than two windows decoded
from temperature 0 take ``models/whisper/batched.py``'s batched path, as in
the JAX package. With ``OS_SPEC_DRAFT_MODEL`` set, beam-1 requests whose
first temperature is 0 decode speculatively against that draft, loaded on
the same device at the same compute type. With ``OS_TPU_MESH`` naming a
model axis (``"d,m"``, m > 1), each loaded model keeps this rank's
tensor-parallel shard (``parallel/mesh.py``); every rank of the model group
must then make the same calls.
"""

from __future__ import annotations

import logging
import os
import re
import shutil
import threading
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

from open_speech_tpu_torch.audio.ingest import TARGET_RATE
from open_speech_tpu_torch.config import settings
from open_speech_tpu_torch.models.whisper import PRESETS, get_tokenizer, init_params
from open_speech_tpu_torch.models.whisper.batched import (
    BATCH_BUCKETS,
    _decode_rows_with_fallback,
    transcribe_batched,
)
from open_speech_tpu_torch.models.whisper.convert import load_params
from open_speech_tpu_torch.models.whisper.decode import detect_language
from open_speech_tpu_torch.models.whisper.model import WhisperConfig, encode
from open_speech_tpu_torch.models.whisper.quantize import (
    dequant_size_ratio,
    model_nbytes,
    quantize_whisper_params,
)
from open_speech_tpu_torch.models.whisper.transcribe import (
    TranscribeOptions,
    build_response,
    transcribe,
)
from open_speech_tpu_torch.ops import audio as codec
from open_speech_tpu_torch.ops.mel import log_mel_spectrogram, pad_or_trim
from open_speech_tpu_torch.ops.resample import resample_array
from open_speech_tpu_torch.schemas import LoadedModelInfo

logger = logging.getLogger(__name__)

# reference CT2 repo id -> native preset name
ALIASES: dict[str, str] = {
    "Systran/faster-whisper-tiny": "tiny",
    "Systran/faster-whisper-tiny.en": "tiny.en",
    "Systran/faster-whisper-base": "base",
    "Systran/faster-whisper-base.en": "base.en",
    "Systran/faster-whisper-small": "small",
    "Systran/faster-whisper-small.en": "small.en",
    "Systran/faster-whisper-medium": "medium",
    "Systran/faster-whisper-medium.en": "medium.en",
    "Systran/faster-whisper-large-v2": "large-v2",
    "Systran/faster-whisper-large-v3": "large-v3",
    "deepdml/faster-whisper-large-v3-turbo-ct2": "large-v3-turbo",
    "Systran/faster-distil-whisper-large-v3": "distil-large-v3",
    # distil .en family: explicit, or the fuzzy tail-strip would map them
    # onto the non-distil presets (wrong decoder depth)
    "Systran/faster-distil-whisper-small.en": "distil-small.en",
    "Systran/faster-distil-whisper-medium.en": "distil-medium.en",
    "distil-whisper/distil-small.en": "distil-small.en",
    "distil-whisper/distil-medium.en": "distil-medium.en",
    "distil-whisper/distil-large-v3": "distil-large-v3",
    "openai/whisper-large-v3-turbo": "large-v3-turbo",
    "openai/whisper-large-v3": "large-v3",
    # committed EOT-trained fixture: test-tiny geometry, weights that emit
    # <|endoftext|> / <|nospeech|>
    "test-tiny-eot": "test-tiny",
}

_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float16": torch.bfloat16,  # bf16 stands in for fp16, as in the JAX package
    "float32": torch.float32,
    "int8": torch.bfloat16,  # the base dtype; weights packed to int8 at load
}


def resolve_preset(model_id: str) -> str | None:
    """Map any accepted model id onto a preset name."""
    if model_id in ALIASES:
        return ALIASES[model_id]
    name = model_id.removeprefix("whisper-")
    if name in PRESETS:
        return name
    # fuzzy: strip org prefix / ct2 suffixes from arbitrary repo ids
    tail = model_id.split("/")[-1].lower()
    is_distil = "distil" in tail
    tail = re.sub(r"^(faster-|distil-)?whisper-", "", tail)
    tail = re.sub(r"(-ct2.*|-turbo-ct2.*)$", "", tail)
    for candidate in (tail, tail.replace("_", "-")):
        if is_distil and not candidate.startswith("distil-"):
            # a distil repo id must never land on the full-depth preset
            candidate = f"distil-{candidate}"
        if candidate in PRESETS:
            return candidate
    return None


class TorchWhisperBackend:
    """STTBackend implementation on PyTorch (CUDA or CPU)."""

    name = "torch-whisper"

    def __init__(self, device: str | None = None, compute_type: str | None = None) -> None:
        dev = torch.device(device or settings.stt_device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"STT device {str(dev)!r} asked for, but CUDA is not available; "
                "pass device='cpu' to run on the CPU"
            )
        if dev.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported STT device {str(dev)!r} (cuda or cpu)")
        self._device = dev
        self._compute_type = compute_type or settings.stt_compute_type
        if self._compute_type == "float32" and dev.type == "cuda":
            # float32 means float32: cuBLAS matmuls and cuDNN convolutions
            # would otherwise be allowed to round inputs to TF32
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            logger.info("float32 compute: TF32 disabled for matmuls and convolutions")
        self._models: dict[str, dict[str, Any]] = {}  # id -> {model, cfg, tok}
        self._last_used: dict[str, float] = {}
        self._loaded_at: dict[str, float] = {}
        self._load_lock = threading.Lock()

    @property
    def device(self) -> torch.device:
        return self._device

    def _dtype(self) -> torch.dtype:
        return _DTYPES.get(self._compute_type, torch.bfloat16)

    # ── weights ───────────────────────────────────────────────────────

    def _weight_dirs(self, model_id: str) -> list[Path]:
        dirs = []
        for root in self._cache_roots():
            dirs.append(root / model_id)
            safe = f"models--{model_id.replace('/', '--')}"
            snap_root = root / safe / "snapshots"
            if snap_root.is_dir():
                dirs.extend(sorted(snap_root.iterdir(), reverse=True))
        return dirs

    def _find_checkpoint(self, model_id: str) -> Path | None:
        for d in self._weight_dirs(model_id):
            if d.is_dir() and any(
                (d / f).exists()
                for f in ("model.safetensors", "model.safetensors.index.json")
            ):
                return d
            if d.is_dir() and any(p.suffix in (".pt", ".bin") for p in d.iterdir()):
                return d
        return None

    # ── protocol: lifecycle ───────────────────────────────────────────

    def load_model(self, model_id: str) -> None:
        if model_id in self._models:
            self._last_used[model_id] = time.time()
            return
        with self._load_lock:
            # double-checked: concurrent loads must not replace the entry
            if model_id in self._models:
                self._last_used[model_id] = time.time()
                return
            self._load_model_locked(model_id)

    def _load_model_locked(self, model_id: str) -> None:
        preset = resolve_preset(model_id)
        if preset is None:
            raise ValueError(f"Unknown whisper model id: {model_id}")
        cfg: WhisperConfig = PRESETS[preset]
        ckpt = self._find_checkpoint(model_id)
        t0 = time.time()
        if ckpt is not None:
            logger.info("Loading %s weights from %s", model_id, ckpt)
            model, cfg = load_params(str(ckpt), cfg, self._dtype(), self._device)
            tok = get_tokenizer(str(ckpt), n_vocab=cfg.n_vocab, n_langs=cfg.n_langs)
        else:
            logger.warning(
                "No checkpoint on disk for %s — initializing random weights "
                "(architecture/serving identical; WER meaningless)",
                model_id,
            )
            gen = torch.Generator(device=self._device).manual_seed(0)
            model = init_params(gen, cfg, self._dtype(), self._device)
            tok = get_tokenizer(n_vocab=cfg.n_vocab, n_langs=cfg.n_langs)
        if self._compute_type == "int8":
            nbytes = model_nbytes(model)
            quantize_whisper_params(model)  # the bf16 weights, as JAX packs them
            logger.info("Quantized %s weights to int8 (per-channel): %.3f of the bf16 bytes",
                        model_id, dequant_size_ratio(nbytes, model))
        model = self._maybe_shard(model)
        self._models[model_id] = {"model": model, "cfg": cfg, "tok": tok}
        now = time.time()
        self._loaded_at[model_id] = now
        self._last_used[model_id] = now
        logger.info("Loaded %s (%s) in %.1fs", model_id, preset, now - t0)
        if settings.os_precompile_on_load:
            self._warmup(model_id)
            # the TTL clock starts at readiness, not at weight load
            self._last_used[model_id] = time.time()

    @staticmethod
    def _maybe_shard(model):
        """Tensor-parallel shards when ``OS_TPU_MESH`` asks for a model axis
        (``parallel/mesh.py``), after quantisation so that each int8 scale
        covers a whole row. A failure is logged and the model served
        unsharded, as in the JAX package; a model axis of 1 leaves it whole
        without building a mesh."""
        spec = (settings.os_tpu_mesh or "").strip()
        if not spec:
            return model
        try:
            from open_speech_tpu_torch.parallel.mesh import (
                mesh_from_settings,
                parse_mesh,
                shard_model,
            )

            if parse_mesh(spec)[1] <= 1:
                return model
            mesh = mesh_from_settings()
            shard_model(model, mesh)
            logger.info("Sharded whisper over mesh %s (tensor parallel)",
                        dict(zip(mesh.mesh_dim_names, mesh.shape)))
            return model
        except Exception:  # noqa: BLE001 — never let TP placement break serving
            logger.exception("OS_TPU_MESH sharding failed; serving unsharded")
            return model

    def _warmup(self, model_id: str) -> None:
        """Build the CUDA kernels and drive one beam-5 transcribe of 30 s of
        silence through the public path, so the first request pays neither;
        with ``os_stream_incremental``, also one streaming block encode and
        ``interim_states``, so the first streaming chunk does not pay K2's
        first launch; with ``os_stt_batched_longform``, one batched encode
        and beam-5 decode at the largest batch rung <= ``os_stt_batch_windows``
        (16 by default, the widest batch an upload makes).

        The JAX package precompiles a ladder of XLA programs here (decode
        budgets, prompt-length buckets, mel rungs, streaming shapes, and
        every batched long-form rung). Eager PyTorch compiles nothing per
        shape, so that ladder has no counterpart: what is left is the nvcc
        build, CUDA and cuBLAS start-up, and the allocator's first growth.
        The largest rung holds the most memory (16 windows' cross-KV, 80
        beam rows), so warming it alone grows the allocator's pool to what
        every smaller rung needs.

        Warmup never blocks the load, as in the JAX package: a stage that
        raises (the 16-window rung out of memory on a busy card, say) is
        logged and the model stays loaded. The nvcc build is not a stage:
        a kernel that does not build raises here.
        """
        entry = self._models[model_id]
        t0 = time.time()
        if self._device.type == "cuda":
            from open_speech_tpu_torch.kernels import build

            build.build()
        window_samples = entry["cfg"].n_audio_ctx * 2 * 160  # hop=160
        wav = codec.write_wav(np.zeros(window_samples, np.float32), TARGET_RATE)
        stages = [("beam-5 transcribe", lambda: self._run_inference(
            wav, model_id, language="en", beam_size=5, fallback=False,
            _budget_override=max(_warmed_budgets(), default=224),
        ))]
        if settings.os_stt_batched_longform:
            stages.append(("batched rung", lambda: self._warmup_batched(entry, window_samples)))
        if settings.os_stream_incremental:
            stages.append(("streaming block encode", lambda: self._warmup_streaming(entry)))
        failed = []
        for name, stage in stages:
            try:
                stage()
            except Exception:  # noqa: BLE001 — warmup must never block load
                logger.exception("STT warmup stage %r failed (%s)", name, model_id)
                failed.append(name)
        logger.info("STT warmup for %s done in %.1fs (%d of %d stages failed)",
                    model_id, time.time() - t0, len(failed), len(stages))

    @torch.no_grad()
    def _warmup_batched(self, entry: dict[str, Any], window_samples: int) -> None:
        """One batched long-form rung: the largest bucket <= os_stt_batch_windows."""
        cfg = entry["cfg"]
        rung = max(b for b in BATCH_BUCKETS if b <= max(1, int(settings.os_stt_batch_windows)))
        mel = log_mel_spectrogram(
            torch.zeros(rung, window_samples, device=self._device), n_mels=cfg.n_mels
        )
        sot = entry["tok"].special.sot_sequence("en", "transcribe", timestamps=True)
        _decode_rows_with_fallback(
            entry["model"], cfg, entry["tok"], encode(entry["model"], mel, cfg),
            np.asarray([sot], np.int32),
            TranscribeOptions(
                language="en", beam_size=5, temperature=(0.0,),
                max_new_tokens=max(_warmed_budgets(), default=224),
                compression_ratio_threshold=None, logprob_threshold=None,
                no_speech_threshold=None,
            ),
        )

    @staticmethod
    def _warmup_streaming(entry: dict[str, Any]) -> None:
        """One streaming block encode and its interim states (K2's first launch)."""
        from open_speech_tpu_torch.models.whisper.streaming import (
            StreamingWhisperEncoder,
        )

        senc = StreamingWhisperEncoder(entry["model"], entry["cfg"])
        senc.append_audio(np.zeros(TARGET_RATE, np.float32))
        senc.interim_states()

    def unload_model(self, model_id: str) -> None:
        if self._models.pop(model_id, None) is not None:
            logger.info("Unloaded %s", model_id)
        self._last_used.pop(model_id, None)
        self._loaded_at.pop(model_id, None)

    def loaded_models(self) -> list[LoadedModelInfo]:
        ttl = settings.os_model_ttl
        now = time.time()
        out = []
        for mid in list(self._models):  # snapshot: loads insert concurrently
            last = self._last_used.get(mid)
            out.append(
                LoadedModelInfo(
                    model=mid,
                    backend=self.name,
                    device=str(self._device),
                    compute_type=self._compute_type,
                    loaded_at=self._loaded_at.get(mid, 0.0),
                    last_used_at=last,
                    is_default=(mid == settings.stt_model),
                    ttl_remaining=(
                        max(0.0, ttl - (now - (last or now))) if ttl > 0 else None
                    ),
                )
            )
        return out

    def is_model_loaded(self, model_id: str) -> bool:
        return model_id in self._models

    # ── cache management ──────────────────────────────────────────────

    def _cache_roots(self) -> list[Path]:
        roots = []
        if settings.stt_model_dir:
            roots.append(Path(settings.stt_model_dir).expanduser())
        for env in ("HF_HUB_CACHE", "HUGGINGFACE_HUB_CACHE"):
            if os.environ.get(env):
                roots.append(Path(os.environ[env]).expanduser())
        roots.append(Path.home() / ".cache" / "huggingface" / "hub")
        return roots

    def list_cached_models(self) -> list[dict[str, Any]]:
        """Every ``models--<org>--<name>`` directory under the cache roots
        whose id maps onto a whisper preset, with its size on disk."""
        result = []
        seen = set()
        for root in self._cache_roots():
            if not root.is_dir():
                continue
            for entry in root.iterdir():
                name = entry.name
                if not name.startswith("models--"):
                    continue
                mid = name.removeprefix("models--").replace("--", "/")
                if mid in seen or resolve_preset(mid) is None:
                    continue
                seen.add(mid)
                size = sum(f.stat().st_size for f in entry.rglob("*") if f.is_file())
                result.append({"model": mid, "backend": self.name,
                               "size_mb": round(size / 1e6), "path": str(entry)})
        return result

    def is_model_cached(self, model_id: str) -> bool:
        return self._find_checkpoint(model_id) is not None

    def delete_cached_model(self, model_id: str) -> bool:
        """Remove the model's directories; only those inside a cache root."""
        deleted = False
        safe = f"models--{model_id.replace('/', '--')}"
        for root in self._cache_roots():
            for cand in (root / safe, root / model_id):
                if cand.is_dir() and root.resolve() in cand.resolve().parents:
                    shutil.rmtree(cand)
                    deleted = True
        return deleted

    # ── protocol: inference ───────────────────────────────────────────

    @torch.no_grad()
    def detect_language_pcm(self, model_id: str, pcm: np.ndarray) -> str:
        """Detect the spoken language of (up to) the first window of 16 kHz
        float PCM. The streaming session calls it once per auto-detect
        session, after ~1 s of speech, and pins the result."""
        entry = self._ensure_model(model_id)
        cfg = entry["cfg"]
        window_samples = cfg.n_audio_ctx * 2 * 160
        audio = torch.as_tensor(np.asarray(pcm, np.float32), device=self._device)
        mel = log_mel_spectrogram(pad_or_trim(audio, window_samples), n_mels=cfg.n_mels)
        enc_out = encode(entry["model"], mel[None], cfg)
        codes, _probs = detect_language(entry["model"], cfg, entry["tok"].special, enc_out)
        return str(codes[0])

    def _ensure_model(self, model_id: str) -> dict[str, Any]:
        # get-then-load loop: an eviction between a membership test and the
        # lookup must not turn a valid request into a KeyError
        for _ in range(3):
            entry = self._models.get(model_id)
            if entry is not None:
                self._last_used[model_id] = time.time()
                return entry
            self.load_model(model_id)
        raise RuntimeError(f"model {model_id!r} kept being evicted during load")

    def _run_inference(
        self,
        audio: bytes,
        model_id: str,
        task: str = "transcribe",
        language: str | None = None,
        response_format: str = "json",
        temperature: float = 0.0,
        prompt: str | None = None,
        beam_size: int = 5,
        fallback: bool = True,
        _budget_override: int | None = None,
    ) -> dict[str, Any]:
        entry = self._ensure_model(model_id)
        pcm, rate = codec.read_wav(audio) if codec.is_wav(audio) else (
            codec.pcm16_to_float(audio),
            TARGET_RATE,
        )
        pcm = resample_array(pcm, rate, TARGET_RATE, self._device)
        temps: tuple[float, ...] = (
            (temperature,)
            if temperature > 0 or not fallback
            else (0.0, 0.2, 0.4, 0.6, 0.8, 1.0)
        )
        # Decode budget scales with audio duration (whisper emits well under
        # 12 tokens/s incl. timestamps), in multiples of 16, then rounded up
        # to a warmed budget as the JAX package does (the decode stops at
        # EOT, so a larger bound only matters for audio that never ends)
        duration_s = len(pcm) / TARGET_RATE
        budget = min(224, int(duration_s * 12) + 12)
        budget = -(-budget // 16) * 16
        covering = [w for w in _warmed_budgets() if w >= budget]
        if covering:
            budget = covering[0]
        if _budget_override is not None:
            budget = _budget_override
        opts = TranscribeOptions(
            task=task,
            language=language if task == "transcribe" else None,
            beam_size=beam_size,
            temperature=temps,
            initial_prompt=prompt,
            max_new_tokens=budget,
            compression_ratio_threshold=2.4 if fallback else None,
            logprob_threshold=-1.0 if fallback else None,
        )
        window_s = entry["cfg"].n_audio_ctx * 2 * 0.01
        if (
            settings.os_stt_batched_longform
            and duration_s > 2 * window_s
            and temps[0] == 0.0
        ):  # no draft here, as in the JAX package
            segments, info = transcribe_batched(
                entry["model"], entry["cfg"], entry["tok"], pcm, opts,
                max_batch=int(settings.os_stt_batch_windows),
            )
        else:
            segments, info = transcribe(
                entry["model"], entry["cfg"], entry["tok"], pcm, opts,
                draft=self._spec_draft(model_id, entry, beam_size, temps),
            )
        return build_response(segments, info, task, response_format)

    def _spec_draft(
        self, model_id: str, entry: dict[str, Any], beam_size: int, temps: tuple[float, ...]
    ) -> dict[str, Any] | None:
        """The speculative draft for a request, or None: OS_SPEC_DRAFT_MODEL
        is set and is not the target, beam 1, the first temperature 0 (a
        sampled-only request never verifies), and the draft shares the
        target's vocabulary. A draft that fails to load is logged and the
        request decodes without it, as in the JAX package."""
        draft_id = str(settings.os_spec_draft_model or "").strip()
        if not draft_id or draft_id == model_id or beam_size != 1 or temps[0] != 0.0:
            return None
        try:
            d_entry = self._ensure_model(draft_id)
        except Exception:  # noqa: BLE001 — the draft only speeds the decode up
            logger.exception("spec draft %s failed to load; decoding without it", draft_id)
            return None
        if d_entry["cfg"].n_vocab != entry["cfg"].n_vocab:
            logger.warning("spec draft %s vocab mismatch; disabled", draft_id)
            return None
        return {"model": d_entry["model"], "cfg": d_entry["cfg"],
                "gamma": int(settings.os_spec_gamma)}

    def transcribe(
        self,
        audio: bytes,
        model: str,
        language: str | None = None,
        response_format: str = "json",
        temperature: float = 0.0,
        prompt: str | None = None,
        beam_size: int = 5,
        fallback: bool = True,
    ) -> dict[str, Any]:
        return self._run_inference(
            audio, model, task="transcribe", language=language,
            response_format=response_format, temperature=temperature,
            prompt=prompt, beam_size=beam_size, fallback=fallback,
        )

    def translate(
        self,
        audio: bytes,
        model: str,
        response_format: str = "json",
        temperature: float = 0.0,
        prompt: str | None = None,
    ) -> dict[str, Any]:
        return self._run_inference(
            audio, model, task="translate", response_format=response_format,
            temperature=temperature, prompt=prompt,
        )


def _warmed_budgets() -> list[int]:
    return sorted(
        int(b)
        for b in str(settings.os_stt_precompile_budgets).split(",")
        if b.strip().isdigit()
    )
