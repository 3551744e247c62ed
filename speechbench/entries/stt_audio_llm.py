"""The entry the audio-LLM STT cells drive: ``runtime/batcher_pool.py:
transcribe_pcm_batched``, the call a streaming session or a ``/v1/realtime``
commit makes with ``OS_BATCHER_ENABLED``, on a ``TorchWhisperBackend``
holding Voxtral, which the pool serves through its ``AudioLLMBatcher``.

Set-up makes the weights from the seed (``weights_voxtral.py``) and hands
them to the port's ``Voxtral``, built at the configuration's shapes on the
meta device, as its storage (no copy), in bf16, as the backend's model
entry: no checkpoint is read. The tokens object handed to the program is
the port's own (``models/voxtral/tokens.py``) with the language ids the
configuration assumes, and its text is the token ids, so the benchmark
reads the served tokens from the served answer itself.

``check`` decides ``correct``: after the window, with the program's state
freed, the reference (``reference_voxtral.py``) remakes the weights from the
seed a layer at a time and runs teacher-forced over each sampled window's
audio, prompt and served tokens. With a control, the reference's fp8 copy
is judged at the same positions in the program's place.
"""

from __future__ import annotations

import asyncio
import math

import numpy as np
import torch

from open_speech_tpu_torch.models.voxtral.tokens import VoxtralTokens
from speechbench import reference, reference_voxtral, traffic as traffic_gen, weights_voxtral
from speechbench.clock import note

SAMPLES_PER_FRAME = reference.HOP
# windows the reference takes at once: its float32 activations stay a few GB
REFERENCE_BATCH = 8


class Entry:
    """Voxtral behind the continuous batcher, for one run."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from open_speech_tpu_torch.backends.torch_whisper import TorchWhisperBackend
        from open_speech_tpu_torch.config import settings
        from open_speech_tpu_torch.models.voxtral.model import Voxtral, VoxtralConfig
        from open_speech_tpu_torch.runtime.audio_llm_batcher import AudioLLMBatcher

        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.model_id = config["name"]
        self.language = config["serving"]["language"]
        self.batcher_cls = AudioLLMBatcher
        self._settings = settings
        self._saved = {k: getattr(settings, k) for k in
                       ("os_batcher_enabled", "os_batch_max_sessions", "os_precompile_on_load")}
        settings.os_batcher_enabled = True
        settings.os_batch_max_sessions = int(traffic["slots"])
        settings.os_precompile_on_load = False
        self.vcfg = VoxtralConfig.from_hf(config)
        if self.device.type == "cuda":
            torch.zeros(1, device=self.device)  # the context, made by its first allocation
            note("CUDA context up")
        with torch.device("meta"):  # shapes only: the made tensors become its storage
            model = Voxtral(self.vcfg, torch.bfloat16)
        targets = model.state_dict()
        made = weights_voxtral.make(config, seed, self.device)
        if sorted(made) != sorted(targets):
            raise ValueError("the made weights do not cover the port's model one to one")
        model.load_state_dict({k: v.to(targets[k].dtype) for k, v in made.items()}, assign=True)
        model.requires_grad_(False).eval()
        del made, targets
        note("weights made on the device as the port's Voxtral")
        self.tok = IdTokens(self.vcfg.audio_positions,
                            {self.language: list(config["assumed"]["lang_ids"])},
                            int(config["assumed"]["eos"]))
        self.backend = TorchWhisperBackend(device=str(self.device), compute_type="bfloat16")
        self.backend._models[self.model_id] = {"model": model, "cfg": self.vcfg, "tok": self.tok}
        self.pool = traffic_gen.clips(seed)
        self.prompt = self.tok.transcription_prompt(self.language)
        self.max_tokens = AudioLLMBatcher.token_budget(traffic_gen.CLIP_S)
        self.token_budget = AudioLLMBatcher.token_budget

    @property
    def steps_per_tick(self) -> int:
        from open_speech_tpu_torch.config import settings

        return max(1, settings.os_batch_steps_per_tick)

    def budget(self, req) -> int:
        return min(self.token_budget(req.n_samples / traffic_gen.SAMPLE_RATE), self.max_tokens)

    async def call(self, req) -> list[int]:
        from open_speech_tpu_torch.runtime.batcher_pool import transcribe_pcm_batched

        out = await transcribe_pcm_batched(self.backend, self.model_id, self.language,
                                           traffic_gen.audio(self.pool, req))
        return [int(t) for t in out["text"].split()]

    async def warm(self) -> None:
        """The cell's shapes before the window: one window through the batcher
        (the batcher, its pool, the kernels, built on a checkout's first
        run, and a tick at every slot), then the encoder, the adapter and
        the prefill at every admission size the batcher can form: cuBLAS
        chooses and loads its kernels per shape on first use, which inside
        the window would stall it."""
        from open_speech_tpu_torch.runtime.batcher_pool import get_batcher

        await self.call(traffic_gen.Request(-1, traffic_gen.SAMPLE_RATE // 2, 0, 0))
        note("warm: one window through the batcher")
        batcher = await get_batcher(self.backend, self.model_id, self.language)
        sizes = batcher._admission_size(batcher.n_slots)
        await asyncio.get_running_loop().run_in_executor(None, self._warm_admissions, sizes)
        note(f"warm: encoder, adapter and prefill at admission sizes 1 to {sizes}")

    @torch.no_grad()
    def _warm_admissions(self, sizes: int) -> None:
        """One layer deep (every layer runs the same shapes), into a cache
        of its own: the batcher's pool is not touched."""
        from open_speech_tpu_torch.models.voxtral.model import encode_audio, prefill

        model, cfg = self.backend._models[self.model_id]["model"], self.vcfg
        enc, layers = model.encoder.blocks, model.layers
        model.encoder.blocks, model.layers = enc[:1], layers[:1]
        ids = torch.tensor(self.prompt[:-1], device=self.device)
        try:
            for size in range(1, sizes + 1):
                mel = torch.zeros(size, cfg.audio.n_mels, 2 * cfg.audio.n_audio_ctx,
                                  device=self.device)
                cache = torch.zeros(1, 2, size, cfg.kv_heads, len(ids), cfg.head_dim,
                                    dtype=torch.bfloat16, device=self.device)
                prefill(model, encode_audio(model, mel), ids, cache,
                        torch.arange(size, device=self.device))
            self.synchronize()
        finally:
            model.encoder.blocks, model.layers = enc, layers

    def synchronize(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def memory_peak_bytes(self) -> int | None:
        if self.device.type != "cuda":
            return None
        return int(torch.cuda.max_memory_allocated(self.device))

    def reset_memory_peak(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)

    async def close(self) -> None:
        """Stop the batcher and free the model, its pool and the allocator's cache."""
        from open_speech_tpu_torch.runtime.batcher_pool import reset_pool, shutdown_batchers

        await shutdown_batchers()
        reset_pool()
        self.backend._models.clear()
        self.backend = None
        for k, v in self._saved.items():
            setattr(self._settings, k, v)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()

    # ── correctness ───────────────────────────────────────────────────

    @torch.no_grad()
    def check(self, finished: list, sample_size: int, control: str | None = None) -> dict:
        """The numbers that decide ``correct``, over the windows that came
        back: over a sample drawn from the seed (the window with the most
        served tokens always in it), the widest gap by which a served token's
        reference logit lies below the reference's largest (infinite for an
        id outside the vocabulary; a window that stopped short of its budget
        must have the end token as the reference's next pick); over every
        window, those that served more tokens than their budget. With
        ``control="fp8"``, the widest gap is that of the token the
        reference's fp8 copy puts first at each position of the same
        windows (the program's own is printed beside it)."""
        if control not in (None, "fp8"):
            raise ValueError(f"control {control!r}: only 'fp8'")
        reference.strict_float32()
        over = sum(1 for r in finished if len(r.served) > self.budget(r))
        gaps: list[float] = []
        low_gaps: list[float] = []
        if finished:
            longest = max(finished, key=lambda r: (len(r.served), r.index))
            rest = [r for r in finished if r is not longest]
            rng = np.random.default_rng([self.seed, 5])
            pick = rng.choice(len(rest), size=min(sample_size - 1, len(rest)), replace=False)
            sample = [longest] + [rest[i] for i in sorted(pick)]
            vocab = self.vcfg.vocab
            judged = []
            for r in sample:
                if any(not 0 <= t < vocab for t in r.served):
                    gaps.append(math.inf)
                else:
                    judged.append(r)
            for at in range(0, len(judged), REFERENCE_BATCH):
                chunk = judged[at: at + REFERENCE_BATCH]
                ref = self._reference(chunk, fp8=False)
                low = self._reference(chunk, fp8=True) if control else [None] * len(chunk)
                for r, logits, low_logits in zip(chunk, ref, low):
                    ended = len(r.served) < self.budget(r)
                    chosen = r.served + [self.tok.eos] if ended else list(r.served)
                    gaps += token_gaps(logits, chosen)
                    if low_logits is not None:
                        low_gaps += token_gaps(logits, low_logits.argmax(dim=-1).tolist())
        note(f"check: {len(gaps)} tokens of {min(sample_size, len(finished))} windows judged, "
             f"the program's widest gap {max(gaps, default=math.inf)!r}"
             + (f", the {control} control's {max(low_gaps, default=math.inf)!r}"
                if control else ""))
        widest = max(low_gaps if control else gaps, default=math.inf)
        return {"max_logit_gap": widest, "over_budget": over}

    def _reference(self, windows: list, fp8: bool) -> list[torch.Tensor]:
        """The reference's logits at each window's judged rows: from the
        prompt's last position, one per served token, and one more where the
        window stopped short of its budget."""
        a = self.config["audio_config"]
        n_samples = a["max_source_positions"] * 2 * SAMPLES_PER_FRAME
        mels = torch.stack([torch.from_numpy(reference.log_mel(
            traffic_gen.audio(self.pool, r), a["num_mel_bins"], n_samples)) for r in windows])
        p = len(self.prompt)
        rows = [range(p - 1, p - 1 + len(r.served) + int(len(r.served) < self.budget(r)))
                for r in windows]
        return reference_voxtral.logits(self.config, self.seed, mels.to(self.device),
                                        [self.prompt + r.served for r in windows], rows, fp8)


class IdTokens(VoxtralTokens):
    """The port's Voxtral tokens, decoding to the token ids as text."""

    @staticmethod
    def decode(ids) -> str:
        return " ".join(str(int(i)) for i in ids)


def token_gaps(logits: torch.Tensor, chosen: list[int]) -> list[float]:
    """Per row j of ``logits`` [n, V]: how far ``chosen[j]``'s logit lies
    below the row's largest (0 where it is the reference's pick)."""
    rows = logits[: len(chosen)].double()
    picked = rows[torch.arange(len(chosen)), torch.tensor(chosen, device=rows.device)]
    return (rows.max(dim=-1).values - picked).tolist()
