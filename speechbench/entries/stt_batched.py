"""The entry the STT cells drive: ``runtime/batcher_pool.py:transcribe_pcm_batched``,
the call a streaming session or a ``/v1/realtime`` commit makes with
``OS_BATCHER_ENABLED``, on a ``TorchWhisperBackend``.

Set-up makes the weights from the seed (``weights.py``) and hands them to
the port's ``Whisper``, built at the configuration's shapes on the meta
device, as its storage (one allocation, no copy), in bf16, as the backend's
model entry, so no checkpoint is read and the backend's own
warmup (a beam-5 decode of silence that no cell uses) never runs. The
tokenizer handed to the program is the port's own layout with one change:
its text is the token ids, so the benchmark reads the served tokens from the
served answer itself.

``check`` decides ``correct``: after the window, with the program's state
freed, the reference (``reference.py``) remakes the weights from the seed
and is run once over each sampled window's audio, prompt and served
tokens. With a control, the reference's fp8 copy is judged at the same
positions in the program's place.
"""

from __future__ import annotations

import asyncio
import math

import numpy as np
import torch

from speechbench import reference, traffic as traffic_gen, weights
from speechbench.clock import note

# what ``transcribe_pcm_batched`` bounds a window's tokens by: the pool's
# budget cap, and the batcher's default cap on its slots' budgets
MAX_BUDGET = 224
BATCHER_MAX_TOKENS = 448


def port_name(name: str) -> str:
    """openai/whisper state-dict name -> the port's ``Whisper`` name."""
    for old, new in ((".attn_ln.", ".ln1."), (".cross_attn_ln.", ".ln_cross."),
                     (".mlp_ln.", ".ln_mlp."), (".cross_attn.", ".cross."),
                     (".query.", ".q."), (".key.", ".k."), (".value.", ".v."), (".out.", ".o."),
                     (".mlp.0.", ".mlp_in."), (".mlp.2.", ".mlp_out.")):
        name = name.replace(old, new)
    return {"encoder.positional_embedding": "encoder.pos",
            "decoder.positional_embedding": "decoder.pos_emb",
            "decoder.token_embedding.weight": "decoder.tok_emb"}.get(name, name)


class IdTokenizer:
    """The port's tokenizer layout, decoding to the token ids as text."""

    def __init__(self, tok) -> None:
        self.special = tok.special
        self.non_speech_tokens = tok.non_speech_tokens

    @staticmethod
    def decode(ids) -> str:
        return " ".join(str(int(i)) for i in ids)


def cache_budget_cap(cfg: dict, prompt_len: int) -> int:
    """The most tokens the batcher's self-KV pool leaves a window: the pool
    holds the prompt, the batcher's budget and one more position, rounded up
    to 64, at most the decoder's positions."""
    budget = min(MAX_BUDGET, BATCHER_MAX_TOKENS)
    cache = min(cfg["max_target_positions"], -(-(prompt_len + budget + 1) // 64) * 64)
    return min(budget, cache - prompt_len - 1)


class Entry:
    """One model behind the continuous batcher, for one run."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from open_speech_tpu_torch.backends.torch_whisper import TorchWhisperBackend
        from open_speech_tpu_torch.config import settings
        from open_speech_tpu_torch.models.whisper.model import Whisper, WhisperConfig
        from open_speech_tpu_torch.models.whisper.tokenizer import get_tokenizer
        from open_speech_tpu_torch.runtime.batcher import ContinuousBatcher

        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.model_id = config["name"]
        self.language = config["serving"]["language"]
        self.batcher_cls = ContinuousBatcher
        self._settings = settings
        self._saved = {k: getattr(settings, k) for k in
                       ("os_batcher_enabled", "os_batch_max_sessions", "os_precompile_on_load")}
        settings.os_batcher_enabled = True
        settings.os_batch_max_sessions = int(traffic["slots"])
        settings.os_precompile_on_load = False
        if config["encoder_ffn_dim"] != 4 * config["d_model"] or (
                config["decoder_ffn_dim"] != 4 * config["d_model"]):
            raise ValueError("the port's Whisper blocks have an MLP of 4 x d_model")
        n_langs = config["assumed"]["n_langs"]
        wcfg = WhisperConfig(
            n_mels=config["num_mel_bins"], n_vocab=config["vocab_size"],
            n_audio_ctx=config["max_source_positions"], n_audio_state=config["d_model"],
            n_audio_head=config["encoder_attention_heads"], n_audio_layer=config["encoder_layers"],
            n_text_ctx=config["max_target_positions"], n_text_state=config["d_model"],
            n_text_head=config["decoder_attention_heads"], n_text_layer=config["decoder_layers"],
            n_langs=n_langs,
        )
        if self.device.type == "cuda":
            torch.zeros(1, device=self.device)  # the context, made by its first allocation
            note("CUDA context up")
        with torch.device("meta"):  # shapes only: the made tensors become its storage
            model = Whisper(wcfg, torch.bfloat16)
        targets = model.state_dict()
        made = {port_name(k): v for k, v in weights.make(config, seed, self.device).items()}
        if sorted(made) != sorted(targets):
            raise ValueError("the made weights do not cover the port's model one to one")
        model.load_state_dict({k: v.to(targets[k].dtype) for k, v in made.items()}, assign=True)
        model.requires_grad_(False).eval()
        del made, targets
        note("weights made on the device as the port's Whisper")
        tok = IdTokenizer(get_tokenizer(n_vocab=config["vocab_size"], n_langs=n_langs))
        self.backend = TorchWhisperBackend(device=str(self.device), compute_type="bfloat16")
        self.backend._models[self.model_id] = {"model": model, "cfg": wcfg, "tok": tok}
        self.pool = traffic_gen.clips(seed)
        self.sp = reference.special_tokens(config["vocab_size"], n_langs)
        self.prompt = reference.prompt(self.sp, config["serving"]["language_index"])
        self.max_tokens = cache_budget_cap(config, len(self.prompt))

    @property
    def steps_per_tick(self) -> int:
        from open_speech_tpu_torch.config import settings

        return max(1, settings.os_batch_steps_per_tick)

    def budget(self, req) -> int:
        return reference.token_budget(req.n_samples, self.max_tokens)

    async def call(self, req) -> list[int]:
        from open_speech_tpu_torch.runtime.batcher_pool import transcribe_pcm_batched

        out = await transcribe_pcm_batched(self.backend, self.model_id, self.language,
                                           traffic_gen.audio(self.pool, req))
        return [int(t) for t in out["text"].split()]

    async def warm(self) -> None:
        """The cell's shapes before the window: one window through the batcher
        (the batcher, its pools, the kernels, built on a checkout's first run,
        the prompt feed and a tick at every slot), then the encoder and the
        cross-attention K and V at every admission size the batcher can form,
        1 to its slots: cuBLAS and cuDNN choose and load their kernels per
        shape on first use, which inside the window would stall it."""
        await self.call(traffic_gen.Request(-1, traffic_gen.SAMPLE_RATE // 2, 0, 0))
        note("warm: one window through the batcher")
        slots = int(self.traffic["slots"])
        await asyncio.get_running_loop().run_in_executor(None, self._warm_admissions, slots)
        note(f"warm: encoder at admission sizes 1 to {slots}")

    @torch.no_grad()
    def _warm_admissions(self, slots: int) -> None:
        """One layer deep: every layer of the encoder, and of the cross K and
        V, runs the same shapes, so the first loads what a size needs."""
        from open_speech_tpu_torch.models.whisper.model import encode, precompute_cross_kv_dense

        entry = self.backend._models[self.model_id]
        model, wcfg = entry["model"], entry["cfg"]
        enc, dec = model.encoder.blocks, model.decoder.blocks
        model.encoder.blocks, model.decoder.blocks = enc[:1], dec[:1]
        try:
            for size in range(1, slots + 1):
                mel = torch.zeros(size, wcfg.n_mels, 2 * wcfg.n_audio_ctx, device=self.device)
                precompute_cross_kv_dense(model, encode(model, mel, wcfg), wcfg)
            self.synchronize()
        finally:
            model.encoder.blocks, model.decoder.blocks = enc, dec

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
        """Stop the batcher and free the model, its pools and the allocator's cache."""
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
        served tokens always in it), the widest logit gap of a served token
        under the reference's pick; over every window, those that served
        more tokens than their budget. With ``control="fp8"``, the widest
        gap is that of the token the reference's fp8 copy puts first at each
        position of the same prompts and served tokens (the program's own is
        printed beside it)."""
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
            made = weights.make(self.config, self.seed, self.device)
            w = reference.Weights(made)
            low = reference.Weights(made, fp8=True) if control else None
            n_samples = self.config["max_source_positions"] * 2 * reference.HOP
            vocab = self.config["vocab_size"]
            for r in sample:
                if any(not 0 <= t < vocab for t in r.served):
                    gaps.append(math.inf)
                    continue
                mel = torch.from_numpy(reference.log_mel(
                    traffic_gen.audio(self.pool, r), self.config["num_mel_bins"],
                    n_samples)).to(self.device)
                tokens, ended = self.prompt + r.served, len(r.served) < self.budget(r)
                logits = reference.decoder_logits(
                    w, tokens, reference.encode(w, mel, self.config),
                    self.config)[len(self.prompt) - 1:]
                gaps += reference.token_gaps(logits, r.served, self.sp, ended)
                if low is not None:
                    low_logits = reference.decoder_logits(
                        low, tokens, reference.encode(low, mel, self.config),
                        self.config)[len(self.prompt) - 1:]
                    picks = reference.rule_picks(low_logits, r.served, self.sp, ended)
                    low_gaps += reference.token_gaps(logits, r.served, self.sp, ended, picks)
        note(f"check: {len(gaps)} tokens of {min(sample_size, len(finished))} windows judged, "
             f"the program's widest gap {max(gaps, default=math.inf)!r}"
             + (f", the {control} control's {max(low_gaps, default=math.inf)!r}"
                if control else ""))
        widest = max(low_gaps if control else gaps, default=math.inf)
        return {"max_logit_gap": widest, "over_budget": over}
