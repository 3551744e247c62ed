"""Whisper tokenizer: GPT-2 byte-level BPE + special-token layout.

A copy of ``open_speech_tpu/models/whisper/tokenizer.py`` (pure Python):

  - ``WhisperTokenizer`` loads ``vocab.json``/``merges.txt`` (openai or HF
    checkpoint layout) when weights are on disk.
  - ``FallbackTokenizer`` is a byte-level tokenizer (ids 0..255 = utf-8
    bytes) with the same special-token layout, used for tests and when no
    vocab files exist.

The special-token layout is positional, derived from the vocab size:
``base = n_vocab - (2 + n_langs + 6 + n_timestamps)``; for all released
whisper checkpoints n_timestamps = 1501 and base lands on 50257
(multilingual) / 50256 (.en) — the <|endoftext|> index of GPT-2.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from functools import lru_cache

# Whisper's language registry in token order (v3 appends yue). Token id for
# language i is sot + 1 + i.
LANGUAGES = (
    "en zh de es ru ko fr ja pt tr pl ca nl ar sv it id hi fi vi he uk el ms "
    "cs ro da hu ta no th ur hr bg lt la mi ml cy sk te fa lv bn sr az sl kn "
    "et mk br eu is hy ne mn bs kk sq sw gl mr pa si km sn yo so af oc ka be "
    "tg sd gu am yi lo uz fo ht ps tk nn mt sa lb my bo tl mg as tt haw ln "
    "ha ba jw su yue"
).split()


@dataclass(frozen=True)
class SpecialTokens:
    eot: int
    sot: int
    lang_begin: int  # first language token
    n_langs: int
    translate: int
    transcribe: int
    startoflm: int
    startofprev: int
    no_speech: int
    no_timestamps: int
    timestamp_begin: int
    n_timestamps: int

    @classmethod
    def from_vocab(cls, n_vocab: int, n_langs: int, n_timestamps: int | None = None):
        if n_timestamps is None:
            n_timestamps = 1501 if n_vocab > 50000 else max(2, n_vocab - 266)
        base = n_vocab - (2 + n_langs + 6 + n_timestamps)
        if base <= 0:
            raise ValueError(
                f"vocab {n_vocab} too small for layout (langs={n_langs}, ts={n_timestamps})"
            )
        return cls(
            eot=base,
            sot=base + 1,
            lang_begin=base + 2,
            n_langs=n_langs,
            translate=base + 2 + n_langs,
            transcribe=base + 3 + n_langs,
            startoflm=base + 4 + n_langs,
            startofprev=base + 5 + n_langs,
            no_speech=base + 6 + n_langs,
            no_timestamps=base + 7 + n_langs,
            timestamp_begin=base + 8 + n_langs,
            n_timestamps=n_timestamps,
        )

    def lang_token(self, code: str) -> int:
        return self.lang_begin + LANGUAGES.index(code)

    def lang_code(self, token: int) -> str:
        return LANGUAGES[token - self.lang_begin]

    def timestamp_seconds(self, token: int) -> float:
        return (token - self.timestamp_begin) * 0.02

    def is_timestamp(self, token: int) -> bool:
        return token >= self.timestamp_begin

    def sot_sequence(
        self, language: str = "en", task: str = "transcribe", timestamps: bool = True
    ) -> list[int]:
        seq = [self.sot, self.lang_token(language),
               self.transcribe if task == "transcribe" else self.translate]
        if not timestamps:
            seq.append(self.no_timestamps)
        return seq


@lru_cache(maxsize=1)
def _bytes_to_unicode() -> dict[int, str]:
    """GPT-2's reversible byte <-> printable-unicode map."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


class _BPE:
    """Byte-level BPE codec (GPT-2 scheme)."""

    def __init__(self, vocab: dict[str, int], merges: list[tuple[str, str]]):
        self.encoder = vocab
        self.decoder = {v: k for k, v in vocab.items()}
        self.ranks = {m: i for i, m in enumerate(merges)}
        self.byte_enc = _bytes_to_unicode()
        self.byte_dec = {v: k for k, v in self.byte_enc.items()}
        import regex

        self.pat = regex.compile(
            r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"
        )
        self.cache: dict[str, list[str]] = {}

    def _bpe(self, token: str) -> list[str]:
        cached = self.cache.get(token)
        if cached is not None:
            return cached
        word = list(token)
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.ranks.get(p, 1 << 30))
            if best not in self.ranks:
                break
            merged: list[str] = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and (word[i], word[i + 1]) == best:
                    merged.append(word[i] + word[i + 1])
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = merged
        self.cache[token] = word
        return word

    def encode(self, text: str) -> list[int]:
        ids: list[int] = []
        for piece in self.pat.findall(text):
            mapped = "".join(self.byte_enc[b] for b in piece.encode("utf-8"))
            for sub in self._bpe(mapped):
                tid = self.encoder.get(sub)
                if tid is not None:
                    ids.append(tid)
        return ids

    def decode(self, ids: list[int]) -> str:
        text = "".join(self.decoder.get(i, "") for i in ids)
        data = bytes(self.byte_dec.get(c, ord("?") & 0xFF) for c in text)
        return data.decode("utf-8", errors="replace")


class WhisperTokenizer:
    """Full tokenizer over a real vocab (vocab.json + merges.txt on disk)."""

    def __init__(self, vocab_dir: str, n_langs: int = 100):
        with open(os.path.join(vocab_dir, "vocab.json"), encoding="utf-8") as f:
            vocab = json.load(f)
        merges_path = os.path.join(vocab_dir, "merges.txt")
        merges: list[tuple[str, str]] = []
        with open(merges_path, encoding="utf-8") as f:
            for line in f:
                line = line.rstrip("\n")
                if not line or line.startswith("#version"):
                    continue
                a, _, b = line.partition(" ")
                merges.append((a, b))
        self._bpe = _BPE(vocab, merges)
        text_vocab = len(vocab)
        # layout sits on top of the text vocab
        n_timestamps = 1501
        self.n_vocab = text_vocab + 2 + n_langs + 6 + n_timestamps
        self.special = SpecialTokens.from_vocab(self.n_vocab, n_langs, n_timestamps)

    def encode(self, text: str) -> list[int]:
        return self._bpe.encode(text)

    def decode(self, ids: list[int]) -> str:
        return self._bpe.decode([i for i in ids if i < self.special.eot])

    @property
    def non_speech_tokens(self) -> list[int]:
        """Token ids whisper suppresses during sampling (symbols, music marks).

        Mirrors openai/whisper's suppress list: standalone punctuation/noise
        symbols that only appear in captions.
        """
        symbols = list('"#()*+/:;<=>@[\\]^_`{|}~「」『』') + (
            "<< >> <<< >>> -- --- -( -[ (' (\" (( )) ((( ))) [[ ]] {{ }} ♪♪ ♪♪♪"
        ).split()
        ids: set[int] = set()
        for sym in symbols + [" -", " '"]:
            for tok in (self.encode(sym), self.encode(" " + sym.strip())):
                if len(tok) == 1:
                    ids.add(tok[0])
        return sorted(ids)


class FallbackTokenizer:
    """Byte-level stand-in: ids 0..255 are utf-8 bytes; same special layout.

    Used in tests (mirroring the reference's no-weights test strategy,
    tests/test_vad.py-style fakes) and as a safe default when vocab files are
    absent.
    """

    def __init__(self, n_vocab: int = 384, n_langs: int = 2):
        self.n_vocab = n_vocab
        self.special = SpecialTokens.from_vocab(n_vocab, n_langs)

    def encode(self, text: str) -> list[int]:
        return list(text.encode("utf-8"))

    def decode(self, ids: list[int]) -> str:
        return bytes(i for i in ids if i < 256).decode("utf-8", errors="replace")

    @property
    def non_speech_tokens(self) -> list[int]:
        return []


def get_tokenizer(
    model_dir: str | None = None, n_vocab: int = 51866, n_langs: int | None = None
):
    """Real tokenizer when vocab files exist, fallback otherwise."""
    if n_langs is None:
        n_langs = 100 if n_vocab >= 51866 else 99
    if model_dir:
        vocab_json = os.path.join(model_dir, "vocab.json")
        if os.path.exists(vocab_json):
            return WhisperTokenizer(model_dir, n_langs)
    if n_vocab > 50000:
        # real-size vocab without files: bytes still decodable, layout exact
        tok = FallbackTokenizer.__new__(FallbackTokenizer)
        tok.n_vocab = n_vocab
        tok.special = SpecialTokens.from_vocab(n_vocab, n_langs, 1501)
        return tok
    return FallbackTokenizer(n_vocab=n_vocab, n_langs=n_langs)
