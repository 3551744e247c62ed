"""Voxtral's transcription request as token ids.

The Tekken tokenizer (``tekken.json``) is not in the repository, so this
holds only what the served path needs without it: the control tokens'
ids (mistral-common's layout: ``<s>`` 1, ``</s>`` 2, ``[INST]`` 3,
``[/INST]`` 4, ``[AUDIO]`` 24, ``[BEGIN_AUDIO]`` 25, ``[TRANSCRIBE]`` 34)
and the ids of each language's ``lang:xx`` text, which whoever holds the
tokenizer hands in. A transcription request is

    <s> [INST] [BEGIN_AUDIO] [AUDIO] x n [/INST] lang:xx [TRANSCRIBE]

and the model answers with the transcript's ids, ending in ``</s>``.
``decode`` turns ids into text, which needs the tokenizer's vocabulary.
"""

from __future__ import annotations

from dataclasses import dataclass, field

BOS, EOS, INST, INST_END, AUDIO, BEGIN_AUDIO, TRANSCRIBE = 1, 2, 3, 4, 24, 25, 34


@dataclass
class VoxtralTokens:
    audio_positions: int  # [AUDIO] placeholders of one 30 s window
    lang_ids: dict[str, list[int]] = field(default_factory=dict)
    eos: int = EOS

    def transcription_prompt(self, language: str) -> list[int]:
        if language not in self.lang_ids:
            raise ValueError(f"no ids for lang:{language}; known: {sorted(self.lang_ids)}")
        return ([BOS, INST, BEGIN_AUDIO] + [AUDIO] * self.audio_positions + [INST_END]
                + list(self.lang_ids[language]) + [TRANSCRIBE])

    def decode(self, ids) -> str:
        raise NotImplementedError(
            "Voxtral's Tekken tokenizer is not in the repository: hand in a tokens object "
            "whose decode maps ids to text"
        )
