"""Grapheme-to-phoneme for TTS front-ends (host-side, text domain).

The reference leans on espeak-ng/misaki C libraries via the kokoro/piper
packages (SURVEY §2.8). Neither is installed here, so this is a
self-contained English G2P: text normalization (numbers, abbreviations), a
lexicon of high-frequency irregular words, and letter-to-sound rules for the
long tail. Output is ARPAbet-style phonemes mapped to a stable id space that
the JAX TTS models consume. Swappable: if espeak-ng appears on the host,
``EspeakG2P`` uses it transparently.
"""

from __future__ import annotations

import re
import shutil
import subprocess

# Phoneme inventory: ARPAbet + pause/boundary marks. Order is the id space.
PHONEMES = [
    "<pad>", "<bos>", "<eos>", " ", ",", ".", "?", "!",
    "AA", "AE", "AH", "AO", "AW", "AY", "B", "CH", "D", "DH", "EH", "ER",
    "EY", "F", "G", "HH", "IH", "IY", "JH", "K", "L", "M", "N", "NG", "OW",
    "OY", "P", "R", "S", "SH", "T", "TH", "UH", "UW", "V", "W", "Y", "Z",
    "ZH",
]
PHONEME_TO_ID = {p: i for i, p in enumerate(PHONEMES)}
N_PHONEMES = len(PHONEMES)

_ONES = "zero one two three four five six seven eight nine".split()
_TEENS = (
    "ten eleven twelve thirteen fourteen fifteen sixteen seventeen eighteen "
    "nineteen".split()
)
_TENS = "zero ten twenty thirty forty fifty sixty seventy eighty ninety".split()

_ABBREV = {
    "mr": "mister", "mrs": "missus", "dr": "doctor", "st": "saint",
    "vs": "versus", "etc": "etcetera", "e.g": "for example", "i.e": "that is",
}

# High-frequency irregular words (letter-to-sound rules get these wrong)
_LEXICON: dict[str, str] = {
    "the": "DH AH", "a": "AH", "of": "AH V", "to": "T UW", "and": "AE N D",
    "is": "IH Z", "was": "W AH Z", "are": "AA R", "were": "W ER",
    "you": "Y UW", "your": "Y AO R", "i": "AY", "he": "HH IY",
    "she": "SH IY", "we": "W IY", "they": "DH EY", "one": "W AH N",
    "two": "T UW", "once": "W AH N S", "who": "HH UW", "what": "W AH T",
    "where": "W EH R", "there": "DH EH R", "their": "DH EH R",
    "said": "S EH D", "says": "S EH Z", "do": "D UW", "does": "D AH Z",
    "done": "D AH N", "have": "HH AE V", "has": "HH AE Z", "had": "HH AE D",
    "would": "W UH D", "could": "K UH D", "should": "SH UH D",
    "laugh": "L AE F", "enough": "IH N AH F", "through": "TH R UW",
    "though": "DH OW", "thought": "TH AO T", "tough": "T AH F",
    "women": "W IH M IH N", "woman": "W UH M AH N", "people": "P IY P AH L",
    "hello": "HH AH L OW", "world": "W ER L D", "live": "L IH V",
    "love": "L AH V", "move": "M UW V", "give": "G IH V", "gone": "G AO N",
    "come": "K AH M", "some": "S AH M", "because": "B IH K AH Z",
    "eye": "AY", "eyes": "AY Z", "busy": "B IH Z IY", "sure": "SH UH R",
    "answer": "AE N S ER", "island": "AY L AH N D", "hour": "AW ER",
    "honest": "AA N AH S T", "many": "M EH N IY", "any": "EH N IY",
    "again": "AH G EH N", "against": "AH G EH N S T", "great": "G R EY T",
    "heart": "HH AA R T", "water": "W AO T ER", "speech": "S P IY CH",
    # irregular high-frequency words the gold-list eval surfaced
    # (tests/test_g2p_accuracy.py): open-syllable o/u, ow-as-AW, etc.
    "now": "N AW", "how": "HH AW", "down": "D AW N", "town": "T AW N",
    "brown": "B R AW N", "open": "OW P AH N", "only": "OW N L IY",
    "over": "OW V ER", "own": "OW N", "most": "M OW S T",
    "both": "B OW TH", "music": "M Y UW Z IH K",
    "machine": "M AH SH IY N", "color": "K AH L ER",
    "money": "M AH N IY", "month": "M AH N TH",
    "nothing": "N AH TH IH NG", "child": "CH AY L D",
    "find": "F AY N D", "kind": "K AY N D", "mind": "M AY N D",
    "country": "K AH N T R IY", "young": "Y AH NG",
    "today": "T AH D EY", "mountain": "M AW N T AH N",
    "question": "K W EH S CH AH N", "second": "S EH K AH N D",
    "together": "T AH G EH DH ER", "evening": "IY V N IH NG",
    "listen": "L IH S AH N", "often": "AO F AH N",
    "very": "V EH R IY", "other": "AH DH ER", "put": "P UH T",
    "full": "F UH L", "pull": "P UH L", "push": "P UH SH",
    "good": "G UH D", "foot": "F UH T", "wood": "W UH D",
    "dog": "D AO G", "watch": "W AA CH", "wash": "W AA SH",
    "our": "AW ER", "off": "AO F", "on": "AA N", "or": "AO R",
    "from": "F R AH M", "front": "F R AH N T", "son": "S AH N",
    "won": "W AH N", "none": "N AH N", "nice": "N AY S",
    "father": "F AA DH ER", "mother": "M AH DH ER",
    "brother": "B R AH DH ER", "about": "AH B AW T",
    "around": "AH R AW N D", "away": "AH W EY", "above": "AH B AH V",
    "across": "AH K R AO S", "paper": "P EY P ER", "table": "T EY B AH L",
    "change": "CH EY N JH", "friend": "F R EH N D", "hear": "HH IY R",
}

# Ordered letter-to-sound rules: (pattern, phonemes). Longest-match first.
# Accuracy measured against tests/data/g2p_gold_en.json
# (tests/test_g2p_accuracy.py); rule classes below were added where that
# eval showed systematic errors (r-controlled vowels, -all/-alk, ther).
_LTS_RULES: list[tuple[str, str]] = [
    ("tion", "SH AH N"), ("sion", "ZH AH N"), ("ough", "AO"),
    ("augh", "AO"), ("eigh", "EY"), ("earn", "ER N"), ("earl", "ER L"),
    ("earth", "ER TH"), ("igh", "AY"),
    ("tch", "CH"), ("dge", "JH"), ("sch", "S K"),
    ("all", "AO L"), ("alk", "AO K"), ("wor", "W ER"), ("old", "OW L D"),
    ("ther", "DH ER"), ("ere", "IY R"), ("oor", "AO R"),
    ("ear", "IH R"), ("air", "EH R"), ("our", "AO R"), ("ong", "AO NG"),
    ("ook", "UH K"), ("ire", "AY ER"), ("are", "EH R"), ("ore", "AO R"),
    ("ure", "UH R"), ("war", "W AO R"), ("oup", "UW P"), ("nk", "NG K"),
    ("ci", "S IH"), ("ce", "S EH"),
    ("ch", "CH"), ("sh", "SH"), ("th", "TH"), ("ph", "F"), ("wh", "W"),
    ("ng", "NG"), ("qu", "K W"), ("ck", "K"), ("gh", "G"), ("kn", "N"),
    ("wr", "R"), ("oo", "UW"), ("ee", "IY"), ("ea", "IY"), ("ai", "EY"),
    ("ay", "EY"), ("oa", "OW"), ("ou", "AW"), ("ow", "OW"), ("oi", "OY"),
    ("oy", "OY"), ("au", "AO"), ("aw", "AO"), ("ew", "UW"),
    ("ar", "AA R"), ("er", "ER"),
    ("ir", "ER"), ("or", "AO R"), ("ur", "ER"), ("oe", "OW"), ("ie", "IY"),
    ("ue", "UW"), ("ei", "EY"), ("ey", "IY"), ("ll", "L"),
    ("a", "AE"), ("b", "B"), ("c", "K"), ("d", "D"), ("e", "EH"),
    ("f", "F"), ("g", "G"), ("h", "HH"), ("i", "IH"), ("j", "JH"),
    ("k", "K"), ("l", "L"), ("m", "M"), ("n", "N"), ("o", "AA"),
    ("p", "P"), ("r", "R"), ("s", "S"), ("t", "T"), ("u", "AH"),
    ("v", "V"), ("w", "W"), ("x", "K S"), ("y", "Y"), ("z", "Z"),
]


def _number_to_words(num: str) -> str:
    try:
        n = int(num)
    except ValueError:
        return " point ".join(_number_to_words(p) for p in num.split("."))
    if n < 0:
        return "minus " + _number_to_words(str(-n))
    if n < 10:
        return _ONES[n]
    if n < 20:
        return _TEENS[n - 10]
    if n < 100:
        tens, ones = divmod(n, 10)
        return _TENS[tens] + (f" {_ONES[ones]}" if ones else "")
    if n < 1000:
        hundreds, rest = divmod(n, 100)
        out = f"{_ONES[hundreds]} hundred"
        return out + (f" {_number_to_words(str(rest))}" if rest else "")
    if n < 1_000_000:
        thousands, rest = divmod(n, 1000)
        out = f"{_number_to_words(str(thousands))} thousand"
        return out + (f" {_number_to_words(str(rest))}" if rest else "")
    millions, rest = divmod(n, 1_000_000)
    out = f"{_number_to_words(str(millions))} million"
    return out + (f" {_number_to_words(str(rest))}" if rest else "")


def normalize_text(text: str) -> str:
    """Expand numbers/abbreviations; collapse whitespace; lowercase."""
    text = text.strip()
    # dotted latinisms first: neither word-regex below can match a key
    # containing an interior dot
    text = re.sub(r"\be\.g\.?(?=[\s,]|$)", "for example", text, flags=re.I)
    text = re.sub(r"\bi\.e\.?(?=[\s,]|$)", "that is", text, flags=re.I)
    # title abbreviations keep their period only when NOT in the table;
    # the next word may be capitalized ("Dr. Smith") — \w, not [a-z]
    text = re.sub(
        r"\b(\w+)\.(?=\s+\w)",
        lambda m: _ABBREV.get(m.group(1).lower(), m.group(0)),
        text,
    )
    text = re.sub(
        r"\b([a-zA-Z]+)\b",
        lambda m: _ABBREV.get(m.group(1).lower(), m.group(1)),
        text,
    )
    text = re.sub(r"\$(\d+)", lambda m: _number_to_words(m.group(1)) + " dollars", text)
    text = re.sub(r"(\d+(?:\.\d+)?)%", lambda m: _number_to_words(m.group(1)) + " percent", text)
    text = re.sub(r"\d+(?:\.\d+)?", lambda m: _number_to_words(m.group(0)), text)
    text = re.sub(r"\s+", " ", text)
    return text.lower()


_LONG_VOWEL = {"a": "EY", "e": "IY", "i": "AY", "o": "OW", "u": "UW"}


def word_to_phonemes(word: str) -> list[str]:
    """One word -> phoneme list via lexicon, else letter-to-sound rules.

    Suffix classes (-y, -le, soft -ge/-ce) and doubled consonants are
    handled before the rule scan; CVCe silent-e lengthens its vowel.
    """
    if word in _LEXICON:
        return _LEXICON[word].split()
    phones: list[str] = []
    suffix: list[str] = []
    work = word
    # suffix classes the position-blind rule scan gets wrong
    if len(work) > 2 and work[-1] == "y" and work[-2] not in "aeiou":
        work = work[:-1]  # happy, early, city; monosyllables: sky, fly
        suffix = ["IY"] if any(c in "aeiou" for c in work) else ["AY"]
    elif len(work) > 3 and work.endswith("le") and work[-3] not in "aeiou":
        work, suffix = work[:-2], ["AH", "L"]  # table, little
    elif len(work) > 3 and work.endswith("ge") and not work.endswith("dge"):
        work, suffix = work[:-2], ["JH"]  # large, change
    elif len(work) > 3 and work.endswith("ce"):
        work, suffix = work[:-2], ["S"]  # face, dance
    elif len(work) > 5 and work.endswith("ous"):
        work, suffix = work[:-3], ["AH", "S"]  # famous, nervous
    elif len(work) > 3 and work.endswith("or") and work[-3] not in "aeiou":
        work, suffix = work[:-2], ["ER"]  # doctor, actor, mirror
    elif (
        len(work) > 3
        and work.endswith("en")
        and work[-3] not in "aeiou"
        and any(c in "aeiouy" for c in work[:-2])
    ):
        work, suffix = work[:-2], ["AH", "N"]  # seven, garden, happen
    elif len(work) > 4 and work.endswith("al") and work[-3] not in "aeiou":
        work, suffix = work[:-2], ["AH", "L"]  # animal, total, final
    # doubled consonants read as one ("ll" keeps its own rule so that
    # "all"/"alk" patterns still see both letters)
    work = re.sub(r"([bcdfgkmnprstvz])\1", r"\1", work)
    # silent-e: a final 'e' after a consonant is mute; in CVCe words it
    # also lengthens the vowel — except vowel+"re", which the
    # r-controlled rules own (fire/more/care: ire/ore/are)
    vowel_idx = -1
    if (
        not suffix
        and len(work) > 3
        and work.endswith("e")
        and work[-2] not in "aeiour"
    ):
        cvce = work[-3] in "aeiou"
        work = work[:-1]
        if cvce:
            # mark the vowel position for long substitution
            vowel_idx = len(work) - 2
    elif (
        suffix
        and len(work) >= 2
        and work[-1] in "aiou"
        and work[-2] not in "aeiou"
    ):
        # open syllable exposed by suffix strip: fa(ce), a(ge) → long vowel
        vowel_idx = len(work) - 1
    i = 0
    while i < len(work):
        for pat, phs in _LTS_RULES:
            if work.startswith(pat, i):
                if i == vowel_idx and pat in "aeiou":
                    phones.append(_LONG_VOWEL[pat])
                else:
                    phones.extend(phs.split())
                i += len(pat)
                break
        else:
            i += 1  # unknown char: skip
    phones.extend(suffix)
    return phones


def piper_phoneme_ids(phones: list[str], id_map: dict) -> list[int]:
    """Encode IPA phonemes with a piper voice's phoneme_id_map.

    Piper framing: BOS "^", pad "_" interspersed after every phoneme,
    EOS "$" (piper-phonemize convention; map values are id lists).
    """
    ids = list(id_map.get("^", [1]))
    pad = list(id_map.get("_", [0]))
    ids.extend(pad)
    for p in phones:
        if p in id_map:
            ids.extend(id_map[p])
            ids.extend(pad)
    ids.extend(id_map.get("$", [2]))
    return ids


class RuleG2P:
    """Self-contained normalizer + lexicon + LTS G2P."""

    name = "rule"

    def supports_language(self, voice_or_lang: str) -> bool:
        from open_speech_tpu_torch.text.g2p_langs import supported_language

        return supported_language(voice_or_lang)

    def phonemize_ipa(self, text: str, voice: str = "en-us") -> list[str] | None:
        """IPA phoneme characters (see ``phonemize_ipa_ex`` for drop counts)."""
        res = self.phonemize_ipa_ex(text, voice)
        return None if res is None else res[0]

    def phonemize_ipa_ex(
        self, text: str, voice: str = "en-us"
    ) -> tuple[list[str], int] | None:
        """IPA phoneme characters + count of untransducible input chars.

        English goes through the ARPAbet path and maps to IPA; rule-table
        languages (es/de/fr/it/pt) transduce directly; ja/zh/hi use the
        kana/pinyin/Devanagari transducers (kanji/hanzi counted as dropped,
        never misread). Returns None for unsupported languages so callers
        gate the voice instead of serving English pronunciations
        (reference G2P is full espeak-ng)."""
        from open_speech_tpu_torch.text.g2p_langs import (
            arpabet_to_ipa,
            base_lang,
            ipa_phonemize_ex,
        )

        if base_lang(voice) == "en":
            return arpabet_to_ipa(self.phonemize(text)), 0
        return ipa_phonemize_ex(text, voice)

    def phonemize(self, text: str) -> list[str]:
        text = normalize_text(text)
        out: list[str] = []
        for token in re.findall(r"[a-z']+|[,.?!]", text):
            if token in ",.?!":
                out.append(token)
            else:
                if out and out[-1] not in (" ", ",", ".", "?", "!"):
                    out.append(" ")
                out.extend(word_to_phonemes(token.replace("'", "")))
        return out

    def to_ids(
        self,
        text: str,
        bos_eos: bool = True,
        id_map: dict | None = None,
        voice: str = "en-us",
    ) -> list[int]:
        """Phoneme ids. With a piper ``phoneme_id_map`` (converted voices),
        encode espeak IPA through it; otherwise the built-in ARPAbet space."""
        if id_map:
            phones = self.phonemize_ipa(text, voice=voice)
            if phones is None:
                # never fall through to the built-in ARPAbet ids: they are a
                # different id space and the model would misread every symbol
                raise ValueError(
                    f"language_not_supported: no IPA G2P path for '{voice}'"
                )
            return piper_phoneme_ids(phones, id_map)
        ids = [PHONEME_TO_ID[p] for p in self.phonemize(text) if p in PHONEME_TO_ID]
        if bos_eos:
            return [PHONEME_TO_ID["<bos>"]] + ids + [PHONEME_TO_ID["<eos>"]]
        return ids


class EspeakG2P(RuleG2P):
    """espeak-ng-backed G2P when the binary exists (closest to reference)."""

    name = "espeak"

    @staticmethod
    def available() -> bool:
        return shutil.which("espeak-ng") is not None

    def supports_language(self, voice_or_lang: str) -> bool:
        return True  # espeak-ng ships ~100 language voices

    def phonemize_ipa_ex(
        self, text: str, voice: str = "en-us"
    ) -> tuple[list[str], int] | None:
        from open_speech_tpu_torch.text.g2p_langs import base_lang, ipa_phonemize_ex

        # ja/zh/hi: prefer the first-party transducers — their symbol
        # conventions match misaki (what kokoro-82M was trained on);
        # espeak's ja/zh phonemization differs substantially from it.
        if base_lang(voice) in ("ja", "zh", "hi"):
            res = ipa_phonemize_ex(text, voice)
            if res is not None:
                return res
        try:
            out = subprocess.run(
                ["espeak-ng", "-q", "--ipa", "-v", voice, text],
                capture_output=True, text=True, timeout=10, check=True,
            ).stdout
            # keep single spaces: the kokoro vocab has a word-boundary symbol
            chars = list(re.sub(r"\s+", " ", out.strip()))
            return chars, 0
        except Exception:  # noqa: BLE001
            return super().phonemize_ipa_ex(text, voice)

    def phonemize(self, text: str) -> list[str]:
        """ARPAbet via espeak IPA (the -x mnemonics are espeak's own
        alphabet, not ARPAbet — mapping through IPA keeps the output in
        the built-in id space, g2p_langs.ipa_to_arpabet)."""
        from open_speech_tpu_torch.text.g2p_langs import ipa_to_arpabet

        try:
            out = subprocess.run(
                ["espeak-ng", "-q", "--ipa", "-v", "en-us", text],
                capture_output=True, text=True, timeout=10, check=True,
            ).stdout
            phones = ipa_to_arpabet(list(re.sub(r"\s+", " ", out.strip())))
            if phones:
                return phones
        except Exception:  # noqa: BLE001
            pass
        return super().phonemize(text)


def get_g2p() -> RuleG2P:
    return EspeakG2P() if EspeakG2P.available() else RuleG2P()


def split_sentences(text: str) -> list[str]:
    """Sentence splitting for per-sentence streaming synthesis."""
    parts = re.split(r"(?<=[.!?])\s+", text.strip())
    return [p for p in parts if p]
