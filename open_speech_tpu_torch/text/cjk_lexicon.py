"""Greedy longest-match reading pass: kanji → kana, hanzi → pinyin.

The reference speaks real Japanese/Chinese through misaki's optional
extras — pyopenjtalk for ja, jieba+pypinyin for zh (reference:
src/tts/backends/kokoro.py:112-122, 194-212). Those are multi-MB native
dictionaries; this is the serving-sized first-party equivalent: a
longest-match-first segmenter over compact vendored reading tables
(text/ja_lexicon.py, text/zh_lexicon.py) that rewrites ideograph spans
into the phonetic scripts the downstream transducers already handle
(kana → _ja_to_ipa, toned pinyin → _zh_to_ipa in text/g2p_langs.py).

Unknown ideographs are left in place so the existing drop counters (and
the serving gate built on them) stay honest: we never guess a reading.
"""

from __future__ import annotations


def _is_kanji(ch: str) -> bool:
    o = ord(ch)
    return (
        0x4E00 <= o <= 0x9FFF  # CJK unified
        or 0x3400 <= o <= 0x4DBF  # extension A
        or o in (0x3005, 0x3006)  # 々 (iteration), 〆
    )


def _is_kana(ch: str) -> bool:
    o = ord(ch)
    return 0x3041 <= o <= 0x309F or 0x30A1 <= o <= 0x30FF or ch == "ー"


# kana-level phonetic fixups applied before the particle pass: historical
# spellings whose surface kana differs from pronunciation.
_JA_KANA_FIXUPS = [
    ("こんにちは", "こんにちわ"),
    ("こんばんは", "こんばんわ"),
]


def ja_apply(text: str) -> str:
    """Rewrite kanji spans in ``text`` to kana via the vendored lexicon.

    Longest-match-first against the merged word+char table (keys may mix
    kanji and okurigana, e.g. 良い). 々 repeats the previous matched
    surface. Topic/direction particles は/へ are read わ/え when they
    directly follow a lexicon match or a kana run that itself follows one
    — the segmentation signal a real tokenizer would provide. Unknown
    kanji pass through unchanged (counted as dropped downstream).
    """
    from open_speech_tpu_torch.text.ja_lexicon import ja_max_key_len, ja_word_table

    table = ja_word_table()
    max_len = ja_max_key_len()
    for src, dst in _JA_KANA_FIXUPS:
        text = text.replace(src, dst)

    out: list[str] = []
    i = 0
    n = len(text)
    after_match = False  # last consumed chars came from a lexicon match
    while i < n:
        ch = text[i]
        if ch in ("々", "〻") and i > 0:
            # iteration mark: repeat the previous character's reading
            prev = text[i - 1]
            rep = table.get(prev)
            if rep is not None:
                out.append(rep)
                i += 1
                after_match = True
                continue
        if _is_kanji(ch):
            matched = False
            for ln in range(min(max_len, n - i), 0, -1):
                key = text[i : i + ln]
                reading = table.get(key)
                if reading is not None:
                    out.append(reading)
                    i += ln
                    matched = True
                    break
            after_match = matched
            if matched:
                continue
            out.append(ch)  # unknown kanji: pass through, drop downstream
            i += 1
            continue
        if ch == "は" and after_match:
            # topic particle directly after a content word: read わ.
            # Only when the next char is NOT kana continuing a word with
            # は inside it is this safe in general, but after a lexicon
            # match the probability mass is overwhelmingly the particle.
            out.append("わ")
            i += 1
            after_match = False
            continue
        if ch == "へ" and after_match and (
            i + 1 >= n or not _is_kana(text[i + 1])
        ):
            # direction particle (学校へ。): read え
            out.append("え")
            i += 1
            after_match = False
            continue
        out.append(ch)
        after_match = False
        i += 1
    return "".join(out)


def zh_apply(text: str) -> str:
    """Rewrite hanzi spans in ``text`` to toned pinyin syllables.

    Longest-match-first against the merged word+char table. Every emitted
    syllable carries a tone digit (5 = neutral), which makes the
    downstream greedy syllable split in _zh_to_ipa unambiguous — no
    syllable contains an interior digit. Unknown hanzi pass through
    (counted as dropped downstream).
    """
    from open_speech_tpu_torch.text.zh_lexicon import zh_max_key_len, zh_word_table

    table = zh_word_table()
    max_len = zh_max_key_len()

    out: list[str] = []
    i = 0
    n = len(text)
    while i < n:
        ch = text[i]
        if _is_kanji(ch):
            matched = False
            for ln in range(min(max_len, n - i), 0, -1):
                reading = table.get(text[i : i + ln])
                if reading is not None:
                    out.append(reading)
                    i += ln
                    matched = True
                    break
            if matched:
                continue
        out.append(ch)
        i += 1
    return "".join(out)
