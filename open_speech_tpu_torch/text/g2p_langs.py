"""Per-language grapheme→IPA rules for TTS front-ends.

The reference gets multi-language G2P from espeak-ng (piper) and misaki
(kokoro) — C libraries that are not available here. For languages with
largely phonemic orthographies (es/de/fr/it/pt) a compact transducer of
ordered, context-aware letter rules produces serviceable IPA; English runs
through the ARPAbet G2P (text/g2p.py) and maps to IPA. Languages whose
text→sound mapping needs a real lexicon (ja/zh/hi/ko) are *not* claimed:
``supported_language`` returns False so the serving layer can gate voices
instead of silently reading them with English rules (the round-1 failure
mode this module removes).

Rule format: ordered ``(regex, ipa)`` pairs; at each position the first
matching pattern consumes its match and emits the IPA string. Patterns may
use lookahead/lookbehind for context (e.g. Spanish ``c`` before e/i).
"""

from __future__ import annotations

import re
import unicodedata

# ── ARPAbet → IPA (for the English path) ──────────────────────────────

ARPABET_TO_IPA = {
    "AA": "ɑ", "AE": "æ", "AH": "ə", "AO": "ɔ", "AW": "aʊ", "AY": "aɪ",
    "B": "b", "CH": "tʃ", "D": "d", "DH": "ð", "EH": "ɛ", "ER": "ɚ",
    "EY": "eɪ", "F": "f", "G": "ɡ", "HH": "h", "IH": "ɪ", "IY": "i",
    "JH": "dʒ", "K": "k", "L": "l", "M": "m", "N": "n", "NG": "ŋ",
    "OW": "oʊ", "OY": "ɔɪ", "P": "p", "R": "ɹ", "S": "s", "SH": "ʃ",
    "T": "t", "TH": "θ", "UH": "ʊ", "UW": "u", "V": "v", "W": "w",
    "Y": "j", "Z": "z", "ZH": "ʒ",
    " ": " ", ",": ",", ".": ".", "?": "?", "!": "!",
}

# ── letter→IPA rule tables ────────────────────────────────────────────
# Order matters: first match wins. All input is lowercased NFC.

_ES_RULES = [
    (r"ch", "tʃ"), (r"ll", "ʝ"), (r"ñ", "ɲ"), (r"rr", "r"),
    (r"qu(?=[ei])", "k"), (r"gu(?=[ei])", "ɡ"), (r"gü", "ɡw"),
    (r"^r", "r"), (r"(?<=[nls])r", "r"),  # trill word-initially / after n,l,s
    (r"c(?=[ei])", "θ"), (r"c", "k"), (r"z", "θ"),
    (r"g(?=[ei])", "x"), (r"j", "x"), (r"h", ""),
    (r"v", "b"), (r"y(?=[aeiou])", "ʝ"), (r"y", "i"),
    (r"á", "ˈa"), (r"é", "ˈe"), (r"í", "ˈi"), (r"ó", "ˈo"), (r"ú", "ˈu"),
    (r"a", "a"), (r"e", "e"), (r"i", "i"), (r"o", "o"), (r"u", "u"),
    (r"b", "b"), (r"d", "d"), (r"f", "f"), (r"g", "ɡ"), (r"k", "k"),
    (r"l", "l"), (r"m", "m"), (r"n", "n"), (r"p", "p"), (r"r", "ɾ"),
    (r"s", "s"), (r"t", "t"), (r"w", "w"), (r"x", "ks"),
]

# German: ordered rules with vowel-length heuristics (long before h, in
# open syllables, and before a single word-final consonant; short before
# clusters/double letters), final devoicing, -er/-e(n) reduction, ng→ŋ.
# Irregular function words (mit, das, ...) live in _DE_LEX below.
_DE_CONS = "bcdfgklmnprstvß"  # single-consonant set for open-syllable length
_DE_RULES = [
    (r"tsch", "tʃ"), (r"sch", "ʃ"),
    (r"chs", "ks"),  # sechs, wachsen
    (r"ch(?<=[aou]ch)", "x"), (r"ch", "ç"),
    (r"ck", "k"), (r"dt", "t"), (r"th", "t"), (r"ph", "f"), (r"pf", "pf"),
    (r"ng", "ŋ"), (r"nk", "ŋk"),
    (r"ieh", "iː"), (r"ie", "iː"),
    (r"ei", "aɪ"), (r"ai", "aɪ"), (r"eu", "ɔʏ"), (r"äu", "ɔʏ"),
    (r"au", "aʊ"),
    (r"^sp", "ʃp"), (r"^st", "ʃt"),  # word-initial (rules run per word)
    (r"ß", "s"), (r"ss", "s"), (r"tz", "ts"), (r"z", "ts"),
    (r"qu", "kv"), (r"v", "f"), (r"w", "v"), (r"j", "j"),
    (r"ig\b", "ɪç"),  # zwanzig, König
    # vowel + h = long vowel, h silent
    (r"ah", "aː"), (r"eh", "eː"), (r"ih", "iː"), (r"oh", "oː"),
    (r"uh", "uː"), (r"äh", "ɛː"), (r"öh", "øː"), (r"üh", "yː"),
    # reduced final syllables: -er → ɐ, -e(n|l|m|s|t) → schwa
    (r"er\b", "ɐ"), (r"e(?=[nlmst]?\b|nd\b|nt\b)", "ə"),
    # doubled consonants signal a short vowel and read as one
    (r"bb", "b"), (r"dd", "d"), (r"ff", "f"), (r"gg", "ɡ"),
    (r"ll", "l"), (r"mm", "m"), (r"nn", "n"), (r"pp", "p"),
    (r"rr", "ʁ"), (r"tt", "t"),
    # long in open syllables (single consonant then vowel) and before a
    # single word-final consonant (Tag, gut, rot)
    (rf"a(?=[{_DE_CONS}][aeiouäöüy]|[{_DE_CONS}]\b)", "aː"),
    (rf"e(?=[{_DE_CONS}][aeiouäöüy]|[{_DE_CONS}]\b)", "eː"),
    (rf"i(?=[{_DE_CONS}][aeiouäöüy]|[{_DE_CONS}]\b)", "iː"),
    (rf"o(?=[{_DE_CONS}][aeiouäöüy]|[{_DE_CONS}]\b)", "oː"),
    (rf"u(?=[{_DE_CONS}][aeiouäöüy]|[{_DE_CONS}]\b)", "uː"),
    (rf"ä(?=[{_DE_CONS}][aeiouäöüy]|[{_DE_CONS}]\b)", "ɛː"),
    (rf"ö(?=[{_DE_CONS}][aeiouäöüy]|[{_DE_CONS}]\b)", "øː"),
    (rf"ü(?=[{_DE_CONS}][aeiouäöüy]|[{_DE_CONS}]\b)", "yː"),
    (r"s(?=[aeiouäöü])", "z"),
    # word-final b/d/g devoice (Auslautverhärtung)
    (r"b\b", "p"), (r"d\b", "t"), (r"g\b", "k"),
    (r"ä", "ɛ"), (r"ö", "œ"), (r"ü", "ʏ"),
    (r"a", "a"), (r"e", "ɛ"), (r"i", "ɪ"), (r"o", "ɔ"), (r"u", "ʊ"),
    (r"b", "b"), (r"c", "k"), (r"d", "d"), (r"f", "f"), (r"g", "ɡ"),
    (r"h", "h"), (r"k", "k"), (r"l", "l"), (r"m", "m"), (r"n", "n"),
    (r"p", "p"), (r"r", "ʁ"), (r"s", "s"), (r"t", "t"), (r"x", "ks"),
    (r"y", "y"),
]

# French: nasal vowels block before a following vowel or m/n/h (bonne,
# bonheur stay oral); doubled consonants read as one; -ill- → ij
# (famille; ville-class exceptions in _FR_LEX); final consonants and
# clusters usually silent. True irregulars (femme, monsieur) in _FR_LEX.
_FR_NO_NASAL = "aeiouyéèêëîïnmh"  # next char that blocks nasalization
_FR_RULES = [
    (r"eaux?", "o"), (r"aux\b", "o"), (r"au", "o"),
    (r"oi", "wa"), (r"ou(?=[aeéèiî])", "w"), (r"ou", "u"),
    (r"ui", "ɥi"),
    (r"gn", "ɲ"), (r"ch", "ʃ"), (r"ph", "f"),
    (r"ail\b", "aj"), (r"eil\b", "ɛj"), (r"euil\b", "œj"),
    # doubled consonants read single (and block nasalization below)
    (r"ill", "ij"), (r"ll", "l"), (r"mm", "m"), (r"nn", "n"),
    (r"ss", "s"), (r"tt", "t"), (r"pp", "p"), (r"rr", "ʁ"),
    (r"ff", "f"), (r"dd", "d"), (r"bb", "b"),
    (r"cc(?=[eiy])", "ks"), (r"cc", "k"), (r"gg", "ɡ"),
    (rf"ain(?=[^{_FR_NO_NASAL}]|\b)", "ɛ̃"),
    (rf"ein(?=[^{_FR_NO_NASAL}]|\b)", "ɛ̃"),
    (rf"ien(?=[^{_FR_NO_NASAL}]|\b)", "jɛ̃"),
    (rf"in(?=[^{_FR_NO_NASAL}]|\b)", "ɛ̃"),
    (rf"yn(?=[^{_FR_NO_NASAL}]|\b)", "ɛ̃"),
    (rf"un(?=[^{_FR_NO_NASAL}]|\b)", "œ̃"),
    (rf"on(?=[^{_FR_NO_NASAL}]|\b)", "ɔ̃"),
    (rf"an(?=[^{_FR_NO_NASAL}]|\b)", "ɑ̃"),
    (r"emps\b", "ɑ̃"), (r"ent\b(?<=\wment)", "ɑ̃"),  # temps; adverbs -ment
    (rf"en(?=[^{_FR_NO_NASAL}]|\b)", "ɑ̃"),
    # nasals before b/p spell with m (temps handled above)
    (r"am(?=[bp])", "ɑ̃"), (r"em(?=[bp])", "ɑ̃"),
    (r"om(?=[bp])", "ɔ̃"), (r"im(?=[bp])", "ɛ̃"), (r"um(?=[bp])", "œ̃"),
    (r"ai", "ɛ"), (r"ei", "ɛ"), (r"é", "e"), (r"è", "ɛ"), (r"ê", "ɛ"),
    (r"à", "a"), (r"â", "ɑ"), (r"ç", "s"), (r"œu", "œ"), (r"œ", "œ"),
    (r"î", "i"), (r"ï", "i"), (r"ô", "o"), (r"û", "y"),
    (r"eu(?=r)", "œ"), (r"eu", "ø"),
    (r"qu", "k"), (r"gu(?=[eiy])", "ɡ"),
    (r"(?<=n)c\b", ""),  # blanc, banc
    (r"c(?=[eiy])", "s"), (r"c", "k"), (r"g(?=[eiy])", "ʒ"), (r"j", "ʒ"),
    (r"h", ""),
    (r"(?<=[aeiouy])s(?=[aeiouyéèêë])", "z"),  # intervocalic s voices
    (r"u", "y"),
    # common final-letter values before the silent-final sweep
    (r"er\b", "e"), (r"ez\b", "e"), (r"et\b", "ɛ"),
    # final consonants and clusters usually silent (approximate)
    (r"(?:[dtxzp]|[dtp]s|es|e)\b", ""), (r"s\b", ""),
    (r"e(?=[bcdfgklmnpqrstvz]{2})", "ɛ"),  # closed syllable: merci, reste
    (r"o(?=nn|mm|n[aeiouyéèêh]|r|l[aeiouyéè])", "ɔ"),  # bonne, bonheur
    (r"a", "a"), (r"e", "ə"), (r"i", "i"), (r"o", "o"), (r"y", "i"),
    (r"b", "b"), (r"d", "d"), (r"f", "f"), (r"g", "ɡ"), (r"k", "k"),
    (r"l", "l"), (r"m", "m"), (r"n", "n"), (r"p", "p"), (r"r", "ʁ"),
    (r"s", "s"), (r"t", "t"), (r"v", "v"), (r"w", "w"), (r"x", "ks"),
    (r"z", "z"),
]

# Italian: near-phonemic; ci/gi/sci absorb the i before another vowel
# (giorno → dʒorno), unstressed i/u glide before vowels, intervocalic s
# voices, zz reads /tts/ (broad — a few words are /ddz/).
_IT_RULES = [
    (r"sch", "sk"), (r"sci(?=[aeou])", "ʃ"), (r"sc(?=[ei])", "ʃ"),
    (r"gli(?=[aeou])", "ʎ"), (r"gli", "ʎi"), (r"gn", "ɲ"),
    (r"ch", "k"), (r"gh", "ɡ"),
    (r"ggi(?=[aeou])", "ddʒ"), (r"cci(?=[aeou])", "ttʃ"),
    (r"gg(?=[ei])", "ddʒ"), (r"cc(?=[ei])", "ttʃ"),
    (r"ci(?=[aeou])", "tʃ"), (r"gi(?=[aeou])", "dʒ"),
    (r"c(?=[ei])", "tʃ"), (r"c", "k"), (r"g(?=[ei])", "dʒ"), (r"g", "ɡ"),
    (r"zz", "tts"), (r"z", "ts"), (r"h", ""),
    (r"à", "ˈa"), (r"è", "ˈɛ"), (r"é", "ˈe"), (r"ì", "ˈi"), (r"ò", "ˈɔ"),
    (r"ù", "ˈu"),
    (r"(?<=[aeiou])s(?=[aeiou])", "z"),
    (r"i(?=[aeouàèéòù])", "j"), (r"u(?=[aeioàèéìò])", "w"),
    (r"a", "a"), (r"e", "e"), (r"i", "i"), (r"o", "o"), (r"u", "u"),
    (r"b", "b"), (r"d", "d"), (r"f", "f"), (r"k", "k"), (r"l", "l"),
    (r"m", "m"), (r"n", "n"), (r"p", "p"), (r"q", "k"), (r"r", "r"),
    (r"s", "s"), (r"t", "t"), (r"v", "v"), (r"w", "w"), (r"x", "ks"),
    (r"y", "j"),
]

# Portuguese (Brazilian — the common piper/kokoro pt voices are pt_BR):
# nasal vowels, ti/di palatalize to tʃi/dʒi, unstressed final e/o raise
# to i/u, rr and initial r → ʁ with single r a tap.
_PT_RULES = [
    (r"lh", "ʎ"), (r"nh", "ɲ"), (r"ch", "ʃ"), (r"ç", "s"),
    (r"qu(?=[eié])", "k"), (r"gu(?=[eié])", "ɡ"),
    (r"qu(?=[ao])", "kw"), (r"gu(?=[ao])", "ɡw"),
    (r"l(?=[bcdfgjkmnpqstvxz]|\b)", "w"),  # BP coda l vocalizes
    (r"ão", "ɐ̃w"), (r"ãe", "ɐ̃j"), (r"õe", "õj"), (r"ã", "ɐ̃"),
    (r"õ", "õ"),
    (r"am\b", "ɐ̃w"), (r"em\b", "ẽj"), (r"ens\b", "ẽjs"),
    (r"om\b", "õ"), (r"im\b", "ĩ"), (r"um\b", "ũ"), (r"ém\b", "ˈẽj"),
    (r"an(?=[^aeiouãõh]|\b)", "ɐ̃"), (r"en(?=[^aeiouãõh]|\b)", "ẽ"),
    (r"in(?=[^aeiouãõh]|\b)", "ĩ"), (r"on(?=[^aeiouãõh]|\b)", "õ"),
    (r"un(?=[^aeiouãõh]|\b)", "ũ"),
    (r"am(?=[bp])", "ɐ̃"), (r"em(?=[bp])", "ẽ"), (r"im(?=[bp])", "ĩ"),
    (r"om(?=[bp])", "õ"), (r"um(?=[bp])", "ũ"),
    (r"á", "ˈa"), (r"â", "ˈɐ"), (r"é", "ˈɛ"), (r"ê", "ˈe"), (r"í", "ˈi"),
    (r"ó", "ˈɔ"), (r"ô", "ˈo"), (r"ú", "ˈu"),
    (r"c(?=[eiéêíì])", "s"), (r"c", "k"), (r"g(?=[eiéêí])", "ʒ"), (r"j", "ʒ"),
    (r"x", "ʃ"), (r"h", ""), (r"ou", "o"),
    (r"ai", "aj"), (r"ei", "ej"), (r"oi", "oj"), (r"ui", "uj"),
    (r"au", "aw"), (r"eu", "ew"), (r"iu", "iw"),
    (r"ss", "s"),
    (r"(?<=[aeiouáéêíóôúâã])s(?=[aeiouáéêíóôúâã])", "z"),
    (r"rr", "ʁ"), (r"^r", "ʁ"),
    # BP palatalization + final-vowel raising
    (r"te\b", "tʃi"), (r"de\b", "dʒi"), (r"t(?=i)", "tʃ"), (r"d(?=i)", "dʒ"),
    (r"e\b", "i"), (r"es\b", "is"), (r"o\b", "u"), (r"os\b", "us"),
    (r"a", "a"), (r"e", "e"), (r"i", "i"), (r"o", "o"), (r"u", "u"),
    (r"b", "b"), (r"d", "d"), (r"f", "f"), (r"g", "ɡ"), (r"k", "k"),
    (r"l", "l"), (r"m", "m"), (r"n", "n"), (r"p", "p"), (r"r", "ɾ"),
    (r"s", "s"), (r"t", "t"), (r"v", "v"), (r"w", "w"), (r"z", "z"),
]

LANG_RULES: dict[str, list[tuple[str, str]]] = {
    "es": _ES_RULES,
    "de": _DE_RULES,
    "fr": _FR_RULES,
    "it": _IT_RULES,
    "pt": _PT_RULES,
}

# Irregular words the letter rules cannot reach (mostly high-frequency
# function words whose vowels defy the length/nasal heuristics). Checked
# before the rule tables, like the English _LEXICON in text/g2p.py.
LANG_LEXICON: dict[str, dict[str, str]] = {
    "de": {
        "der": "deːɐ", "er": "eːɐ", "wir": "viːɐ", "mir": "miːɐ",
        "dir": "diːɐ", "den": "deːn", "dem": "deːm", "wen": "veːn",
        "vier": "fiːɐ", "nur": "nuːɐ", "für": "fyːɐ", "ihr": "iːɐ",
        "mit": "mɪt", "das": "das", "was": "vas", "es": "ɛs",
        "an": "an", "in": "ɪn", "im": "ɪm", "am": "am", "um": "ʊm",
        "man": "man", "bin": "bɪn", "bis": "bɪs", "ob": "ɔp",
        "hat": "hat", "ab": "ap", "weg": "vɛk", "von": "fɔn",
        "zum": "tsʊm", "des": "dɛs", "uns": "ʊns", "und": "ʊnt",
        "herr": "hɛʁ", "buch": "buːx", "auch": "aʊx",
    },
    "fr": {
        "femme": "fam", "monsieur": "məsjø", "est": "ɛ", "et": "e",
        "les": "le", "des": "de", "mes": "me", "tes": "te", "ses": "se",
        "ville": "vil", "mille": "mil", "tranquille": "tʁɑ̃kil",
        "fils": "fis", "plus": "ply", "tous": "tus", "sens": "sɑ̃s",
        "hier": "jɛʁ", "eau": "o", "août": "ut", "oeil": "œj",
        "œil": "œj", "pays": "pei", "ils": "il", "elles": "ɛl",
    },
    "es": {},
    "it": {},
    "pt": {"muito": "mũjtu", "não": "nɐ̃w", "e": "i", "o": "u"},
}

# ── Japanese: kana → IPA ──────────────────────────────────────────────
# Fully regular once kanji are resolved: the vendored reading lexicon
# (text/ja_lexicon.py via cjk_lexicon.ja_apply) plays the role of the
# reference's misaki[ja]/pyopenjtalk dictionary; kanji it can't read are
# reported via the drop counter instead of silently misread. Digraphs
# (palatalized kya/sho/...) listed first.

_KANA_BASE = {
    "あ": "a", "い": "i", "う": "ɯ", "え": "e", "お": "o",
    "か": "ka", "き": "ki", "く": "kɯ", "け": "ke", "こ": "ko",
    "が": "ɡa", "ぎ": "ɡi", "ぐ": "ɡɯ", "げ": "ɡe", "ご": "ɡo",
    "さ": "sa", "し": "ɕi", "す": "sɯ", "せ": "se", "そ": "so",
    "ざ": "za", "じ": "ʥi", "ず": "zɯ", "ぜ": "ze", "ぞ": "zo",
    "た": "ta", "ち": "ʨi", "つ": "ʦɯ", "て": "te", "と": "to",
    "だ": "da", "ぢ": "ʥi", "づ": "zɯ", "で": "de", "ど": "do",
    "な": "na", "に": "ɲi", "ぬ": "nɯ", "ね": "ne", "の": "no",
    "は": "ha", "ひ": "çi", "ふ": "ɸɯ", "へ": "he", "ほ": "ho",
    "ば": "ba", "び": "bi", "ぶ": "bɯ", "べ": "be", "ぼ": "bo",
    "ぱ": "pa", "ぴ": "pi", "ぷ": "pɯ", "ぺ": "pe", "ぽ": "po",
    "ま": "ma", "み": "mi", "む": "mɯ", "め": "me", "も": "mo",
    "や": "ja", "ゆ": "jɯ", "よ": "jo",
    "ら": "ɾa", "り": "ɾi", "る": "ɾɯ", "れ": "ɾe", "ろ": "ɾo",
    "わ": "wa", "ゐ": "i", "ゑ": "e", "を": "o", "ん": "ɴ",
    "ぁ": "a", "ぃ": "i", "ぅ": "ɯ", "ぇ": "e", "ぉ": "o",
    "ゔ": "bɯ",
}

_KANA_DIGRAPH = {
    "きゃ": "kʲa", "きゅ": "kʲɯ", "きょ": "kʲo",
    "ぎゃ": "ɡʲa", "ぎゅ": "ɡʲɯ", "ぎょ": "ɡʲo",
    "しゃ": "ɕa", "しゅ": "ɕɯ", "しょ": "ɕo",
    "じゃ": "ʥa", "じゅ": "ʥɯ", "じょ": "ʥo",
    "ちゃ": "ʨa", "ちゅ": "ʨɯ", "ちょ": "ʨo",
    "にゃ": "ɲa", "にゅ": "ɲɯ", "にょ": "ɲo",
    "ひゃ": "ça", "ひゅ": "çɯ", "ひょ": "ço",
    "びゃ": "bʲa", "びゅ": "bʲɯ", "びょ": "bʲo",
    "ぴゃ": "pʲa", "ぴゅ": "pʲɯ", "ぴょ": "pʲo",
    "みゃ": "mʲa", "みゅ": "mʲɯ", "みょ": "mʲo",
    "りゃ": "ɾʲa", "りゅ": "ɾʲɯ", "りょ": "ɾʲo",
    # katakana-only foreign combinations
    "ファ": "ɸa", "フィ": "ɸi", "フェ": "ɸe", "フォ": "ɸo",
    "ティ": "ti", "ディ": "di", "トゥ": "tɯ", "ドゥ": "dɯ",
    "ウィ": "wi", "ウェ": "we", "ウォ": "wo",
    "シェ": "ɕe", "ジェ": "ʥe", "チェ": "ʨe",
}


def _hira(ch: str) -> str:
    """Katakana → hiragana (same syllabary, offset 0x60)."""
    o = ord(ch)
    return chr(o - 0x60) if 0x30A1 <= o <= 0x30F6 else ch


def _ja_to_ipa(word: str) -> tuple[str, int]:
    """Kana/kanji word → (IPA string, count of untransducible chars).

    Kanji spans are first rewritten to phonetic kana by the vendored
    reading lexicon (text/cjk_lexicon.ja_apply); anything it can't read
    stays in place and lands in the drop counter below.
    """
    from open_speech_tpu_torch.text.cjk_lexicon import ja_apply

    word = ja_apply(word)
    out: list[str] = []
    dropped = 0
    i = 0
    n = len(word)
    while i < n:
        two = word[i : i + 2]
        two_h = "".join(_hira(c) for c in two)
        if two in _KANA_DIGRAPH:
            out.append(_KANA_DIGRAPH[two])
            i += 2
            continue
        if two_h in _KANA_DIGRAPH:
            out.append(_KANA_DIGRAPH[two_h])
            i += 2
            continue
        ch = word[i]
        h = _hira(ch)
        if h in ("っ",):  # sokuon: geminate the next consonant
            nxt = word[i + 1 : i + 3]
            nxt_ipa = None
            nh = "".join(_hira(c) for c in nxt)
            if nh in _KANA_DIGRAPH:
                nxt_ipa = _KANA_DIGRAPH[nh]
            elif nh[:1] in _KANA_BASE:
                nxt_ipa = _KANA_BASE[nh[:1]]
            out.append(nxt_ipa[0] if nxt_ipa else "ʔ")
            i += 1
            continue
        if ch == "ー":  # chōonpu: lengthen preceding vowel
            out.append("ː")
            i += 1
            continue
        if h in _KANA_BASE:
            out.append(_KANA_BASE[h])
            i += 1
            continue
        dropped += 1  # kanji or unknown symbol: no lexicon here
        i += 1
    return "".join(out), dropped


# ── Mandarin: pinyin → IPA ────────────────────────────────────────────
# Tones map to the kokoro arrow symbols (misaki[zh] convention: the
# checkpoint vocab carries →/↗/↓/↘ for tones 1-4). Raw hanzi are
# resolved by the vendored reading lexicon (text/zh_lexicon.py via
# cjk_lexicon.zh_apply — the reference uses misaki[zh]'s jieba/pypinyin);
# hanzi it can't read are counted as dropped.

_PINYIN_INITIALS = [
    ("zh", "ʈʂ"), ("ch", "ʈʂʰ"), ("sh", "ʂ"),
    ("b", "p"), ("p", "pʰ"), ("m", "m"), ("f", "f"),
    ("d", "t"), ("t", "tʰ"), ("n", "n"), ("l", "l"),
    ("g", "k"), ("k", "kʰ"), ("h", "x"),
    ("j", "ʨ"), ("q", "ʨʰ"), ("x", "ɕ"),
    ("r", "ɻ"), ("z", "ʦ"), ("c", "ʦʰ"), ("s", "s"),
    ("y", "j"), ("w", "w"),
]

_PINYIN_FINALS = [
    ("iong", "jʊŋ"), ("iang", "jɑŋ"), ("uang", "wɑŋ"), ("ueng", "wəŋ"),
    ("iao", "jaʊ"), ("uai", "waɪ"), ("ian", "jɛn"), ("uan", "wan"),
    ("ang", "ɑŋ"), ("eng", "əŋ"), ("ong", "ʊŋ"), ("ing", "iŋ"),
    ("üan", "ɥɛn"), ("üe", "ɥe"), ("ün", "yn"),
    ("ia", "ja"), ("ie", "je"), ("iu", "joʊ"), ("in", "in"),
    ("ua", "wa"), ("uo", "wo"), ("ui", "weɪ"), ("un", "wən"),
    ("ai", "aɪ"), ("ei", "eɪ"), ("ao", "aʊ"), ("ou", "oʊ"),
    ("an", "an"), ("en", "ən"), ("er", "ɚ"),
    ("a", "a"), ("o", "o"), ("e", "ɤ"), ("i", "i"), ("u", "u"), ("ü", "y"),
]

_ZH_TONES = {"1": "→", "2": "↗", "3": "↓", "4": "↘", "5": ""}

# pinyin tone diacritics → (bare vowel, tone digit)
_PINYIN_TONE_MARKS = {
    "ā": ("a", "1"), "á": ("a", "2"), "ǎ": ("a", "3"), "à": ("a", "4"),
    "ē": ("e", "1"), "é": ("e", "2"), "ě": ("e", "3"), "è": ("e", "4"),
    "ī": ("i", "1"), "í": ("i", "2"), "ǐ": ("i", "3"), "ì": ("i", "4"),
    "ō": ("o", "1"), "ó": ("o", "2"), "ǒ": ("o", "3"), "ò": ("o", "4"),
    "ū": ("u", "1"), "ú": ("u", "2"), "ǔ": ("u", "3"), "ù": ("u", "4"),
    "ǖ": ("ü", "1"), "ǘ": ("ü", "2"), "ǚ": ("ü", "3"), "ǜ": ("ü", "4"),
}

_SIBILANT_INITIALS = ("ʦ", "ʦʰ", "s", "ʈʂ", "ʈʂʰ", "ʂ", "ɻ")


def _zh_syllable_to_ipa(syl: str) -> str | None:
    """One pinyin syllable (tone digit or mark, e.g. 'zhong1'/'hǎo') → IPA."""
    tone = ""
    bare = []
    for ch in syl:
        if ch in _PINYIN_TONE_MARKS:
            v, t = _PINYIN_TONE_MARKS[ch]
            bare.append(v)
            tone = _ZH_TONES[t]
        elif ch in _ZH_TONES:
            tone = _ZH_TONES[ch]
        elif ch == "v":  # common ASCII stand-in for ü
            bare.append("ü")
        else:
            bare.append(ch)
    s = "".join(bare)
    if not s:
        return None
    initial_ipa = ""
    for pat, ipa in _PINYIN_INITIALS:
        if s.startswith(pat):
            initial_ipa = ipa
            s = s[len(pat):]
            break
    if not s and initial_ipa:  # e.g. "m" interjection
        return initial_ipa + tone
    for pat, ipa in _PINYIN_FINALS:
        if s == pat:
            # apical vowel after sibilants: zi/ci/si/zhi/chi/shi/ri
            if pat == "i" and initial_ipa in _SIBILANT_INITIALS:
                ipa = "ɨ"
            # jü/qü/xü written without umlaut: ju → tɕy
            if pat in ("u", "un", "uan") and initial_ipa in ("ʨ", "ʨʰ", "ɕ"):
                ipa = {"u": "y", "un": "yn", "uan": "ɥɛn"}[pat]
            return initial_ipa + ipa + tone
    return None


def _zh_to_ipa(word: str) -> tuple[str, int]:
    """Pinyin text (syllables with tone digits/marks) → (IPA, dropped).

    Hanzi spans are first rewritten to toned pinyin by the vendored
    reading lexicon (text/cjk_lexicon.zh_apply); hanzi it can't read
    stay in place and are counted as dropped."""
    from open_speech_tpu_torch.text.cjk_lexicon import zh_apply

    word = zh_apply(word)
    # already-split syllable? try whole word first, then greedy split
    out: list[str] = []
    dropped = 0
    for chunk in re.findall(r"[a-zümāáǎàēéěèīíǐìōóǒòūúǔùǖǘǚǜ1-5]+|.", word):
        if len(chunk) == 1 and not chunk.isascii() and chunk not in _PINYIN_TONE_MARKS:
            dropped += 1  # hanzi / unknown
            continue
        ipa = _zh_syllable_to_ipa(chunk)
        if ipa is not None:
            out.append(ipa)
            continue
        # greedy multi-syllable split: longest prefix that parses
        rest = chunk
        ok = True
        while rest:
            for ln in range(min(7, len(rest)), 0, -1):
                ipa = _zh_syllable_to_ipa(rest[:ln])
                if ipa is not None:
                    out.append(ipa)
                    rest = rest[ln:]
                    break
            else:
                ok = False
                break
        if not ok:
            dropped += len(rest)
    return "".join(out), dropped


# ── Hindi: Devanagari → IPA ───────────────────────────────────────────
# Devanagari is near-phonemic: consonants carry an inherent schwa unless
# a matra or virama follows; word-final schwa deletes (standard Hindi).

_DEV_CONS = {
    "क": "k", "ख": "kʰ", "ग": "ɡ", "घ": "ɡʰ", "ङ": "ŋ",
    "च": "ʧ", "छ": "ʧʰ", "ज": "ʤ", "झ": "ʤʰ", "ञ": "ɲ",
    "ट": "ʈ", "ठ": "ʈʰ", "ड": "ɖ", "ढ": "ɖʰ", "ण": "ɳ",
    "त": "t", "थ": "tʰ", "द": "d", "ध": "dʰ", "न": "n",
    "प": "p", "फ": "pʰ", "ब": "b", "भ": "bʰ", "म": "m",
    "य": "j", "र": "ɾ", "ल": "l", "व": "ʋ",
    "श": "ʃ", "ष": "ʂ", "स": "s", "ह": "h",
    "ड़": "ɽ", "ढ़": "ɽʰ", "क़": "q", "ख़": "x", "ग़": "ɣ",
    "ज़": "z", "फ़": "f", "ऱ": "ɾ", "य़": "j",
}

_DEV_VOWELS = {
    "अ": "ə", "आ": "ɑ", "इ": "ɪ", "ई": "i", "उ": "ʊ", "ऊ": "u",
    "ऋ": "ɾɪ", "ए": "e", "ऐ": "ɛ", "ओ": "o", "औ": "ɔ",
    "ऑ": "ɒ", "ऍ": "æ",
}

_DEV_MATRAS = {
    "ा": "ɑ", "ि": "ɪ", "ी": "i", "ु": "ʊ", "ू": "u", "ृ": "ɾɪ",
    "े": "e", "ै": "ɛ", "ो": "o", "ौ": "ɔ", "ॉ": "ɒ", "ॅ": "æ",
}

_DEV_VIRAMA = "्"
_DEV_ANUSVARA = "ं"
_DEV_CANDRABINDU = "ँ"
_DEV_VISARGA = "ः"
_DEV_NUKTA = "़"


def _hi_to_ipa(word: str) -> tuple[str, int]:
    out: list[str] = []
    dropped = 0
    i = 0
    n = len(word)
    while i < n:
        ch = word[i]
        two = word[i : i + 2]
        cons = _DEV_CONS.get(two) or _DEV_CONS.get(ch)
        if cons is not None:
            step = 2 if two in _DEV_CONS else 1
            i += step
            # nukta folded into the two-char lookup; stray nukta skipped
            if i < n and word[i] == _DEV_NUKTA:
                i += 1
            out.append(cons)
            if i < n and word[i] in _DEV_MATRAS:
                out.append(_DEV_MATRAS[word[i]])
                i += 1
            elif i < n and word[i] == _DEV_VIRAMA:
                i += 1  # conjunct: no vowel
            elif i < n or len(out) == 1:
                # inherent schwa; deleted word-finally (standard Hindi)
                # except for a lone-consonant word
                out.append("ə")
            continue
        if ch in _DEV_VOWELS:
            out.append(_DEV_VOWELS[ch])
            i += 1
            continue
        if ch == _DEV_ANUSVARA:
            out.append("n")
            i += 1
            continue
        if ch == _DEV_CANDRABINDU:
            out.append("̃")
            i += 1
            continue
        if ch == _DEV_VISARGA:
            out.append("h")
            i += 1
            continue
        if ch in (_DEV_VIRAMA, _DEV_NUKTA, "ऽ"):
            i += 1
            continue
        dropped += 1
        i += 1
    return "".join(out), dropped


_LEXICAL_LANGS = {"ja": _ja_to_ipa, "zh": _zh_to_ipa, "hi": _hi_to_ipa}

# 0-9 per language so digits aren't read with English words
_DIGITS = {
    "es": "cero uno dos tres cuatro cinco seis siete ocho nueve".split(),
    "de": "null eins zwei drei vier fünf sechs sieben acht neun".split(),
    "fr": "zéro un deux trois quatre cinq six sept huit neuf".split(),
    "it": "zero uno due tre quattro cinque sei sette otto nove".split(),
    "pt": "zero um dois três quatro cinco seis sete oito nove".split(),
}

_COMPILED: dict[str, list[tuple[re.Pattern, str]]] = {}


def _rules_for(lang: str) -> list[tuple[re.Pattern, str]]:
    if lang not in _COMPILED:
        _COMPILED[lang] = [
            (re.compile(pat), ipa) for pat, ipa in LANG_RULES[lang]
        ]
    return _COMPILED[lang]


def base_lang(voice_or_lang: str) -> str:
    """'de_DE-thorsten-medium' / 'fr-fr' / 'es' → 'de'/'fr'/'es'."""
    tok = voice_or_lang.split("/")[-1]
    return re.split(r"[-_]", tok.lower())[0] or "en"


def supported_language(voice_or_lang: str) -> bool:
    lang = base_lang(voice_or_lang)
    return lang == "en" or lang in LANG_RULES or lang in _LEXICAL_LANGS


def _word_to_ipa(word: str, lang: str) -> str:
    lex = LANG_LEXICON.get(lang)
    if lex is not None:
        hit = lex.get(word)
        if hit is not None:
            return hit
    rules = _rules_for(lang)
    out: list[str] = []
    i = 0
    while i < len(word):
        for pat, ipa in rules:
            m = pat.match(word, i)
            if m and m.end() > i:
                out.append(ipa)
                i = m.end()
                break
        else:
            i += 1  # unknown character: skip
    return "".join(out)


def ipa_phonemize_ex(text: str, lang: str) -> tuple[list[str], int] | None:
    """Text → (IPA character list, dropped-char count).

    Rule-table languages (es/de/fr/it/pt) transduce letter rules; ja/zh/hi
    use the kana/pinyin/Devanagari transducers (chars needing a reading
    lexicon — kanji, hanzi — are counted as dropped, never misread).
    Returns None when ``lang`` has no path (caller should gate the voice
    rather than fall back to English pronunciation).
    """
    lang = base_lang(lang)
    lexical = _LEXICAL_LANGS.get(lang)
    if lang not in LANG_RULES and lexical is None:
        return None
    text = unicodedata.normalize("NFC", text.lower())
    if lang in _DIGITS:
        digits = _DIGITS[lang]
        text = re.sub(
            r"\d", lambda m: " " + digits[int(m.group(0))] + " ", text
        )
    chars: list[str] = []
    dropped = 0
    word_re = r"[^\W_]+" if lexical else r"[^\W\d_]+"
    for token in re.findall(word_re + r"|[,.?!、。？！]", text, re.UNICODE):
        if token in ",.?!":
            chars.append(token)
            continue
        if token in "、。？！":  # CJK punctuation → vocab equivalents
            chars.append({"、": ",", "。": ".", "？": "?", "！": "!"}[token])
            continue
        if chars and chars[-1] not in (" ", ",", ".", "?", "!"):
            chars.append(" ")
        if lexical:
            ipa, miss = lexical(token)
            chars.extend(ipa)
            dropped += miss
        else:
            chars.extend(_word_to_ipa(token, lang))
    return chars, dropped


def ipa_phonemize(text: str, lang: str) -> list[str] | None:
    """Back-compat wrapper: IPA chars only (see ``ipa_phonemize_ex``)."""
    res = ipa_phonemize_ex(text, lang)
    return None if res is None else res[0]


# espeak output quirks / multi-char sequences → kokoro vocab symbols.
# The kokoro checkpoint vocab encodes affricates as single codepoints
# (ʧ ʤ ʦ ʨ ʥ); espeak --ipa emits tied or plain digraphs. Order matters.
_IPA_NORM_SEQ = [
    ("t͡ʃ", "ʧ"), ("d͡ʒ", "ʤ"), ("t͡s", "ʦ"), ("d͡z", "ʣ"),
    ("t͡ɕ", "ʨ"), ("d͡ʑ", "ʥ"),
    ("tʃ", "ʧ"), ("dʒ", "ʤ"), ("tɕ", "ʨ"), ("dʑ", "ʥ"),
    ("g", "ɡ"), ("'", "ˈ"), ("ˑ", "ː"),
    ("‿", " "), ("|", " "), ("‖", " "), ("_", " "), ("͡", ""),
    # precomposed nasal vowels (pt) -> base + combining tilde U+0303
    # (both in the kokoro alphabet); ʏ (de/espeak) -> nearest in-vocab vowel
    ("\u00e3", "a\u0303"),
    ("\u1ebd", "e\u0303"),
    ("\u0129", "i\u0303"),
    ("\u00f5", "o\u0303"),
    ("\u0169", "u\u0303"),
    ("\u028f", "\u028a"),
]


def normalize_ipa(chars: list[str]) -> list[str]:
    """Normalize an espeak/transducer IPA stream onto the kokoro symbol set.

    Fuses affricate digraphs into the single-codepoint vocab symbols,
    fixes ascii 'g', maps separators to space — so checkpoint-vocab encoding
    drops only genuinely unknown symbols (which the caller counts/report).
    """
    s = "".join(chars)
    for pat, rep in _IPA_NORM_SEQ:
        s = s.replace(pat, rep)
    s = re.sub(r"\s+", " ", s)
    return list(s.strip())


def arpabet_to_ipa(phones: list[str]) -> list[str]:
    """ARPAbet phoneme list → IPA character list (English path)."""
    chars: list[str] = []
    for p in phones:
        chars.extend(ARPABET_TO_IPA.get(p, ""))
    return chars


# Inverse map for the espeak→built-in-id-space path, extended with the
# en-us symbols espeak emits that the forward table never produces
# (rhotic/reduced vowels, flap, glottal stop). Length marks and stress
# are stripped before matching, so the long vowels resolve via their
# base symbol (ɑː→ɑ→AA).
_IPA_TO_ARPABET: dict[str, str] = {
    ipa: arp for arp, ipa in ARPABET_TO_IPA.items() if ipa.strip()
}
_IPA_TO_ARPABET.update({
    "ɚ": "ER", "ɜ": "ER", "ɝ": "ER", "ɐ": "AH", "ʌ": "AH", "ɒ": "AA",
    "əʊ": "OW", "ɪə": "IH R", "eə": "EH R", "ʊə": "UH R",
    "ɾ": "D", "ʔ": "T", "ɫ": "L", "r": "R", "ʍ": "W", "x": "K",
    "e": "EH", "o": "OW", "a": "AE", "ᵻ": "IH", "ɵ": "AH",
    "ʧ": "CH", "ʤ": "JH",
    " ": " ", ",": ",", ".": ".", "?": "?", "!": "!",
})
_IPA_ARPA_KEYS_2 = {k for k in _IPA_TO_ARPABET if len(k) == 2}


def ipa_to_arpabet(chars: list[str]) -> list[str]:
    """IPA character stream → ARPAbet phonemes (greedy longest match).

    Used when espeak provides the phonemization but the consumer is the
    built-in ARPAbet id space (no checkpoint vocab). Stress/length/tie
    marks are prosody-only there and are dropped; unknown symbols are
    skipped rather than misread.
    """
    s = "".join(normalize_ipa(chars))
    for mark in ("ˈ", "ˌ", "ː", "̩", "̯", "͡"):
        s = s.replace(mark, "")
    out: list[str] = []
    i = 0
    while i < len(s):
        pair = s[i : i + 2]
        if pair in _IPA_ARPA_KEYS_2:
            out.extend(_IPA_TO_ARPABET[pair].split())
            i += 2
            continue
        hit = _IPA_TO_ARPABET.get(s[i])
        if hit is not None:
            # .split() eats the word-boundary symbol itself — keep it
            out.extend(hit.split() or [hit])
        i += 1
    return out
