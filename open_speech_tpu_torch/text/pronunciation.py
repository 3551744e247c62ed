"""Pronunciation dictionary + SSML subset (reference: src/pronunciation/dictionary.py).

Longest-match-first regex substitutions loaded from JSON/YAML (:33-37); the
SSML subset turns <break time="Ns"> into pause dots and strips the remaining
tags (:40-48).
"""

from __future__ import annotations

import json
import logging
import re
from pathlib import Path

logger = logging.getLogger(__name__)


class PronunciationDictionary:
    def __init__(self, path: str = "") -> None:
        self._subs: list[tuple[re.Pattern, str]] = []
        if path:
            self.load(path)

    def load(self, path: str) -> None:
        p = Path(path)
        if not p.exists():
            logger.warning("Pronunciation dict not found: %s", path)
            return
        text = p.read_text(encoding="utf-8")
        if p.suffix in (".yml", ".yaml"):
            import yaml

            mapping = yaml.safe_load(text) or {}
        else:
            mapping = json.loads(text)
        self.set_mapping(mapping)

    def set_mapping(self, mapping: dict[str, str]) -> None:
        # longest keys first so multi-word entries win
        items = sorted(mapping.items(), key=lambda kv: -len(kv[0]))
        # replacement is user data, not a regex template: a literal
        # backslash in a dictionary value must not become a group reference
        self._subs = [
            (
                re.compile(rf"\b{re.escape(k)}\b", re.IGNORECASE),
                (lambda v: lambda m: v)(str(v)),
            )
            for k, v in items
        ]

    def apply(self, text: str) -> str:
        for pattern, replacement in self._subs:
            text = pattern.sub(replacement, text)
        return text

    def __len__(self) -> int:
        return len(self._subs)


_BREAK_RE = re.compile(r"<break\s+time=[\"']?(\d+(?:\.\d+)?)(m?s)[\"']?\s*/?>")
_TAG_RE = re.compile(r"<[^>]+>")


def parse_ssml(ssml: str) -> str:
    """SSML subset -> plain text with pause dots (reference semantics)."""

    def break_to_dots(m: re.Match) -> str:
        value = float(m.group(1))
        seconds = value / 1000.0 if m.group(2) == "ms" else value
        dots = max(1, int(round(seconds * 2)))
        return " " + "." * dots + " "

    text = _BREAK_RE.sub(break_to_dots, ssml)
    text = _TAG_RE.sub("", text)
    return re.sub(r"\s+", " ", text).strip()
