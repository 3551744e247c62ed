"""Transcript format converters — SRT, VTT, plain text.

A copy of ``open_speech_tpu/text/formatters.py``: truncating timestamp
math, the same cue layout, the same no-segment fallbacks, so the bytes
match the JAX package's.
"""

from __future__ import annotations

from typing import Any


def _clock(seconds: float, ms_sep: str) -> str:
    """HH:MM:SS<sep>mmm with every field truncated (not rounded)."""
    h, m = int(seconds // 3600), int((seconds % 3600) // 60)
    s, ms = int(seconds % 60), int((seconds % 1) * 1000)
    return f"{h:02d}:{m:02d}:{s:02d}{ms_sep}{ms:03d}"


def _fmt_time_srt(seconds: float) -> str:
    return _clock(seconds, ",")


def _fmt_time_vtt(seconds: float) -> str:
    return _clock(seconds, ".")


def _cues(result: dict[str, Any]):
    """Yield (start, end, text) for each non-empty segment."""
    for seg in result.get("segments", []):
        text = seg.get("text", "").strip()
        if text:
            yield seg.get("start", 0.0), seg.get("end", 0.0), text


def format_as_text(result: dict[str, Any]) -> str:
    return result.get("text", "").strip()


def format_as_srt(result: dict[str, Any]) -> str:
    cues = list(_cues(result))
    if not result.get("segments"):
        text = format_as_text(result)
        if not text:
            return ""
        end = _fmt_time_srt(result.get("duration", 0.0))
        return f"1\n{_fmt_time_srt(0)} --> {end}\n{text}\n"
    out: list[str] = []
    for index, (start, end, text) in enumerate(cues, 1):
        out += [str(index), f"{_fmt_time_srt(start)} --> {_fmt_time_srt(end)}",
                text, ""]
    return "\n".join(out)


def format_as_vtt(result: dict[str, Any]) -> str:
    header = ["WEBVTT", ""]
    if not result.get("segments"):
        text = format_as_text(result)
        if not text:
            return "WEBVTT\n"
        end = _fmt_time_vtt(result.get("duration", 0.0))
        return "\n".join(header + [f"{_fmt_time_vtt(0)} --> {end}", text, ""])
    out = header
    for start, end, text in _cues(result):
        out += [f"{_fmt_time_vtt(start)} --> {_fmt_time_vtt(end)}", text, ""]
    return "\n".join(out)


_DISPATCH = {
    "text": (format_as_text, "text/plain"),
    "srt": (format_as_srt, "text/plain"),
    "vtt": (format_as_vtt, "text/vtt"),
}


def format_transcription(
    result: dict[str, Any], response_format: str
) -> tuple[str, str]:
    """Returns (content, content_type); empty content means emit JSON."""
    entry = _DISPATCH.get(response_format)
    if entry is None:
        return "", "application/json"
    formatter, content_type = entry
    return formatter(result), content_type


# Segment-object variants (used by the whisper transcribe layer directly)


def segments_to_srt(segments: list) -> str:
    rows = []
    for index, seg in enumerate(segments, 1):
        window = f"{_fmt_time_srt(seg.start)} --> {_fmt_time_srt(seg.end)}"
        rows.append(f"{index}\n{window}\n{seg.text.strip()}\n")
    return "\n".join(rows)


def segments_to_vtt(segments: list) -> str:
    rows = ["WEBVTT\n"]
    for seg in segments:
        window = f"{_fmt_time_vtt(seg.start)} --> {_fmt_time_vtt(seg.end)}"
        rows.append(f"{window}\n{seg.text.strip()}\n")
    return "\n".join(rows)
