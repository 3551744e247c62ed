"""Host-side PCM/WAV and G.711 codecs (numpy only).

Copy of the WAV, PCM16, G.711 and linear-resampler parts of
``open_speech_tpu/ops/audio.py``, without the optional native-library path:
the bytes in and out are the same.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np


def float_to_pcm16(audio: np.ndarray) -> bytes:
    """float32 [-1, 1] -> little-endian int16 bytes (clipped)."""
    clipped = np.clip(np.asarray(audio, dtype=np.float32), -1.0, 1.0)
    return (clipped * 32767.0).astype("<i2").tobytes()


def pcm16_to_float(data: bytes | np.ndarray) -> np.ndarray:
    """little-endian int16 bytes (or int16 array) -> float32 in [-1, 1]."""
    if isinstance(data, np.ndarray):
        ints = data.astype(np.int16)
    else:
        ints = np.frombuffer(data, dtype="<i2")
    return ints.astype(np.float32) / 32768.0


@dataclass
class WavInfo:
    sample_rate: int
    channels: int
    bits_per_sample: int
    audio_format: int  # 1 = PCM, 3 = IEEE float
    data_offset: int
    data_size: int


def wav_header(
    data_size: int, sample_rate: int, channels: int = 1, bits: int = 16
) -> bytes:
    """44-byte canonical RIFF/WAVE header for PCM data of ``data_size`` bytes."""
    byte_rate = sample_rate * channels * bits // 8
    block_align = channels * bits // 8
    return b"".join(
        [
            b"RIFF",
            struct.pack("<I", 36 + data_size),
            b"WAVE",
            b"fmt ",
            struct.pack(
                "<IHHIIHH", 16, 1, channels, sample_rate, byte_rate, block_align, bits
            ),
            b"data",
            struct.pack("<I", data_size),
        ]
    )


def write_wav(audio: np.ndarray, sample_rate: int, channels: int = 1) -> bytes:
    """float32 [-1,1] mono (or [n, ch]) -> complete 16-bit PCM WAV bytes."""
    audio = np.asarray(audio, dtype=np.float32)
    if audio.ndim == 2:
        channels = audio.shape[1]
        audio = audio.reshape(-1)
    pcm = float_to_pcm16(audio)
    return wav_header(len(pcm), sample_rate, channels) + pcm


def pcm16_to_wav(pcm: bytes, sample_rate: int, channels: int = 1) -> bytes:
    """Wrap raw PCM16 bytes in a WAV container."""
    return wav_header(len(pcm), sample_rate, channels) + pcm


def is_wav(data: bytes) -> bool:
    return len(data) >= 12 and data[:4] == b"RIFF" and data[8:12] == b"WAVE"


def parse_wav_header(data: bytes) -> WavInfo:
    """Walk RIFF chunks to locate fmt/data; tolerant of extra chunks (LIST etc.)."""
    if not is_wav(data):
        raise ValueError("not a RIFF/WAVE file")
    pos = 12
    fmt: tuple[int, int, int, int] | None = None  # format, channels, rate, bits
    data_offset = data_size = -1
    n = len(data)
    while pos + 8 <= n:
        chunk_id = data[pos : pos + 4]
        (chunk_size,) = struct.unpack_from("<I", data, pos + 4)
        body = pos + 8
        if chunk_id == b"fmt " and body + 16 <= n:
            audio_format, channels, rate, _br, _ba, bits = struct.unpack_from(
                "<HHIIHH", data, body
            )
            # WAVE_FORMAT_EXTENSIBLE: the sub-format sits at body+24; a
            # truncated upload may claim 40 bytes it does not carry
            if audio_format == 0xFFFE and chunk_size >= 40 and body + 26 <= n:
                (sub,) = struct.unpack_from("<H", data, body + 24)
                audio_format = sub
            fmt = (audio_format, channels, rate, bits)
        elif chunk_id == b"data":
            data_offset = body
            data_size = min(chunk_size, n - body)
            if fmt is not None:
                break
        pos = body + chunk_size + (chunk_size & 1)  # chunks are word-aligned
    if fmt is None or data_offset < 0:
        raise ValueError("WAV missing fmt/data chunk")
    audio_format, channels, rate, bits = fmt
    return WavInfo(rate, channels, bits, audio_format, data_offset, data_size)


def read_wav(data: bytes) -> tuple[np.ndarray, int]:
    """WAV bytes -> (float32 mono [-1,1], sample_rate).

    Supports PCM 8/16/24/32-bit, IEEE float32/64 and G.711 A-law/mu-law
    (format tags 6/7); multichannel is averaged to mono.
    """
    info = parse_wav_header(data)
    raw = data[info.data_offset : info.data_offset + info.data_size]
    # a cut-short stream may leave a partial trailing sample: decode the
    # usable prefix
    elem = max(1, info.bits_per_sample // 8)
    raw = raw[: len(raw) - len(raw) % elem]
    bits, fmt = info.bits_per_sample, info.audio_format
    if fmt == 1:  # integer PCM
        if bits == 16:
            audio = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
        elif bits == 8:  # unsigned
            audio = (
                np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0
            ) / 128.0
        elif bits == 24:
            b = np.frombuffer(raw[: len(raw) - len(raw) % 3], dtype=np.uint8)
            b = b.reshape(-1, 3)
            ints = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
            ints = np.where(ints >= 1 << 23, ints - (1 << 24), ints)
            audio = ints.astype(np.float32) / float(1 << 23)
        elif bits == 32:
            audio = np.frombuffer(raw, dtype="<i4").astype(np.float32) / float(
                1 << 31
            )
        else:
            raise ValueError(f"unsupported PCM bit depth: {bits}")
    elif fmt == 3:  # IEEE float
        dtype = "<f4" if bits == 32 else "<f8"
        audio = np.frombuffer(raw, dtype=dtype).astype(np.float32)
    elif fmt in (6, 7):  # a-law / mu-law payloads inside WAV
        u8 = np.frombuffer(raw, dtype=np.uint8)
        ints = alaw_decode(u8) if fmt == 6 else ulaw_decode(u8)
        audio = ints.astype(np.float32) / 32768.0
    else:
        raise ValueError(f"unsupported WAV format tag: {fmt}")
    if info.channels > 1:
        usable = len(audio) - len(audio) % info.channels
        audio = audio[:usable].reshape(-1, info.channels).mean(axis=1)
    return np.ascontiguousarray(audio, dtype=np.float32), info.sample_rate


# ──────────────────────────────────────────────────────────────────────
# G.711 mu-law / A-law (LUT based; replaces audioop)
# ──────────────────────────────────────────────────────────────────────

_ULAW_BIAS = 0x84
_ULAW_CLIP = 32635


def _build_ulaw_decode_table() -> np.ndarray:
    codes = np.arange(256, dtype=np.int32) ^ 0xFF
    sign = codes & 0x80
    exponent = (codes >> 4) & 0x07
    mantissa = codes & 0x0F
    magnitude = ((mantissa << 3) + _ULAW_BIAS) << exponent
    magnitude -= _ULAW_BIAS
    return np.where(sign != 0, -magnitude, magnitude).astype(np.int16)


def _build_alaw_decode_table() -> np.ndarray:
    codes = np.arange(256, dtype=np.int32) ^ 0x55
    sign = codes & 0x80
    exponent = (codes >> 4) & 0x07
    mantissa = codes & 0x0F
    magnitude = np.where(
        exponent == 0,
        (mantissa << 4) + 8,
        ((mantissa << 4) + 0x108) << (exponent - 1),
    )
    # A-law sign convention is inverted vs μ-law: sign bit SET → positive
    # (g711.c st_alaw2linear16; verified bit-exact vs audioop.alaw2lin)
    return np.where(sign != 0, magnitude, -magnitude).astype(np.int16)


_ULAW_DECODE = _build_ulaw_decode_table()
_ALAW_DECODE = _build_alaw_decode_table()


def _build_ulaw_encode_table() -> np.ndarray:
    """ITU-T G.711 μ-law segment encoder over all 65536 int16 values.

    Bit-exact with audioop.lin2ulaw (Sun g711.c st_14linear2ulaw on
    sample >> 2) — a nearest-decode inverse differs from the standard
    quantizer on ~1% of values, breaking wire parity with G.711 peers.
    """
    samples = np.arange(-32768, 32768, dtype=np.int32)
    pcm = samples >> 2  # 14-bit domain
    mask = np.where(pcm < 0, 0x7F, 0xFF)
    mag = np.minimum(np.abs(pcm), 8159) + (_ULAW_BIAS >> 2)
    seg_ends = np.array(
        [0x3F, 0x7F, 0xFF, 0x1FF, 0x3FF, 0x7FF, 0xFFF, 0x1FFF], np.int32
    )
    seg = np.searchsorted(seg_ends, mag)
    seg_c = np.minimum(seg, 7)
    uval = (seg_c << 4) | ((mag >> (seg_c + 1)) & 0xF)
    out = np.where(seg >= 8, 0x7F, uval) ^ mask
    return out.astype(np.uint8)


def _build_alaw_encode_table() -> np.ndarray:
    """ITU-T G.711 A-law segment encoder (audioop.lin2alaw: st_linear2alaw
    on sample >> 3, 13-bit domain)."""
    samples = np.arange(-32768, 32768, dtype=np.int32)
    pcm = samples >> 3
    mask = np.where(pcm >= 0, 0xD5, 0x55)
    mag = np.where(pcm >= 0, pcm, -pcm - 1)
    seg_ends = np.array(
        [0x1F, 0x3F, 0x7F, 0xFF, 0x1FF, 0x3FF, 0x7FF, 0xFFF], np.int32
    )
    seg = np.searchsorted(seg_ends, mag)
    seg_c = np.minimum(seg, 7)
    aval = (seg_c << 4) | np.where(
        seg_c < 2, (mag >> 1) & 0xF, (mag >> seg_c) & 0xF
    )
    out = np.where(seg >= 8, 0x7F, aval) ^ mask
    return out.astype(np.uint8)


_ULAW_ENCODE = _build_ulaw_encode_table()
_ALAW_ENCODE = _build_alaw_encode_table()


def ulaw_decode(codes: bytes | np.ndarray) -> np.ndarray:
    u8 = np.frombuffer(codes, dtype=np.uint8) if isinstance(codes, bytes) else codes
    return _ULAW_DECODE[u8.astype(np.uint8)]


def ulaw_encode(pcm: np.ndarray) -> np.ndarray:
    ints = np.clip(pcm.astype(np.int32), -32768, 32767) + 32768
    return _ULAW_ENCODE[ints]


def alaw_decode(codes: bytes | np.ndarray) -> np.ndarray:
    u8 = np.frombuffer(codes, dtype=np.uint8) if isinstance(codes, bytes) else codes
    return _ALAW_DECODE[u8.astype(np.uint8)]


def alaw_encode(pcm: np.ndarray) -> np.ndarray:
    ints = np.clip(pcm.astype(np.int32), -32768, 32767) + 32768
    return _ALAW_ENCODE[ints]


def linear_resample_pcm16(pcm: bytes, src_rate: int, dst_rate: int) -> bytes:
    """Linear-interpolation resample of int16 PCM bytes on the host: the
    realtime socket's format conversion (the device path is
    ``ops/resample.py:resample_pcm16``)."""
    if src_rate == dst_rate:
        return bytes(pcm)
    x = np.frombuffer(pcm, dtype="<i2").astype(np.float32)
    if x.size == 0:
        return b""
    n_out = max(1, int(round(x.size * dst_rate / src_rate)))
    src_pos = np.linspace(0.0, x.size - 1, n_out)
    out = np.interp(src_pos, np.arange(x.size), x)
    return np.clip(np.round(out), -32768, 32767).astype("<i2").tobytes()
