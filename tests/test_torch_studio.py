"""The Studio's managers of the port, held against the JAX package on the CPU.

Each package's managers run on directories of their own under ``tmp_path``
(the JAX package's through its settings and a closed ``_store``, the
port's through a ``Store`` of its own), so no xdist worker sees another's
rows:

- **Storage**: the DDL equals the JAX package's, every table's ``PRAGMA
  table_info`` and index list are equal, and a database written by either
  package's managers reads back through the other's with the rows equal.
- **Profiles and history**: the same calls give the same records and the
  same errors, ids and timestamps masked; history pruning by count and by
  audio MB removes the same rows and files.
- **Voice library and TTS cache** (copies of the JAX modules): the cases of
  ``tests/test_storage_units.py`` on both packages, with equal results.
- **Composer**: the cases of ``tests/test_composer_units.py`` (sum, mute,
  solo, offset, volume, allow-list, resample, listing and delete), each
  render's WAV held against JAX's: byte for byte where no resample or
  effect runs, within 1e-5 through the resampler (``tests/
  test_torch_audio.py``'s bound) and within ``tests/test_torch_effects.py``'s
  bounds through an effect.
- **Conversations**: three turns rendered with one injected numpy
  ``synthesize_fn`` in both packages: the turn WAVs and the render are
  byte-equal without effects; with a chain on one turn, within the effects
  tests' bound for that chain.
- **``_synthesize_array``** of both apps on tiny Kokoro (one numpy-seeded
  JAX tree carried over with ``kokoro_from_jax_tree``, the harmonic
  features injected into both) within ``tests/test_torch_tts.py``'s 2e-3,
  and on a tiny Piper voice at 22.05 kHz (``tests/test_torch_piper.py``'s
  oracle, JAX's row noise injected) resampled to 24 kHz, within its 2e-5.
"""

from __future__ import annotations

import json
import re
import sqlite3
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

import jax  # noqa: F401 — the JAX package below needs it on the CPU

import open_speech_tpu.cache.tts_cache as JCACHE
import open_speech_tpu.studio.storage as JS
import open_speech_tpu.studio.voice_library as JVL
import open_speech_tpu_torch.cache.tts_cache as TCACHE
import open_speech_tpu_torch.studio.voice_library as TVL
from open_speech_tpu.config import settings as jax_settings
from open_speech_tpu.ops import audio as JA
from open_speech_tpu.studio.composer import MultiTrackComposer as JComposer
from open_speech_tpu.studio.conversation import ConversationManager as JConversations
from open_speech_tpu.studio.history import HistoryManager as JHistory
from open_speech_tpu.studio.profiles import ProfileManager as JProfiles
from open_speech_tpu_torch.ops import audio as TA
from open_speech_tpu_torch.studio import storage as TS
from open_speech_tpu_torch.studio.composer import MultiTrackComposer as TComposer
from open_speech_tpu_torch.studio.conversation import ConversationManager as TConversations
from open_speech_tpu_torch.studio.history import HistoryManager as THistory
from open_speech_tpu_torch.studio.profiles import ProfileManager as TProfiles
from tests.torch_tts_common import one_torch_thread

# one intra-op thread, as the Kokoro tests hold it: under the suite's six
# workers a full pool per worker makes small CPU ops spin (170 s, not 12 s)
_one_torch_thread = pytest.fixture(scope="module", autouse=True)(one_torch_thread)

TABLES = ("profiles", "history_entries", "conversations", "conversation_turns", "compositions")
MASKED = ("id", "created_at", "updated_at", "conversation_id", "composition_id", "profile_id")
TOL_RESAMPLE = 1e-5  # tests/test_torch_audio.py's resampler bound
TOL_FX = {"normalize": 1e-6, "reverb": 1e-6, "chain": 1e-3}  # tests/test_torch_effects.py's bounds


_UUID = re.compile(r"[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{12}")


def _mask(value, root: Path | None = None):
    """``value`` with ids and timestamps replaced by their key, ids inside
    strings (paths, URLs) by ``<id>``, and paths under ``root`` made
    relative to it."""
    if isinstance(value, dict):
        return {k: (k if k in MASKED and value[k] is not None else _mask(v, root)) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_mask(v, root) for v in value]
    if isinstance(value, str):
        if root is not None and value.startswith(str(root)):
            value = value[len(str(root)):]
        return _UUID.sub("<id>", value)
    return value


# ── each package's studio on its own directories ────────────────────────


class _Side:
    """One package's studio directories under ``root``."""

    def __init__(self, root: Path) -> None:
        self.root = root
        self.db = root / "studio.db"
        self.conversations = root / "conversations"
        self.composer = root / "composer"
        self.voices = root / "voices"


@pytest.fixture
def jax_side(tmp_path, monkeypatch):
    """The JAX package's settings on ``tmp_path/jax``, its store reopened
    there, the tables created."""
    side = _Side(tmp_path / "jax")
    _point_jax(monkeypatch, side)
    yield side
    JS.reset_db()


def _point_jax(monkeypatch, side: _Side, **history) -> None:
    for name, value in (("os_studio_db_path", side.db), ("os_conversations_dir", side.conversations),
                        ("os_composer_dir", side.composer), ("os_voice_library_path", side.voices)):
        monkeypatch.setattr(jax_settings, name, str(value))
    for name, value in history.items():
        monkeypatch.setattr(jax_settings, f"os_history_{name}", value)
    JS.reset_db()
    JS.init_db()


@pytest.fixture
def port_side(tmp_path):
    side = _Side(tmp_path / "port")
    side.store = TS.Store(side.db)
    side.store.bootstrap()
    yield side
    side.store.close()


def _history_pair(jax_side, port_side, monkeypatch, max_entries=1000, max_mb=2000, retain_audio=True):
    for name, value in (("max_entries", max_entries), ("max_mb", max_mb), ("retain_audio", retain_audio)):
        monkeypatch.setattr(jax_settings, f"os_history_{name}", value)
    return JHistory(), THistory(port_side.store, max_entries=max_entries, max_mb=max_mb,
                                retain_audio=retain_audio)


# ── storage ─────────────────────────────────────────────────────────────


def test_ddl_equals_the_jax_packages():
    assert TS._TABLES == JS._TABLES and TS.SCHEMA_SQL == JS.SCHEMA_SQL


@pytest.mark.parametrize("table", TABLES)
def test_table_columns_and_indexes_equal_jax(jax_side, port_side, table):
    def describe(path: Path) -> tuple:
        with sqlite3.connect(path) as conn:
            cols = conn.execute(f"PRAGMA table_info({table})").fetchall()
            idx = sorted(conn.execute(f"PRAGMA index_list({table})").fetchall())
            fks = conn.execute(f"PRAGMA foreign_key_list({table})").fetchall()
        return cols, idx, fks

    got, want = describe(port_side.db), describe(jax_side.db)
    assert got[0] and got == want


def _write_rows(profiles, history, conversations) -> str:
    pid = profiles.create("Narrator", "kokoro", "kokoro", "af_heart", 1.1, "wav", None, None,
                          [{"type": "normalize"}])["id"]
    profiles.create("Butler", "kokoro", None, "bm_george", 0.9, "mp3", "b(1)", "ref1", [])
    profiles.set_default(pid)
    history.log_stt("whisper-1", "a.wav", "hello there")
    history.log_tts("kokoro", "af_heart", 1.0, "wav", "hi " * 100, None, 1234, streamed=False)
    history.log_tts("kokoro", "af_sky", 1.2, "pcm", "streamed", None, None, streamed=True)
    conv = conversations.create("demo", [{"speaker": "A", "text": "one", "profile_id": pid},
                                         {"speaker": "B", "text": "two", "effects": [{"type": "reverb"}]}])
    conversations.add_turn(conv["id"], "A", "three")
    return conv["id"]


def _read_rows(profiles, history, conversations, cid) -> dict:
    listed = history.list_entries()
    listed["items"].sort(key=lambda r: r["full_text"])  # rows logged in one instant tie on created_at
    return {"profiles": profiles.list_all(), "default": profiles.get_default()["name"], "history": listed,
            "stt": history.list_entries(type_filter="stt", limit=1),
            "conversations": conversations.list_all(), "conversation": conversations.get(cid)}


def _port_conversations(side: _Side, profiles=None, synthesize_fn=None) -> TConversations:
    return TConversations(side.store, output_dir=side.conversations, default_model="kokoro",
                          default_voice="af_heart", device="cpu", profile_manager=profiles,
                          synthesize_fn=synthesize_fn)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_studio_db_opens_in_the_other_package(jax_side, port_side, monkeypatch, writer):
    """Rows written by one package's managers read back equal through the
    other's, on the same file."""
    jax_mgrs = lambda: (JProfiles(), JHistory(), JConversations())  # noqa: E731
    port_mgrs = lambda: (TProfiles(port_side.store), THistory(port_side.store, max_entries=1000, max_mb=2000,  # noqa: E731
                                                              retain_audio=True), _port_conversations(port_side))
    write, read = (jax_mgrs, port_mgrs) if writer == "jax" else (port_mgrs, jax_mgrs)
    if writer == "port":
        _point_jax(monkeypatch, _Side(port_side.root))  # the JAX store on the port's file
    else:
        port_side.store = TS.Store(jax_side.db)
    cid = _write_rows(*write())
    written = _read_rows(*write(), cid)
    got = _read_rows(*read(), cid)
    assert got == written  # in full: ids and timestamps too
    assert got["default"] == "Narrator" and got["history"]["total"] == 3
    assert [t["turn_index"] for t in got["conversation"]["turns"]] == [0, 1, 2]


# ── profiles ────────────────────────────────────────────────────────────


def _profile_calls(pm) -> list:
    out = []

    def call(fn, *args, **kw):
        try:
            out.append(("ok", fn(*args, **kw)))
        except (ValueError, KeyError) as e:
            out.append((type(e).__name__, str(e) if isinstance(e, ValueError) else None))
        return out[-1][1]

    a = call(pm.create, "Zed", "kokoro", None, "af_sky", 1.3, "mp3", None, None, None)
    b = call(pm.create, "alpha", "piper", "piper/en_US-lessac-medium", "x", 1.0, "wav", "m", "r",
             [{"type": "pitch", "semitones": 2}])
    call(pm.create, "Zed", "kokoro", None, "af_sky", 1.0, "mp3", None, None, None)  # duplicate
    call(pm.list_all)
    call(pm.update, a["id"], voice="af_heart", speed=0.9, effects=[{"type": "reverb"}])
    call(pm.update, a["id"], name="alpha")  # duplicate through an update
    call(pm.update, a["id"])  # nothing to change
    call(pm.update, "missing", voice="x")
    call(pm.update, "missing")
    call(pm.get_default)
    call(pm.set_default, b["id"])
    call(pm.set_default, "missing")
    call(pm.get_default)
    call(pm.set_default, a["id"])
    call(pm.list_all)
    call(pm.get, "missing")
    call(pm.delete, b["id"])
    call(pm.delete, b["id"])
    call(pm.list_all)
    return out


def test_profiles_match_jax(jax_side, port_side):
    assert _mask(_profile_calls(TProfiles(port_side.store))) == _mask(_profile_calls(JProfiles()))


# ── history ─────────────────────────────────────────────────────────────


def _history_calls(hm, audio_dir: Path) -> list:
    audio_dir.mkdir(parents=True, exist_ok=True)
    out, ids = [], []
    for i in range(5):
        path = audio_dir / f"out{i}.wav"
        path.write_bytes(b"\0" * (300 * 1024))
        ids.append(hm.log_tts("kokoro", "af_heart", 1.0, "wav", f"text {i} " + "x" * (200 * (i % 2)),
                              str(path), None if i == 2 else 300 * 1024, streamed=i == 4))
        ids.append(hm.log_stt("whisper-1", f"in{i}.wav", f"heard {i}"))
        out.append(hm.list_entries(limit=100))
    out.append(hm.list_entries(type_filter="tts", limit=2, offset=1))
    out.append(hm.list_entries(type_filter="nope"))
    out.append(hm.delete_entry(ids[-1]))
    out.append(hm.delete_entry(ids[-1]))
    out.append(hm.list_entries())
    out.append(sorted(p.name for p in audio_dir.iterdir()))
    out.append(hm.clear_all())
    out.append(sorted(p.name for p in audio_dir.iterdir()))
    return [_mask(o, audio_dir) for o in out]


@pytest.mark.parametrize("caps", [dict(max_entries=1000, max_mb=2000), dict(max_entries=4, max_mb=2000),
                                  dict(max_entries=1000, max_mb=1), dict(max_entries=0, max_mb=0, retain_audio=False)],
                         ids=["no-prune", "by-count", "by-audio-mb", "caps-off-no-audio"])
def test_history_and_its_pruning_match_jax(jax_side, port_side, monkeypatch, caps):
    jhm, thm = _history_pair(jax_side, port_side, monkeypatch, **caps)
    want = _history_calls(jhm, jax_side.root / "audio")
    got = _history_calls(thm, port_side.root / "audio")
    assert got == want
    if caps["max_mb"] == 1:  # 1 MiB holds three 300 KiB files: the oldest went with their rows
        assert len(want[4]["items"]) < 10
        assert sorted(r["output_path"] for r in want[4]["items"] if r["output_path"]) == \
            ["/out1.wav", "/out2.wav", "/out3.wav"]  # out2's size is read from its file; out4 was streamed


def test_history_preview_is_clipped_as_jax_clips_it(jax_side, port_side, monkeypatch):
    jhm, thm = _history_pair(jax_side, port_side, monkeypatch)
    text = "  " + "word " * 60
    jhm.log_stt("m", "a.wav", text)
    thm.log_stt("m", "a.wav", text)
    want, got = jhm.list_entries()["items"][0], thm.list_entries()["items"][0]
    assert _mask(got) == _mask(want) and got["text_preview"].endswith("…") and len(got["text_preview"]) == 180


# ── voice library (tests/test_storage_units.py on both packages) ────────


def _wav_bytes():
    return JA.write_wav(np.zeros(1600, np.float32), 16000)


def test_voice_library_module_is_the_jax_packages():
    """Copied verbatim (``tests/test_torch_isolation.py`` holds the file);
    the same names come out of the same inputs."""
    for name in ("My Voice!", "../../etc/passwd", "a-b c", "x" * 80, "Ünïcode voice"):
        assert TVL._slug(name) == JVL._slug(name)
    for bad in ("", "!!!", " ?* "):
        with pytest.raises(ValueError) as want:
            JVL._slug(bad)
        with pytest.raises(ValueError, match=str(want.value)):
            TVL._slug(bad)


def _library_calls(mod, path: Path) -> list:
    out = []

    def call(fn, *args, **kw):
        try:
            res = fn(*args, **kw)
            out.append(("ok", _mask({"r": res} if not isinstance(res, tuple) else
                                    {"audio": res[0], "meta": res[1]})))
        except (ValueError, KeyError) as e:
            out.append((type(e).__name__, str(e)))

    lib = mod.VoiceLibraryManager(path, max_count=2)
    call(lib.save, "Test Voice", _wav_bytes(), content_type="audio/mpeg")
    call(lib.save, "bad", b"definitely not a wav file")
    call(lib.save, "empty", b"")
    call(lib.save, "two", _wav_bytes())
    call(lib.save, "three", _wav_bytes())  # over max_count
    call(lib.save, "two", _wav_bytes() + b"\0\0")  # replacing is not adding
    (path / "broken.meta.json").write_text("{not json")
    (path / "orphan.meta.json").write_text(json.dumps({"name": "orphan", "content_type": "audio/wav"}))
    call(lib.list_voices)
    call(lib.get, "test voice")
    call(lib.get, "nobody")
    call(lib.exists, "TWO")
    call(lib.delete, "Test Voice")
    call(lib.delete, "Test Voice")
    call(lib.list_voices)
    return [(kind, {k: v for k, v in res.items()} if isinstance(res, dict) else res) for kind, res in out]


def test_voice_library_matches_jax(tmp_path):
    def strip(calls):  # created_at differs; everything else must not
        return json.loads(json.dumps(calls, default=repr).replace('"created_at"', '"t"'),
                          object_hook=lambda d: {k: v for k, v in d.items() if k != "t"})

    assert strip(_library_calls(TVL, tmp_path / "port")) == strip(_library_calls(JVL, tmp_path / "jax"))


# ── TTS cache (tests/test_storage_units.py on both packages) ────────────


@pytest.mark.parametrize("fields", [("hi", "af", 1.0, "wav", "kokoro"), ("hello|af_sky", "af_bella", 1.0, "wav", "k"),
                                    ("hello", "af_sky|af_bella", 1.0, "wav", "k"), ("é", "v", 1.25, "pcm", "m")])
def test_cache_keys_equal_jax(fields):
    assert TCACHE.TTSCache.make_key(*fields) == JCACHE.TTSCache.make_key(*fields)


def test_cache_keys_cannot_collide():
    a = TCACHE.TTSCache.make_key("hello|af_sky", "af_bella", 1.0, "wav", "kokoro")
    b = TCACHE.TTSCache.make_key("hello", "af_sky|af_bella", 1.0, "wav", "kokoro")
    assert a != b


def _cache_calls(mod, path: Path) -> list:
    import time

    c = mod.TTSCache(str(path), max_mb=1)
    out = [c.get_for(text="a", voice="v", speed=1.0, fmt="wav", model="m")]
    big = b"x" * (600 * 1024)
    c.set_for(text="a", voice="v", speed=1.0, fmt="wav", model="m", audio=big)
    time.sleep(0.02)
    c.set_for(text="b", voice="v", speed=1.0, fmt="wav", model="m", audio=big)
    out.append(c.stats())
    out.append(c.cleanup())
    out.append([c.get_for(text=t, voice="v", speed=1.0, fmt="wav", model="m") is not None for t in ("a", "b")])
    k = c.make_key("hi", "af", 1.0, "wav", "kokoro")
    c.set(k, "wav", b"data")
    out.append((c.get(k, "wav"), sorted(p.suffix for p in path.iterdir())))
    off = mod.TTSCache(str(path / "off"), enabled=False)
    off.set_for(text="a", voice="v", speed=1.0, fmt="wav", model="m", audio=b"DATA")
    out.append((off.get_for(text="a", voice="v", speed=1.0, fmt="wav", model="m"), (path / "off").exists()))
    (path / "afile").write_text("x")
    broken = mod.TTSCache(str(path / "afile" / "cache"))
    out.append((broken.enabled, broken.cleanup(), broken.stats()))
    return out


def test_cache_eviction_atomic_set_and_disabled_match_jax(tmp_path):
    got, want = _cache_calls(TCACHE, tmp_path / "port"), _cache_calls(JCACHE, tmp_path / "jax")
    assert got == want
    assert want[3] == [False, True]  # the oldest evicted to fit under max_mb; the newer survives
    assert want[4] == (b"data", [".wav", ".wav"])  # no .tmp left behind


# ── composer (tests/test_composer_units.py, held against JAX) ───────────


def _tone(path: Path, freq, seconds=0.5, rate=24000, amp=0.3) -> Path:
    t = np.arange(int(seconds * rate)) / rate
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(JA.write_wav((amp * np.sin(2 * np.pi * freq * t)).astype(np.float32), rate))
    return path


@pytest.fixture
def composers(jax_side, port_side, tmp_path):
    """Both composers, and ``tracks(side)`` writing the tones into each
    side's voice-library directory (an allowed root)."""
    jc = JComposer()
    tc = TComposer(port_side.store, output_dir=port_side.composer, conversations_dir=port_side.conversations,
                   voice_library_path=port_side.voices, device="cpu")
    return jc, tc


def _render(comp, side: _Side, tracks: list[dict], **kw):
    """The composer's render of ``tracks`` (source names resolved under the
    side's voice directory): (result or error, decoded samples, rate, bytes)."""
    tracks = [{**t, "source_path": str(side.voices / t["source_path"])} if "source_path" in t else t
              for t in tracks]
    try:
        out = comp.render(tracks=tracks, sample_rate=kw.pop("sample_rate", 24000),
                          format=kw.pop("format", "wav"), name=kw.pop("name", "mix"))
    except (ValueError, PermissionError, FileNotFoundError) as e:
        return (type(e).__name__, str(e).replace(str(side.root), "")), None, None, None
    data = Path(out["output_path"]).read_bytes()
    samples, rate = JA.read_wav(data)
    return _mask(out, side.root), samples, rate, data


TONES = {"a.wav": (220, 0.5, 24000, 0.3), "b.wav": (440, 0.5, 24000, 0.3), "c.wav": (1400, 0.5, 24000, 0.6),
         "short.wav": (330, 0.2, 24000, 0.3), "a16.wav": (330, 0.5, 16000, 0.3), "a22.wav": (500, 0.4, 22050, 0.4)}

COMPOSER_CASES = [
    ("sum", [{"source_path": "a.wav", "volume": 1.0}, {"source_path": "b.wav", "volume": 1.0}], {}),
    ("mute", [{"source_path": "a.wav"}, {"source_path": "c.wav", "muted": True}], {}),
    ("solo", [{"source_path": "a.wav"}, {"source_path": "c.wav", "solo": True}], {}),
    ("offset", [{"source_path": "short.wav", "offset_s": 0.1}], {}),
    ("offset-negative-and-clip", [{"source_path": "c.wav", "offset_s": -1}, {"source_path": "c.wav", "volume": 2}],
     {}),
    ("volume", [{"source_path": "a.wav", "volume": 0.25}], {}),
    ("all-muted", [{"source_path": "a.wav", "muted": True}], {}),
    ("missing-source", [{"source_path": "nope.wav"}], {}),
    ("no-source", [{"volume": 1.0}], {}),
    ("resample-16k", [{"source_path": "a16.wav"}], {}),
    ("resample-22k-to-16k", [{"source_path": "a22.wav"}, {"source_path": "a.wav", "offset_s": 0.05}],
     {"sample_rate": 16000}),
    ("effects", [{"source_path": "a.wav", "effects": [{"type": "normalize"}]},
                 {"source_path": "b.wav", "effects": [{"type": "reverb"}], "volume": 0.5}], {}),
    ("effects-and-resample", [{"source_path": "a22.wav", "effects": [{"type": "reverb"}]}], {}),
]


@pytest.mark.parametrize("name,tracks,kw", COMPOSER_CASES, ids=[c[0] for c in COMPOSER_CASES])
def test_composer_renders_match_jax(composers, jax_side, port_side, name, tracks, kw):
    for side in (jax_side, port_side):
        for fname, (freq, seconds, rate, amp) in TONES.items():
            _tone(side.voices / fname, freq, seconds, rate, amp)
    jc, tc = composers
    want = _render(jc, jax_side, tracks, **dict(kw))
    got = _render(tc, port_side, tracks, **dict(kw))
    assert got[0] == want[0] and got[2] == want[2]
    if want[1] is None:
        return
    assert got[1].shape == want[1].shape and got[1].size > 0
    if "effects" in name:
        np.testing.assert_allclose(got[1], want[1], atol=TOL_FX["reverb"] + 2 / 32768, rtol=0)
    elif "resample" in name:
        np.testing.assert_allclose(got[1], want[1], atol=TOL_RESAMPLE + 2 / 32768, rtol=0)
    else:
        assert got[3] == want[3]
    if name == "offset":  # silence before the offset
        assert np.abs(got[1][: int(0.09 * 24000)]).max() < 1e-4
    if name == "sum":
        solo = JA.read_wav((port_side.voices / "a.wav").read_bytes())[0]
        assert np.sqrt((got[1] ** 2).mean()) > np.sqrt((solo ** 2).mean())


def test_composer_path_allowlist_matches_jax(composers, jax_side, port_side, tmp_path):
    outside = _tone(tmp_path / "evil.wav", 440)
    jc, tc = composers
    answers = []
    for comp, side in ((jc, jax_side), (tc, port_side)):
        inside = _tone(side.conversations / "ok.wav", 440)
        answers.append([_render(comp, side, [{"source_path": str(p)}])[0] for p in (outside, "/etc/passwd", inside)])
    assert answers[1] == answers[0]
    assert answers[0][0][0] == "PermissionError" and answers[0][2]["duration_ms"] == 500


def test_composer_listing_and_delete_match_jax(composers, jax_side, port_side):
    jc, tc = composers
    out = []
    for comp, side in ((jc, jax_side), (tc, port_side)):
        src = str(_tone(side.voices / "a.wav", 330))
        cid = comp.render([{"source_path": src}], name="one")["composition_id"]
        comp.render([{"source_path": src, "volume": 0.5}], name="two")
        row = comp.get_render(cid)
        steps = [_mask(comp.list_renders(), side.root), _mask(comp.list_renders(limit=1, offset=1), side.root),
                 _mask(row, side.root), comp.delete_render(cid), comp.get_render(cid), comp.delete_render(cid),
                 Path(row["render_output_path"]).exists(), comp.list_renders()["total"]]
        out.append(steps)
    assert out[1] == out[0]
    assert out[0][3:] == [True, None, False, False, 1] and out[0][0]["total"] == 2


def test_composer_on_an_absent_card_raises(port_side):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the check is for hosts without it")
    _tone(port_side.voices / "a16.wav", 330, rate=16000)
    tc = TComposer(port_side.store, output_dir=port_side.composer, conversations_dir=port_side.conversations,
                   voice_library_path=port_side.voices, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tc.render([{"source_path": str(port_side.voices / "a16.wav")}])


# ── conversations ───────────────────────────────────────────────────────


def _synth(*, text, model, voice, speed, sample_rate):
    """A deterministic numpy synthesis: a tone whose pitch follows the
    voice and model, whose length follows the text and speed."""
    seed = zlib.crc32(f"{model}|{voice}".encode())
    n = int(sample_rate * (0.05 * len(text) / max(speed, 0.1)))
    t = np.arange(n) / sample_rate
    freq = 150 + seed % 300
    return (0.4 * np.sin(2 * np.pi * freq * t) * np.hanning(n)).astype(np.float32)


def _conversation_run(conversations, profiles, out_dir: Path, effects) -> tuple:
    pid = profiles.create("Host", "kokoro", "kokoro-82m", "af_sky", 1.5, "wav", None, None, [])["id"]
    conv = conversations.create("three turns", [
        {"speaker": "Host", "text": "Welcome to the show.", "profile_id": pid},
        {"speaker": "Guest", "text": "Thanks for having me here.", "effects": effects},
    ])
    conversations.add_turn(conv["id"], "Host", "Let us begin.", profile_id="unknown-profile")
    result = conversations.render(conv["id"], format="wav", sample_rate=24000)
    files = {p.name: p.read_bytes() for p in sorted((out_dir / conv["id"]).iterdir())}
    again = conversations.get(conv["id"])
    return _mask(result, out_dir), files, _mask(again, out_dir)


@pytest.mark.parametrize("effects", [None, [{"type": "normalize"}], [{"type": "normalize"}, {"type": "reverb"}]],
                         ids=["plain", "normalize", "chain"])
def test_conversation_render_matches_jax(jax_side, port_side, effects):
    jprof, tprof = JProfiles(), TProfiles(port_side.store)
    want = _conversation_run(JConversations(profile_manager=jprof, synthesize_fn=_synth), jprof,
                             jax_side.conversations, effects)
    got = _conversation_run(_port_conversations(port_side, tprof, _synth), tprof, port_side.conversations,
                            effects)
    assert got[0] == want[0] and got[2] == want[2]
    assert want[0]["turn_count"] == 3 and [t["duration_ms"] for t in want[2]["turns"]] == [666, 1300, 650]
    assert sorted(got[1]) == sorted(want[1]) == ["render.wav", "turn_1.wav", "turn_2.wav", "turn_3.wav"]
    for name in want[1]:
        if effects is None or name in ("turn_1.wav", "turn_3.wav"):
            assert got[1][name] == want[1][name], name
        else:
            g, w = TA.read_wav(got[1][name])[0], JA.read_wav(want[1][name])[0]
            tol = TOL_FX["chain" if len(effects) > 1 else "normalize"]
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, atol=tol + 2 / 32768, rtol=0)


def test_conversation_errors_match_jax(jax_side, port_side):
    out = []
    for conv in (JConversations(), _port_conversations(port_side)):
        empty = conv.create("empty", [])
        steps = []
        for fn, args in ((conv.render, (empty["id"],)), (conv.render, ("missing",)),
                         (conv.add_turn, ("missing", "A", "x")),
                         (conv.delete_turn, (empty["id"], "missing")), (conv.delete, ("missing",)),
                         (conv.get, ("missing",))):
            try:
                steps.append(("ok", fn(*args)))
            except (ValueError, KeyError, RuntimeError) as e:
                steps.append((type(e).__name__, str(e)))
        conv.add_turn(empty["id"], "A", "x")
        try:
            conv.render(empty["id"])
        except RuntimeError as e:
            steps.append(str(e))
        steps.append(conv.delete(empty["id"]))
        out.append(steps)
    assert out[1] == out[0]
    assert out[0][0] == ("ValueError", "Conversation has no turns") and out[0][-2] == "No synthesis function configured"


# ── _synthesize_array on tiny Kokoro and Piper ──────────────────────────


@pytest.fixture(scope="module")
def kokoro_pair():
    from open_speech_tpu_torch.models.kokoro.convert import kokoro_from_jax_tree
    from tests.torch_tts_common import CFG, TCFG, inject_har, injected_har, jax_tree

    tree = jax_tree(CFG)
    jtree = jax.tree_util.tree_map(jax.numpy.asarray, tree)
    model = kokoro_from_jax_tree(tree, device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        inject_har(mp, injected_har(jtree))
        yield jtree, model, CFG, TCFG


def _routers(monkeypatch):
    from open_speech_tpu.server import app as JAPP
    from open_speech_tpu.tts.router import TTSRouter as JRouter
    from open_speech_tpu_torch.tts.router import TTSRouter

    jr = JRouter(device="cpu")
    monkeypatch.setattr(JAPP, "tts_router", jr)
    for s in (jax_settings,):
        monkeypatch.setattr(s, "os_tts_batcher_enabled", False)
    from open_speech_tpu_torch.config import settings as torch_settings

    monkeypatch.setattr(torch_settings, "os_tts_batcher_enabled", False)
    return JAPP, jr, TTSRouter(device="cpu")


def test_synthesize_array_kokoro_matches_jax(kokoro_pair, monkeypatch, tmp_path):
    from open_speech_tpu_torch.server import app as TAPP
    from tests.torch_tts_common import TEXT, TOL_AUDIO, voice_packs

    jtree, model, cfg, tcfg = kokoro_pair
    monkeypatch.setenv("OS_KOKORO_VOICES_DIR", voice_packs(tmp_path))
    JAPP, jr, tr = _routers(monkeypatch)
    jb, tb = jr.get_backend("kokoro"), tr.get_backend("kokoro")
    jb._params, jb._cfg = jtree, cfg
    tb._model, tb._cfg = model, tcfg
    kw = dict(text=TEXT, model="kokoro", voice="af_bella", speed=1.1, sample_rate=24000)
    want = JAPP._synthesize_array(**kw)
    got = TAPP._synthesize_array(tr, **kw)
    assert got.dtype == np.float32 and got.shape == want.shape and got.size > 0
    np.testing.assert_allclose(got, want, atol=TOL_AUDIO, rtol=0)


@pytest.fixture
def piper_voice(tmp_path, monkeypatch):
    """``tests/test_torch_piper.py``'s oracle as a 22.05 kHz voice for both
    packages, JAX's row noise injected into the port."""
    from open_speech_tpu.models.onnx_io import write_onnx_initializers
    from open_speech_tpu_torch.runtime import tts_batcher as TB
    from tests.test_torch_piper import _jax_row_noise
    from tests.test_piper_convert import SynthesizerT

    torch.manual_seed(3)
    oracle = SynthesizerT().eval()
    write_onnx_initializers(oracle.state_dict_numpy(), tmp_path / "en_US-lessac-medium.onnx")
    (tmp_path / "en_US-lessac-medium.onnx.json").write_text(json.dumps({
        "audio": {"sample_rate": 22050}, "inference": {"noise_scale": 0.5, "noise_w": 0.6, "length_scale": 1.0},
        "num_symbols": 40, "num_speakers": 3}))
    monkeypatch.setenv("OS_PIPER_VOICES_DIR", str(tmp_path))
    monkeypatch.setattr(TB, "_row_noise", _jax_row_noise)


def test_synthesize_array_piper_resampled_matches_jax(piper_voice, monkeypatch):
    from open_speech_tpu_torch.server import app as TAPP

    JAPP, jr, tr = _routers(monkeypatch)
    voice = "piper/en_US-lessac-medium"
    kw = dict(text="Hello there. Call me back later.", model=voice, voice=voice, speed=1.0, sample_rate=24000)
    want = JAPP._synthesize_array(**kw)
    got = TAPP._synthesize_array(tr, **kw)
    assert tr.get_backend(voice).get_sample_rate(voice) == 22050
    assert got.dtype == np.float32 and got.shape == want.shape and got.size > 0
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
