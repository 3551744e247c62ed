"""The port's diarizer against the JAX package's, on the CPU.

``open_speech_tpu_torch/models/diarize.py`` and ``diarization.py`` against
``open_speech_tpu/models/diarize.py`` and ``open_speech_tpu/diarization.py``:

- the host functions (clustering, the speaker cap, the Hungarian
  assignment, DER, the overlap-add stitching) are numpy copies, held
  exactly equal on seeded inputs;
- the conv embedder (``embed_windows``) on JAX's ``PRNGKey(23)`` tree,
  carried over with ``diarizer_params_from_jax``, within relative L2 1e-5;
- whole diarizations: turns equal to JAX's on the well-separated synthetic
  speakers of ``tests/test_diarize.py`` (harmonic stacks at 220, 340 and
  520 Hz; their clusters sit far from the threshold), on the energy-gated
  path with JAX's params injected, on the GE2E path from one checkpoint,
  on the segmented path from the two committed fixtures (the least powerset
  margin is checked), and on the segmented path with ground-truth local
  activity injected into both packages' segmentation call;
- the service: the ``STT_DIARIZE_ENABLED`` gate, an 8 kHz upload through
  each package's resampler, ``attach_text_to_speakers``, and the device
  rule (CUDA asked for and absent raises).

No checkpoint leaks in from the host: each test clears the three
checkpoint variables and points ``HF_HOME`` and ``HOME`` at an empty
directory. Every JAX diarizer runs its jitted programs as the JAX package's
own tests run them.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
from open_speech_tpu import diarization as JDS
from open_speech_tpu.models import diarize as JD
from open_speech_tpu.models import segmentation as JS
from open_speech_tpu.ops import audio as JA
from open_speech_tpu_torch import diarization as TDS
from open_speech_tpu_torch.config import settings as torch_settings
from open_speech_tpu_torch.models import diarize as TD
from open_speech_tpu_torch.models import segmentation as TS
from tests.test_diarize import _speaker_audio

FIXTURES = "tests/fixtures/diarize/"
TOL_EMBED = 1e-5  # relative L2 of embeddings
CKPT_VARS = ("OS_SEGMENTATION_CKPT_PATH", "OS_WESPEAKER_CKPT_PATH", "OS_DIARIZER_CKPT_PATH")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module: the suite runs six workers on
    the host's cores, and with a full pool per worker the LSTMs' small CPU
    ops wait on each other's spinning threads (a 1 s test took minutes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def no_checkpoints(monkeypatch, tmp_path):
    for var in CKPT_VARS:
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("HF_HOME", str(tmp_path))
    monkeypatch.setenv("HOME", str(tmp_path))


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def three_speakers() -> tuple[np.ndarray, list[dict]]:
    """25 s: A, B, A and B at once, C, A; the reference turns."""
    audio = np.concatenate([
        _speaker_audio(220, 6, 1), _speaker_audio(520, 6, 2),
        _speaker_audio(220, 3, 7) + _speaker_audio(520, 3, 8),
        _speaker_audio(340, 6, 5), _speaker_audio(220, 4, 9),
    ])
    ref = [{"speaker": "A", "start": 0.0, "end": 6.0}, {"speaker": "B", "start": 6.0, "end": 15.0},
           {"speaker": "A", "start": 12.0, "end": 15.0}, {"speaker": "C", "start": 15.0, "end": 21.0},
           {"speaker": "A", "start": 21.0, "end": 25.0}]
    return audio, ref


def _pair(threshold: float = 0.2):
    """A JAX diarizer and the port's on the CPU with JAX's conv-embedder
    weights (checkpoints as the environment finds them)."""
    jd = JD.JaxDiarizer(threshold=threshold)
    params = TD.diarizer_params_from_jax(_numpy(jd.params), jd.cfg, device="cpu")
    return jd, TD.TorchDiarizer(params=params, threshold=threshold, device="cpu")


# ── host functions: exactly equal ───────────────────────────────────────


@pytest.mark.parametrize("seed", range(4))
def test_agglomerate_and_cap_equal_jax(seed):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((3 + seed, 32))
    emb = np.concatenate([c + 0.4 * rng.standard_normal((5 + 3 * seed, 32)) for c in centers])
    emb = emb[rng.permutation(len(emb))]
    for raw in (emb, emb[:2], emb[:9]):
        assert np.array_equal(TD._center_normalize(raw), JD._center_normalize(raw))
        centered = JD._center_normalize(raw)
        for threshold in (0.2, 0.35, 0.6):
            labels = JD._agglomerate(centered, threshold)
            assert np.array_equal(TD._agglomerate(centered, threshold), labels)
            for cap in (1, 2, 8):
                assert np.array_equal(TD._cap_speakers(labels, centered, cap),
                                      JD._cap_speakers(labels, centered, cap))


@pytest.mark.parametrize("shape", [(1, 1), (3, 5), (6, 4), (7, 7)])
def test_assignment_max_equals_jax(shape):
    score = np.random.default_rng(sum(shape)).integers(0, 50, shape)
    assert TD._assignment_max(score) == JD._assignment_max(score)


def _random_turns(rng, n: int, names: str) -> list[dict]:
    out = []
    for _ in range(n):
        start = float(np.round(rng.uniform(0, 20), 2))
        out.append({"speaker": str(rng.choice(list(names))), "start": start,
                    "end": float(np.round(start + rng.uniform(0.1, 5), 2))})
    return out


@pytest.mark.parametrize("seed", range(3))
def test_der_equals_jax(seed):
    rng = np.random.default_rng(seed)
    ref, hyp = _random_turns(rng, 6, "AB C"), _random_turns(rng, 7, "XYZW")
    for r, h in ((ref, hyp), (ref, ref), (ref, []), ([], hyp), ([], [])):
        assert TD.diarization_error_rate(r, h) == JD.diarization_error_rate(r, h)


@pytest.mark.parametrize("seed", range(3))
def test_turns_from_local_activity_equal_jax(seed):
    rng = np.random.default_rng(seed)
    frame_step, t_chunk = 270, 589
    n_samples = 160000 + 80000 * (1 + seed) + 1234
    starts = list(range(0, n_samples - 160000 + 1, 80000)) + [n_samples - 160000]
    active = (rng.uniform(size=(len(starts), t_chunk, 3)) < 0.5).astype(np.float32)
    active = np.repeat(active[:, ::20], 20, axis=1)[:, :t_chunk]  # runs of 20 frames
    keys = [(ci, s) for ci in range(len(starts)) for s in range(3) if rng.uniform() < 0.7]
    labels = rng.integers(0, 3, len(keys))
    labels = np.unique(labels, return_inverse=True)[1]
    want = JD.turns_from_local_activity(starts, active, keys, labels, n_samples, frame_step)
    assert want
    assert TD.turns_from_local_activity(starts, active, keys, labels, n_samples, frame_step) == want
    assert TD.turns_from_local_activity(starts, active, [], labels[:0], n_samples, frame_step) == []


def test_attach_text_to_speakers_equals_jax():
    segs = [{"speaker": "SPEAKER_00", "start": 0.0, "end": 2.0},
            {"speaker": "SPEAKER_01", "start": 2.0, "end": 7.5},
            {"speaker": "SPEAKER_00", "start": 7.5, "end": 8.0}]
    for text in ("", "one", "one two three four five six seven", " ".join(["w"] * 23)):
        for s in (segs, segs[:1], []):
            assert TDS.attach_text_to_speakers(text, s) == JDS.attach_text_to_speakers(text, s)


# ── the conv embedder ───────────────────────────────────────────────────


def test_embed_windows_matches_jax():
    cfg = JD.DiarizerConfig()
    tree = JD.init_diarizer_params()
    mels = np.random.default_rng(0).uniform(-1, 1, (5, cfg.n_mels, 150)).astype(np.float32)
    want = np.asarray(JD.embed_windows(tree, cfg, mels))
    model = TD.diarizer_params_from_jax(_numpy(tree), cfg, device="cpu")
    got = TD.embed_windows(model, torch.from_numpy(mels)).numpy()
    assert got.shape == want.shape == (5, cfg.embed_dim + 2 * cfg.n_mels)
    assert _rel_l2(got, want) < TOL_EMBED
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)


def test_random_conv_embedder_is_seeded():
    a, b = TD.init_diarizer_params(device="cpu"), TD.init_diarizer_params(device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(), b.state_dict().values()))
    assert a.conv1.weight.shape == (128, 80, 5) and a.proj.weight.shape == (64, 256)


# ── whole diarizations ──────────────────────────────────────────────────


@pytest.mark.parametrize("case", ["two-speakers", "three-speakers", "silence", "short"])
def test_energy_gated_turns_equal_jax(case):
    audio = {
        "two-speakers": lambda: np.concatenate([_speaker_audio(220, 4, 1), _speaker_audio(520, 4, 2),
                                                _speaker_audio(220, 3, 3)]),
        "three-speakers": lambda: three_speakers()[0],
        "silence": lambda: np.zeros(16000 * 3, np.float32),
        "short": lambda: _speaker_audio(300, 0.5, 4),
    }[case]()
    jd, td = _pair()
    assert td.seg is None and td.wespeaker is None and td.ge2e is None
    want = jd.diarize_audio(audio)
    assert td.diarize_audio(audio) == want
    if case == "three-speakers":
        assert len({t["speaker"] for t in want}) == 3


def test_energy_gated_embeddings_match_jax():
    """The voiced windows' embeddings that the turns above are cut from."""
    audio, _ = three_speakers()
    jd, td = _pair()
    win, hop = int(JD.WINDOW_S * 16000), int(JD.HOP_S * 16000)
    windows = np.stack([audio[s : s + win] for s in range(0, len(audio) - win + 1, hop)])
    want = jd._embed_bucketed(windows)
    got = td._embed_bucketed(windows)
    assert got.shape == want.shape
    assert _rel_l2(got, want) < TOL_EMBED


def test_ge2e_checkpoint_path_equals_jax(monkeypatch, tmp_path):
    """One resemblyzer-layout checkpoint found through OS_DIARIZER_CKPT_PATH
    by both packages (no WeSpeaker: GE2E is next in line)."""
    from tests.test_ge2e import TorchVoiceEncoder

    torch.manual_seed(3)
    path = tmp_path / "pretrained.pt"
    torch.save({"model_state": TorchVoiceEncoder().state_dict()}, path)
    monkeypatch.setenv("OS_DIARIZER_CKPT_PATH", str(path))
    audio = np.concatenate([_speaker_audio(220, 4, 1), _speaker_audio(520, 4, 2)])
    jd, td = _pair()
    assert td.ge2e is not None and td.wespeaker is None and td.seg is None
    assert td.ge2e[0].lstm.weight_ih_l0.device.type == "cpu"
    win = int(JD.WINDOW_S * 16000)
    windows = np.stack([audio[s : s + win] for s in range(0, len(audio) - win + 1, 12000)])
    assert _rel_l2(td._embed(windows), jd._embed(windows)) < TOL_EMBED
    assert td.diarize_audio(audio) == jd.diarize_audio(audio)


def test_a_checkpoint_that_fails_to_convert_falls_to_the_next(monkeypatch, tmp_path, caplog):
    bad = tmp_path / "broken.bin"
    bad.write_bytes(b"not a checkpoint")
    for var in ("OS_SEGMENTATION_CKPT_PATH", "OS_WESPEAKER_CKPT_PATH"):
        monkeypatch.setenv(var, str(bad))
    jd, td = _pair()
    assert (jd.seg, jd.wespeaker) == (None, None) and (td.seg, td.wespeaker, td.ge2e) == (None, None, None)
    assert "failed to convert" in caplog.text
    audio = np.concatenate([_speaker_audio(220, 3, 1), _speaker_audio(520, 3, 2)])
    assert td.diarize_audio(audio) == jd.diarize_audio(audio)


def _least_margin(jd, audio: np.ndarray) -> float:
    """The least top-1 minus top-2 powerset log-prob over the chunks the
    segmented path runs (JAX's)."""
    params, cfg = jd.seg
    n, chunk = len(audio), JS.CHUNK_SAMPLES
    starts = list(range(0, max(1, n - chunk + 1), chunk // 2))
    if starts[-1] + chunk < n:
        starts.append(n - chunk)
    chunks = np.stack([np.pad(audio[s : s + chunk], (0, max(0, s + chunk - n))) for s in starts])
    top = np.sort(np.asarray(JS.segment_chunks(params, chunks, cfg)), axis=-1)
    return float((top[..., -1] - top[..., -2]).min())


def test_segmented_fixture_turns_equal_jax(monkeypatch):
    """The committed PyanNet and WeSpeaker fixtures through both packages'
    discovery -> converter -> segmented path."""
    monkeypatch.setenv("OS_SEGMENTATION_CKPT_PATH", FIXTURES + "segmentation.bin")
    monkeypatch.setenv("OS_WESPEAKER_CKPT_PATH", FIXTURES + "wespeaker.bin")
    audio, _ = three_speakers()
    jd, td = _pair()
    assert td.seg is not None and td.wespeaker is not None
    assert td.seg[1].lstm_layers == 1 and td.seg[1].conv_hidden == 12
    assert td.wespeaker[1].m_channels == 4 and td.wespeaker[1].embed_dim == 32
    margin = _least_margin(jd, audio)
    assert margin > 1e-3, f"a powerset near-tie ({margin}) would make the turns rounding's choice"
    want = jd.diarize_audio(audio)
    assert want and td.diarize_audio(audio) == want


def _oracle_segment(ref, frame_step: int, n_classes: int, audio: np.ndarray):
    """A segmentation call that answers the reference turns' activity
    (speaker A local slot 0, B 1, C 2) for chunks it finds in ``audio``."""
    classes = JS.powerset_classes(3, 2)
    cls_of = {frozenset(s): i for i, s in enumerate(classes)}
    slot = {"A": 0, "B": 1, "C": 2}
    chunk = JS.CHUNK_SAMPLES
    grid = {audio[s : s + 1000].tobytes(): s for s in range(0, len(audio) - 999, 80000)}
    grid[audio[len(audio) - chunk : len(audio) - chunk + 1000].tobytes()] = len(audio) - chunk

    def logp(chunks) -> np.ndarray:
        chunks = np.asarray(chunks, np.float32)
        t = chunk // frame_step
        out = np.full((len(chunks), t, n_classes), -20.0, np.float32)
        for ci in range(len(chunks)):
            s0 = grid.get(chunks[ci, :1000].tobytes())
            if s0 is None:  # JAX's zero-fill rows
                continue
            for f in range(t):
                mid = (s0 + f * frame_step + frame_step // 2) / 16000
                local = frozenset(slot[r["speaker"]] for r in ref if r["start"] <= mid < r["end"])
                out[ci, f, cls_of[local]] = 0.0
        return out

    return logp


def test_segmented_turns_with_injected_activity_equal_jax(monkeypatch):
    """Ground-truth local activity (with the overlap) injected into both
    packages' segmentation call, WeSpeaker from the fixture: the embedding,
    clustering and overlap-aware stitching give JAX's turns."""
    monkeypatch.setenv("OS_SEGMENTATION_CKPT_PATH", FIXTURES + "segmentation.bin")
    monkeypatch.setenv("OS_WESPEAKER_CKPT_PATH", FIXTURES + "wespeaker.bin")
    audio, ref = three_speakers()
    jd, td = _pair()
    cfg = td.seg[1]
    logp = _oracle_segment(ref, cfg.sinc_stride * 27, cfg.n_classes, audio)
    monkeypatch.setattr(JS, "segment_chunks", lambda params, chunks, scfg: logp(chunks))
    monkeypatch.setattr(TS, "segment_chunks", lambda model, chunks: torch.from_numpy(logp(chunks)))
    want = jd.diarize_audio(audio)
    got = td.diarize_audio(audio)
    assert got == want
    overlapping = [(a, b) for a in want for b in want
                   if a["speaker"] != b["speaker"] and a["start"] < b["end"] and b["start"] < a["end"]]
    assert overlapping, "the overlap stretch gives simultaneous turns"
    assert TD.diarization_error_rate(ref, got) < 0.25


# ── the service ─────────────────────────────────────────────────────────


def test_diarizer_gate_and_shared_instance(monkeypatch):
    monkeypatch.setattr(torch_settings, "stt_diarize_enabled", False)
    with pytest.raises(RuntimeError, match="Diarization is disabled. Set STT_DIARIZE_ENABLED=true"):
        TDS.Diarizer()
    monkeypatch.setattr(torch_settings, "stt_diarize_enabled", True)
    monkeypatch.setattr(torch_settings, "stt_device", "cpu")
    monkeypatch.setattr(TDS, "_shared", None)
    first = TDS.Diarizer()
    assert TDS.Diarizer()._model is first._model is TDS._shared
    assert first._model.device.type == "cpu"
    assert first.diarize(JA.write_wav(np.zeros(0, np.float32), 16000)) == []


@pytest.mark.parametrize("rate", [8000, 16000, 22050])
def test_uploads_at_other_rates_equal_jax(monkeypatch, rate):
    """A WAV at ``rate`` through each package's ``Diarizer.diarize``: the
    resampler of each package, then the same turns."""
    from open_speech_tpu.config import settings as jax_settings

    jd, td = _pair()
    for s in (jax_settings, torch_settings):
        monkeypatch.setattr(s, "stt_diarize_enabled", True)
    monkeypatch.setattr(JDS, "_shared", jd)
    monkeypatch.setattr(TDS, "_shared", td)
    audio = np.concatenate([_speaker_audio(220, 4, 1), _speaker_audio(520, 4, 2)])
    audio = audio[np.round(np.arange(0, len(audio), 16000 / rate)).astype(int)]  # ~rate Hz
    wav = JA.write_wav(audio, rate)
    want = JDS.Diarizer().diarize(wav)
    assert len({t["speaker"] for t in want}) == 2
    assert TDS.Diarizer().diarize(wav) == want


def test_cuda_asked_for_without_cuda_raises(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the check is for hosts without it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TD.TorchDiarizer(device="cuda")
    monkeypatch.setattr(torch_settings, "stt_device", "cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TD.TorchDiarizer()  # the default device is the card
    assert TD.TorchDiarizer(device="cpu").params.proj.weight.device.type == "cpu"
