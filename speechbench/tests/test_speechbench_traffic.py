"""The traffic generator: the same seed gives the same window, and every seed
the same sizes and gaps in another order."""

from __future__ import annotations

import numpy as np
import pytest

from speechbench import traffic

OPEN = {"loop": "open", "rate_per_s": 40.0, "audio_s": {"uniform": [1.5, 6.0]}}
CLOSED = {"loop": "closed", "sessions": 64, "rounds": 6, "start_spread_s": 1.0,
          "audio_s": {"uniform": [5.0, 30.0]}}
SEEDS = (1, 2**31 + 5, 2**33 + 17)


def _open(seed):
    return traffic.plan(OPEN, seed, 30.0).requests


def test_open_loop_same_seed_same_window():
    a, b = _open(SEEDS[1]), _open(SEEDS[1])
    assert [(r.due, r.n_samples, r.clip, r.offset) for r in a] == \
        [(r.due, r.n_samples, r.clip, r.offset) for r in b]


@pytest.mark.parametrize("seed", SEEDS)
def test_open_loop_shape(seed):
    reqs = _open(seed)
    due = [r.due for r in reqs]
    assert due[0] == 0.0 and due == sorted(due) and due[-1] < 30.0
    assert 0.9 * 40 * 30 <= len(reqs) <= 40 * 30
    lengths = np.array([r.audio_s for r in reqs])
    assert lengths.min() >= 1.5 and lengths.max() <= 6.0
    assert np.mean(np.diff(due)) == pytest.approx(1 / 40, rel=0.05)
    for r in reqs:
        assert 0 <= r.offset and r.offset + r.n_samples <= traffic.CLIP_S * traffic.SAMPLE_RATE


def test_open_loop_seeds_share_sizes_and_gaps_in_another_order():
    n = int(np.ceil(40 * 30))
    gaps, lengths, orders = [], [], []
    for seed in SEEDS:
        full = traffic.plan(OPEN, seed, 30.0)  # the gaps sum to under 30 s: all are due
        assert len(full.requests) == n
        due = np.array([r.due for r in full.requests])
        gaps.append(np.sort(np.diff(due)))
        lengths.append(sorted(r.n_samples for r in full.requests))
        orders.append([r.n_samples for r in full.requests])
    for g, l in zip(gaps[1:], lengths[1:]):
        # one gap opens the window: the rest are the same quantiles
        assert len(set(np.round(g, 12)) - set(np.round(gaps[0], 12))) <= 1
        assert l == lengths[0]
    assert orders[0] != orders[1]


def test_closed_loop_rounds_share_sizes():
    plans = [traffic.plan(CLOSED, seed, 30.0) for seed in SEEDS]
    for p in plans:
        assert len(p.sessions) == 64 and all(len(s) == 6 for s in p.sessions)
        assert min(p.starts) == 0.0 and max(p.starts) < 1.0
        assert len({r.index for s in p.sessions for r in s}) == 64 * 6
    for k in range(6):
        rounds = [sorted(s[k].n_samples for s in p.sessions) for p in plans]
        assert rounds[0] == rounds[1] == rounds[2]
    assert [s[0].n_samples for s in plans[0].sessions] != [s[0].n_samples for s in plans[1].sessions]


def test_random_phase_cuts_each_first_utterance_to_a_share():
    phased = {**CLOSED, "random_phase": True}
    plans = [traffic.plan(phased, seed, 30.0) for seed in SEEDS]
    for seed, p in zip(SEEDS, plans):
        whole = traffic.plan(CLOSED, seed, 30.0)
        shares = sorted(a[0].n_samples / b[0].n_samples
                        for a, b in zip(p.sessions, whole.sessions))
        assert np.allclose(shares, (np.arange(64) + 0.5) / 64, atol=1e-4)
        for k in range(1, 6):  # later rounds are whole
            assert [s[k].n_samples for s in p.sessions] == [s[k].n_samples for s in whole.sessions]
    firsts = [sorted(s[0].n_samples for s in p.sessions) for p in plans]
    assert firsts[0] != firsts[1]  # the shares meet other lengths per seed
    assert sum(firsts[0]) == pytest.approx(sum(firsts[1]), rel=0.1)


def test_clips_are_seeded_speech_like_audio():
    a, b = traffic.clips(7), traffic.clips(7)
    assert a.dtype == np.float32 and a.shape == (traffic.N_CLIPS, traffic.CLIP_S * 16000)
    assert np.array_equal(a, b)
    assert not np.array_equal(a, traffic.clips(8))
    assert 0.3 < np.abs(a).max() <= 0.5 + 1e-6


def test_unknown_loop_is_refused():
    with pytest.raises(ValueError):
        traffic.plan({**OPEN, "loop": "bursty"}, 1, 1.0)


def test_preroll_comes_before_the_window():
    p = traffic.plan({**OPEN, "preroll_s": 3.0}, SEEDS[0], 30.0)
    assert p.preroll_s == 3.0 and len(p.requests) == int(np.ceil(40 * 33))
    assert max(r.due for r in p.requests) < 33.0
    c = traffic.plan({**CLOSED, "preroll_s": 20.0}, SEEDS[0], 30.0)
    assert c.preroll_s == 20.0 and len(c.all_requests()) == 64 * 6
