"""The one traffic generator: a traffic file's parameters and a seed in, the
window's requests and their audio out.

Every seed gets the same set of sizes and gaps in another order, so that two
seeds ask the same work of the program:

A run sends ``preroll_s`` of its traffic before the window opens, so that
the window sees the program in its steady state.

- ``"loop": "open"``: independent devices. ``ceil(rate x (preroll + seconds))`` requests
  whose gaps are the evenly spaced quantiles of the exponential distribution
  at ``rate_per_s`` (a Poisson process's gaps), in the seed's order; each is
  due at the sum of the gaps before it, from the start of sending.
- ``"loop": "closed"``: ``sessions`` callers that each send their next
  utterance when the last one's transcript returns, after ``think_s``. Their
  starts are spread evenly over ``start_spread_s`` in the seed's order, and
  round k of every session draws its length from the same evenly spaced
  quantiles, dealt out in the seed's order. With ``random_phase``, each
  session's first utterance is cut to a share of its length (evenly spaced
  shares in the seed's order), as if the session had been running: sessions
  that start together then finish at scattered times, and the pre-roll
  needs to cover only the first admissions, not a spread of starts.

Lengths are the evenly spaced quantiles of ``audio_s``'s uniform range. The
audio is cut from a few clips of speech-like sound made from the seed:
voiced harmonics on a gliding pitch under a syllable-rate envelope, over
low noise.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

SAMPLE_RATE = 16_000
CLIP_S = 30
N_CLIPS = 4


@dataclass
class Request:
    index: int
    n_samples: int
    clip: int
    offset: int
    session: int | None = None
    due: float | None = None  # seconds after sending starts (open loop)
    due_at: float | None = None  # host clock (perf_counter) of ``due``
    sent: float | None = None  # host clock (perf_counter)
    done: float | None = None
    served: list[int] | None = None
    error: str | None = None

    @property
    def audio_s(self) -> float:
        return self.n_samples / SAMPLE_RATE


@dataclass
class Plan:
    loop: str
    preroll_s: float  # the window opens this long after sending starts
    requests: list[Request]  # the open loop's, in order of due time
    sessions: list[list[Request]] = field(default_factory=list)  # the closed loop's
    starts: list[float] = field(default_factory=list)

    def all_requests(self) -> list[Request]:
        return self.requests + [r for s in self.sessions for r in s]


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([seed, stream])


def _lengths(traffic: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    lo, hi = traffic["audio_s"]["uniform"]
    q = (np.arange(n) + 0.5) / n
    return rng.permutation(np.round((lo + (hi - lo) * q) * SAMPLE_RATE).astype(np.int64))


def _place(n_samples: int, rng: np.random.Generator) -> tuple[int, int]:
    """(clip, offset) of a request's audio inside the clips."""
    clip = int(rng.integers(N_CLIPS))
    room = CLIP_S * SAMPLE_RATE - n_samples
    return clip, int(rng.integers(room + 1)) if room > 0 else 0


def plan(traffic: dict, seed: int, seconds: float) -> Plan:
    """The requests of a run: ``preroll_s`` of the same traffic to bring the
    program to its steady state, then the window's ``seconds``."""
    place = _rng(seed, 3)
    preroll = float(traffic.get("preroll_s", 0.0))
    if traffic["loop"] == "open":
        rate = float(traffic["rate_per_s"])
        n = math.ceil(rate * (preroll + seconds))
        q = (np.arange(n) + 0.5) / n
        gaps = _rng(seed, 1).permutation(-np.log1p(-q) / rate)
        due = np.cumsum(gaps) - gaps[0]  # the first request starts the sending
        lengths = _lengths(traffic, n, _rng(seed, 2))
        reqs = [Request(i, int(lengths[i]), *_place(int(lengths[i]), place), due=float(due[i]))
                for i in range(n) if due[i] < preroll + seconds]
        return Plan("open", preroll, reqs)
    if traffic["loop"] == "closed":
        sessions = int(traffic["sessions"])
        rounds = int(traffic["rounds"])
        order = _rng(seed, 1)
        starts = order.permutation((np.arange(sessions) + 0.5) / sessions) * traffic["start_spread_s"]
        starts -= starts.min()
        per_round = [_lengths(traffic, sessions, _rng(seed, 100 + k)) for k in range(rounds)]
        if traffic.get("random_phase", False):
            share = _rng(seed, 6).permutation((np.arange(sessions) + 0.5) / sessions)
            per_round[0] = np.maximum(1, np.round(per_round[0] * share)).astype(np.int64)
        out, index = [], 0
        for s in range(sessions):
            mine = []
            for k in range(rounds):
                n_samples = int(per_round[k][s])
                mine.append(Request(index, n_samples, *_place(n_samples, place), session=s))
                index += 1
            out.append(mine)
        return Plan("closed", preroll, [], out, [float(t) for t in starts])
    raise ValueError(f"traffic loop {traffic['loop']!r}: 'open' or 'closed'")


def clips(seed: int) -> np.ndarray:
    """[N_CLIPS, CLIP_S x 16 kHz] float32 speech-like audio in [-1, 1]."""
    rng = _rng(seed, 4)
    n = CLIP_S * SAMPLE_RATE
    t = np.arange(n) / SAMPLE_RATE
    out = np.empty((N_CLIPS, n), np.float32)
    for c in range(N_CLIPS):
        f0 = rng.uniform(90, 260) * (1 + 0.15 * np.sin(2 * np.pi * rng.uniform(0.1, 0.5) * t))
        phase = 2 * np.pi * np.cumsum(f0) / SAMPLE_RATE
        voiced = sum(np.sin(k * phase) / k for k in range(1, 7))
        syllables = np.clip(np.sin(2 * np.pi * rng.uniform(3, 5) * t + rng.uniform(0, 6)), 0, None)
        sig = 0.2 * voiced * syllables + 0.01 * rng.standard_normal(n)
        out[c] = (sig / np.abs(sig).max() * 0.5).astype(np.float32)
    return out


def audio(pool: np.ndarray, req: Request) -> np.ndarray:
    return pool[req.clip, req.offset: req.offset + req.n_samples]
