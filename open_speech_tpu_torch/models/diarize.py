"""Speaker diarization in PyTorch: embedders, clustering and turns.

Counterpart of ``open_speech_tpu/models/diarize.py``. Two pipelines, as in
the JAX package:

- **segmented** (pyannote-3.1's recipe), when a PyanNet segmentation
  checkpoint is found: per-frame local speaker activity over 10 s chunks
  (``models/segmentation.py``), one embedding per (chunk, local speaker)
  from WeSpeaker ResNet34 (``models/wespeaker.py``), else GE2E
  (``models/ge2e.py``), else the conv embedder below, then agglomerative
  clustering on the host and overlap-aware turns;
- **energy-gated**, without one: 1.5 s windows every 0.75 s, the voiced
  ones embedded, clustered and stitched into non-overlapping turns.

The conv embedder (``DiarizerModel``, ``embed_windows``) runs over
whisper-style log-mels: strided convolutions, statistics pooling and a
projection, concatenated with the raw per-band mel statistics. Random
weights come from a ``torch.Generator`` (seed 23 by default), so they
differ from the JAX package's ``PRNGKey(23)`` draws;
``diarizer_params_from_jax`` carries JAX's tree across.

The host functions (``_agglomerate``, ``_center_normalize``,
``_cap_speakers``, ``_assignment_max``, ``diarization_error_rate``,
``turns_from_local_activity``) are numpy copies of the JAX module's. The
window gathering and the clustering stay on the host; the models run on
the diarizer's device (``settings.stt_device``, the card, unless the
caller names one) inside ``ops/vocoder.py:inference()``: cuDNN in float32.

Eager torch compiles nothing per shape, so embedding dispatches pad to no
power-of-two bucket and segmentation batches of 8 chunks are not filled
up: rows are independent (BatchNorms are folded, no batch statistics).
The 512-row cap per embedding dispatch stays: it bounds memory
(WeSpeaker's first stage alone is 512 x 32 x 80 x 148 x 4 B = 0.78 GB).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from open_speech_tpu_torch.ops.mel import log_mel_spectrogram
from open_speech_tpu_torch.ops.vocoder import inference

WINDOW_S = 1.5
HOP_S = 0.75
SAMPLE_RATE = 16000
_MEL_FRAMES = int(WINDOW_S * 100)  # 150 mel frames per window
EMBED_ROWS = 512  # windows per embedding dispatch at most
SEG_BATCH = 8  # 10 s chunks per segmentation call at most


def diarizer_device(device=None) -> torch.device:
    """``device``, or ``settings.stt_device`` (the card) when None: where a
    diarizer's weights live. Raises when CUDA is asked for and absent."""
    if device is None:
        from open_speech_tpu_torch.config import settings

        device = settings.stt_device
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"diarizer device {str(dev)!r} asked for, but CUDA is not available; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


def build_model(cfg, module_cls, tensors: dict, device) -> nn.Module:
    """``module_cls(cfg)`` holding ``tensors`` ({state-dict name: numpy}) on
    ``device``; every tensor of the module must be given."""
    model = module_cls(cfg)
    model.load_state_dict({k: torch.tensor(np.asarray(v, np.float32)) for k, v in tensors.items()})
    model = model.to(device).eval().requires_grad_(False)  # inference only
    for mod in model.modules():
        if isinstance(mod, nn.LSTM):
            mod.flatten_parameters()  # one weight buffer for cuDNN
    return model


def lstm_tensors(prefix: str, layer: str, w_ih, w_hh, bias) -> dict:
    """One LSTM direction's state-dict entries: weights [4H, in] and [4H, H]
    (gates i, f, g, o), the direction's single bias in ``bias_ih`` and a
    zero ``bias_hh``."""
    bias = np.asarray(bias, np.float32)
    return {f"{prefix}.weight_ih_{layer}": w_ih, f"{prefix}.weight_hh_{layer}": w_hh,
            f"{prefix}.bias_ih_{layer}": bias, f"{prefix}.bias_hh_{layer}": np.zeros_like(bias)}


def l2_normalize(e: torch.Tensor) -> torch.Tensor:
    return e / torch.clamp(torch.linalg.vector_norm(e, dim=-1, keepdim=True), min=1e-8)


@dataclass(frozen=True)
class DiarizerConfig:
    n_mels: int = 80
    hidden: int = 128
    embed_dim: int = 64


class DiarizerModel(nn.Module):
    """The conv embedder: two stride-2 convolutions (k 5), one k 3, 'same'
    padding, then a projection of their statistics."""

    def __init__(self, cfg: DiarizerConfig) -> None:
        super().__init__()
        self.cfg = cfg
        self.conv1 = nn.Conv1d(cfg.n_mels, cfg.hidden, 5, stride=2, padding=2)
        self.conv2 = nn.Conv1d(cfg.hidden, cfg.hidden, 5, stride=2, padding=2)
        self.conv3 = nn.Conv1d(cfg.hidden, cfg.hidden, 3, padding=1)
        self.proj = nn.Linear(2 * cfg.hidden, cfg.embed_dim)

    def forward(self, mels: torch.Tensor) -> torch.Tensor:
        raw = torch.cat([mels.mean(dim=-1), mels.std(dim=-1, correction=0)], dim=-1)
        h = F.relu(self.conv1(mels))
        h = F.relu(self.conv2(h))
        h = F.relu(self.conv3(h))
        stats = torch.cat([h.mean(dim=-1), h.std(dim=-1, correction=0)], dim=-1)
        return l2_normalize(torch.cat([self.proj(stats), raw], dim=-1))


def init_diarizer_params(
    generator: torch.Generator | None = None, cfg: DiarizerConfig = DiarizerConfig(), device=None
) -> DiarizerModel:
    """Random conv-embedder weights in the JAX init's distributions (normal,
    scaled by fan-in; zero biases) from ``generator`` (seed 23 when None)."""
    gen = generator if generator is not None else torch.Generator().manual_seed(23)

    def normal(*shape, fan_in: int) -> np.ndarray:
        return (torch.randn(shape, generator=gen) * fan_in**-0.5).numpy()

    t = {}
    for name, width, c_in in (("conv1", 5, cfg.n_mels), ("conv2", 5, cfg.hidden), ("conv3", 3, cfg.hidden)):
        t[f"{name}.weight"] = normal(cfg.hidden, c_in, width, fan_in=width * c_in)
        t[f"{name}.bias"] = np.zeros(cfg.hidden, np.float32)
    t["proj.weight"] = normal(cfg.embed_dim, 2 * cfg.hidden, fan_in=2 * cfg.hidden)
    t["proj.bias"] = np.zeros(cfg.embed_dim, np.float32)
    return build_model(cfg, DiarizerModel, t, diarizer_device(device))


def diarizer_params_from_jax(tree: dict, cfg: DiarizerConfig = DiarizerConfig(), device=None) -> DiarizerModel:
    """The JAX conv embedder's tree (numpy arrays) as a ``DiarizerModel``:
    convolutions [K, C_in, C_out] -> [C_out, C_in, K], the projection
    transposed."""
    t = {}
    for name in ("conv1", "conv2", "conv3"):
        t[f"{name}.weight"] = np.asarray(tree[name]["w"]).transpose(2, 1, 0)
        t[f"{name}.bias"] = tree[name]["b"]
    t["proj.weight"], t["proj.bias"] = np.asarray(tree["proj"]["w"]).T, tree["proj"]["b"]
    return build_model(cfg, DiarizerModel, t, diarizer_device(device))


def embed_windows(model: DiarizerModel, mels: torch.Tensor) -> torch.Tensor:
    """mels [N, n_mels, 150] -> L2-normalized embeddings.

    Output = learned conv-stat projection ++ raw per-band mel statistics
    ([N, embed_dim + 2*n_mels]): the raw spectral signature keeps the
    embedding discriminative even before any training, trained weights
    sharpen it.
    """
    with inference():
        return model(mels.float())


def _agglomerate(
    embeddings: np.ndarray, threshold: float, s_floor: float = 0.15
) -> np.ndarray:
    """Average-linkage clustering: threshold cut + small-cluster absorption.

    The plain threshold cut leaves speaker-switch windows (which blend two
    voices and resemble each other across switches) as spurious
    mid-distance clusters. On utterance-centered embeddings the structure
    is visible per merge: within-speaker merges sit near 1, boundary-blend
    clusters are SMALL and join a bigger cluster at moderate positive
    similarity, and cross-speaker merges join two SUBSTANTIAL clusters at
    near-zero/negative similarity (centered d-vectors of distinct speakers
    point apart). So merging proceeds while sim >= 1-threshold as usual,
    and past that cut it continues ONLY for absorption merges — a small
    cluster joining a larger one at sim >= s_floor. The threshold keeps
    its meaning for speaker-vs-speaker decisions; the floor only governs
    boundary-blend cleanup. Stops online (no full merge trace).
    Ref bar: pyannote's clustering (the reference's pyannote-3.1 diarizer).
    """
    n = len(embeddings)
    if n == 1:
        return np.zeros(1, np.int32)
    stop = 1.0 - threshold
    small = max(2, int(0.2 * n))
    emb = np.asarray(embeddings, np.float64)
    members: list[list[int]] = [[i] for i in range(n)]
    sizes = np.ones(n, np.int64)
    alive = np.ones(n, bool)
    norm = lambda c: c / (np.linalg.norm(c) + 1e-9)  # noqa: E731
    cn = np.stack([norm(emb[i]) for i in range(n)])
    # cached pairwise centroid similarity, refreshed only for merged rows:
    # vectorized O(n²) per merge instead of Python-loop O(n²) dots per merge
    sim = cn @ cn.T
    np.fill_diagonal(sim, -2.0)
    while alive.sum() > 1:
        # best pair among ELIGIBLE merges (not the global best pair:
        # two large near-stop clusters must not mask a qualifying
        # small-cluster absorption elsewhere)
        pair_small = np.minimum(sizes[:, None], sizes[None, :]) <= small
        elig = (sim >= stop) | (pair_small & (sim >= s_floor))
        elig &= alive[:, None] & alive[None, :]
        if not elig.any():
            break
        masked = np.where(elig, sim, -2.0)
        bi, bj = np.unravel_index(int(np.argmax(masked)), masked.shape)
        members[bi].extend(members[bj])
        sizes[bi] += sizes[bj]
        alive[bj] = False
        cn[bi] = norm(emb[members[bi]].mean(axis=0))
        row = cn @ cn[bi]
        sim[bi, :] = row
        sim[:, bi] = row
        sim[bi, bi] = -2.0
        sim[bj, :] = -2.0
        sim[:, bj] = -2.0
    labels = np.zeros(n, np.int32)
    for idx, ci in enumerate(np.where(alive)[0]):
        labels[np.asarray(members[ci])] = idx
    return labels


def _center_normalize(emb: np.ndarray) -> np.ndarray:
    """Clustering preprocessing: mean-center (so between-speaker variation
    dominates) then L2-normalize — but center only with enough rows. With
    K=2 embeddings, centering makes them exactly antipodal (cosine −1), so
    single-speaker audio would deterministically split into two speakers;
    small K in general drives same-speaker cosines negative (centered rows
    sum to zero)."""
    if len(emb) >= 8:
        emb = emb - emb.mean(axis=0, keepdims=True)
    return emb / np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-8)


def _cap_speakers(
    labels: np.ndarray, emb: np.ndarray, max_speakers: int
) -> np.ndarray:
    """Cap cluster count: rows of clusters beyond the ``max_speakers``
    largest reassign to the nearest surviving centroid."""
    uniq, counts = np.unique(labels, return_counts=True)
    if len(uniq) <= max_speakers:
        return labels
    big = uniq[np.argsort(-counts)][:max_speakers]
    cents = np.stack([emb[labels == u].mean(axis=0) for u in big])
    cents /= np.maximum(np.linalg.norm(cents, axis=1, keepdims=True), 1e-8)
    return big[np.argmax(emb @ cents.T, axis=1)]


def _assignment_max(score: np.ndarray) -> int:
    """Exact max-sum 1:1 assignment (Hungarian, O(n³)) — scipy-free
    fallback so diarization_error_rate works in production installs
    (scipy is a dev-only extra)."""
    r, c = score.shape
    n = max(r, c)
    cost = np.zeros((n, n))
    cost[:r, :c] = -score  # minimize
    INF = float("inf")
    u = [0.0] * (n + 1)
    v = [0.0] * (n + 1)
    p = [0] * (n + 1)
    way = [0] * (n + 1)
    for i in range(1, n + 1):
        p[0] = i
        j0 = 0
        minv = [INF] * (n + 1)
        used = [False] * (n + 1)
        while True:
            used[j0] = True
            i0, delta, j1 = p[j0], INF, 0
            for j in range(1, n + 1):
                if used[j]:
                    continue
                cur = cost[i0 - 1][j - 1] - u[i0] - v[j]
                if cur < minv[j]:
                    minv[j] = cur
                    way[j] = j0
                if minv[j] < delta:
                    delta = minv[j]
                    j1 = j
            for j in range(n + 1):
                if used[j]:
                    u[p[j]] += delta
                    v[j] -= delta
                else:
                    minv[j] -= delta
            j0 = j1
            if p[j0] == 0:
                break
        while j0:
            j1 = way[j0]
            p[j0] = p[j1]
            j0 = j1
    total = 0
    for j in range(1, n + 1):
        if p[j] and p[j] - 1 < r and j - 1 < c:
            total += int(score[p[j] - 1, j - 1])
    return total


def diarization_error_rate(
    ref: list[dict], hyp: list[dict], step_s: float = 0.01
) -> float:
    """Frame-based DER with optimal speaker mapping, overlap-aware.

    ref/hyp: [{speaker, start, end}] turns; turns of different speakers
    MAY overlap (simultaneous speech — the segmented pipeline emits such
    turns). Per frame with Nref/Nhyp active speakers and Ncorrect matched
    under the best global label mapping (NIST md-eval accounting):
    miss = max(0, Nref-Nhyp), fa = max(0, Nhyp-Nref), confusion =
    min(Nref, Nhyp) - Ncorrect; DER = sum / total ref speaker-time — the
    metric pyannote (the reference's quality bar) is evaluated with.
    """
    if not ref:
        return 0.0 if not hyp else float("inf")
    end = max(t["end"] for t in ref + hyp)
    n = int(round(end / step_s)) + 1

    def activity_of(turns):
        names = sorted({t["speaker"] for t in turns})
        idx = {s: i for i, s in enumerate(names)}
        act = np.zeros((n, max(len(names), 1)), bool)
        for t in turns:
            a = int(round(t["start"] / step_s))
            b = int(round(t["end"] / step_s))
            act[a:b, idx[t["speaker"]]] = True
        return act, len(names)

    r, nr = activity_of(ref)
    h, nh = activity_of(hyp)
    n_ref = r.sum(axis=1)
    n_hyp = h.sum(axis=1)
    ref_speech = int(n_ref.sum())
    if ref_speech == 0:
        return 0.0
    miss = int(np.maximum(n_ref - n_hyp, 0).sum())
    fa = int(np.maximum(n_hyp - n_ref, 0).sum())
    matched_cap = np.minimum(n_ref, n_hyp)
    # best 1:1 assignment of hyp labels onto ref labels: the objective
    # sum_j overlap(ref[map(j)], hyp[j]) is separable per pair, so the
    # Hungarian algorithm finds the md-eval-optimal mapping in
    # O(max(nr,nh)^3) instead of brute-forcing k! permutations
    overlap = (
        r[:, :nr].astype(np.int64).T @ h[:, :nh].astype(np.int64)
    )  # [nr, nh] frames where ref i and hyp j are both active
    try:
        from scipy.optimize import linear_sum_assignment

        rows, cols = linear_sum_assignment(overlap, maximize=True)
        best_correct = int(overlap[rows, cols].sum())
    except ImportError:  # scipy is a dev extra; production uses our own
        best_correct = _assignment_max(overlap)
    confusion = int(matched_cap.sum()) - best_correct
    return (miss + fa + confusion) / ref_speech


def turns_from_local_activity(
    starts: list[int],
    active: np.ndarray,  # [n_chunks, T, local_speakers] binary
    keys: list[tuple[int, int]],  # (chunk, local_speaker) with an embedding
    labels: np.ndarray,  # global label per key
    n_samples: int,
    frame_step: int,
    min_on_s: float = 0.25,
    max_gap_s: float = 0.25,
) -> list[dict]:
    """Stitch per-chunk local speaker activity into global speaker turns.

    Overlap-add: chunks vote on shared frames per global speaker (>= half
    the covering chunks must mark the frame active), then per-speaker runs
    become turns — turns of DIFFERENT speakers may overlap (simultaneous
    speech), matching pyannote's output contract. Short gaps are bridged
    and sub-``min_on_s`` blips dropped.
    """
    if not keys:
        return []
    n_frames_total = -(-n_samples // frame_step)
    n_global = int(np.max(labels)) + 1
    votes = np.zeros((n_frames_total, n_global), np.float32)
    cover = np.zeros((n_frames_total, n_global), np.float32)
    t_chunk = active.shape[1]
    for (ci, spk), g in zip(keys, labels):
        f0 = starts[ci] // frame_step
        hi = min(f0 + t_chunk, n_frames_total)
        votes[f0:hi, g] += active[ci, : hi - f0, spk]
        cover[f0:hi, g] += 1.0
    act = votes >= np.maximum(cover, 1.0) / 2.0

    sec = frame_step / SAMPLE_RATE
    min_on = max(1, int(round(min_on_s / sec)))
    max_gap = int(round(max_gap_s / sec))
    raw: list[dict] = []
    for g in range(n_global):
        on = act[:, g]
        runs: list[list[int]] = []
        f = 0
        while f < len(on):
            if on[f]:
                e = f
                while e + 1 < len(on) and on[e + 1]:
                    e += 1
                if runs and f - runs[-1][1] - 1 <= max_gap:
                    runs[-1][1] = e  # bridge the short gap
                else:
                    runs.append([f, e])
                f = e + 1
            else:
                f += 1
        for a, b in runs:
            if b - a + 1 < min_on:
                continue
            raw.append(
                {
                    "_g": g,
                    "start": round(a * sec, 3),
                    "end": round(min((b + 1) * sec, n_samples / SAMPLE_RATE), 3),
                }
            )
    raw.sort(key=lambda t: (t["start"], t["end"]))
    # number speakers by first appearance in time
    first_seen: dict[int, int] = {}
    for t in raw:
        if t["_g"] not in first_seen:
            first_seen[t["_g"]] = len(first_seen)
    return [
        {
            "speaker": f"SPEAKER_{first_seen[t['_g']]:02d}",
            "start": t["start"],
            "end": t["end"],
        }
        for t in raw
    ]


class TorchDiarizer:
    """Windowed embedding diarizer with energy-based speech gating.

    When a PyanNet segmentation checkpoint is available (the model inside
    pyannote's 3.1 pipeline), diarization runs the full local-segmentation
    -> speaker-embedding -> clustering recipe instead: per-frame speaker
    activity over 10 s chunks gives VAD, speaker-change boundaries, AND
    overlapping speech (the energy-gated path smears overlaps by
    construction).

    ``params`` is a ``DiarizerModel`` and ``seg`` a (``SegmentationModel``,
    cfg) pair, both on ``device``; checkpoints found on disk are converted
    onto ``device`` (``settings.stt_device`` when None).
    """

    def __init__(
        self,
        params: DiarizerModel | None = None,
        cfg: DiarizerConfig = DiarizerConfig(),
        threshold: float = 0.35,
        max_speakers: int = 8,
        seg=None,
        device=None,
    ):
        self.device = diarizer_device(device)
        self.cfg = cfg
        self.params = params if params is not None else init_diarizer_params(cfg=cfg, device=self.device)
        self.threshold = threshold
        self.max_speakers = max_speakers
        # PyanNet segmentation (model, cfg) — explicit, or auto-converted
        # from an on-disk checkpoint
        self.seg = seg

        def _try_convert(find_fn, convert_fn, name):
            """Find + convert an on-disk checkpoint; any failure logs and
            falls back (diarization must stay runnable checkpoint-less)."""
            ckpt = find_fn()
            if ckpt is None:
                return None
            try:
                return convert_fn(ckpt, device=self.device)
            except Exception:  # noqa: BLE001
                import logging

                logging.getLogger(__name__).exception(
                    "%s checkpoint %s failed to convert", name, ckpt
                )
                return None

        if self.seg is None:
            from open_speech_tpu_torch.models.segmentation import (
                convert_segmentation,
                find_segmentation_checkpoint,
            )

            self.seg = _try_convert(
                find_segmentation_checkpoint, convert_segmentation,
                "Segmentation",
            )
        # trained embedding path, preferred first: WeSpeaker ResNet34 (the
        # model pyannote-3.1 itself embeds with), then GE2E (resemblyzer)
        # d-vectors; the conv fallback keeps the pipeline runnable without
        # any checkpoint
        from open_speech_tpu_torch.models.wespeaker import (
            convert_wespeaker,
            find_wespeaker_checkpoint,
        )

        self.wespeaker = _try_convert(
            find_wespeaker_checkpoint, convert_wespeaker, "WeSpeaker"
        )
        self.ge2e = None
        if self.wespeaker is None:
            from open_speech_tpu_torch.models.ge2e import (
                convert_ge2e,
                find_ge2e_checkpoint,
            )

            self.ge2e = _try_convert(
                find_ge2e_checkpoint, convert_ge2e, "GE2E"
            )

    def _embed_bucketed(self, flat: np.ndarray) -> np.ndarray:
        """Embed dispatches of at most ``EMBED_ROWS`` windows: an hour of
        audio is ~2000 window sets, and one flat dispatch would be tens of
        GB of fbank and ResNet intermediates. No row padding: eager torch
        compiles nothing per shape."""
        return np.concatenate(
            [self._embed(flat[i : i + EMBED_ROWS]) for i in range(0, len(flat), EMBED_ROWS)]
        )

    def _embed(self, windows: np.ndarray) -> np.ndarray:
        """[N, win_samples] → [N, E] L2-normalized speaker embeddings."""
        x = torch.from_numpy(np.ascontiguousarray(windows, np.float32)).to(self.device)
        with inference():
            if self.wespeaker is not None:
                from open_speech_tpu_torch.models.wespeaker import (
                    kaldi_fbank,
                    wespeaker_embed,
                )

                model, _cfg = self.wespeaker
                out = wespeaker_embed(model, kaldi_fbank(x))
            elif self.ge2e is not None:
                from open_speech_tpu_torch.models.ge2e import ge2e_embed, ge2e_mel

                model, _cfg = self.ge2e
                out = ge2e_embed(model, ge2e_mel(x))  # one batched dispatch
            else:
                mels = log_mel_spectrogram(x, n_mels=self.cfg.n_mels)[..., :_MEL_FRAMES]
                out = embed_windows(self.params, mels)
            return out.cpu().numpy()

    def _segment(self, chunks: np.ndarray) -> np.ndarray:
        """[N, 160000] chunks -> log-probs [N, T, classes] on the host, in
        calls of at most ``SEG_BATCH`` chunks (bounded memory)."""
        from open_speech_tpu_torch.models.segmentation import segment_chunks

        seg_model, _cfg = self.seg
        return np.concatenate(
            [segment_chunks(seg_model, chunks[i : i + SEG_BATCH]).cpu().numpy()
             for i in range(0, len(chunks), SEG_BATCH)]
        )

    def _diarize_segmented(self, audio: np.ndarray) -> list[dict]:
        """PyanNet path: local activity -> per-(chunk, speaker) embeddings
        -> global clustering -> overlap-aware turns."""
        from open_speech_tpu_torch.models.segmentation import (
            CHUNK_SAMPLES,
            powerset_to_multilabel,
        )

        _seg_model, seg_cfg = self.seg
        n = len(audio)
        hop = CHUNK_SAMPLES // 2
        padded = (
            np.pad(audio, (0, CHUNK_SAMPLES - n)) if n < CHUNK_SAMPLES else audio
        )
        starts = list(range(0, max(1, len(padded) - CHUNK_SAMPLES + 1), hop))
        if starts[-1] + CHUNK_SAMPLES < len(padded):  # tail chunk, padded
            starts.append(len(padded) - CHUNK_SAMPLES)
        chunks = np.stack(
            [
                np.pad(padded[s : s + CHUNK_SAMPLES],
                       (0, max(0, s + CHUNK_SAMPLES - len(padded))))
                for s in starts
            ]
        )
        logp = self._segment(chunks)
        active = powerset_to_multilabel(logp.argmax(-1), seg_cfg)  # [N,T,S]
        # frame stride = product of the conv-stack strides (10 * 3^3 = 270)
        frame_step = seg_cfg.sinc_stride * 27
        # zero activity on frames past the real audio (padded tails)
        for ci, s0 in enumerate(starts):
            real = max(0, min(n - s0, CHUNK_SAMPLES)) // frame_step
            active[ci, real:] = 0.0

        win = int(WINDOW_S * SAMPLE_RATE)
        hop_w = int(HOP_S * SAMPLE_RATE)
        n_wins = 16  # fixed per-(chunk,speaker) window count
        win_sets, keys = [], []
        for ci, s0 in enumerate(starts):
            for spk in range(seg_cfg.max_speakers):
                frames = np.where(active[ci, :, spk] > 0)[0]
                if len(frames) * frame_step < 0.4 * SAMPLE_RATE:
                    continue  # <0.4 s of local speech: too little to embed
                picks = [
                    audio[s0 + f * frame_step : s0 + (f + 1) * frame_step]
                    for f in frames
                    if s0 + f * frame_step < n
                ]
                speech = np.concatenate(picks) if picks else np.zeros(0, np.float32)
                if len(speech) < 0.4 * SAMPLE_RATE:
                    continue
                # tile cyclically so exactly n_wins strided windows exist
                need = win + (n_wins - 1) * hop_w
                if len(speech) < need:
                    speech = np.tile(speech, -(-need // len(speech)))[:need]
                win_sets.append(
                    np.stack(
                        [speech[o : o + win]
                         for o in range(0, hop_w * n_wins, hop_w)]
                    )
                )
                keys.append((ci, spk))
        if not win_sets:
            return []
        all_emb = self._embed_bucketed(np.concatenate(win_sets))
        emb = all_emb.reshape(len(win_sets), n_wins, -1).mean(axis=1)
        emb /= np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-8)
        centered = _center_normalize(emb)
        labels = (
            _agglomerate(centered, self.threshold)
            if len(emb) > 1
            else np.zeros(1, np.int32)
        )
        labels = _cap_speakers(labels, centered, self.max_speakers)
        # compact to consecutive ints: turns_from_local_activity sizes its
        # vote arrays by max(labels)+1, and capped labels keep original
        # (possibly large, sparse) cluster ids
        labels = np.unique(labels, return_inverse=True)[1]
        return turns_from_local_activity(
            starts, active, keys, labels, n, frame_step
        )

    def diarize_audio(self, audio: np.ndarray) -> list[dict]:
        """float32 16 kHz mono -> [{speaker, start, end}] turns.

        Turns may overlap when the segmentation model is active (real
        simultaneous speech); the energy-gated fallback emits
        non-overlapping turns only.
        """
        audio = np.asarray(audio, np.float32).reshape(-1)
        if self.seg is not None and len(audio) > 0:
            return self._diarize_segmented(audio)
        win = int(WINDOW_S * SAMPLE_RATE)
        hop = int(HOP_S * SAMPLE_RATE)
        if len(audio) < win:
            audio = np.pad(audio, (0, win - len(audio)))
        # NO window-count truncation: the whole file is analyzed (embedding
        # runs in capped batches), so the final turn's end never gets
        # stretched over unexamined audio
        starts = list(range(0, len(audio) - win + 1, hop))
        if not starts:
            return []

        windows = np.stack([audio[s : s + win] for s in starts])
        rms = np.sqrt((windows**2).mean(axis=1))
        voiced = rms > max(0.005, float(np.median(rms)) * 0.3)
        if not voiced.any():
            return []

        active_idx = np.where(voiced)[0]
        # embed ONLY voiced windows: unvoiced rows are never used
        active = self._embed_bucketed(windows[active_idx])
        active = _center_normalize(active)
        labels_active = _agglomerate(active, self.threshold)
        # cap speaker count: windows of clusters beyond the max_speakers
        # largest reassign to the nearest surviving centroid (boundary-blend
        # clusters were already absorbed inside _agglomerate)
        labels_active = _cap_speakers(labels_active, active, self.max_speakers)
        # temporal median: a lone-window label between two agreeing
        # neighbors is a boundary artifact, not a 0.75 s speaker
        for pos in range(1, len(labels_active) - 1):
            if (
                labels_active[pos - 1] == labels_active[pos + 1]
                and labels_active[pos] != labels_active[pos - 1]
            ):
                labels_active[pos] = labels_active[pos - 1]

        # stitch into turns with midpoint attribution: each overlapping
        # window votes for its center hop-segment, so turns are contiguous
        # and boundaries land within one hop of the true change
        margin = (WINDOW_S - HOP_S) / 2
        total_s = len(audio) / SAMPLE_RATE
        relabel = {int(u): i for i, u in enumerate(dict.fromkeys(int(x) for x in labels_active))}
        turns: list[dict] = []
        for pos, wi in enumerate(active_idx):
            speaker = f"SPEAKER_{relabel[int(labels_active[pos])]:02d}"
            w0 = starts[wi] / SAMPLE_RATE
            start = 0.0 if wi == 0 else w0 + margin
            end = total_s if wi == len(starts) - 1 else w0 + WINDOW_S - margin
            if turns and turns[-1]["speaker"] == speaker and start <= turns[-1]["end"] + HOP_S:
                turns[-1]["end"] = max(turns[-1]["end"], end)
            else:
                if turns and start < turns[-1]["end"]:
                    start = turns[-1]["end"]
                turns.append({"speaker": speaker, "start": start, "end": end})
        for t in turns:
            t["start"] = round(t["start"], 3)
            t["end"] = round(t["end"], 3)
        return turns
