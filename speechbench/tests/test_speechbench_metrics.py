"""The metric arithmetic on hand-made records: rates over the whole window,
tails of every window, idle shares from interval unions, rooflines and MFU
from shapes, and the device trace's attribution to spans."""

from __future__ import annotations

import json
import math

import pytest

from speechbench import flops
from speechbench.run import Run
from speechbench.spec import Spec
from speechbench.trace import DeviceOp, DeviceTrace, Span, idle_gaps, parse_chrome_trace
from speechbench.traffic import Request

H100 = flops.PEAKS["NVIDIA H100 80GB HBM3"]
CFG = {"d_model": 1280, "encoder_layers": 32, "decoder_layers": 4, "encoder_attention_heads": 20,
       "encoder_ffn_dim": 5120, "decoder_ffn_dim": 5120, "num_mel_bins": 128,
       "vocab_size": 51866, "max_source_positions": 1500}


def _run(requests=(), spans=(), trace=None, seconds=10.0, counted_until=None, peaks=H100,
         loop="open"):
    return Run(cell={"name": "c"}, config=CFG, traffic={"loop": loop}, seconds=seconds, t0=100.0,
               counted_until=100.0 + seconds if counted_until is None else counted_until,
               setup_s=12.5, requests=list(requests), spans=list(spans), steps_per_tick=4,
               slots=64, prompt_len=3, peaks=peaks, trace=trace)


def _req(i, audio_s, sent, done, due=None, served=(1, 2, 3)):
    r = Request(i, int(audio_s * 16000), 0, 0, due=due, due_at=None if due is None else 100.0 + due)
    r.sent, r.done, r.served = sent, done, None if served is None else list(served)
    return r


@pytest.fixture(scope="module")
def metric():
    spec = Spec({})
    return lambda name: spec.metric(name).read


def test_audio_rate_counts_only_transcripts_back_inside_the_window(metric):
    reqs = [_req(0, 2.0, 100.0, 101.0), _req(1, 3.0, 101.0, 109.9),
            _req(2, 4.0, 105.0, 110.5),  # answered after the close
            _req(3, 5.0, 106.0, 107.0, served=None)]  # failed
    assert metric("stt_audio_s_per_s")(_run(reqs)) == pytest.approx(5.0 / 10.0)


def test_p95_is_nearest_rank_over_every_window_late_ones_included(metric):
    # open loop: latency runs from the due time, not the send time
    reqs = [_req(i, 1.0, 100.0 + i * 0.1 + 0.05, 100.0 + i * 0.1 + 0.2 + i * 0.001, due=i * 0.1)
            for i in range(40)]
    reqs[39].done = 100.0 + 3.9 + 30.0  # answered long after the close
    lat = sorted(r.done - (100.0 + r.due) for r in reqs)
    want = lat[math.ceil(0.95 * 40) - 1]
    assert metric("stt_window_p95_ms")(_run(reqs)) == pytest.approx(1e3 * want)
    for r in reqs[37:]:  # failures that reach the tail
        r.served = None
    assert metric("stt_window_p95_ms")(_run(reqs)) is None


def test_closed_loop_latency_from_the_call_and_lag_from_the_last_reply(metric):
    # a session: due when its last transcript came back, sent a little later
    reqs = [_req(0, 1.0, 100.002, 100.5, due=0.0), _req(1, 1.0, 100.51, 101.5, due=0.5)]
    assert metric("stt_window_p95_ms")(_run(reqs, loop="closed")) == pytest.approx(990.0)
    assert metric("gen.lag_p95_ms")(_run(reqs, loop="closed")) == pytest.approx(10.0)
    reqs[1].due_at = None  # no due time, nothing to read
    reqs[0].due_at = None
    assert metric("gen.lag_p95_ms")(_run(reqs, loop="closed")) is None


def test_generator_lag(metric):
    reqs = [_req(i, 1.0, 100.0 + i + 0.001 * i, 100.0 + i + 0.5, due=float(i)) for i in range(20)]
    assert metric("gen.lag_p95_ms")(_run(reqs, seconds=30)) == pytest.approx(1e3 * 0.001 * 18)


def test_slot_use_and_tick_ms_over_the_counted_window(metric):
    spans = [Span("tick", 100.0 + i, 100.0 + i + 0.02, 128) for i in range(5)]
    spans.append(Span("tick", 108.0, 108.5, 256))  # after the counted part
    run = _run(spans=spans, counted_until=106.0)
    assert metric("batch.slot_use")(run) == pytest.approx(100.0 * 128 / (4 * 64))
    assert metric("batch.tick_ms")(run) == pytest.approx(20.0)


def test_mfu_from_shapes(metric):
    spans = [Span("admit", 100.0, 100.01, 2), Span("tick", 100.01, 100.03, 64)]
    reqs = [_req(0, 1.0, 100.0, 101.0, served=range(40))]
    work = (2 * flops.encoder_flops(CFG)
            + (2 * 2 + 64) * flops.decoder_position_flops(CFG, 3 + 20))
    want = 100.0 * work / (0.03 * H100["bf16_flops"])
    assert metric("mfu.stt")(_run(reqs, spans)) == pytest.approx(want)
    assert metric("mfu.stt")(_run(reqs, spans, peaks=None)) is None


def test_encoder_flops_match_the_published_widths():
    # 32 layers at d 1280 over 1500 positions: 2.26 TFLOP, plus the stem and
    # the 4 decoder layers' cross K and V
    assert flops.encoder_flops(CFG) == pytest.approx(2.31e12, rel=0.01)
    assert flops.k1_bound_s(1, 20, 1500, 1500, 64, H100) == pytest.approx(1.152e10 / 989e12)


def _trace():
    """Two whole ticks (pinned state copy in, result copy out) around an
    admission of 4 windows (two K1 launches of a 2-layer encoder: 2 + 2)."""
    pin, out = "Memcpy HtoD (Pinned -> Device)", "Memcpy DtoH (Device -> Pageable)"
    ops = [
        DeviceOp(pin, 0.100, 0.001), DeviceOp("gemv", 0.101, 0.010), DeviceOp(out, 0.111, 0.001),
        DeviceOp("Memcpy HtoD (Pageable -> Device)", 0.150, 0.001),  # a mel's audio
        DeviceOp("flash_fwd_bf16<64, false>", 0.160, 0.004, (12, 20, 2)),
        DeviceOp("gemm", 0.164, 0.006),
        DeviceOp("flash_fwd_bf16<64, false>", 0.170, 0.004, (12, 20, 2)),
        DeviceOp(pin, 0.300, 0.001), DeviceOp("gemv", 0.301, 0.010),
        DeviceOp("copy", 0.305, 0.010),  # overlaps the op before
        DeviceOp(out, 0.315, 0.001),
        DeviceOp(pin, 0.900, 0.001),  # a tick the profile cut off
    ]
    return DeviceTrace(1.0, ops)


CFG2 = {**CFG, "encoder_layers": 2}


def test_idle_share_from_the_union_of_intervals(metric):
    tr = _trace()
    merged = tr.busy_intervals()
    assert merged == sorted(merged) and all(b > a for a, b in merged)
    busy = 0.012 + 0.001 + 0.014 + 0.016 + 0.001
    assert tr.busy_s() == pytest.approx(busy)
    assert metric("device.idle_share")(_run(trace=tr)) == pytest.approx(100.0 * (1 - busy))


def test_ticks_admissions_and_the_k1_roofline(metric):
    tr = _trace()
    assert tr.ticks() == [(0.100, pytest.approx(0.112)), (0.300, pytest.approx(0.316))]
    run = _run(trace=tr)
    run.config = CFG2
    assert metric("decode.device_ms")(run) == pytest.approx(1e3 * (0.012 + 0.022) / (2 * 4))
    # between the ticks: 0.015 s of device work over (2 + 2) / 2 layers = 2 windows
    assert metric("encode.device_ms")(run) == pytest.approx(1e3 * 0.015 / 2)
    want = 100.0 * 2 * flops.k1_bound_s(2, 20, 1500, 1500, 64, H100) / 0.008
    assert metric("k1_roofline")(run) == pytest.approx(want)
    assert metric("k1_roofline")(_run(trace=tr, peaks=None)) is None


def test_no_whole_tick_reads_nothing(metric):
    tr = DeviceTrace(1.0, [DeviceOp("Memcpy HtoD (Pinned -> Device)", 0.1, 0.001)])
    assert metric("decode.device_ms")(_run(trace=tr)) is None
    assert metric("encode.device_ms")(_run(trace=tr)) is None


def test_window_membership_counts_from_the_due_time():
    run = _run()
    early = _req(0, 1.0, 99.0, 100.5, due=-1.0)  # sent in the pre-roll
    late = _req(1, 1.0, 100.2, 101.0, due=0.1)
    assert not run.in_window(early) and run.in_window(late)
    assert run.latency_s(late) == pytest.approx(0.9)


def test_idle_gaps_are_named_by_the_device_timeline():
    gaps = idle_gaps(_trace(), top=2)
    assert gaps[0][0] == "between ticks" and gaps[0][1] == pytest.approx(0.900 - 0.316)
    assert gaps[1][0] == "between ticks" and gaps[1][1] == pytest.approx(0.300 - 0.174)


def test_chrome_trace_parse_keeps_device_work_and_grids(tmp_path):
    trace = {"traceEvents": [
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 1000.0, "dur": 5},
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 1010.0, "dur": 20.0,
         "args": {"grid": [12, 20, 3]}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pinned -> Device)", "ts": 1005.0,
         "dur": 2.0},
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 0},
    ]}
    path = tmp_path / "t.json"
    path.write_text(json.dumps(trace))
    tr = parse_chrome_trace(str(path), 3.0)
    copy, k = tr.ops
    assert copy.grid is None and k.grid == (12, 20, 3)
    assert k.start == pytest.approx(1010e-6) and k.dur == pytest.approx(20e-6)
    assert tr.window_s == 3.0
