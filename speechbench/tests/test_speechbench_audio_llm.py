"""The audio-LLM cells' pieces on the CPU: the weights' layout and streams,
the reference held against the port at a tiny size, the dictation traffic,
the four metric readers on hand-made traces, and a tiny cell run whole
(sound, and its fp8 control not)."""

from __future__ import annotations

import json
import math

import pytest
import torch

from speechbench import flops, flops_voxtral, reference, reference_voxtral, traffic, weights_voxtral
from speechbench.run import Run
from speechbench.spec import HERE, Spec
from speechbench.tests.conftest import TINY, run_tiny, tiny_bench
from speechbench.trace import DeviceOp, DeviceTrace, Span
from speechbench.traffic import Request

H100 = flops.PEAKS["NVIDIA H100 80GB HBM3"]
CFG = json.loads((HERE / "configs" / "voxtral-small-24b.json").read_text())
TINY_CFG = json.loads((TINY / "configs" / "test-tiny-voxtral.json").read_text())
CELL = "tiny-audio-llm"


@pytest.fixture
def audio_llm_spec(tiny_root) -> Spec:
    """The tiny benchmark with a tiny Voxtral cell on the audio-LLM entry."""
    bench = tiny_bench()
    bench["workloads"].append({"name": CELL, "config": "test-tiny-voxtral",
                               "traffic": "tiny-audio-llm", "chips": 1, "why": "tiny Voxtral"})
    for m in bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append(CELL)
    return Spec(bench, tiny_root)


def test_layout_covers_the_port_model_at_the_published_widths():
    from open_speech_tpu_torch.models.voxtral.model import Voxtral, VoxtralConfig

    with torch.device("meta"):
        model = Voxtral(VoxtralConfig.from_hf(CFG), torch.bfloat16)
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    got = {name: shape for name, shape, _, _ in weights_voxtral.layout(CFG)}
    assert got == want
    params = sum(math.prod(s) for s in got.values())
    assert params * 2 / 1e9 == pytest.approx(48.52, abs=0.01)  # bf16 GB: the published 48.5


def test_each_tensor_has_its_own_stream():
    every = weights_voxtral.make(TINY_CFG, 5, "cpu")
    layer = weights_voxtral.make(TINY_CFG, 5, "cpu", select=lambda n: n.startswith("layers.1."))
    assert layer and all(torch.equal(every[k], v) for k, v in layer.items())
    other = weights_voxtral.make(TINY_CFG, 6, "cpu", select=lambda n: n == "head.weight")
    assert not torch.equal(other["head.weight"], every["head.weight"])
    assert every["encoder.blocks.0.ln1.weight"].dtype == torch.float32
    assert every["layers.0.attn_norm.weight"].dtype == torch.bfloat16


def test_reference_matches_the_port_at_float32():
    """The float32 port (prefill, then one cached step a position) against
    the reference's teacher-forced pass, at the tiny widths."""
    from open_speech_tpu_torch.models.voxtral.model import (
        Voxtral, VoxtralConfig, decode_step, encode_audio, prefill, rope_tables)
    from open_speech_tpu_torch.models.voxtral.tokens import VoxtralTokens

    reference.strict_float32()
    vcfg = VoxtralConfig.from_hf(TINY_CFG)
    model = Voxtral.empty(vcfg, torch.float32, "cpu")
    model.load_state_dict({k: v.float() for k, v in weights_voxtral.make(TINY_CFG, 9, "cpu").items()})
    prompt = VoxtralTokens(vcfg.audio_positions, {"en": TINY_CFG["assumed"]["lang_ids"]}).transcription_prompt("en")
    served = [7, 400, 12, 99]
    n = TINY_CFG["audio_config"]["max_source_positions"] * 2 * reference.HOP
    mel = torch.from_numpy(reference.log_mel(traffic.clips(9)[2, : n // 2], 80, n))
    p = len(prompt)
    want = reference_voxtral.logits(TINY_CFG, 9, mel[None], [prompt + served],
                                    [range(p - 1, p - 1 + len(served))])[0]
    cache = torch.zeros(vcfg.layers, 2, 1, vcfg.kv_heads, 64, vcfg.head_dim)
    with torch.no_grad():
        prefill(model, encode_audio(model, mel[None]), torch.tensor(prompt[:-1]), cache,
                torch.tensor([0]))
        rope = rope_tables(vcfg, 64, "cpu")
        got = [decode_step(model, torch.tensor([t]), torch.tensor([p - 1 + j]), cache, rope)[0]
               for j, t in enumerate([prompt[-1]] + served[:-1])]
    # float32 on both sides; the mel's front ends (float64 NumPy against the
    # reference's) agree within 2e-4 and sums run in other orders: 1e-3
    torch.testing.assert_close(torch.stack(got), want, rtol=1e-3, atol=1e-3)


def test_dictation_mix_sizes_and_budgets():
    from open_speech_tpu_torch.runtime.audio_llm_batcher import AudioLLMBatcher

    mix = json.loads((HERE / "traffic" / "audio-llm-dictation.json").read_text())
    plan = traffic.plan(mix, 2**31 + 3, 51.0)
    assert len(plan.sessions) == 64 and plan.preroll_s == 8.0
    later = [r.audio_s for s in plan.sessions for r in s[1:]]
    assert min(later) >= 5.0 and max(later) <= 30.0
    budgets = {AudioLLMBatcher.token_budget(seconds) for seconds in later}
    assert min(budgets) == 48 and max(budgets) == 144


def _run(trace=None, spans=(), requests=(), peaks=H100):
    return Run(cell={"name": "v"}, config=CFG, traffic={"loop": "closed"}, seconds=10.0, t0=100.0,
               counted_until=110.0, setup_s=30.0, requests=list(requests), spans=list(spans),
               steps_per_tick=4, slots=64, prompt_len=383, peaks=peaks, trace=trace)


def _trace():
    """Two whole ticks around an admission of 2 windows (32 D = 64 K1
    launches of a window each, one grouped K1 launch a layer)."""
    pin, out = "Memcpy HtoD (Pinned -> Device)", "Memcpy DtoH (Device -> Pageable)"
    ops = [DeviceOp(pin, 0.100, 0.001), DeviceOp("gemv", 0.101, 0.020), DeviceOp(out, 0.121, 0.001)]
    at = 0.130
    for _ in range(32):
        ops.append(DeviceOp("void flash_fwd_bf16<64, false>", at, 0.0005, (24, 20, 2)))
        at += 0.001
    for _ in range(40):
        ops.append(DeviceOp("void flash_fwd_gqa_bf16", at, 0.0001, (6, 32, 2)))
        at += 0.001
    ops += [DeviceOp(pin, 0.300, 0.001), DeviceOp("gemv", 0.301, 0.040), DeviceOp(out, 0.341, 0.001)]
    return DeviceTrace(1.0, ops)


@pytest.fixture(scope="module")
def metric():
    spec = Spec({})
    return lambda name: spec.metric(name).read


def test_admission_device_time_per_window(metric):
    # 72 launches between the ticks: 32 x 0.5 ms + 40 x 0.1 ms over 32 x 2 / 32 windows
    assert metric("admit.device_ms")(_run(_trace())) == pytest.approx(1e3 * 0.020 / 2)
    assert metric("admit.device_ms")(_run()) is None


def test_grouped_k1_roofline(metric):
    want = 100.0 * 40 * flops_voxtral.k1_gqa_bound_s(2, 32, 8, 382, 382, 128, H100) / 0.004
    assert metric("k1_gqa_roofline")(_run(_trace())) == pytest.approx(want)
    # the visible pairs of a causal 382: 382 x 383 / 2
    assert flops_voxtral.k1_gqa_bound_s(1, 32, 8, 382, 382, 128, H100) == pytest.approx(
        max(4 * 32 * 382 * 383 / 2 * 128 / 989e12, (2 * 32 + 2 * 8) * 382 * 128 * 2 / 3.35e12))
    assert metric("k1_gqa_roofline")(_run(_trace(), peaks=None)) is None


def test_audio_tower_k1_roofline(metric):
    """The D = 64 K1 launches alone, at the audio tower's 1500 positions and
    1280 / 20 head dim from ``audio_config``: the grouped launches are not
    read."""
    want = 100.0 * 32 * flops.k1_bound_s(2, 20, 1500, 1500, 64, H100) / 0.016
    assert metric("k1_roofline.voxtral")(_run(_trace())) == pytest.approx(want)
    assert metric("k1_roofline.voxtral")(_run(DeviceTrace(1.0, []))) is None
    assert metric("k1_roofline.voxtral")(_run(_trace(), peaks=None)) is None


def test_decode_bandwidth_roofline(metric):
    spans = [Span("tick", 101.0 + i, 101.2 + i, 4 * 48) for i in range(3)]  # 48 live slots
    reqs = [Request(0, 16000, 0, 0)]
    reqs[0].served = list(range(100))
    step = (0.022 + 0.042) / (2 * 4)
    nbytes = flops_voxtral.step_weight_bytes(CFG) + 48 * (383 + 50) * 163840
    want = 100.0 * nbytes / 3.35e12 / step
    assert metric("decode.bw_roofline")(_run(_trace(), spans, reqs)) == pytest.approx(want)
    assert flops_voxtral.step_weight_bytes(CFG) / 1e9 == pytest.approx(45.8, abs=0.05)
    assert metric("decode.bw_roofline")(_run(_trace(), [], reqs)) is None


def test_mfu_from_voxtrals_shapes(metric):
    spans = [Span("admit", 100.0, 100.3, 8), Span("tick", 100.3, 100.4, 256)]
    reqs = [Request(0, 16000, 0, 0)]
    reqs[0].served = list(range(60))
    work = (8 * (flops_voxtral.encoder_flops(CFG) + flops_voxtral.prefill_flops(CFG, 382))
            + 256 * flops_voxtral.position_flops(CFG, 383 + 30))
    assert metric("mfu.voxtral")(_run(None, spans, reqs)) == pytest.approx(
        100.0 * work / (0.4 * 989e12))
    # a window's prefill ~17 TFLOP; a decoded position ~46 GFLOP
    assert flops_voxtral.prefill_flops(CFG, 382) == pytest.approx(1.70e13, rel=0.01)
    assert flops_voxtral.position_flops(CFG, 450) == pytest.approx(4.61e10, rel=0.01)


def test_tiny_cell_is_correct_and_its_fp8_control_is_not(audio_llm_spec):
    sound = run_tiny(audio_llm_spec, CELL)
    assert sound["correct"] and sound["failed"] == 0, sound["checks"]
    assert sound["metrics"]["stt_audio_s_per_s"]["value"] > 0
    low = run_tiny(audio_llm_spec, CELL, control="fp8")
    assert not low["correct"], low["checks"]
    assert low["checks"]["max_logit_gap"]["value"] > low["checks"]["max_logit_gap"]["limit"]
