"""The decode step's share of its HBM bound, in %: the language model's
weights (every layer, the final norm and the head) and each live slot's
valid K and V, read once a step at the published bandwidth, over the device
time of a decode step (``decode.device_ms``: the ticks seen whole on the
device's timeline, over ticks x steps per tick). Live slots a step are the
tokens the counted window's ticks appended over their steps; a slot's valid
length is the prompt and half its window's served tokens, on the mean."""

from speechbench import flops_voxtral


def read(run):
    if run.trace is None or run.peaks is None:
        return None
    ticks, spans = run.trace.ticks(), run.counted_spans("tick")
    served = [len(r.served) for r in run.requests if r.served]
    if not ticks or not spans or not served:
        return None
    step_s = sum(o.dur for t in ticks for o in run.trace.ops_in(t)) / (
        len(ticks) * run.steps_per_tick)
    live = sum(s.size for s in spans) / (len(spans) * run.steps_per_tick)
    length = run.prompt_len + sum(served) / len(served) / 2
    nbytes = (flops_voxtral.step_weight_bytes(run.config)
              + live * length * flops_voxtral.kv_bytes_per_position(run.config))
    return 100.0 * nbytes / run.peaks["bytes_per_s"] / step_s if step_s > 0 else None
