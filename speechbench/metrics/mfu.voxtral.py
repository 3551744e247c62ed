"""The whole step's share of the card's bf16 peak, in %, for an audio-LLM:
the model's operations for the work that served windows (per window
admitted the audio tower, the adapter and the prefill of the prompt but its
last position; per decoded position the language model at the window's mean
length, the head included), over the host time of the admissions and ticks
in the counted window x the peak. Slots computed for no window count as no
work."""

from speechbench import flops_voxtral


def read(run):
    if run.peaks is None:
        return None
    admits, ticks = run.counted_spans("admit"), run.counted_spans("tick")
    busy = sum(s.end - s.start for s in admits + ticks)
    if busy <= 0:
        return None
    windows = sum(s.size for s in admits)
    # a window's first decode step feeds the prompt's last position and
    # appends its first token: decoded positions are the tokens appended
    positions = sum(s.size for s in ticks)
    served = [len(r.served) for r in run.requests if r.served]
    mean_len = run.prompt_len + (sum(served) / len(served) / 2 if served else 0)
    work = (windows * (flops_voxtral.encoder_flops(run.config)
                       + flops_voxtral.prefill_flops(run.config, run.prompt_len - 1))
            + positions * flops_voxtral.position_flops(run.config, mean_len))
    return 100.0 * work / (busy * run.peaks["bf16_flops"])
