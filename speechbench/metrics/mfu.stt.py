"""The whole step's share of the card's bf16 peak, in %: the model's
operations for the work that served windows (the encoder and the
cross-attention K and V per window admitted; per decoder position fed or
decoded for a window, its self-attention over the window's mean length),
over the host time of the admissions and ticks in the counted window x the
peak. Slots computed for no window count as no work."""

from speechbench import flops


def read(run):
    if run.peaks is None:
        return None
    admits, ticks = run.counted_spans("admit"), run.counted_spans("tick")
    busy = sum(s.end - s.start for s in admits + ticks)
    if busy <= 0:
        return None
    windows = sum(s.size for s in admits)
    positions = (run.prompt_len - 1) * windows + sum(s.size for s in ticks)
    served = [len(r.served) for r in run.requests if r.served]
    mean_len = run.prompt_len + (sum(served) / len(served) / 2 if served else 0)
    work = (windows * flops.encoder_flops(run.config)
            + positions * flops.decoder_position_flops(run.config, mean_len))
    return 100.0 * work / (busy * run.peaks["bf16_flops"])
