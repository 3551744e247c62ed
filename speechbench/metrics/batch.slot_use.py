"""The useful share of the slot-steps the batcher's ticks computed: tokens
appended over ticks x steps per tick x slots, in %, over the counted window."""


def read(run):
    ticks = run.counted_spans("tick")
    if not ticks:
        return None
    return 100.0 * sum(s.size for s in ticks) / (len(ticks) * run.steps_per_tick * run.slots)
