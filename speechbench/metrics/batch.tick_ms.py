"""Host wall per batcher tick (``_tick``, which ends in its one host sync),
the mean over the counted window."""


def read(run):
    ticks = run.counted_spans("tick")
    if not ticks:
        return None
    return 1e3 * sum(s.end - s.start for s in ticks) / len(ticks)
