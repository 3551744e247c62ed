"""Device time of the batcher's ticks per decode step: every kernel, copy
and fill of each tick seen whole on the device's timeline, over those ticks
x steps per tick."""


def read(run):
    if run.trace is None:
        return None
    ticks = run.trace.ticks()
    if not ticks:
        return None
    device = sum(o.dur for t in ticks for o in run.trace.ops_in(t))
    return 1e3 * device / (len(ticks) * run.steps_per_tick)
