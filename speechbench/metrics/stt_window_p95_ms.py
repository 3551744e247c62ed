"""The 95th percentile, by nearest rank, over every window sent in the window,
of the time from the call (in an open loop, from the moment it was due) to
its transcript. Windows answered after the close count; one that failed or
never came counts as missing every limit, and a tail that reaches it is left
out of the line."""

import math


def read(run):
    lat = sorted(run.latency_s(r) if r.served is not None else math.inf
                 for r in run.requests if run.in_window(r))
    if not lat:
        return None
    p95 = lat[max(0, math.ceil(0.95 * len(lat)) - 1)]
    return 1e3 * p95 if math.isfinite(p95) else None
