"""How late the traffic generator sent: the 95th percentile, by nearest
rank, of send time minus due time over the requests due in the counted part
of the window. A request is due at its arrival in an open loop, and in a
closed loop when its session's last transcript came back and its think time
passed."""

import math


def read(run):
    lags = sorted(r.sent - r.due_at for r in run.requests
                  if r.due_at is not None and run.t0 <= r.due_at <= run.counted_until)
    if not lags:
        return None
    return 1e3 * lags[max(0, math.ceil(0.95 * len(lags)) - 1)]
