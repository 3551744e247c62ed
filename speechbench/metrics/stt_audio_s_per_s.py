"""Seconds of real (unpadded) audio whose transcript came back inside the
window, over the window's seconds."""


def read(run):
    done = [r for r in run.requests
            if r.served is not None and run.t0 <= r.done <= run.t_end]
    return sum(r.audio_s for r in done) / run.seconds
