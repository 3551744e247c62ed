"""Device time of the admissions (the encoder, the cross-attention K and V
and the prompt feed), per window admitted: every kernel, copy and fill that
ran between two whole ticks where an encoder ran, over the windows those
encoders took (K1's grid gives each launch's windows; one launch a layer)."""


def read(run):
    if run.trace is None:
        return None
    device = windows = 0.0
    for interval in run.trace.between_ticks():
        ops = run.trace.ops_in(interval)
        k1 = [o for o in ops if "flash_fwd_bf16" in o.name and o.grid]
        if k1:
            device += sum(o.dur for o in ops)
            windows += sum(o.grid[2] for o in k1) / run.config["encoder_layers"]
    return 1e3 * device / windows if windows else None
