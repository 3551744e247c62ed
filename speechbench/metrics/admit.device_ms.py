"""Device time of an audio-LLM's admissions (the audio tower, the adapter
and the prefill), per window admitted: every kernel, copy and fill that ran
between two whole ticks where the audio tower ran, over the windows those
encoders took (the grid of each of its K1 launches at D = 64 gives its
windows; one launch a layer of ``audio_config``)."""


def read(run):
    if run.trace is None:
        return None
    device = windows = 0.0
    for interval in run.trace.between_ticks():
        ops = run.trace.ops_in(interval)
        k1 = [o for o in ops if "flash_fwd_bf16" in o.name and o.grid]
        if k1:
            device += sum(o.dur for o in ops)
            windows += sum(o.grid[2] for o in k1) / run.config["audio_config"]["num_hidden_layers"]
    return 1e3 * device / windows if windows else None
