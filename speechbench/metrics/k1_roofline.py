"""K1's share of its roofline, in %: the least time of each K1 launch
(``flash_fwd_bf16``: the encoder's self-attention over the windows an
admission takes, at the published peaks), summed, over those launches'
device time. A launch's grid gives its windows and heads; the query and key
lengths are the configuration's audio positions."""

from speechbench import flops


def read(run):
    if run.trace is None or run.peaks is None:
        return None
    c = run.config
    t, d = c["max_source_positions"], c["d_model"] // c["encoder_attention_heads"]
    bound = device = 0.0
    for o in run.trace.ops:
        if "flash_fwd_bf16" in o.name and o.grid:
            bound += flops.k1_bound_s(o.grid[2], o.grid[1], t, t, d, run.peaks)
            device += o.dur
    return 100.0 * bound / device if device > 0 else None
