"""K1's share of its roofline at head dim 128 with grouped KV heads, in %:
the least time of each ``flash_fwd_gqa_bf16`` launch (the language model's
causal prefill over the windows an admission takes, at the published
peaks), summed, over those launches' device time. A launch's grid (query
blocks, query heads, windows) gives its windows and heads; its query and
key lengths are the prompt's positions but its last (the first decode step
feeds that one)."""

from speechbench import flops_voxtral


def read(run):
    if run.trace is None or run.peaks is None:
        return None
    t = run.config["text_config"]
    length = run.prompt_len - 1
    bound = device = 0.0
    for o in run.trace.ops:
        if "flash_fwd_gqa_bf16" in o.name and o.grid:
            bound += flops_voxtral.k1_gqa_bound_s(o.grid[2], o.grid[1], t["num_key_value_heads"],
                                                  length, length, t["head_dim"], run.peaks)
            device += o.dur
    return 100.0 * bound / device if device > 0 else None
