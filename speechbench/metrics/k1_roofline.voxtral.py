"""K1's share of its roofline in an audio-LLM's audio tower, in %: the least
time of each ``flash_fwd_bf16`` launch (Whisper's encoder self-attention
over the windows an admission takes, at the published peaks), summed, over
those launches' device time. ``k1_roofline``'s reading, from the keys of
the configuration's ``audio_config``. A launch's grid gives its windows and
heads; the query and key lengths are the audio tower's positions. The
language model's K1 (``flash_fwd_gqa_bf16``) is ``k1_gqa_roofline``'s."""

from speechbench import flops


def read(run):
    if run.trace is None or run.peaks is None:
        return None
    a = run.config["audio_config"]
    t, d = a["max_source_positions"], a["hidden_size"] // a["num_attention_heads"]
    bound = device = 0.0
    for o in run.trace.ops:
        if "flash_fwd_bf16" in o.name and o.grid:
            bound += flops.k1_bound_s(o.grid[2], o.grid[1], t, t, d, run.peaks)
            device += o.dur
    return 100.0 * bound / device if device > 0 else None
