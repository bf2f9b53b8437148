"""decode_attn_roofline_pct: the least time of the traced stretch's
decode attention calls (work.decode_attn_call_seconds, valid K/V bytes)
over the device time the profiler gives the decode attention kernels
(csrc/decode_attention.cu), in %."""
from portbench.harness import traced_least_seconds


def read(run):
    dev = run.summary.by_group.get("decode_attn", 0.0) if run.summary \
        else 0.0
    return 100.0 * traced_least_seconds(run, "decode_attn") / dev \
        if dev else None
