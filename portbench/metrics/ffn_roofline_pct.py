"""ffn_roofline_pct: the least time of the traced stretch's expert FFN
calls (work.ffn_call_seconds on each call's shapes) over the device time
the profiler gives the FFN kernels (csrc/moe_gemm.cu, every path), in %."""
from portbench.harness import traced_least_seconds


def read(run):
    dev = run.summary.by_group.get("ffn", 0.0) if run.summary else 0.0
    return 100.0 * traced_least_seconds(run, "ffn") / dev if dev else None
