"""tbt_p50_ms: the median of every gap between consecutive tokens of a
request, both inside the window, in ms: the decode cadence a reader of
the stream sees."""
from portbench.harness import percentile


def read(run):
    p = percentile(run.gaps(), 50)
    return None if p is None else p * 1e3
