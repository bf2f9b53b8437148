"""prefill_call_ms: the mean of the program's ``prefill.call`` host spans
(``api.prefill`` or ``api.prefill_chunk`` through the dispatch load's
copy to the host) in the window's steps outside the profiled stretch, a
call, in ms."""
from portbench import spans


def read(run):
    idx = spans.index(run)
    if idx is None:
        return None
    calls = [idx[s.t0]["prefill.call"] for s in run.steps
             if run.in_window(s.t1) and not s.traced and
             "prefill.call" in idx.get(s.t0, {})]
    n = sum(c[0] for c in calls)
    return sum(c[1] for c in calls) / n / 1e6 if n else None
