"""resume_gap_ms: the mean, over the window's failures whose detecting
tick restored requests, of the time from that tick's end (``t_detect`` +
``tick_s``) to the step by which every victim had emitted a token again
(the latest of their first stamps after the tick), in ms. A failure a
victim of which is not served again in the window, or whose gap meets the
profiled stretch, is left out."""
from portbench import spans


def read(run):
    got = []
    for f in run.failures:
        if f.restored_bytes <= 0 or not run.in_window(f.t_detect):
            continue
        firsts = [next((t for t in run.reqs[rid].stamps if t > f.t_detect),
                       None) for rid in f.victims]
        if not firsts or None in firsts or max(firsts) > run.t_close:
            continue
        end = f.t_detect + f.tick_s
        if not spans.profiled(run, f.t_detect, max(firsts)):
            got.append(max(firsts) - end)
    return sum(got) / len(got) * 1e3 if got else None
