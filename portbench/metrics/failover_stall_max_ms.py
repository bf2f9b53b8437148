"""failover_stall_max_ms: the longest victim stall in the window (see
failover_stall_ms), in ms."""


def read(run):
    vals = run.victim_stalls()
    return max(vals) * 1e3 if vals else None
