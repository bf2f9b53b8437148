"""failover_stall_ms: the mean, over every victim of every failure in
the window (a request resident on the AW when the failure is injected),
of the time from the injection to its first token after the
orchestrator's tick that detected the failure and restored it; a victim
not served again by the window's end counts with the time to the end."""


def read(run):
    vals = run.victim_stalls()
    return sum(vals) / len(vals) * 1e3 if vals else None
