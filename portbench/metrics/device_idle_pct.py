"""device_idle_pct: the share of the traced stretch's host-clock length
in which no kernel or copy ran on the device, from the profiler's
timeline, in %."""


def read(run):
    s = run.summary
    if s is None or not s.busy_s:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
