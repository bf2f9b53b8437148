"""restore_ms: the mean, over the failures whose detecting tick restored
requests, of that orchestrator tick's host time (the engine's
``fail_aw`` and ``recover_aw_requests``), through a device sync, in ms.
A failure with no healthy AW to take its victims restores nothing in
that tick and is not counted."""


def read(run):
    ticks = [f.tick_s for f in run.failures if f.restored_bytes > 0]
    return sum(ticks) / len(ticks) * 1e3 if ticks else None
