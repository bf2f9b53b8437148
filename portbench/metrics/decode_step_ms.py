"""decode_step_ms: the mean host time of the window's decode steps (the
steps that prefilled nothing), through the step's token drain, in ms."""


def read(run):
    steps = [s for s in run.decode_steps() if run.in_window(s.t1)]
    return sum(s.wall for s in steps) / len(steps) * 1e3 if steps else None
