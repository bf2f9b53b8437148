"""prefill_tick_ms: the mean host time of the window's engine steps that
prefilled (the engine's prefill token count grew), through the step's
token drain, in ms."""


def read(run):
    steps = [s for s in run.prefill_steps() if run.in_window(s.t1)]
    return sum(s.wall for s in steps) / len(steps) * 1e3 if steps else None
