"""decode_rows_mean: the mean number of rows (tokens emitted) of the
window's decode steps, the steps that prefilled nothing."""


def read(run):
    steps = [s for s in run.decode_steps() if run.in_window(s.t1)]
    return sum(s.tokens for s in steps) / len(steps) if steps else None
