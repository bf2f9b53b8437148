"""decode_mfu_pct: model operations of the window's decode steps (2 a
weight each token multiplies by, and 4 * head_dim a query head and valid
key) over their host time at the bf16 peak of 989 TFLOP/s, in %."""
from portbench import work


def read(run):
    steps = [s for s in run.decode_steps() if run.in_window(s.t1)]
    wall = sum(s.wall for s in steps)
    if not wall:
        return None
    flops = sum(work.model_flops(run.shapes, s.tokens, s.keys)
                for s in steps)
    return 100.0 * flops / wall / work.BF16_FLOPS_PER_S
