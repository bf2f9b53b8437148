"""ckpt_pin_alloc_ms: the mean, over the window's decode steps outside
the profiled stretch, of the ``ckpt.pin_alloc`` host spans in the step:
the pinned host block each checkpoint copy allocates, in ms."""
from portbench import spans


def read(run):
    return spans.per_decode_step_ms(run, ["ckpt.pin_alloc"])
