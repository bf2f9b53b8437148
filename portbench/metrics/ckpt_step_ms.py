"""ckpt_step_ms: the mean, over the window's decode steps outside the
profiled stretch, of the checkpoint's host spans in the step: the gather
(``ckpt.gather``), the pinned allocation (``ckpt.pin_alloc``), the copy
to the host (``ckpt.copy``) and the commit to the store (``ckpt.commit``),
in ms."""
from portbench import spans


def read(run):
    return spans.per_decode_step_ms(
        run, ["ckpt.gather", "ckpt.pin_alloc", "ckpt.copy", "ckpt.commit"])
