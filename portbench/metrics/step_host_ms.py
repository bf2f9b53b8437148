"""step_host_ms: the mean, over the window's decode steps outside the
profiled stretch, of the program's ``step`` host span less the spans that
wait on the device (``decode.replay``, ``decode.drain`` and the
checkpoint's ``ckpt.copy``): the step's host work, in ms."""
from portbench import spans


def read(run):
    return spans.per_decode_step_ms(
        run, ["step"], less=["decode.replay", "decode.drain", "ckpt.copy"])
