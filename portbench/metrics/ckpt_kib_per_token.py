"""ckpt_kib_per_token: checkpoint bytes written in the window
(``CheckpointStore.stats.bytes_written``) over the tokens decoded and the
prompt tokens prefilled in it, in KiB."""


def read(run):
    steps = [s for s in run.steps if run.in_window(s.t1)]
    n = sum(s.tokens + s.prefill_tokens for s in steps)
    return run.ckpt_bytes / n / 1024 if n and run.ckpt_bytes else None
