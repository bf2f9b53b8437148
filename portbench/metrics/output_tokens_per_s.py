"""output_tokens_per_s: every output token stamped inside the window,
over the window's seconds."""


def read(run):
    return run.window_tokens() / run.seconds
