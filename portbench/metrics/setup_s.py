"""setup_s: seconds from the process's start to the window's opening:
imports, the card, kernel loading (and building, in a checkout's first
run), the weights, the engine, the warm-up and the set-up's prefills."""


def read(run):
    return run.setup_s
