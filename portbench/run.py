"""The port's benchmark, one run of one cell:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for. Prints diagnostics and, last on standard error, each number the
check compared with its limit; the last line of standard output is the
result's JSON object. Exits non-zero, with no result, without CUDA, when
the program cannot be imported, or when the process has loaded JAX or the
JAX package once the window has closed. ``--control 1`` puts the fp8
control in the program's place in the check, which it has to fail (the
reading that the check's limit is set against; a benchmark run leaves it
off).
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

#: top-level module names that a run may never load (compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules():
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    import torch
    torch.set_num_threads(4)
    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        log("no CUDA device: the benchmark measures the port on the card")
        return 2
    from portbench import runner
    from repro_torch.kernels import build
    log(f"card: {card_line()}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    result, lines = runner.run_cell(
        args.workload, args.seed, args.seconds, bool(args.trace),
        t_start=T_START, device="cuda", control=bool(args.control), log=log)
    log(f"kernel build this run: {build.build_seconds:.1f} s "
        f"(0 when the checkout's build/kernels had every library)")
    bad = forbidden_modules()
    if bad:
        log(f"refused: the process loaded {bad}")
        return 3
    for line in lines:
        log(line)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
