"""Host times of the serving path of one or more checkouts, each in its
own process, in turns on one card: the prefills inside ``client.submit``,
the chunk ticks, the decode steps and the checkpoint copies to the host
(``kvcache._pack_to_host``), at Mixtral-8x7B widths with 8 layers in
bf16 (capacity factor 4.0, 2 AWs x 2 EWs, 8 requests of 128 prompt
tokens and 16 new ones) on a whole-prompt and a chunked engine (256
prompt tokens a tick), three passes each: the first pays the process's
lazy set-up (kernel libraries, allocators, step graphs), the others show
the steady state.

    python src/repro_torch/launch/host_times.py TREE [TREE ...]

Each TREE is the root of a checkout (``.`` for this one; another commit
unpacked with ``git archive`` into a directory git ignores); they run in
the order given, so ``A B B A`` alternates two of them. A tree builds its
kernels into its own ``build/kernels``: copy this checkout's there first
when the kernel sources are the same. Host clock through a device sync;
needs an NVIDIA GPU. Prints one line a pass with the card's name and
power limit.
"""
import dataclasses
import statistics
import subprocess
import sys
import time
from pathlib import Path

PASSES = 3


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def one(tree: Path):
    """The passes of one tree, in this process, on that tree's code."""
    sys.path.insert(0, str(tree / "src"))
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.serving import kvcache
    from repro_torch.serving.api import RequestSpec
    from repro_torch.serving.engine import EngineConfig, InferenceEngine
    if not torch.cuda.is_available():
        raise SystemExit("host_times: no CUDA device visible")
    copies = []
    pack = kvcache._pack_to_host

    def timed_pack(leaves):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = pack(leaves)
        copies.append(time.perf_counter() - t0)
        return out
    kvcache._pack_to_host = timed_pack
    cfg = dataclasses.replace(get_config("mixtral_8x7b"), num_layers=8,
                              dtype="bfloat16")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=4.0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=(128,)).astype(np.int32)
               for _ in range(8)]
    base = dict(max_batch=8, max_seq=512, num_aw=2, num_ew=2)
    whole = InferenceEngine(cfg, EngineConfig(**base), seed=0,
                            device="cuda")
    chunked = InferenceEngine(cfg, EngineConfig(**base,
                                                chunk_token_budget=256),
                              params=whole.params, device="cuda")
    where = card()
    for name, eng in (("whole", whole), ("chunked", chunked)):
        for n in range(PASSES):
            copies.clear()
            handles, submit, steps = [], 0.0, []
            for i, p in enumerate(prompts):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                handles.append(eng.client.submit(RequestSpec(
                    rid=f"r{i}", prompt=p, max_new=16)))
                torch.cuda.synchronize()
                submit += time.perf_counter() - t0
            while not all(h.done() for h in handles):
                t0 = time.perf_counter()
                eng.step()          # ends in the token drain's host sync
                steps.append(time.perf_counter() - t0)
            for h in reversed(handles):
                eng.release_request(h.rid)
            print(f"{tree.resolve().name} {name} pass {n}: submits "
                  f"{submit * 1e3:.1f} ms; {len(steps)} steps, median "
                  f"{statistics.median(steps) * 1e3:.2f} ms, first four "
                  f"{[round(s * 1e3, 1) for s in steps[:4]]}; "
                  f"{len(copies)} host copies, {sum(copies) * 1e3:.1f} ms; "
                  f"on {where}", flush=True)


def main(argv):
    if len(argv) >= 2 and argv[0] == "--one":
        one(Path(argv[1]))
        return 0
    if not argv:
        print(__doc__)
        return 2
    for tree in argv:
        subprocess.run([sys.executable, str(Path(__file__).resolve()),
                        "--one", tree], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
