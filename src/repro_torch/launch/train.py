"""Training launcher of the port (twin of ``repro.launch.train``): train
a reduced model for N steps on synthetic LM data (the paper is about
inference; this drives the training substrate).

    python -m repro_torch.launch.train --arch qwen2_1_5b \\
        --steps 50 --batch 4 --seq 32 [--device cpu]

The model runs on the card unless ``--device cpu`` is given; without a
CUDA device and without ``--device cpu`` it raises. Weights are seeded
(``torch.Generator`` seed 0); an encoder-decoder gets zero frames.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.data.workloads import lm_batches
from repro_torch.launch.serve import require_device
from repro_torch.models import get_model
from repro_torch.training import init_opt_state, make_train_step
from repro_torch.training.train import tree_leaves


def main(argv=None, log=print) -> list:
    """Run the launcher; returns the loss of every step."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2_1_5b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the model (cuda or cpu)")
    args = ap.parse_args(argv)
    require_device(args.device)

    cfg = get_config(args.arch).reduced()
    api = get_model(cfg, num_aw=1, num_ew=2, device=args.device)
    params = api.init_params(
        torch.Generator(device=args.device).manual_seed(0))
    rs = api.init_route_state()
    opt = init_opt_state(params)
    step_fn = make_train_step(api, lr=args.lr)

    n_params = sum(x.numel() for x in tree_leaves(params))
    log(f"[train] {cfg.name}: {n_params/1e6:.2f}M params, "
        f"{args.steps} steps @ batch={args.batch} seq={args.seq} on "
        f"{args.device}")

    losses = []
    t0 = time.time()
    for i, batch in enumerate(lm_batches(cfg.vocab_size, args.batch,
                                         args.seq, args.steps, seed=1)):
        if cfg.is_encdec:
            batch["frames"] = np.zeros(
                (args.batch, cfg.encoder_seq, cfg.d_model), np.float32)
        params, opt, loss = step_fn(params, opt, batch, rs)
        losses.append(float(loss))
        if (i + 1) % args.log_every == 0:
            log(f"  step {i+1:4d}  loss {losses[-1]:.4f}  "
                f"({(time.time()-t0)/(i+1)*1e3:.0f} ms/step)")
    log(f"[train] loss {losses[0]:.4f} -> {losses[-1]:.4f} "
        f"({'improved' if losses[-1] < losses[0] else 'NOT improved'})")
    return losses


if __name__ == "__main__":
    main()
