"""End-to-end training example of the port (twin of
``examples/train_lm.py``): train a ~100M-param dense model for a few
hundred steps on synthetic LM data and check that the loss goes down.

    python -m repro_torch.examples.train_lm [--steps 300] [--small] \\
        [--device cpu]

``--small`` uses the reduced Qwen2 config (seconds on the CPU); the
default builds a ~100M-parameter Qwen2-family variant. The model runs on
the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs import get_config
from repro_torch.data.workloads import lm_batches
from repro_torch.launch.serve import require_device
from repro_torch.models import get_model
from repro_torch.training import init_opt_state, make_train_step
from repro_torch.training.train import tree_leaves


def hundred_m_config():
    base = get_config("qwen2_1_5b")
    return dataclasses.replace(
        base, name="qwen2-100m", num_layers=8, d_model=512, num_heads=8,
        num_kv_heads=2, head_dim=64, d_ff=2048, vocab_size=32000)


def main(argv=None, log=print):
    """Run the example; returns (first loss, last loss)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the model (cuda or cpu)")
    args = ap.parse_args(argv)
    require_device(args.device)

    cfg = get_config("qwen2_1_5b").reduced() if args.small \
        else hundred_m_config()
    api = get_model(cfg, device=args.device)
    params = api.init_params(
        torch.Generator(device=args.device).manual_seed(0))
    rs = api.init_route_state()
    opt = init_opt_state(params)
    step_fn = make_train_step(api, lr=3e-4)

    n = sum(x.numel() for x in tree_leaves(params))
    log(f"model {cfg.name}: {n/1e6:.1f}M params")

    t0 = time.time()
    first = last = None
    for i, batch in enumerate(lm_batches(cfg.vocab_size, args.batch,
                                         args.seq, args.steps, seed=0)):
        params, opt, loss = step_fn(params, opt, batch, rs)
        loss = float(loss)
        first = first if first is not None else loss
        last = loss
        if (i + 1) % 20 == 0:
            log(f"step {i+1:4d}  loss {loss:.4f}  "
                f"{(time.time()-t0)/(i+1)*1e3:.0f} ms/step")
    log(f"loss: {first:.4f} -> {last:.4f}")
    if not last < first:
        raise RuntimeError("training did not reduce loss")
    return first, last


if __name__ == "__main__":
    main()
