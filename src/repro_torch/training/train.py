"""Training substrate (port of ``repro.training.train``): the
cross-entropy LM loss and AdamW with bfloat16 moments.

The params are the port's plain tree of dicts and lists of tensors; the
optimizer walks it leaf by leaf in the tree's order. A train step is
``forward_loss`` (the model's ``forward_train``, cross-entropy plus
``aux_coef`` times the router's aux loss), ``torch.autograd.grad`` of the
loss, then ``adamw_update`` in the reference's order: the float32 global
norm over every gradient, the clip scale, the bias corrections from
step + 1, the update in float32, the params cast back to their dtype and
the moments to bfloat16. Weight decay applies to every leaf, as in the
reference.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple

import torch

from repro_torch.convert import tree_map


def leaf_paths(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Every tensor of a nested dict/list/tuple keyed by its path, joined
    with "/", in the tree's order."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(leaf_paths(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a nested dict/list/tuple, in the tree's order."""
    return list(leaf_paths(tree).values())


def tree_unflatten(like, leaves):
    """``leaves`` (in ``tree_leaves`` order) in the structure of
    ``like``."""
    it = iter(leaves)
    return tree_map(like, lambda _: next(it))


class AdamWState(NamedTuple):
    mu: Any                 # first moments, bfloat16, the params' tree
    nu: Any                 # second moments, bfloat16
    step: torch.Tensor      # int32 scalar: steps taken


def init_opt_state(params) -> AdamWState:
    leaves = tree_leaves(params)

    def zeros():
        return tree_unflatten(params, [
            torch.zeros(p.shape, dtype=torch.bfloat16, device=p.device)
            for p in leaves])
    return AdamWState(zeros(), zeros(),
                      torch.zeros((), dtype=torch.int32,
                                  device=leaves[0].device))


def cross_entropy(logits, labels):
    """logits: [B, S, V]; labels: [B, S] int -> the mean NLL in
    float32, through logsumexp."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(lse - gold)


def forward_loss(api, params, batch, route_state, *, aux_coef: float):
    """Grad mode must be on. Returns (loss, leaves): the loss of
    ``api.forward_train`` on ``batch`` (its "labels" the next tokens) over
    copies of the params that require grad, and those copies (in
    ``tree_leaves`` order), which ``torch.autograd.grad`` takes."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    logits, aux = api.forward_train(tree_unflatten(params, leaves), batch,
                                    route_state)
    labels = torch.as_tensor(batch["labels"], device=logits.device)
    return cross_entropy(logits, labels) + aux_coef * aux, leaves


def loss_and_grads(api, params, batch, route_state, *, aux_coef: float):
    """(loss, gradient tree): a leaf the loss does not reach has None."""
    with torch.enable_grad():
        loss, leaves = forward_loss(api, params, batch, route_state,
                                    aux_coef=aux_coef)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), tree_unflatten(params, list(grads))


def adamw_update(params, grads, opt: AdamWState, *, lr: float,
                 beta1: float, beta2: float, eps: float,
                 weight_decay: float, clip: float):
    """One AdamW update of every leaf. ``grads`` is a tree like params or
    a list in ``tree_leaves`` order; None counts as a zero gradient.
    Returns (new params, new AdamWState)."""
    flat_p = tree_leaves(params)
    flat_g = grads if isinstance(grads, list) else tree_leaves(grads)
    flat_g = [torch.zeros_like(p) if g is None else g
              for p, g in zip(flat_p, flat_g)]
    with torch.no_grad():
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                               for g in flat_g))
        scale = torch.clamp(clip / torch.clamp(gnorm, min=1e-9), max=1.0)
        step = opt.step + 1
        bc1 = 1.0 - beta1 ** step.float()
        bc2 = 1.0 - beta2 ** step.float()
        new_p, new_m, new_v = [], [], []
        for p, g, m, v in zip(flat_p, flat_g, tree_leaves(opt.mu),
                              tree_leaves(opt.nu)):
            g = g.float() * scale
            m32 = beta1 * m.float() + (1 - beta1) * g
            v32 = beta2 * v.float() + (1 - beta2) * g * g
            mh = m32 / bc1
            vh = v32 / bc2
            delta = lr * (mh / (torch.sqrt(vh) + eps) +
                          weight_decay * p.float())
            new_p.append((p.float() - delta).to(p.dtype))
            new_m.append(m32.to(torch.bfloat16))
            new_v.append(v32.to(torch.bfloat16))
    return tree_unflatten(params, new_p), AdamWState(
        tree_unflatten(params, new_m), tree_unflatten(params, new_v), step)


def make_train_step(api, *, lr: float = 3e-4, beta1: float = 0.9,
                    beta2: float = 0.95, eps: float = 1e-8,
                    weight_decay: float = 0.1, aux_coef: float = 0.01,
                    clip: float = 1.0):
    """The reference's train step, with its defaults: ``step(params, opt,
    batch, route_state) -> (params, opt, loss)``."""
    def train_step(params, opt: AdamWState, batch, route_state):
        loss, grads = loss_and_grads(api, params, batch, route_state,
                                     aux_coef=aux_coef)
        params, opt = adamw_update(params, grads, opt, lr=lr, beta1=beta1,
                                   beta2=beta2, eps=eps,
                                   weight_decay=weight_decay, clip=clip)
        return params, opt, loss

    return train_step
