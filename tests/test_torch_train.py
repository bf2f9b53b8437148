"""The port's training path against the JAX package on the CPU, float32,
reduced configs, fed the reference's params through ``repro_torch.convert``
and seeded numpy batches:

  * ``forward_train``'s logits and aux loss for every architecture id of
    the reference's tests (the twin of ``test_smoke_archs.py``'s
    ``test_forward_shapes_no_nans``) against ``jax.jit(api.forward_train)``;
  * the AdamW update alone: both packages' train steps given the same
    gradients (a model whose loss is sum(p * G) gives gradient G) agree
    on the new params and both bfloat16 moments, and count one step;
  * ``KernelWithPlainGrad``, the autograd Function a CUDA kernel call
    goes through when it needs a gradient, with the plain versions in the
    kernels' place: its gradients equal autograd's of the plain version
    (flash, the expert FFN with shadow slots, the SSD scan);
  * ``expert_io``'s scatter and gather against the reference's one-hot
    contraction, gradients included, and the row-blocked projection's
    backward.

The loss and gradient parity is in ``test_torch_train_grads.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import all_arch_ids, make_batch
from repro.configs import get_config as jget_config
from repro.models import get_model as jget_model
from repro.training import init_opt_state as jinit_opt_state
from repro.training import make_train_step as jmake_train_step
from repro.training.train import cross_entropy as jcross_entropy
from torch_threads import one_intra_op_thread  # noqa: F401
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_reference
from repro_torch.kernels import ops
from repro_torch.kernels.moe_gemm import expert_ffn_plain
from repro_torch.kernels.ref import ssm_scan_chunked_ref
from repro_torch.models import get_model as tget_model
from repro_torch.models.attention import blockwise_attention
from repro_torch.training import init_opt_state, make_train_step
from repro_torch.training.train import cross_entropy, leaf_paths, tree_leaves

# logits and aux: the tolerance of the earlier parity tests
TOL = dict(rtol=1e-4, atol=1e-4)


def _models(arch, num_ew=2):
    jcfg, tcfg = jget_config(arch).reduced(), tget_config(arch).reduced()
    japi = jget_model(jcfg, num_aw=2, num_ew=num_ew)
    tapi = tget_model(tcfg, num_aw=2, num_ew=num_ew, device="cpu")
    jp = japi.init_params(jax.random.PRNGKey(0))
    return japi, tapi, jp, params_from_reference(jp, device="cpu")


@pytest.mark.parametrize("arch", all_arch_ids())
def test_forward_train_matches_reference(arch):
    japi, tapi, jp, tp = _models(arch)
    batch = make_batch(japi.cfg, 2, 16)
    jl, jaux = jax.jit(japi.forward_train)(jp, batch,
                                          japi.init_route_state())
    tl, taux = tapi.forward_train(tp, batch, tapi.init_route_state())
    assert tl.shape == (2, 16, japi.cfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(taux.item(), float(jaux), **TOL)
    assert (taux.item() > 0) == japi.cfg.moe.enabled


class _GradientModel:
    """A model whose loss is sum over leaves of sum(p * G): its gradient
    is G. Logits are constant (cross-entropy contributes none)."""

    def __init__(self, leaves, grads, zeros, to_logits):
        self.leaves, self.grads = leaves, grads
        self.zeros, self.to_logits = zeros, to_logits

    def forward_train(self, params, batch, route_state):
        aux = sum((p * g).sum() for p, g in zip(self.leaves(params),
                                                self.grads))
        return self.to_logits(self.zeros), aux


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(dtype):
    """Both packages' train steps at aux_coef 1 on the same params and
    gradients: the params within one ulp of their dtype, or 8 float32 ulps
    of the unit step times lr where p - delta cancels (the global norm
    sums leaves in another order, so the normalised step m / sqrt(v)
    differs in its last bits), both bfloat16 moments within one bf16 ulp,
    and the step counter at 1."""
    arch = "mixtral_8x7b"
    japi, tapi, jp, _ = _models(arch)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jp = jax.tree_util.tree_map(lambda a: a.astype(jdt), jp)
    rng = np.random.default_rng(11)
    jg = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.normal(0, 1e-2, a.shape).astype(np.float32)
                              ).astype(jdt), jp)
    tp = params_from_reference(jp, device="cpu")
    tgrads = tree_leaves(params_from_reference(jg, device="cpu"))
    batch = {"tokens": np.zeros((1, 1), np.int32),
             "labels": np.zeros((1, 1), np.int32)}
    v = japi.cfg.vocab_size

    zeros = np.zeros((1, 1, v), np.float32)
    jmodel = _GradientModel(jax.tree_util.tree_leaves,
                            jax.tree_util.tree_leaves(jg), zeros,
                            jnp.asarray)
    tmodel = _GradientModel(tree_leaves, tgrads, zeros, torch.from_numpy)
    hp = dict(lr=1e-3, aux_coef=1.0)
    jp2, jopt, jloss = jax.jit(jmake_train_step(jmodel, **hp))(
        jp, jinit_opt_state(jp), batch, japi.init_route_state())
    tp2, topt, tloss = make_train_step(tmodel, **hp)(
        tp, init_opt_state(tp), batch, tapi.init_route_state())
    assert int(jopt.step) == 1 and int(topt.step) == 1
    # the loss sums bfloat16 products in another order
    np.testing.assert_allclose(tloss.item(), float(jloss),
                               rtol={"float32": 1e-5, "bfloat16": 1e-3}[dtype])
    ulp = {"float32": 2.0 ** -23, "bfloat16": 2.0 ** -7}
    for name, jt, tt, dt, atol in (
            ("params", jp2, tp2, dtype, hp["lr"] * 2.0 ** -20),
            ("mu", jopt.mu, topt.mu, "bfloat16", 1e-30),
            ("nu", jopt.nu, topt.nu, "bfloat16", 1e-30)):
        want = leaf_paths(params_from_reference(jt, device="cpu"))
        got = leaf_paths(tt)
        for k, w in want.items():
            g = got[k]
            assert g.dtype == w.dtype, (name, k)
            w, g = w.float(), g.float()
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=ulp[dt],
                                       atol=atol, err_msg=f"{name} {k}")
    # every float32 param moved by about lr (its gradient is nonzero; a
    # bfloat16 norm scale of 1 keeps its value: lr is below half its ulp)
    if dtype == "float32":
        for k, w in leaf_paths(tp).items():
            assert not torch.equal(leaf_paths(tp2)[k], w), k


# ---------------------------------------------------------------------------
# KernelWithPlainGrad with the plain versions in the kernels' place
# ---------------------------------------------------------------------------

def _plain_kernel_grads(kernel, grads, inputs, dout):
    """Gradients through KernelWithPlainGrad (``kernel`` forward) and
    through plain autograd of ``kernel``, for every floating input."""
    def run(fn):
        leaves = [t.detach().requires_grad_() if t is not None and
                  t.is_floating_point() else t for t in inputs]
        out = fn(*leaves)
        outs = out if isinstance(out, tuple) else (out,)
        loss = sum((o.float() * d).sum() for o, d in zip(outs, dout))
        loss.backward()
        return outs, [t.grad for t in leaves
                      if t is not None and t.is_floating_point()]
    got = run(lambda *t: ops.KernelWithPlainGrad.apply(kernel, grads, *t))
    want = run(kernel)
    return got, want


def _assert_same(got, want, tol):
    (go, gg), (wo, wg) = got, want
    for a, b in zip(go + tuple(gg), wo + tuple(wg)):
        assert a is not None and b is not None
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=tol, atol=tol)


def test_plain_grad_function_flash():
    g = torch.Generator().manual_seed(0)
    b, s, h, hkv, dh = 2, 24, 4, 2, 16
    q = torch.randn((b, s, h, dh), generator=g)
    k, v = (torch.randn((b, s, hkv, dh), generator=g) for _ in range(2))
    pos = torch.arange(s, dtype=torch.int32).expand(b, s).clone()
    pos[1, 20:] = -1                               # pad tail

    def kernel(q, k, v, qp, kp):
        return blockwise_attention(q, k, v, qp, kp, window=8)

    def plain(q, k, v, qp, kp):
        return blockwise_attention(q, k, v, qp, kp, window=8, block_q=s,
                                   block_k=s)
    dout = [torch.randn((b, s, h, dh), generator=g)]
    _assert_same(*_plain_kernel_grads(
        kernel, lambda *a: ops.plain_grads(plain, *a),
        [q, k, v, pos, pos], dout), 1e-5)


def test_plain_grad_function_expert_ffn_with_shadows():
    """Six slots over four experts: slots 4 and 5 shadow experts 1 and 0,
    slot 3 gets no token; the bank's gradient sums each expert's slots."""
    g = torch.Generator().manual_seed(1)
    p, c, d, f, e = 6, 5, 16, 24, 4
    x = torch.randn((p, c, d), generator=g)
    wg, wu = (torch.randn((e, d, f), generator=g) * 0.2 for _ in range(2))
    wd = torch.randn((e, f, d), generator=g) * 0.2
    se = torch.tensor([0, 1, 2, 3, 1, 0], dtype=torch.int32)
    cnt = torch.tensor([5, 3, 1, 0, 2, 4], dtype=torch.int32)

    def kernel(x, wg, wu, wd, se, cnt):
        return expert_ffn_plain(x, wg, wu, wd, se, cnt)
    dout = [torch.randn((p, c, d), generator=g)]
    got, want = _plain_kernel_grads(
        kernel, lambda *a: ops._expert_ffn_grads(*a, act="silu"),
        [x, wg, wu, wd, se, cnt], dout)
    _assert_same(got, want, 1e-5)
    assert got[1][0][3].abs().max() == 0             # slot 3: no token
    assert got[1][1][3].abs().max() == 0             # expert 3: slot 3 only


def test_plain_grad_function_expert_ffn_bf16_rounds_once():
    """bf16 inputs: the backward recomputes each slot in float32 and sums
    a shadowed expert's slots in float32, so every gradient is the
    float32 plain version's on the inputs upcast, rounded once to bf16
    (rtol 2^-8 covers one rounding; atol 1e-6 of the tensor's RMS covers
    float32 summation order). The output cotangent is bf16-exact, so the
    cast of the output adds no rounding of its own."""
    g = torch.Generator().manual_seed(4)
    p, c, d, f, e = 6, 5, 16, 24, 4
    x = torch.randn((p, c, d), generator=g).bfloat16()
    wg, wu = ((torch.randn((e, d, f), generator=g) * 0.2).bfloat16()
              for _ in range(2))
    wd = (torch.randn((e, f, d), generator=g) * 0.2).bfloat16()
    se = torch.tensor([0, 1, 2, 3, 1, 0], dtype=torch.int32)
    cnt = torch.tensor([5, 3, 1, 0, 2, 4], dtype=torch.int32)

    def kernel(x, wg, wu, wd, se, cnt):
        return expert_ffn_plain(x, wg, wu, wd, se, cnt)
    dout = [torch.randn((p, c, d), generator=g).bfloat16().float()]
    got, _ = _plain_kernel_grads(
        kernel, lambda *a: ops._expert_ffn_grads(*a, act="silu"),
        [x, wg, wu, wd, se, cnt], dout)
    _, want = _plain_kernel_grads(
        kernel, lambda *a: ops._expert_ffn_grads(*a, act="silu"),
        [t.float() if t.is_floating_point() else t
         for t in (x, wg, wu, wd, se, cnt)], dout)
    (go, gg), (wo, wg32) = got, want
    for a, b in zip(go + tuple(gg), wo + tuple(wg32)):
        assert a.dtype == torch.bfloat16
        rms = float(b.detach().square().mean().sqrt())
        np.testing.assert_allclose(a.float().detach().numpy(),
                                   b.detach().numpy(), rtol=2 ** -8,
                                   atol=1e-6 * rms)


def test_plain_grad_function_ssm_scan():
    g = torch.Generator().manual_seed(2)
    b, s, h, p, n = 2, 16, 3, 4, 5
    x = torch.randn((b, s, h, p), generator=g)
    dt = torch.nn.functional.softplus(torch.randn((b, s, h), generator=g))
    a = -torch.exp(torch.randn((h,), generator=g) * 0.5)
    bm, cm = (torch.randn((b, s, n), generator=g) * 0.3 for _ in range(2))

    def kernel(*t):
        return ssm_scan_chunked_ref(*t, chunk=4)
    dout = [torch.randn((b, s, h, p), generator=g),
            torch.randn((b, h, p, n), generator=g)]
    _assert_same(*_plain_kernel_grads(
        kernel, lambda *t: ops.plain_grads(kernel, *t), [x, dt, a, bm, cm],
        dout), 1e-5)


def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(2, 5, 33)).astype(np.float32) * 4
    labels = rng.integers(0, 33, (2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels)
                      ).item(),
        float(jcross_entropy(jnp.asarray(logits), jnp.asarray(labels))),
        rtol=1e-6)


def test_expert_io_gradient_matches_the_onehot_contraction():
    """``expert_io``'s indexed scatter and gather against the reference's
    one-hot dispatch and combine contraction (``routing_onehots``), at a
    capacity of 2 that drops choices: the same output and the same
    gradients for the tokens and the router (through the gate weights);
    a token whose every choice was dropped gets exactly zero."""
    from repro_torch.core import ert, refe
    g = torch.Generator().manual_seed(4)
    t, d, e = 24, 8, 4
    placement = ert.default_placement(e, 2, -1)
    rs = refe.RouteState.healthy(placement, 1, device="cpu")
    w = torch.randn((d, d), generator=g)

    def run(combine):
        x = torch.randn((t, d), generator=torch.Generator().manual_seed(5))
        x.requires_grad_()
        router = torch.randn((d, e), generator=torch.Generator().manual_seed(
            6)).requires_grad_()
        routing = refe.route(x, x @ router, rs, placement, top_k=2,
                             capacity_factor=1.0, capacity=2)
        y = combine(x, routing)
        (y * torch.linspace(-1, 1, t * d).reshape(t, d)).sum().backward()
        return y, x.grad, router.grad, routing["keep"]

    def scatter(x, routing):
        return refe.expert_io(x, routing, lambda a: torch.tanh(a @ w))

    def onehot(x, routing):
        dispatch, comb = refe.routing_onehots(routing)
        expert_in = torch.einsum("tpc,td->pcd", dispatch, x)
        return torch.einsum("tpc,pcd->td", comb, torch.tanh(expert_in @ w))

    y1, gx1, gr1, keep = run(scatter)
    y2, gx2, gr2, _ = run(onehot)
    for a, b in ((y1, y2), (gx1, gx2), (gr1, gr2)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-5, atol=1e-6)
    dropped = ~keep.any(1)
    assert dropped.any() and keep.any()
    assert gx1[dropped].abs().max() == 0
    assert gr1.abs().max() > 0


def test_row_blocked_gradient():
    """The row-blocked projection (fixed 128-row blocks, the last padded
    with zeros) has the unblocked call's gradient, at a row count that
    is not a multiple of the block."""
    from repro_torch.models.layers import matmul
    g = torch.Generator().manual_seed(7)
    x = torch.randn((3, 100, 16), generator=g, requires_grad=True)
    w = torch.randn((16, 24), generator=g, requires_grad=True)
    dy = torch.randn((3, 100, 24), generator=g)
    got = torch.autograd.grad(matmul(x, w, True), (x, w), dy)
    want = torch.autograd.grad(x @ w, (x, w), dy)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5)
