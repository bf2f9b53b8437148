"""The port's training loss and gradients against the JAX package on the
CPU, float32, reduced configs, the reference's params through
``repro_torch.convert`` and seeded numpy batches: the loss
``cross_entropy(logits, labels) + aux_coef * aux`` and its gradient for
the five archs the reference trains (``test_smoke_archs.py``'s
``test_train_step_runs``), each gradient leaf (converted from the
reference's gradient tree by ``params_from_reference``) within GRAD_RTOL
of that leaf's largest magnitude, and every leaf's gradient present and
nonzero wherever the reference's is: a gradient cut anywhere on the path,
at a kernel call or an in-place write, shows here as None or zeros.
"""
import jax
import numpy as np
import pytest

from conftest import make_batch
from repro.configs import get_config as jget_config
from repro.models import get_model as jget_model
from repro.training.train import cross_entropy as jcross_entropy
from torch_threads import one_intra_op_thread  # noqa: F401
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_reference
from repro_torch.models import get_model as tget_model
from repro_torch.training.train import leaf_paths
from repro_torch.training.train import loss_and_grads

TOL = dict(rtol=1e-4, atol=1e-4)        # the loss
# a gradient leaf: max |port - reference| within GRAD_RTOL of the
# reference leaf's largest magnitude (float32 on both sides; the orders
# of summation differ)
GRAD_RTOL = 1e-3
AUX_COEF = 0.01
TRAINED = ("qwen2_1_5b", "mixtral_8x7b", "zamba2_7b", "xlstm_350m",
           "whisper_small")


def _models(arch, num_ew=2):
    jcfg, tcfg = jget_config(arch).reduced(), tget_config(arch).reduced()
    japi = jget_model(jcfg, num_aw=2, num_ew=num_ew)
    tapi = tget_model(tcfg, num_aw=2, num_ew=num_ew, device="cpu")
    jp = japi.init_params(jax.random.PRNGKey(0))
    return japi, tapi, jp, params_from_reference(jp, device="cpu")


@pytest.mark.parametrize("arch", TRAINED)
def test_loss_and_gradients_match_reference(arch):
    """mixtral_8x7b at 2 EWs: 4 experts in 4 primary and 2 shadow slots,
    so the expert banks' gradients sum over a primary and its shadow
    wherever the router sends a shadow tokens."""
    japi, tapi, jp, tp = _models(arch)
    batch = make_batch(japi.cfg, 2, 16, np.random.default_rng(5),
                       with_labels=True)
    jrs = japi.init_route_state()

    def jloss(params):
        logits, aux = japi.forward_train(params, batch, jrs)
        return jcross_entropy(logits, batch["labels"]) + AUX_COEF * aux

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jp)
    tl, tg = loss_and_grads(tapi, tp, batch, tapi.init_route_state(),
                            aux_coef=AUX_COEF)
    np.testing.assert_allclose(tl.item(), float(jl), **TOL)
    want = leaf_paths(params_from_reference(
        jax.tree_util.tree_map(np.asarray, jg), device="cpu"))
    got = leaf_paths(tg)
    assert got.keys() == want.keys()
    zero = []
    for k, w in want.items():
        g = got[k]
        assert g is not None, f"{k}: no gradient"
        assert g.shape == w.shape, k
        scale = w.abs().max().item()
        if scale == 0:
            zero.append(k)
            continue
        assert g.abs().max().item() > 0, f"{k}: zero gradient"
        err = (g - w).abs().max().item()
        assert err <= GRAD_RTOL * scale, (k, err, scale)
    # only leaves no token reaches may be zero
    assert all("experts" in k or "router" in k for k in zero), zero
