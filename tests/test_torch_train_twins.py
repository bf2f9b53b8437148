"""Twins of the reference's training tests for the port, on the CPU,
float32, reduced configs, the reference's params through
``repro_torch.convert`` and seeded numpy batches:

  * ``test_smoke_archs.py``'s ``test_train_step_runs`` and
    ``test_loss_decreases``;
  * ``test_integration_extras.py``'s ``test_weight_checkpoint_roundtrip``
    (and the same for bfloat16 leaves, which numpy stores as raw bits);
  * ``test_decode_consistency.py``: the port's prefill and decode against
    the port's own ``forward_train`` at the reference's 2e-4, for every
    architecture id, and the sliding-window ring cache;
  * the training launcher and the ``train_lm`` example on the CPU.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from conftest import all_arch_ids, make_batch
from repro.configs import get_config as jget_config
from repro.models import get_model as jget_model
from torch_threads import one_intra_op_thread  # noqa: F401
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_reference
from repro_torch.examples import train_lm
from repro_torch.launch import train as train_launcher
from repro_torch.models import get_model as tget_model
from repro_torch.models.transformer import cast_floats
from repro_torch.training import init_opt_state, make_train_step
from repro_torch.training.checkpoint_io import load_params, save_params
from repro_torch.training.train import leaf_paths, tree_leaves

TOL = dict(rtol=2e-4, atol=2e-4)        # test_decode_consistency.py's


def _model(arch, num_aw=2, num_ew=2, cap_factor=0.0, **replace):
    """The port's reduced model and the reference's params for it."""
    cfgs = []
    for cfg in (jget_config(arch).reduced(), tget_config(arch).reduced()):
        if cap_factor and cfg.moe.enabled:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=cap_factor))
        cfgs.append(dataclasses.replace(cfg, **replace))
    jcfg, tcfg = cfgs
    jp = jget_model(jcfg, num_aw=num_aw, num_ew=num_ew).init_params(
        jax.random.PRNGKey(0))
    api = tget_model(tcfg, num_aw=num_aw, num_ew=num_ew, device="cpu")
    return api, params_from_reference(jp, device="cpu")


@pytest.mark.parametrize("arch", ["qwen2_1_5b", "mixtral_8x7b",
                                  "zamba2_7b", "xlstm_350m",
                                  "whisper_small"])
def test_train_step_runs(arch):
    api, params = _model(arch, num_aw=1)
    step = make_train_step(api, lr=1e-3)
    batch = make_batch(api.cfg, 2, 8, with_labels=True)
    params2, opt2, loss = step(params, init_opt_state(params), batch,
                               api.init_route_state())
    assert np.isfinite(loss.item())
    assert int(opt2.step) == 1
    assert any(not torch.equal(a, b) for a, b in
               zip(tree_leaves(params), tree_leaves(params2)))


@pytest.mark.parametrize("arch", ["qwen2_1_5b", "xlstm_350m"])
def test_loss_decreases(arch):
    api, params = _model(arch, num_aw=1, num_ew=1)
    opt = init_opt_state(params)
    step = make_train_step(api, lr=3e-3)
    batch = make_batch(api.cfg, 2, 8, with_labels=True)
    rs = api.init_route_state()
    losses = []
    for _ in range(8):
        params, opt, loss = step(params, opt, batch, rs)
        losses.append(loss.item())
    assert losses[-1] < losses[0], losses


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weight_checkpoint_roundtrip(tmp_path, dtype):
    api, params = _model("qwen2_1_5b", num_aw=1, num_ew=1, dtype=dtype)
    path = str(tmp_path / "ckpt.npz")
    save_params(path, params, step=42)
    assert not (tmp_path / "ckpt.npz.tmp").exists()
    with np.load(path) as data:
        assert "layers/1/attn/wq" in data and "__step__" in data
    loaded, step = load_params(path, params)
    assert step == 42
    assert leaf_paths(loaded).keys() == leaf_paths(params).keys()
    for a, b in zip(tree_leaves(params), tree_leaves(loaded)):
        assert a.dtype == b.dtype == api.cfg.torch_dtype
        # bit for bit (as raw bits: a bfloat16 NaN would not equal itself)
        assert torch.equal(a.view(torch.int16) if a.itemsize == 2 else a,
                           b.view(torch.int16) if b.itemsize == 2 else b)
    # into float32 leaves: each cast from the stored dtype
    as32, _ = load_params(path, cast_floats(params, torch.float32))
    for a, b in zip(tree_leaves(params), tree_leaves(as32)):
        assert b.dtype == torch.float32 and torch.equal(a.float(), b)
    rs = api.init_route_state()
    batch = {"tokens": np.arange(8, dtype=np.int32)[None]}
    l0, _ = api.forward_train(params, batch, rs)
    l1, _ = api.forward_train(loaded, batch, rs)
    assert torch.equal(l0, l1)


def test_load_params_refuses_a_wrong_shape(tmp_path):
    api, params = _model("qwen2_1_5b", num_aw=1, num_ew=1)
    path = str(tmp_path / "ckpt.npz")
    save_params(path, params)
    like = dict(params, embed=params["embed"][:-1])
    with pytest.raises(ValueError, match="embed"):
        load_params(path, like)


def _prefill(api, params, toks, rs, max_seq, frames):
    kw = {} if frames is None else {"frames": torch.from_numpy(frames)}
    return api.prefill(params, torch.from_numpy(toks), rs, max_seq, **kw)


@pytest.mark.parametrize("arch", all_arch_ids())
def test_decode_matches_teacher_forcing(arch):
    api, params = _model(arch, cap_factor=8.0)
    rs = api.init_route_state()
    b, s = 2, 10
    full = make_batch(api.cfg, b, s + 3, np.random.default_rng(3))
    toks = full["tokens"]
    logits_full, _ = api.forward_train(params, full, rs)
    last, cache, _ = _prefill(api, params, toks[:, :s], rs, s + 4,
                              full.get("frames"))
    np.testing.assert_allclose(last.numpy(), logits_full[:, s - 1].numpy(),
                               **TOL)
    # decode three steps, each must match the teacher-forced position
    for j in range(3):
        pos = torch.full((b,), s + j, dtype=torch.int32)
        lg, cache, _ = api.decode(params, torch.from_numpy(toks[:, s + j]),
                                  pos, cache, rs)
        np.testing.assert_allclose(lg.numpy(),
                                   logits_full[:, s + j].detach().numpy(),
                                   **TOL)


def test_sliding_window_ring_buffer():
    """Windowed decode with ring cache == full cache with window mask."""
    api, params = _model("h2o_danube_1_8b", num_aw=1, num_ew=1,
                         sliding_window=8)
    rs = api.init_route_state()
    batch = make_batch(api.cfg, 1, 12)
    logits_full, _ = api.forward_train(params, batch, rs)
    last, cache, _ = _prefill(api, params, batch["tokens"], rs, 32, None)
    np.testing.assert_allclose(last.numpy(),
                               logits_full[:, -1].detach().numpy(), **TOL)
    # the cache is ring-sized (the window), not max_seq
    assert cache["layers"][0]["k"].shape[1] == 8


def test_train_launcher_on_cpu():
    lines = []
    losses = train_launcher.main(["--device", "cpu", "--steps", "12",
                                  "--log-every", "4"], log=lines.append)
    assert len(losses) == 12 and losses[-1] < losses[0], losses
    assert "(improved)" in lines[-1]


def test_train_lm_example_small_on_cpu():
    first, last = train_lm.main(["--small", "--device", "cpu", "--steps",
                                 "12", "--batch", "4", "--seq", "32"],
                                log=lambda *_: None)
    assert last < first


def test_launchers_refuse_a_missing_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (train_launcher.main, train_lm.main):
        with pytest.raises(RuntimeError, match="--device cpu"):
            main(["--steps", "1"])


@pytest.mark.parametrize("arch", ["mixtral_8x7b", "zamba2_7b",
                                  "xlstm_350m", "whisper_small"])
def test_remat_gives_the_same_loss_and_gradients(arch):
    """``cfg.remat`` (the reference's ``jax.checkpoint`` of its scan
    body) wraps each layer in ``torch.utils.checkpoint``: the layers'
    activations are recomputed in the backward pass, and the loss and
    every gradient are bitwise those without it."""
    from repro_torch.training.train import loss_and_grads
    api, params = _model(arch, num_aw=1)
    rapi, _ = _model(arch, num_aw=1, remat=True)
    batch = make_batch(api.cfg, 2, 8, with_labels=True)
    rs = api.init_route_state()
    loss, grads = loss_and_grads(api, params, batch, rs, aux_coef=0.01)
    rloss, rgrads = loss_and_grads(rapi, params, batch, rs, aux_coef=0.01)
    assert torch.equal(loss, rloss)
    for a, b in zip(tree_leaves(grads), tree_leaves(rgrads)):
        assert torch.equal(a, b)
