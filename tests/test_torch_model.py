"""Reduced Mixtral-8x7B: the port's decoder, fed the reference's params
through ``repro_torch.convert``, against the JAX decoder — prefill and
decode logits to 1e-4 in float32, and the caches they write."""
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import selfheal as jheal
from repro.models import get_model as jget_model
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_reference
from repro_torch.core import selfheal as theal
from repro_torch.models import get_model as tget_model

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def models():
    jcfg = jget_config("mixtral_8x7b").reduced()
    tcfg = tget_config("mixtral_8x7b").reduced()
    japi = jget_model(jcfg, num_aw=2, num_ew=2)
    tapi = tget_model(tcfg, num_aw=2, num_ew=2, device="cpu")
    jparams = japi.init_params(jax.random.PRNGKey(0))
    return japi, tapi, jparams, params_from_reference(jparams)


def test_configs_match():
    j = jget_config("mixtral_8x7b")
    t = tget_config("mixtral_8x7b")
    for cfg_j, cfg_t in ((j, t), (j.reduced(), t.reduced())):
        for f in ("num_layers", "d_model", "num_heads", "num_kv_heads",
                  "head_dim_", "vocab_size", "rope_theta", "norm_eps",
                  "tie_embeddings", "dtype", "param_count"):
            assert getattr(cfg_t, f) == getattr(cfg_j, f), f
        assert cfg_t.moe.__dict__ == cfg_j.moe.__dict__


def test_own_init_matches_reference_shapes(models):
    """The port's seeded init (used on the card, which has no JAX) draws
    the same shapes at the same scales as the reference's."""
    japi, tapi, _, tp = models
    own = tapi.init_params(torch.Generator().manual_seed(0))

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [shapes(v) for v in tree]
        return (tuple(tree.shape), tree.dtype)

    assert shapes(own) == shapes(tp)
    for name in ("wq", "wo"):
        a = own["layers"][0]["attn"][name].std().item()
        b = tp["layers"][0]["attn"][name].std().item()
        assert abs(a - b) / b < 0.1, name
    a = own["layers"][1]["moe"]["experts"]["wd"].std().item()
    b = tp["layers"][1]["moe"]["experts"]["wd"].std().item()
    assert abs(a - b) / b < 0.1


@pytest.mark.parametrize("fail_ew", [None, 0])
def test_prefill_and_decode_logits(models, fail_ew):
    japi, tapi, jparams, tparams = models
    jrs, trs = japi.init_route_state(), tapi.init_route_state()
    if fail_ew is not None:
        jrs, trs = jheal.fail_ew(jrs, fail_ew), theal.fail_ew(trs, fail_ew)
    r = np.random.default_rng(1)
    b, s, max_seq = 4, 16, 40
    toks = r.integers(0, 512, (b, s)).astype(np.int32)
    mask = np.ones((b, s), bool)
    mask[1, 11:] = False                 # a padded prompt
    jl, jc = jax.jit(japi.prefill, static_argnames=("max_seq", "capacity"))(
        jparams, {"tokens": jnp.asarray(toks), "mask": jnp.asarray(mask)},
        jrs, max_seq=max_seq, capacity=32)
    tl, tc, _ = tapi.prefill(tparams, torch.from_numpy(toks), trs, max_seq,
                             capacity=32, mask=torch.from_numpy(mask))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    jdec = jax.jit(japi.decode, static_argnames=("capacity",))
    pos = np.array([s, s, -1, s], np.int32)   # row 2 idles this step
    for step in range(3):
        nt = r.integers(0, 512, (b,)).astype(np.int32)
        jl, jc = jdec(jparams, jnp.asarray(nt), jnp.asarray(pos), jc, jrs)
        tl, tc, _ = tapi.decode(tparams, torch.from_numpy(nt),
                                torch.from_numpy(pos), tc, trs)
        live = pos >= 0
        np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                                   **TOL)
        pos = np.where(live, pos + 1, pos)
    for i, layer in enumerate(tc["layers"]):
        jlayer = {k: np.asarray(v[i]) for k, v in jc["blocks"][0].items()}
        np.testing.assert_array_equal(layer["pos"].numpy(), jlayer["pos"])
        np.testing.assert_allclose(layer["k"].numpy(), jlayer["k"], **TOL)
        np.testing.assert_allclose(layer["v"].numpy(), jlayer["v"], **TOL)


def test_port_imports_neither_jax_nor_reference():
    """The serving stack of the port runs on a machine without JAX."""
    code = ("import sys; import repro_torch.serving.engine, "
            "repro_torch.convert, repro_torch.kernels.ops; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')); print(bad); "
            "sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_port_sources_name_no_jax():
    """No module of the port, nor chip_smoke.py, imports JAX or the
    reference package."""
    files = list((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    for f in files:
        for line in f.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                mod = s.split()[1].split(".")[0]
                assert mod not in ("jax", "jaxlib", "repro"), f"{f}: {s}"
