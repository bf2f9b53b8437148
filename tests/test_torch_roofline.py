"""The port's roofline against the JAX package's: ``model_flops`` for
every arch x shape, the loop multiplicity that the reference's HLO parser
works out (the op counter gets it from Python running the loop), the
analytic count of a served decode step and prefill call against the op
count of the same call on the CPU (every op an aten op), the kernel
report hook, and the dry run at both production meshes."""
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import SHAPES as J_SHAPES
from repro.roofline.analysis import model_flops as j_model_flops
from torch_threads import one_intra_op_thread  # noqa: F401
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.launch import dryrun
from repro_torch.roofline import analysis, h100, op_count
from repro_torch.roofline.analysis import model_flops, served_work
from repro_torch.serving.engine import EngineConfig, InferenceEngine

# archs without a long-context path: skipped at long_500k
NO_LONG = {"qwen2-1.5b", "qwen2-moe-a2.7b", "chameleon-34b",
           "whisper-small", "granite-34b", "kimi-k2-1t-a32b",
           "mixtral-8x7b"}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_equal_reference(arch):
    for name in SHAPES:
        assert model_flops(get_config(arch), SHAPES[name]) == \
            j_model_flops(jget_config(arch), J_SHAPES[name])


def test_model_flops_moe_uses_active_params():
    dense = get_config("qwen2_1_5b")
    moe = get_config("mixtral_8x7b")
    sh = SHAPES["decode_32k"]
    assert model_flops(moe, sh) < 6 * moe.param_count * sh.global_batch
    assert model_flops(dense, sh) == 2.0 * dense.param_count * \
        sh.global_batch


def test_op_count_loop_multiplicity():
    """The twin of the HLO parser's loop test: a 7-step loop of
    tanh(c @ w_i) counts 7 x 2 x 8 x 64 x 64 flops, on ``meta``."""
    x = torch.empty((8, 64), device="meta")
    w = torch.empty((7, 64, 64), device="meta")
    with op_count.OpCounter() as c:
        for i in range(7):
            x = torch.tanh(x @ w[i])
    assert c.flops == 7 * 2 * 8 * 64 * 64


def test_kernel_reports_only_to_an_active_counter():
    calls = []

    def work():
        calls.append(1)
        torch.ones(4).sum()          # counted neither as an op nor twice
        return 10.0, 20.0
    op_count.kernel("k", work)
    assert not calls
    with op_count.OpCounter() as c:
        op_count.kernel("k", work)
    assert calls == [1]
    assert (c.flops, c.bytes, c.kernels) == (10.0, 20.0, {"k": [1, 10.0,
                                                                20.0]})


def test_one_definition_of_the_h100_figures():
    assert analysis.PEAK_FLOPS == h100.BF16_FLOPS_PER_S == 989e12
    assert analysis.HBM_BW == h100.HBM_BYTES_PER_S == 3.35e12
    smoke = (Path(__file__).resolve().parents[1] / "chip_smoke.py") \
        .read_text()
    for literal in ("989e12", "3.35e12", "67e12", "197e12", "819e9"):
        assert literal not in smoke, literal


@pytest.fixture(scope="module", params=["mixtral_8x7b", "qwen2_1_5b"])
def served(request):
    cfg = get_config(request.param).reduced()
    if cfg.moe.enabled:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=4.0))
    eng = InferenceEngine(cfg, EngineConfig(max_batch=8, max_seq=96,
                                            num_aw=2, num_ew=2),
                          device="cpu")
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(1, cfg.vocab_size, (8, 32))
                           .astype(np.int32))
    return eng, toks


def _live_slots(eng):
    # the plain expert FFN computes every slot at capacity (the kernel
    # only the slots with a token)
    return eng.api.placement.num_slots if eng.cfg.moe.enabled else None


def test_analytic_count_matches_the_op_count_of_a_prefill_call(served):
    """Flops: the op count within +0/10% of the analytic count (the plain
    blockwise attention computes masked pairs too). Bytes: the analytic
    count is the floor (each leaf read once); the plain versions write and
    read every intermediate, 30-70x that floor here."""
    eng, toks = served
    cap = eng.prefill_capacity(toks.numel())
    with op_count.OpCounter() as c:
        eng.api.prefill(eng.params, toks, eng.route_state, 96, capacity=cap)
    w = served_work(eng, "prefill", rows=8, seq=32, capacity=cap,
                    live_slots=_live_slots(eng))
    assert 1.0 <= c.flops / w.flops <= 1.10
    assert 1.0 <= c.bytes / w.hbm_bytes <= 100


def test_analytic_count_matches_the_op_count_of_a_decode_step(served):
    """Flops as for prefill (the plain decode attention runs over every
    cache slot, the analytic count over the valid keys); bytes: the floor
    again, 3-10x below the op count here."""
    eng, toks = served
    _, cache, _ = eng.api.prefill(eng.params, toks, eng.route_state, 96)
    pos = torch.full((8,), 32, dtype=torch.int32)
    with op_count.OpCounter() as c:
        eng.api.decode(eng.params, torch.zeros(8, dtype=torch.int32), pos,
                       cache, eng.route_state)
    w = served_work(eng, "decode", rows=8, ctx=[33] * 8,
                    live_slots=_live_slots(eng))
    assert 1.0 <= c.flops / w.flops <= 1.10
    assert 1.0 <= c.bytes / w.hbm_bytes <= 100


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16",
                                                          "2x16x16"])
def test_dry_run_all_cases(multi_pod, tmp_path, capsys):
    """``--all --include-paper-model``: 37 ok, the 7 archs without a
    long-context path skipped at long_500k, 0 errors; the JSON written."""
    out = tmp_path / "dryrun.json"
    dryrun.main(["--all", "--include-paper-model", "--json", str(out)] +
                (["--multi-pod"] if multi_pod else []))
    assert "dry-run: 37 ok, 7 skipped (documented), 0 errors" in \
        capsys.readouterr().out
    results = json.loads(out.read_text())
    assert len(results) == 44
    skipped = {r["name"] for r in results if r["status"] == "skipped"}
    assert skipped == {f"{a}:long_500k" for a in NO_LONG}
    for r in results:
        if r["status"] == "ok":
            assert r["chips"] == (512 if multi_pod else 256)
            assert r["mesh"] == ("2x16x16" if multi_pod else "16x16")
            assert r["dominant"] in ("compute", "memory", "collective")
            assert r["hlo_flops"] > 0 and r["mem_per_device_bytes"] > 0
