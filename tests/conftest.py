import dataclasses
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from repro.configs import ASSIGNED_ARCHS, get_config  # noqa: E402


def reduced(name: str, cap_factor: float = 0.0):
    cfg = get_config(name).reduced()
    if cap_factor and cfg.moe.enabled:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe,
                                         capacity_factor=cap_factor))
    return cfg


@pytest.fixture(scope="session")
def key():
    return jax.random.PRNGKey(0)


def all_arch_ids():
    return list(ASSIGNED_ARCHS) + ["mixtral_8x7b"]


def make_batch(cfg, b, s, rng=None, with_labels=False):
    rng = rng or np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if with_labels:
        batch["labels"] = rng.integers(0, cfg.vocab_size,
                                       (b, s)).astype(np.int32)
    if cfg.is_encdec:
        batch["frames"] = rng.normal(size=(b, cfg.encoder_seq,
                                           cfg.d_model)).astype(np.float32)
    return batch


# --------------------------------------------------------------------------
# postmortem on test failure (serving/flightrec.py): any engine built
# during a failing test still holds its flight recorder — dump the most
# recent ones as bundles so CI can upload the incident, not just the
# traceback. Best-effort: a broken engine must never mask the failure.
# --------------------------------------------------------------------------

FLIGHTREC_DIR = os.environ.get("FLIGHTREC_DIR", "artifacts/flightrec")


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_makereport(item, call):
    outcome = yield
    report = outcome.get_result()
    if report.when != "call" or not report.failed:
        return
    try:
        from repro.serving import flightrec
        paths = flightrec.dump_live_recorders(FLIGHTREC_DIR, item.nodeid)
        if paths:
            report.sections.append(
                ("flight recorder", "postmortem bundles:\n" +
                 "\n".join(f"  {p}" for p in paths)))
    except Exception:
        pass


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc (CUDA kernels of "
        "repro_torch have no CPU mode); skips elsewhere")
