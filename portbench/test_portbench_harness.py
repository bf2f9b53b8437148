"""CPU tests of the port's benchmark: names resolve, traffic is fixed by
the seed, the window arithmetic, a whole run at a tiny size against the
reference, the control and a planted fault failing the check, and the
imports a run may never make. Tests that need the card have none here:
every run below is on the CPU at a tiny size."""
import ast
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

from portbench import (  # noqa: E402
    check, generator, harness, model, runner, work)

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}

# a tiny Mixtral-family model (the registry's reduced variant) in float32,
# 8 slots, and a short closed loop
TINY_CONFIG = {"port_reduced": True, "hidden_size": 128,
               "intermediate_size": 64, "num_attention_heads": 4,
               "num_key_value_heads": 4, "head_dim": 32,
               "num_hidden_layers": 2, "num_local_experts": 4,
               "vocab_size": 512, "torch_dtype": "float32",
               "engine": {"max_batch": 8, "max_seq": 256}}
TINY_TRAFFIC = {
    "loop": {"clients": 6},
    "prompt": [{"weight": 1.0, "dist": "lognormal", "mu": 3.0,
                "sigma": 0.5, "min": 4, "max": 32}],
    "output": [{"weight": 1.0, "dist": "uniform", "min": 40, "max": 120}],
    "steady_start": {
        "context": [{"weight": 1.0, "dist": "uniform", "min": 33,
                     "max": 64}],
        "residual": [{"weight": 1.0, "dist": "uniform", "min": 1,
                      "max": 120}]}}
TINY_LIMIT = 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_run(cell, seconds=1.5, **kw):
    traffic = dict(TINY_TRAFFIC)
    if "aw_fail" in cell:
        traffic["warm_failover"] = {"kind": "aw", "worker": 0,
                                    "requests": 2, "prompt": 8, "output": 6}
    kw.setdefault("log", lambda *_: None)
    return runner.run_cell(
        cell, 4_000_000_007, seconds, False, t_start=time.perf_counter(),
        device="cpu",
        overrides={"config": TINY_CONFIG, "traffic": traffic,
                   "cell": {"check": {"limit": TINY_LIMIT}}}, **kw)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_names_resolve(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    spec = harness.load_cell(cell)
    assert (spec["config"], spec["traffic"]) == (entry["config"],
                                                 entry["traffic"])
    conf = model.load_config(spec["config"])
    listed = next(c for c in BENCH["configs"] if c["name"] == conf["name"])
    assert listed["file"] == f"portbench/configs/{conf['name']}.json"
    assert listed["reduced"] == conf["reduced"]
    generator.load_mix(spec["traffic"])
    for m in harness.cell_metrics(BENCH, cell, False) + \
            harness.cell_metrics(BENCH, cell, True):
        assert callable(harness.load_reader(m["name"]))


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_config_widths_are_the_ports(name):
    conf = model.load_config(name)
    cfg = model.port_config(conf)
    assert cfg.num_layers == conf["num_hidden_layers"]
    assert cfg.torch_dtype == torch.bfloat16
    published = conf["published"]
    for key in conf["reduced"]:
        assert key in published and published[key] != conf[key]


@pytest.mark.parametrize("mix", sorted(p.stem for p in
                                       (ROOT / "portbench" / "traffic")
                                       .glob("*.json")))
def test_traffic_is_fixed_by_the_seed(mix):
    spec = generator.load_mix(mix)
    a = generator.make_requests(spec, 2 ** 40 + 7, 30.0, 32000)
    b = generator.make_requests(spec, 2 ** 40 + 7, 30.0, 32000)
    c = generator.make_requests(spec, 11, 30.0, 32000)

    def flat(t):
        qs = [r for q in t["clients"] for r in q] if "clients" in t \
            else t["arrivals"]
        return [(r.rid, r.prompt.tolist(), r.max_new,
                 r.rid.endswith("-0")) for r in qs]
    assert flat(a) == flat(b)
    # another seed: the same amount of work in another order
    for part in (True, False):
        for work_of in (lambda x: len(x[1]), lambda x: x[2]):
            assert sorted(work_of(x) for x in flat(a) if x[3] == part) == \
                sorted(work_of(x) for x in flat(c) if x[3] == part)
    assert flat(a) != flat(c)


def test_stratified_lengths_follow_the_law():
    law = [{"weight": 1.0, "dist": "uniform", "min": 2048, "max": 4096}]
    got = generator.lengths(law, 1000, generator.rng_for(3, 2))
    assert min(got) >= 2048 and max(got) <= 4096
    assert abs(np.mean(got) - 3072) < 3
    law = [{"weight": 1.0, "dist": "lognormal", "mu": 5.0, "sigma": 1.0,
            "min": 4, "max": 512}]
    got = generator.lengths(law, 1001, generator.rng_for(3, 2))
    assert sorted(got)[500] == int(np.exp(5.0))


def _run_with(stamps, t_open=10.0, seconds=10.0):
    run = harness.Run("x", {}, model.load_config("mixtral-8x7b.16of32"),
                      {"loop": {"kind": "closed"}}, 0, seconds, False)
    run.t_open, run.t_close = t_open, t_open + seconds
    for rid, ts in stamps.items():
        run.reqs[rid] = harness.Served(rid, np.zeros(4, np.int32), 9, 0.0,
                                       stamps=list(ts))
    return run


def test_gaps_percentile_and_failover_stall_arithmetic():
    run = _run_with({"a": [9.5, 10.5, 11.0, 12.0, 21.0],
                     "b": [10.2, 10.4, 15.0],
                     "v": [14.0, 14.1, 16.5, 16.6]})
    # gaps with both tokens inside (10, 20]
    assert sorted(run.gaps()) == pytest.approx(
        sorted([0.5, 1.0, 0.2, 4.6, 0.1, 2.4, 0.1]))
    assert run.window_tokens() == 3 + 3 + 4
    assert harness.percentile([1, 2, 3, 4], 50) == 2.5
    run.failures = [harness.Failure("aw", 0, 15.0, ["v", "b"], t_detect=16.0)]
    # v: next token after the detection at 16.5; b: none, so to the close
    assert run.victim_stalls() == pytest.approx([1.5, 5.0])
    read = harness.load_reader("failover_stall_ms")
    assert read(run) == pytest.approx(3250.0)
    assert harness.load_reader("failover_stall_max_ms")(run) == \
        pytest.approx(5000.0)
    assert harness.load_reader("tbt_p50_ms")(run) == pytest.approx(500.0)
    # restores are counted only where the detecting tick restored bytes
    run.failures[0].tick_s, run.failures[0].restored_bytes = 1.25, 2 ** 21
    run.failures.append(harness.Failure("aw", 1, 18.0, [], t_detect=18.1,
                                        tick_s=0.001))
    assert harness.load_reader("restore_ms")(run) == pytest.approx(1250.0)
    assert harness.load_reader("restored_mib")(run) == pytest.approx(2.0)


def test_work_formulas_at_mixtral_widths():
    s = work.Shapes.of(model.load_config("mixtral-8x7b.16of32"))
    # 16 layers x 8 experts x gate, up and down at 4096 x 14336 in bf16
    assert s.layers * s.experts * s.expert_params * 2 == 45_097_156_608
    t = s.layers * work.ffn_call_seconds(s, 64, s.experts)
    assert t == pytest.approx(45_097_156_608 / 3.35e12, rel=1e-3)
    # one row at 1,000 keys: K and V of 8 heads x 128 in bf16 a key
    assert work.decode_attn_call_seconds(s, 1, 1000) == pytest.approx(
        (1000 * 8 * 128 * 4 + 32 * 128 * 4) / 3.35e12)


def test_tiny_run_is_correct_against_the_reference():
    res, lines = tiny_run("mixtral16.longgen.closed64")
    assert res["correct"], lines
    assert res["compared"]["tokens_compared"]["value"] > 50
    assert set(res["metrics"]) == {"output_tokens_per_s", "tbt_p50_ms",
                                   "setup_s"}
    assert list(res)[-1] == "compared"


def test_tiny_open_loop_run_is_correct():
    res, lines = runner.run_cell(
        "mixtral16.longgen.closed64", 77, 2.0, False,
        t_start=time.perf_counter(), device="cpu", log=lambda *_: None,
        overrides={"config": TINY_CONFIG, "cell": {"check": {"limit":
                                                             TINY_LIMIT}},
                   "traffic": {**TINY_TRAFFIC, "steady_start": None,
                               "loop": {"kind": "open", "rate_rps": 8.0}}})
    assert res["correct"], lines
    assert res["attempted"] >= 8


def test_tiny_failure_run_checks_restored_victims():
    res, lines = tiny_run("mixtral16.longgen.closed32.aw_fail", seconds=3.0)
    assert res["correct"], lines
    assert "failover_stall_ms" in res["metrics"]


def test_control_fails_the_check():
    res, lines = tiny_run("mixtral16.longgen.closed64", control=True)
    assert not res["correct"], lines
    assert res["compared"]["mean_logit_gap"]["value"] > 3 * TINY_LIMIT


def test_sample_adds_extra_requests_once():
    finished = {"a": (np.zeros(3), [1] * 9), "b": (np.zeros(3), [1] * 5),
                "c": (np.zeros(3), [1] * 4)}
    extra = {"b": finished["b"], "d": (np.zeros(3), [2, 3]),
             "e": (np.zeros(3), [])}
    got = check.draw_sample(finished, extra, 1, np.random.default_rng(0))
    # the longest finished, then every extra request with tokens, once
    assert [s[0] for s in got] == ["a", "b", "d"]


def test_check_samples_requests_admitted_in_the_window(monkeypatch):
    seen = {}
    draw = check.draw_sample

    def spy(finished, extra, n, rng):
        seen["extra"] = dict(extra)
        seen["sample"] = draw(finished, extra, n, rng)
        return seen["sample"]
    monkeypatch.setattr(check, "draw_sample", spy)
    res, lines = tiny_run("mixtral16.longgen.closed64")
    assert res["correct"], lines
    # first-wave requests (``-0``) were admitted in set-up; the others in
    # the window, prefilled by its steps
    admitted = [rid for rid in seen["extra"] if not rid.endswith("-0")]
    assert len(admitted) == harness.load_cell(
        "mixtral16.longgen.closed64")["check"]["admitted"]
    sampled = {s[0]: s[2] for s in seen["sample"]}
    assert all(sampled.get(rid) for rid in admitted)


def _alter_tokens(engine):
    """Fault: the decode head's tokens altered where they are produced,
    every row's at every 7th step."""
    plane = engine.decode_plane
    run, n = plane.run, [0]

    def altered(act, seg_len):
        ring = run(act, seg_len)
        n[0] += 1
        if n[0] % 7 == 0:
            for r in act:
                ring[0, r.slot] = (ring[0, r.slot] + 1) % \
                    engine.cfg.vocab_size
        return ring
    plane.run = altered


def test_an_altered_token_fails_the_check():
    res, lines = tiny_run("mixtral16.longgen.closed64", tamper=_alter_tokens)
    assert not res["correct"], lines


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_source_imports_jax_or_the_jax_package():
    for path in (ROOT / "portbench").rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in FORBIDDEN, (path, name)
            if "reference" in path.parts:
                assert name.split(".")[0] != "repro_torch", (path, name)


def test_a_run_loads_no_jax_module():
    code = ("import sys; sys.path[:0] = ['.', 'src']\n"
            "import portbench.runner, portbench.check\n"
            "import repro_torch.serving.engine, repro_torch.kernels.ops\n"
            "import repro_torch.core.orchestrator\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{sorted(FORBIDDEN)!r}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_run_py_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the refusal is for one "
                    "without")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "mixtral16.longgen.closed64", "--seed", "1", "--seconds", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
