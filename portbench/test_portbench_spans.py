"""CPU tests of the readers of the program's host spans
(``portbench/spans.py`` and the metrics that use it): each on a
synthetic run and a stand-in plane, their silence where the program has
no host spans, and the tiny ``--trace 1`` runs of both cells reporting
them."""
import json
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

from portbench import harness, model, runner  # noqa: E402
from portbench.test_portbench_harness import (  # noqa: E402
    TINY_CONFIG, TINY_LIMIT, TINY_TRAFFIC)

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SPAN_READERS = ["step_host_ms", "ckpt_step_ms", "ckpt_pin_alloc_ms",
                "prefill_call_ms", "restore_host_ms", "restore_upload_ms"]
#: read from the harness's own stamps, not from host spans
STAMP_READERS = ["resume_gap_ms"]
READERS = SPAN_READERS + STAMP_READERS
FAILURE_ONLY = {"restore_host_ms", "restore_upload_ms", "resume_gap_ms"}


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _span(name, tick, ms, at=0):
    return (name, tick, at, at + int(ms * 1e6), None)


def _run():
    """Decode steps at 11 and 12, a profiled one at 13, a prefill step at
    14 and one after the window's close; failures detected at 15.03
    (restoring, its tick 0.9 s, its victim's next token at 16.53), 16
    (restoring nothing) and 13.05 (in the profiled stretch)."""
    run = harness.Run("x", {}, model.load_config("mixtral-8x7b.16of32"),
                      {"loop": {"kind": "closed"}}, 0, 10.0, True)
    run.t_open, run.t_close = 10.0, 20.0
    S = harness.Step
    run.steps = [S(11.0, 11.04, 4, 0, 9), S(12.0, 12.05, 4, 0, 9),
                 S(13.0, 13.1, 4, 0, 9, traced=True),
                 S(14.0, 14.2, 3, 100, 9), S(25.0, 25.5, 4, 0, 9)]
    F = harness.Failure
    run.failures = [F("aw", 0, 15.0, ["a"], t_detect=15.03, tick_s=0.9,
                      restored_bytes=2 ** 20),
                    F("aw", 1, 15.9, [], t_detect=16.0),
                    F("aw", 0, 13.0, ["b"], t_detect=13.05, tick_s=0.01,
                      restored_bytes=2 ** 20)]
    for rid, stamps in (("a", [14.0, 15.0, 16.53, 16.6]),
                        ("b", [12.0, 13.1])):
        run.reqs[rid] = harness.Served(rid, np.zeros(4, np.int32), 8, 10.0,
                                       stamps=stamps)
    spans = []
    for tick, ms in ((11.0, (40, 1, 20, 2, 5, 1, 3)),
                     (12.0, (50, 1, 25, 2, 7, 1, 3)),
                     (13.0, (100, 1, 50, 9, 50, 9, 9)),
                     (25.0, (500, 1, 1, 1, 1, 1, 1))):
        spans += [_span(n, tick, v) for n, v in zip(
            ("step", "decode.replay", "decode.drain", "ckpt.gather",
             "ckpt.pin_alloc", "ckpt.copy", "ckpt.commit"), ms)]
    spans += [_span("step", 14.0, 200), _span("prefill.call", 14.0, 150),
              _span("prefill.call", 14.0, 10), _span("prefill.call", 13.0,
                                                     999)]
    for tick in (15.03, 13.05):
        spans += [_span("orch.tick", tick, 900), _span("restore.read", tick,
                                                       100),
                  _span("restore.read", tick, 100),
                  _span("restore.stack", tick, 50),
                  _span("restore.upload", tick, 300)]
    spans += [_span("orch.tick", 16.0, 1)]
    return run, spans


def _plane(monkeypatch, spans, dropped=0):
    from repro_torch.serving import telemetry
    plane = types.SimpleNamespace(tracer=types.SimpleNamespace(
        host_spans=spans, host_dropped=dropped))
    monkeypatch.setattr(telemetry, "newest_plane", lambda: plane)


def test_readers_join_spans_to_steps_and_failures(monkeypatch):
    run, spans = _run()
    _plane(monkeypatch, spans)
    got = {n: harness.load_reader(n)(run) for n in READERS}
    assert got == pytest.approx({
        "step_host_ms": ((40 - 22) + (50 - 27)) / 2,
        "ckpt_step_ms": ((2 + 5 + 1 + 3) + (2 + 7 + 1 + 3)) / 2,
        "ckpt_pin_alloc_ms": 6.0,
        "prefill_call_ms": 80.0,
        "restore_host_ms": 250.0,
        "restore_upload_ms": 300.0,
        "resume_gap_ms": 600.0})


def test_readers_are_silent_without_host_spans(monkeypatch):
    from repro_torch.serving import telemetry
    run, spans = _run()
    none = dict.fromkeys(SPAN_READERS)
    # no span at the run's ticks
    _plane(monkeypatch, [_span("step", 99.0, 1)])
    assert {n: harness.load_reader(n)(run) for n in SPAN_READERS} == none
    # no plane alive
    monkeypatch.setattr(telemetry, "newest_plane", lambda: None)
    assert {n: harness.load_reader(n)(run) for n in SPAN_READERS} == none
    # a program without host spans (no ``newest_plane`` to import)
    monkeypatch.delattr(telemetry, "newest_plane")
    assert {n: harness.load_reader(n)(run) for n in SPAN_READERS} == none
    # the stamps' reader needs no span
    assert harness.load_reader("resume_gap_ms")(run) == pytest.approx(600.0)


def test_readers_are_silent_when_the_ring_dropped_spans_of_the_window(
        monkeypatch):
    run, spans = _run()
    read = {n: harness.load_reader(n) for n in SPAN_READERS}
    # the oldest span left is the window's: some of its spans are gone
    _plane(monkeypatch, spans, dropped=3)
    assert {n: f(run) for n, f in read.items()} == dict.fromkeys(read)
    # the ring dropped only spans older than the window
    _plane(monkeypatch, [_span("step", 5.0, 1)] + spans, dropped=3)
    assert all(f(run) is not None for f in read.values())


def test_new_metrics_are_declared_for_their_cells():
    per_layer = {m["name"]: m for m in BENCH["per_layer"]}
    cells = [w["name"] for w in BENCH["workloads"]]
    for name in READERS:
        m = per_layer[name]
        assert m["source"] == ("host_clock" if name in STAMP_READERS
                               else "program_span"), name
        want = [c for c in cells if "aw_fail" in c] \
            if name in FAILURE_ONLY else cells
        assert m["workloads"] == want, name


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_tiny_traced_runs_report_the_span_metrics(cell):
    traffic = dict(TINY_TRAFFIC)
    seconds = 1.5
    if "aw_fail" in cell:
        # each AW back 0.3 s after its failure is detected: with none
        # alive, the loop would spin on empty steps whose spans push the
        # window's out of the ring
        seconds = 3.0
        traffic["warm_failover"] = {"kind": "aw", "worker": 0,
                                    "requests": 2, "prompt": 8, "output": 6}
        traffic["orchestrator"] = {"worker_init_time": 0.3}
    res, lines = runner.run_cell(
        cell, 4_000_000_007, seconds, True, t_start=time.perf_counter(),
        device="cpu", log=lambda *_: None,
        overrides={"config": TINY_CONFIG, "traffic": traffic,
                   "cell": {"check": {"limit": TINY_LIMIT},
                            "profile": {"at": 0.5, "iterations": 5}}})
    assert res["correct"], lines
    want = {n for n in READERS if "aw_fail" in cell or n not in FAILURE_ONLY}
    assert want <= set(res["metrics"]), sorted(res["metrics"])
    vals = {n: res["metrics"][n]["value"] for n in want}
    assert all(np.isfinite(v) and v >= 0 for v in vals.values()), vals
    assert vals["step_host_ms"] > 0 and vals["prefill_call_ms"] > 0
