"""One run of one cell: set-up, the measured window, the metrics and the
check against the reference.

The window drives the port's public serving calls on the host's wall
clock, in the order of ``serving/scheduler.py::run_serving``: the
failures that are due (``Orchestrator.inject_failure``), the
orchestrator's tick, ``Gateway.enqueue`` of every request that is due,
then ``InferenceEngine.step``; each token is stamped when the step that
made it returns, and a finished request is released
(``release_request``). The engine's clock (``now``) is the host clock in
seconds since the process started, so set-up and window share it.

A closed loop's client sends its next request when the last one
finishes; an open loop sends each request at its due time, late if the
loop was busy, and its latency counts from the due time.
"""
from __future__ import annotations

import contextlib
import json
import time
from collections import deque
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np

from portbench import generator, trace, work

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_cell(name: str) -> dict:
    path = HERE / "cells" / f"{name}.json"
    if not path.exists():
        raise KeyError(f"no cell {name!r} (looked for {path})")
    return json.loads(path.read_text())


def load_benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


@dataclass
class Served:
    rid: str
    prompt: np.ndarray
    max_new: int
    due: float                    # host clock when it was due
    client: int = -1
    stamps: List[float] = field(default_factory=list)
    tokens: List[int] = field(default_factory=list)   # final stream
    done: float = -1.0


@dataclass
class Step:
    t0: float
    t1: float
    tokens: int                   # tokens the step emitted
    prefill_tokens: int           # prompt tokens it prefilled
    keys: int                     # valid keys over the emitting rows
    traced: bool = False
    loads: Optional[np.ndarray] = None     # per-slot loads (traced steps)
    prefills: List[int] = field(default_factory=list)  # prompt lengths

    @property
    def wall(self) -> float:
        return self.t1 - self.t0


@dataclass
class Failure:
    kind: str
    worker: int
    t_inject: float
    victims: List[str]
    t_detect: float = -1.0
    tick_s: float = 0.0           # host time of the detecting tick
    restored_bytes: int = 0


class Run:
    """Everything a metric reader needs from one run."""

    def __init__(self, cell_name: str, cell: dict, conf: dict, mix: dict,
                 seed: int, seconds: float, trace_on: bool):
        self.cell_name, self.cell, self.conf, self.mix = (cell_name, cell,
                                                         conf, mix)
        self.seed, self.seconds, self.trace_on = seed, seconds, trace_on
        self.shapes = work.Shapes.of(conf)
        self.loop = mix["loop"]["kind"]
        self.reqs: Dict[str, Served] = {}
        self.steps: List[Step] = []
        self.failures: List[Failure] = []
        self.queue_delay: Dict[str, float] = {}
        self.t_open = self.t_close = 0.0
        self.setup_s = 0.0
        self.ckpt_bytes = 0
        self.summary: Optional[trace.TraceSummary] = None
        self.late_s = 0.0             # open loop: how late enqueues ran

    # -- window views ----------------------------------------------------
    def in_window(self, t: float) -> bool:
        return self.t_open < t <= self.t_close

    def window_tokens(self) -> int:
        return sum(1 for r in self.reqs.values() for t in r.stamps
                   if self.in_window(t))

    def gaps(self) -> List[float]:
        out = []
        for r in self.reqs.values():
            s = r.stamps
            out.extend(b - a for a, b in zip(s, s[1:])
                       if a >= self.t_open and b <= self.t_close)
        return out

    def decode_steps(self) -> List[Step]:
        return [s for s in self.steps if not s.prefill_tokens and s.tokens]

    def prefill_steps(self) -> List[Step]:
        return [s for s in self.steps if s.prefill_tokens]

    def victim_stalls(self) -> List[float]:
        """Per victim of every failure: from the injection to its first
        token after the detecting tick (the window's end if none came)."""
        out = []
        for f in self.failures:
            for rid in f.victims:
                after = [t for t in self.reqs[rid].stamps
                         if f.t_detect >= 0 and t > f.t_detect]
                out.append((after[0] if after and after[0] <= self.t_close
                            else self.t_close) - f.t_inject)
        return out


def percentile(values, q: float) -> Optional[float]:
    """numpy's linear percentile, None for no values."""
    return float(np.percentile(np.asarray(values, np.float64), q)) \
        if len(values) else None


def load_reader(name: str) -> Callable[[Run], Optional[float]]:
    """The reader of metric ``name``: ``metrics/<name>.py``'s ``read``."""
    import importlib.util
    path = HERE / "metrics" / f"{name}.py"
    if not path.exists():
        raise KeyError(f"no reader for metric {name!r} (looked for {path})")
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, cell_name: str, trace_on: bool) -> List[dict]:
    """The metrics this cell reports in this kind of run, in the order of
    BENCHMARK.json: end-to-end with ``--trace 0``, per-layer with 1."""
    kind = "per_layer" if trace_on else "end_to_end"
    return [m for m in bench[kind]
            if "workloads" not in m or cell_name in m["workloads"]]


class Serving:
    """The engine, the orchestrator and the benchmark's loop around them."""

    def __init__(self, run: Run, engine, clock: Callable[[], float],
                 sync: Callable[[], None]):
        from repro_torch.core.orchestrator import Orchestrator
        self.run, self.engine, self.clock, self.sync = run, engine, clock, \
            sync
        self.Orchestrator = Orchestrator
        self.gw = engine.gateway
        self.orch = None
        self.n_got: Dict[str, int] = {}
        self.mark = _no_mark

    def enqueue(self, req: generator.Request, due: float):
        r = Served(req.rid, req.prompt, req.max_new, due, client=req.client)
        self.run.reqs[req.rid] = r
        self.n_got[req.rid] = 0
        self.gw.enqueue(req.rid, req.prompt, req.max_new, now=due)

    def step(self, traced: bool = False) -> Dict[str, List[int]]:
        eng = self.engine
        pf0 = eng.prefill_tokens_done()
        pre = set(eng.requests) if traced else None
        t0 = self.clock()
        with self.mark("step"):
            out = eng.step(now=t0)
        t1 = self.clock()
        keys, emitted = 0, 0
        with self.mark("release"):
            for rid, toks in out.items():
                r = self.run.reqs[rid]
                n = self.n_got[rid]
                keys += sum(len(r.prompt) + n + j for j in range(len(toks)))
                emitted += len(toks)
                self.n_got[rid] = n + len(toks)
                r.stamps.extend([t1] * len(toks))
            pf = eng.prefill_tokens_done() - pf0
            if not emitted and not pf:
                return []
            st = Step(t0, t1, emitted, pf, keys, traced=traced)
            if traced:
                st.prefills = [len(self.run.reqs[rid].prompt)
                               for rid in set(eng.requests) - pre]
                loads = eng.decode_plane.host_loads
                st.loads = None if loads is None else np.array(loads[0])
            self.run.steps.append(st)
            finished = []
            for rid in out:
                state = eng.requests.get(rid)
                if state is not None and state.done:
                    r = self.run.reqs[rid]
                    r.tokens = list(state.tokens)
                    r.done = t1
                    eng.release_request(rid)
                    finished.append(r)
        return finished

    # -- set-up ------------------------------------------------------------
    def warm_failover(self, spec: dict, vocab: int, seed: int):
        """One fail, restore and provision cycle of ``spec``'s worker on
        throwaway requests, so the window meets a warm restore path; its
        orchestrator provisions at once (no T_w wait)."""
        eng = self.engine
        orch = self.Orchestrator(eng, worker_init_time=0.0)
        rng = generator.rng_for(seed, 7)
        warm = [generator.Request(f"warm-{i}", rng.integers(
            0, vocab, size=(spec["prompt"],), dtype=np.int32),
            spec["output"]) for i in range(spec["requests"])]
        for req in warm:
            self.enqueue(req, self.clock())
            self.step()
        orch.inject_failure(spec["kind"], spec["worker"], self.clock())
        while not any(e.kind == "provisioned" for e in orch.events):
            time.sleep(0.005)
            orch.tick(self.clock())
            self.step()
        while any(not self.run.reqs[q.rid].tokens for q in warm):
            self.step()
        for q in warm:
            eng.release_request(q.rid)
            del self.run.reqs[q.rid], self.n_got[q.rid]

    def first_wave(self, clients: List[List[generator.Request]]):
        """Each client's first request, one a step, then steps until every
        one of them is decoding: a prefill call holds one request, so its
        rows never exceed what one whole-prompt call takes."""
        first = []
        for queue in clients:
            req = queue.pop(0)
            first.append(req.rid)
            self.enqueue(req, self.clock())
            self.step()
        while any(self.n_got[rid] == 0 for rid in first):
            self.step()

    # -- the window --------------------------------------------------------
    def window(self, traffic: dict, fails: List[dict], prof_at: float,
               prof_iters: int, profiler_factory):
        run, eng, clock = self.run, self.engine, self.clock
        self.orch = self.Orchestrator(eng, **run.mix.get("orchestrator", {}))
        t_open = run.t_open
        t_close = run.t_close
        pending = deque()
        clients = traffic.get("clients")
        arrivals = deque(traffic.get("arrivals", []))
        injected = [False] * len(fails)
        prof, prof_left, prof_t0, traced = None, 0, 0.0, None
        store = eng.store.stats
        b0 = store.bytes_written
        while True:
            now = clock()
            if now >= t_close:
                break
            if run.trace_on and prof is None and \
                    now - t_open >= prof_at and traced is None:
                self.sync()
                prof = profiler_factory()
                prof.__enter__()
                self.mark = _record_mark
                prof_left = prof_iters
                prof_t0 = clock()
            with self.mark("failures"):
                for i, f in enumerate(fails):
                    if not injected[i] and now >= t_open + f["t"]:
                        injected[i] = True
                        victims = [r.rid for r in eng.requests.values()
                                   if r.aw == f["worker"] and not r.done
                                   and not r.paused]
                        self.orch.inject_failure(f["kind"], f["worker"], now)
                        run.failures.append(Failure(f["kind"], f["worker"],
                                                    now, victims))
            with self.mark("tick"):
                rb0 = store.bytes_restored
                t0 = clock()
                events = self.orch.tick(now)
                detected = [e for e in events if e.kind == "detected"]
                if detected:
                    if run.trace_on:
                        self.sync()
                    dt = clock() - t0
                    for e in detected:
                        for f in run.failures:
                            if f.t_detect < 0 and e.worker == \
                                    f"{f.kind}{f.worker}":
                                f.t_detect, f.tick_s = now, dt
                                f.restored_bytes = store.bytes_restored - rb0
            with self.mark("enqueue"):
                while pending and pending[0][0] <= now:
                    due, req = pending.popleft()
                    self.enqueue(req, due)
                while arrivals and t_open + arrivals[0].due <= now:
                    req = arrivals.popleft()
                    run.late_s = max(run.late_s, now - t_open - req.due)
                    self.enqueue(req, t_open + req.due)
            finished = self.step(traced=prof is not None)
            if clients is not None:
                for r in finished:
                    queue = clients[r.client]
                    if queue:
                        pending.append((r.done, queue.pop(0)))
            if prof is not None:
                prof_left -= 1
                if prof_left == 0:
                    # stopping the profiler post-processes its events, for
                    # seconds, in the window: the traced run reports no
                    # end-to-end metric
                    self.sync()
                    traced = (prof, clock() - prof_t0)
                    prof.__exit__(None, None, None)
                    self.mark = _no_mark
                    prof = None
        if prof is not None:
            self.sync()
            traced = (prof, clock() - prof_t0)
            prof.__exit__(None, None, None)
            self.mark = _no_mark
        run.ckpt_bytes = store.bytes_written - b0
        run.queue_delay = {rid: d for rid, d in self.gw.stats.queue_delay
                           .items() if rid in run.reqs and
                           run.in_window(run.reqs[rid].due)}
        # streams still in flight at the close: what was served so far
        for rid, state in eng.requests.items():
            if rid in run.reqs and not run.reqs[rid].tokens:
                run.reqs[rid].tokens = list(state.tokens)
        return traced


@contextlib.contextmanager
def _no_mark(name):
    yield


def _record_mark(name):
    import torch
    return torch.profiler.record_function(f"bench/{name}")


def traced_least_seconds(run: Run, group: str) -> float:
    """Least seconds of the traced steps' calls of a kernel group, from
    the shapes the benchmark holds: ``"ffn"``, one call a MoE layer of
    every decode step and of every prefill call; ``"decode_attn"``, one
    call a layer of every decode step. A decode step's experts used come
    from its per-slot dispatch loads, summed over the layers: a slot with
    load n counts in min(layers, n) of them (every expert in every layer
    when the engine exposes no loads); a prefill call of p prompt tokens
    uses min(experts, (p - 1) * top-k) a layer."""
    s = run.shapes
    total = 0.0
    for st in run.steps:
        if not st.traced:
            continue
        if group == "decode_attn" and st.tokens:
            total += s.layers * work.decode_attn_call_seconds(
                s, st.tokens, st.keys)
        elif group == "ffn":
            if st.tokens:
                uses = s.layers * s.experts if st.loads is None else \
                    float(np.minimum(st.loads, s.layers).sum())
                total += s.layers * work.ffn_call_seconds(
                    s, st.tokens, uses / s.layers)
            for p in st.prefills:
                total += s.layers * work.ffn_call_seconds(
                    s, p - 1, min(s.experts, (p - 1) * s.top_k))
    return total
