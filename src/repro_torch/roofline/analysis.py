"""Roofline terms of one step of the port on NVIDIA H100 cards (port of
``repro.roofline.analysis``).

Three terms per (arch x shape x mesh):

    compute    = flops_per_device / 989e12          (H100 SXM, dense bf16)
    memory     = hbm_bytes_per_device / 3.35e12     (H100 SXM, HBM3)
    collective = sum over collectives of bytes / the link its axis uses

The reference reads per-device flops and bytes off the compiled HLO. The
port has no HLO: ``step_work`` counts them from the config, the shape and
the batch, and ``analyze`` splits them by the case's placements and adds
the collective bytes the placements imply:

* flops: every weight matrix times the tokens that pass through it,
  attention over the valid (query, key) pairs, the experts at capacity
  (the live slots, C rows each), the SSD scan and the mLSTM cell, and the
  unembed of the rows whose logits the step returns; a train step is the
  forward pass three times (forward and backward), four with remat;
* HBM bytes: each param leaf read once (the live slots' experts, the
  embedding rows gathered), the cache read and written (the valid keys of
  a decode step), the tokens in and the logits out; a train step reads
  the params twice and writes the gradients, and AdamW reads and writes
  params and bfloat16 moments;
* collective bytes: an all-reduce after a projection whose contracted dim
  is split over ``model`` (and after the vocab-split embedding), the
  all-to-all of dispatched tokens over the expert axis, the all-gather of
  vocab-split logits, and in ``train`` the gradient all-reduce over the
  data-parallel axes a leaf is replicated on, plus ZeRO's all-gather of
  pod-split weights (forward and backward) and reduce-scatter of their
  gradients.

Link model (``h100.py``): an axis whose devices fit in one 8-card node
runs over NVLink 4 (450 GB/s each way per card); an axis that leaves the
node runs over one 400 Gb/s NIC per card (50 GB/s). On the production
meshes (row-major 16 x 16 and 2 x 16 x 16) every axis leaves the node.
"""
from __future__ import annotations

import math
import re
from dataclasses import asdict, dataclass, field
from typing import Dict, Optional

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.kernels import ssm_scan
from repro_torch.models.transformer import layer_windows
from repro_torch.roofline import h100
from repro_torch.training.train import leaf_paths

PEAK_FLOPS = h100.BF16_FLOPS_PER_S
HBM_BW = h100.HBM_BYTES_PER_S

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")


@dataclass
class RooflineReport:
    name: str
    chips: int
    # per device, counted from config x shape x placements by
    # ``step_work`` (the reference's names; it read them off the HLO)
    hlo_flops: float
    hlo_bytes: float
    coll_bytes: float           # per device
    coll_breakdown: Dict[str, float]
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float          # whole-step useful FLOPs (all devices)
    useful_ratio: float
    # params, optimizer state, cache and batch: one device's shards
    mem_per_device_bytes: Optional[float] = None
    mem_breakdown: Dict[str, float] = field(default_factory=dict)

    def to_dict(self):
        return asdict(self)


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """6·N·D (dense) / 6·N_active·D (MoE); D = tokens processed this step."""
    n = cfg.active_param_count
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens           # fwd+bwd
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch  # decode: one token per request


def default_capacity(cfg: ModelConfig, tokens: int) -> int:
    """Expert capacity of a call over ``tokens`` tokens at the model's
    capacity factor (``core.refe.route``'s rule)."""
    return int(max(1, round(cfg.moe.capacity_factor * cfg.moe.top_k *
                            tokens / cfg.moe.num_experts)))


def _pairs(n: int, window: int) -> int:
    """Causal (query, key) pairs of n queries at positions 0..n-1 over
    the same n keys: a query at p sees min(p + 1, window) keys."""
    if not window or window >= n:
        return n * (n + 1) // 2
    return window * (window + 1) // 2 + (n - window) * window


@dataclass
class StepWork:
    """Flops and HBM bytes of one step, per part: each part's flops and
    bytes with the param or cache leaf that decides how the part splits
    across devices (None: the batch alone splits it)."""
    parts: list = field(default_factory=list)

    def add(self, name: str, flops: float, nbytes: float, leaf=None,
            kind: str = "param"):
        self.parts.append((name, float(flops), float(nbytes), leaf, kind))

    @property
    def flops(self) -> float:
        return sum(p[1] for p in self.parts)

    @property
    def hbm_bytes(self) -> float:
        return sum(p[2] for p in self.parts)

    def by(self, what: int = 1) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for p in self.parts:
            key = p[0].split(":")[0]
            out[key] = out.get(key, 0.0) + p[what]
        return out


_LAYER = re.compile(r"^(layers|blocks|enc|dec)/(\d+)/")


def step_work(cfg: ModelConfig, params: Dict[str, tuple], kind: str,
              rows: int, seq: int, *, ctx=None, capacity=None,
              live_slots=None, cache: Optional[Dict[str, tuple]] = None,
              el: int = 2) -> StepWork:
    """One step's work on one device holding everything.

    ``params``: path -> shape of every param leaf (the port's tree);
    ``kind``: "train", "prefill" (``rows`` x ``seq`` tokens, each row at
    positions 0..seq-1, the last position's logits returned) or "decode"
    (one token a row; ``ctx``, a list of each row's key count, the new
    token included; a row with 0 keys is idle); ``capacity``: the expert
    capacity per slot (None: the model's factor over the call's tokens);
    ``live_slots``: slots with a token per MoE layer (None: the
    ``num_experts`` primaries); ``cache``: path -> shape of the cache
    leaves (decode: read; prefill: written)."""
    w = StepWork()
    d, hd, h, hkv = cfg.d_model, cfg.head_dim_, cfg.num_heads, \
        cfg.num_kv_heads
    decode = kind == "decode"
    tokens = rows if decode else rows * seq
    t_enc = 0 if decode else rows * cfg.encoder_seq
    out_rows = tokens if kind == "train" else rows
    if ctx is None:
        ctx = [seq] * rows
    live_rows = sum(1 for c in ctx if c > 0) if decode else rows
    if cfg.moe.enabled:
        if capacity is None:
            capacity = default_capacity(cfg, tokens)
        if live_slots is None:
            live_slots = cfg.moe.num_experts
    windows = layer_windows(cfg)

    for path, shape in params.items():
        numel = math.prod(shape)
        m = _LAYER.match(path)
        if path in ("embed", "unembed"):
            if path == "embed":
                w.add("embed:gather", 0, 2 * tokens * d * el, path)
            if path == "unembed" or cfg.tie_embeddings:
                w.add("unembed", 2.0 * out_rows * numel, numel * el, path)
            continue
        if re.search(r"experts/(wg|wu|wd)$", path):
            e = shape[0]
            mat = numel // e
            w.add("experts", 2.0 * live_slots * capacity * mat,
                  min(live_slots, e) * mat * el, path)
            continue
        if len(shape) != 2 or path.endswith("conv_w"):
            w.add("elementwise:" + path, 0, numel * el, path)
            continue
        n_tok = tokens
        if path.startswith("enc/") or re.search(r"cross_attn/(wk|wv)$",
                                                path):
            n_tok = t_enc
        if path.startswith("shared/"):
            n_tok = tokens * (cfg.num_layers // cfg.hybrid_attn_every)
        name = "router" if path.endswith("router") else "projections"
        w.add(f"{name}:{path}", 2.0 * n_tok * numel, numel * el, path)
        if m is None or not re.search(r"(attn|self_attn|cross_attn)/wq$",
                                      path):
            continue
        # the attention core of this layer, split as its wq is
        if path.startswith("enc/"):
            # the encoder runs at prefill only (decode reads its cache)
            pairs = 0 if decode else rows * cfg.encoder_seq ** 2
        elif "cross_attn" in path:
            pairs = (live_rows if decode else tokens) * cfg.encoder_seq
        else:
            win = windows[int(m.group(2))] if m.group(1) == "layers" else 0
            pairs = sum(min(c, win) if win else c for c in ctx) if decode \
                else rows * _pairs(seq, win)
        w.add("attention", 4.0 * h * hd * pairs, 0, path)
    if "shared/attn/wq" in params:
        n_app = cfg.num_layers // cfg.hybrid_attn_every
        pairs = sum(ctx) if decode else rows * _pairs(seq, 0)
        w.add("attention", 4.0 * h * hd * pairs * n_app, 0,
              "shared/attn/wq")
    if cfg.ssm.enabled:
        d_in = cfg.ssm.expand * d
        hs, p_, n_ = d_in // cfg.ssm.head_dim, cfg.ssm.head_dim, \
            cfg.ssm.state_dim
        if decode:
            f = 6.0 * live_rows * hs * p_ * n_
        else:
            f = ssm_scan.work(rows, seq, hs, p_, n_, cfg.ssm.chunk)[0]
        w.add("scan", f * cfg.num_layers, 0)
    if cfg.xlstm_pattern:
        nh = 4                     # the mLSTM's heads (models/xlstm.py)
        dh = d // nh
        n_m = cfg.xlstm_pattern.count("mlstm") * cfg.num_layers // \
            len(cfg.xlstm_pattern)
        w.add("mlstm_cell", 6.0 * tokens * nh * dh * dh * n_m, 0)
    for path, shape in (cache or {}).items():
        numel = math.prod(shape)
        leaf = path.rsplit("/", 1)[-1]
        if leaf in ("k", "v") and decode:
            i = int(path.split("/")[1])
            win = windows[i] if i < len(windows) else 0
            keys = sum(min(c, win) if win else c for c in ctx)
            per_key = numel // (shape[0] * shape[1])
            w.add("cache", 0, (keys + rows) * per_key * el, path, "cache")
        elif leaf in ("k", "v"):
            w.add("cache", 0, rows * seq * (numel // (shape[0] * shape[1]))
                  * el, path, "cache")
        elif leaf == "pos":
            w.add("cache", 0, numel * 4, path, "cache")
        elif decode and leaf not in ("cross_k", "cross_v"):
            w.add("cache", 0, 2 * numel * el, path, "cache")   # state r+w
        else:
            w.add("cache", 0, numel * el, path, "cache")
    w.add("batch", 0, tokens * 4 + out_rows * cfg.vocab_size * el, None,
          "batch")
    if kind == "train":
        _as_train(w, cfg)
    return w


def _as_train(w: StepWork, cfg: ModelConfig):
    """Forward work -> a train step: the backward is twice the forward's
    flops (remat adds one more forward); params read in the forward and
    the backward, gradients written, AdamW's read of params, gradients
    and the two bfloat16 moments and write of params and moments."""
    mult = 4.0 if cfg.remat else 3.0
    # a bf16 param's bytes b: read forward and backward (2b), gradient
    # written (b); AdamW reads p, g, mu, nu (4b) and writes p, mu, nu (3b)
    w.parts = [(name, mult * f, 10 * b if kind == "param" else b, leaf,
                kind) for name, f, b, leaf, kind in w.parts]


def _axis_bw(sizes: Dict[str, int], axis) -> float:
    """The per-card bandwidth of a collective over ``axis`` (a name or a
    tuple): NVLink if its devices fit in one node, else the NIC."""
    names = list(sizes)
    axes = axis if isinstance(axis, tuple) else (axis,)
    span = 1
    for a in axes:
        stride = 1
        for b in names[names.index(a) + 1:]:
            stride *= sizes[b]
        span = max(span, stride * sizes[a])
    return h100.NVLINK_BYTES_PER_S if span <= h100.CARDS_PER_NODE \
        else h100.NIC_BYTES_PER_S


def _ring(n: int, kind: str) -> float:
    """Bytes each device moves per byte of the collective's buffer."""
    if n <= 1:
        return 0.0
    return 2.0 * (n - 1) / n if kind == "all-reduce" else (n - 1) / n


def analyze(case) -> RooflineReport:
    """The roofline of a dry-run case (``launch/specs.py``): its step's
    work split by the case's placements, the collectives they imply,
    and one device's bytes of params, optimizer state, cache and batch."""
    cfg, shape, sh = case.cfg, case.shape, case.sharder
    sizes = sh.sizes
    chips = math.prod(sizes.values())
    pspec, cspec = case.param_specs, case.cache_specs
    pshape, cshape = case.param_shapes, case.cache_shapes
    rows, seq = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        work = step_work(cfg, pshape, "decode", rows, seq, cache=cshape)
    else:
        work = step_work(cfg, pshape, shape.kind, rows, seq)
    bspec = sh.batch_spec((rows, seq))
    batch_div = _split(sizes, bspec[:1])

    flops = nbytes = 0.0
    for name, f, b, leaf, kind in work.parts:
        if kind == "cache":
            flops += f
            nbytes += b / _split(sizes, cspec[leaf])
        elif leaf is None:
            flops += f / batch_div
            nbytes += b / batch_div
        else:
            spec = pspec[leaf]
            model = sizes["model"] if "model" in _names(spec) else 1
            flops += f / (batch_div * model)
            # the leaf's shard is read whole on each device; the
            # embedding rows and the batch split with the batch
            nbytes += b / (batch_div if name.startswith("embed")
                           else _split(sizes, spec))

    coll = _collectives(case, batch_div)
    coll_total = sum(b for b, _ in coll.values())
    coll_s = sum(b / bw for b, bw in coll.values())
    breakdown = {k: 0.0 for k in _COLLECTIVES}
    for (kind, _axis), (b, _) in coll.items():
        breakdown[kind] += b
    compute_s, memory_s = flops / PEAK_FLOPS, nbytes / HBM_BW
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": coll_s}
    dominant = max(terms, key=terms.get)
    mf = model_flops(cfg, shape)
    mem = case.bytes_per_device()
    return RooflineReport(
        name=case.name, chips=chips, hlo_flops=flops, hlo_bytes=nbytes,
        coll_bytes=coll_total, coll_breakdown=breakdown,
        compute_s=compute_s, memory_s=memory_s, collective_s=coll_s,
        dominant=dominant, model_flops=mf,
        useful_ratio=mf / (flops * chips) if flops else 0.0,
        mem_per_device_bytes=float(sum(mem.values())),
        mem_breakdown=mem)


def _names(spec):
    out = []
    for e in spec:
        if isinstance(e, tuple):
            out.extend(e)
        elif e is not None:
            out.append(e)
    return out


def _split(sizes, spec) -> int:
    """The devices a spec splits a tensor over."""
    return math.prod(sizes[a] for a in _names(spec))


def _collectives(case, batch_div: int):
    """(collective kind, axis) -> (bytes per device, link bandwidth)."""
    cfg, shape, sh = case.cfg, case.shape, case.sharder
    sizes, pspec, pshape = sh.sizes, case.param_specs, case.param_shapes
    el = 2
    out: Dict[tuple, list] = {}

    def add(kind, axis, nbytes):
        n = _split(sizes, (axis,))
        moved = _ring(n, kind) * nbytes
        if moved:
            got = out.setdefault((kind, axis), [0.0, _axis_bw(sizes, axis)])
            got[0] += moved

    decode = shape.kind == "decode"
    tokens = shape.global_batch * (1 if decode else shape.seq_len)
    t_loc = tokens / batch_div
    passes = 1.0 if shape.kind != "train" else 2.0   # activations fwd+bwd
    for path, spec in pspec.items():
        shp = pshape[path]
        names = _names(spec)
        if "model" in names and len(shp) == 2 and spec[0] == "model" and \
                not re.search(r"experts|embed$|unembed$", path):
            # row-parallel projection: partial sums all-reduced
            add("all-reduce", "model", passes * t_loc * shp[1] * el)
        if path == "embed" and spec and spec[0] == "model":
            add("all-reduce", "model", passes * t_loc * shp[1] * el)
        if path.endswith("experts/wg") and "model" in names:
            # tokens dispatched to the expert group and combined back
            add("all-to-all", "model",
                passes * 2 * t_loc * cfg.moe.top_k * cfg.d_model * el)
        if "pod" in names:
            full = el * math.prod(shp) / _split(sizes, spec) * \
                sizes["pod"]
            add("all-gather", "pod", passes * full)
            if shape.kind == "train":
                add("reduce-scatter", "pod", full)
        if shape.kind == "train":
            rep = tuple(a for a in ("pod", "data")
                        if a in sizes and a not in names)
            if rep:
                local = el * math.prod(shp) / _split(sizes, spec)
                add("all-reduce", rep if len(rep) > 1 else rep[0], local)
    unembed = "unembed" if "unembed" in pspec else "embed"
    if "model" in _names(pspec[unembed]):
        out_rows = tokens if shape.kind == "train" else shape.global_batch
        add("all-gather", "model",
            out_rows / batch_div * cfg.vocab_size * el)
    return {k: tuple(v) for k, v in out.items()}


def served_work(engine, kind: str, *, rows: int, seq: int = 0, ctx=None,
                capacity=None, live_slots=None) -> StepWork:
    """``step_work`` of one call of a serving engine on one device: its
    params and (decode) cache shapes; ``el`` from the engine's dtype."""
    params = {p: tuple(t.shape) for p, t in leaf_paths(engine.params)
              .items()}
    cache = None
    if kind == "decode":
        cache = {p: tuple(t.shape) for p, t in leaf_paths(engine.cache)
                 .items()}
    return step_work(engine.cfg, params, kind, rows, seq, ctx=ctx,
                     capacity=capacity, live_slots=live_slots, cache=cache,
                     el=engine.cfg.torch_dtype.itemsize)

