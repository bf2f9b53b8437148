"""How ``correct`` is decided: the served tokens against the plain
reference (``reference/moe_lm.py``).

After the window closes the benchmark takes a sample, drawn from the
seed, of the requests the timed path served: the longest that finished,
others that finished, requests that the window admitted and prefilled
(what they were served by the close), and in the failure cells the
victims of each failure (their tokens after the restore included). The
reference runs once over each prompt followed by its served tokens, and
each served token's gap is how far its reference logit lies below the
reference's best logit at that position. Greedy decoding makes every served token
the program's own best, so a sound program's gaps come from its
rounding: most are 0, and a few, where bf16 rounding flips a near tie of
the router's top-k or of the head, reach whole logits. The widest gap is
set by such flips in bf16 and in fp8 alike, so it does not separate the
program from the control; the number compared is the mean gap over the
sample's served tokens (``mean_logit_gap``), which counts how often and
how far the served tokens leave the reference's best.

The control (``control_gaps``) puts the reference in the program's place
in the precision below bfloat16 (``precision="fp8"``) and reads, at the
same positions, the gap of the token that the fp8 model puts first.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from portbench.reference import moe_lm

Sample = List[Tuple[str, Sequence[int], Sequence[int]]]  # rid, prompt, served


def draw_sample(finished: Dict[str, Tuple[np.ndarray, List[int]]],
                extra: Dict[str, Tuple[np.ndarray, List[int]]],
                n: int, rng: np.random.Generator) -> Sample:
    """The longest finished request (by served tokens), ``n - 1`` others
    of the finished drawn by ``rng``, and every request of ``extra`` not
    drawn already."""
    out: Sample = []
    done = sorted(finished, key=lambda r: (-len(finished[r][1]), r))
    if done:
        out.append((done[0], *finished[done[0]]))
        rest = done[1:]
        for i in rng.permutation(len(rest))[:max(0, n - 1)]:
            out.append((rest[i], *finished[rest[i]]))
    drawn = {s[0] for s in out}
    for rid in sorted(extra):
        if extra[rid][1] and rid not in drawn:
            out.append((rid, *extra[rid]))
    return out


def _targets(sample: Sample):
    seqs, spans = [], []
    for _, prompt, served in sample:
        seqs.append(list(map(int, prompt)) + list(map(int, served[:-1])))
        spans.append((len(prompt) - 1, np.asarray(served, np.int64)))
    return seqs, spans


def _rows(spans, i, r0, logits):
    """The rows of a logits block that predict a served token: (block
    rows, served indices)."""
    first, served = spans[i]
    lo = max(r0, first)
    hi = min(r0 + logits.shape[0], first + len(served))
    if lo >= hi:
        return None
    return slice(lo - r0, hi - r0), slice(lo - first, hi - first)


def served_gaps(conf: dict, params: dict, sample: Sample, device,
                choices: List[np.ndarray] = None) -> List[np.ndarray]:
    """Per request, the float32 reference's gap of each served token (or
    of ``choices``, the tokens another model put first at the same
    positions)."""
    seqs, spans = _targets(sample)
    gaps = [np.zeros(len(s[1]), np.float64) for s in spans]

    def on_logits(i, r0, logits):
        got = _rows(spans, i, r0, logits)
        if got is None:
            return
        rows, idx = got
        lg = logits[rows]
        want = spans[i][1][idx] if choices is None else choices[i][idx]
        tok = torch.as_tensor(want, device=lg.device)
        gap = lg.max(-1).values - lg.gather(1, tok[:, None])[:, 0]
        gaps[i][idx] = gap.double().cpu().numpy()

    moe_lm.forward(conf, params, seqs, on_logits, device=device)
    return gaps


def first_choices(conf: dict, params: dict, sample: Sample, device,
                  precision: str) -> List[np.ndarray]:
    """The token that the reference in ``precision`` puts first at each
    position that predicts a served token."""
    seqs, spans = _targets(sample)
    out = [np.zeros(len(s[1]), np.int64) for s in spans]

    def on_logits(i, r0, logits):
        got = _rows(spans, i, r0, logits)
        if got is not None:
            rows, idx = got
            out[i][idx] = logits[rows].argmax(-1).cpu().numpy()

    moe_lm.forward(conf, params, seqs, on_logits, device=device,
                   precision=precision)
    return out


def control_gaps(conf: dict, params: dict, sample: Sample, device
                 ) -> List[np.ndarray]:
    """The control's gaps: the fp8 model's first choices, judged by the
    float32 reference."""
    choices = first_choices(conf, params, sample, device, "fp8")
    return served_gaps(conf, params, sample, device, choices)


def widest(gaps: List[np.ndarray]) -> float:
    return float(max((g.max() for g in gaps if g.size), default=0.0))


def mean(gaps: List[np.ndarray]) -> float:
    """The mean gap over every served token of the sample."""
    n = sum(g.size for g in gaps)
    return float(sum(g.sum() for g in gaps) / n) if n else 0.0


def share_off_best(gaps: List[np.ndarray]) -> float:
    """The share of served tokens that are not the reference's best."""
    n = sum(g.size for g in gaps)
    return float(sum((g > 0).sum() for g in gaps) / n) if n else 0.0
