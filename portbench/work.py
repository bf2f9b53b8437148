"""The yardstick's arithmetic: the published peaks of one H100 SXM card
and the operations and bytes that a decode step, a prefill call and
their kernels need, computed from the shapes the benchmark holds.

Frozen copies of the port's ``roofline/h100.py`` figures and of the byte
and flop formulas of ``chip_smoke.py``'s ``bound()``: each input byte is
read once and each output byte written once, whatever a kernel reads
again, and work depends on the valid keys and the experts a call uses,
not on the padded extents.
"""
from __future__ import annotations

from dataclasses import dataclass

HBM_BYTES_PER_S = 3.35e12          # HBM3, NVIDIA's data sheet (SXM, 700 W)
BF16_FLOPS_PER_S = 989e12          # dense bf16 on the tensor cores
FP32_FLOPS_PER_S = 67e12           # float32 on the CUDA cores
BF16 = 2                           # bytes of a served weight or KV entry


@dataclass(frozen=True)
class Shapes:
    """The widths the formulas need, from a configuration file."""
    d: int                  # hidden size
    layers: int
    heads: int
    kv_heads: int
    head_dim: int
    experts: int
    top_k: int
    f: int                  # an expert's hidden size
    shared_f: int           # the shared experts' hidden size (0 = none)
    vocab: int

    @staticmethod
    def of(conf: dict) -> "Shapes":
        return Shapes(
            d=conf["hidden_size"], layers=conf["num_hidden_layers"],
            heads=conf["num_attention_heads"],
            kv_heads=conf["num_key_value_heads"], head_dim=conf["head_dim"],
            experts=conf.get("num_local_experts", conf.get("num_experts")),
            top_k=conf["num_experts_per_tok"],
            f=conf.get("moe_intermediate_size", conf["intermediate_size"]),
            shared_f=conf.get("shared_expert_intermediate_size", 0),
            vocab=conf["vocab_size"])

    @property
    def attn_params(self) -> int:
        """Projection weights of one attention layer."""
        qo = 2 * self.d * self.heads * self.head_dim
        return qo + 2 * self.d * self.kv_heads * self.head_dim

    @property
    def expert_params(self) -> int:
        return 3 * self.d * self.f

    def matmul_params_per_token(self) -> int:
        """Weights every token multiplies by: attention, router, its top-k
        experts and the shared experts in every layer, then the head."""
        per_layer = self.attn_params + self.d * self.experts + \
            self.top_k * self.expert_params + 3 * self.d * self.shared_f
        return self.layers * per_layer + self.d * self.vocab


def least_seconds(nbytes: float, flops: float,
                  peak: float = BF16_FLOPS_PER_S) -> float:
    """The least time for the work: bytes at the HBM rate or operations at
    ``peak``, the larger."""
    return max(nbytes / HBM_BYTES_PER_S, flops / peak)


def model_flops(s: Shapes, rows: int, keys: int) -> float:
    """Model operations of a decode step: 2 per weight a token multiplies
    by, for ``rows`` tokens, and 4 * head_dim per (query head, valid key)
    pair for the scores and the weighted sum, ``keys`` summed over the
    rows (each row's cache length plus its own token)."""
    return 2.0 * s.matmul_params_per_token() * rows + \
        4.0 * s.layers * s.heads * s.head_dim * keys


def ffn_call_seconds(s: Shapes, tokens: int, experts_used: int) -> float:
    """Least time of one MoE layer's expert FFN call: the used experts'
    gate, up and down weights read once, each routed token's input read
    and output written once; 2 operations per weight a routed token
    multiplies by."""
    pairs = tokens * s.top_k
    nbytes = experts_used * s.expert_params * BF16 + 2 * pairs * s.d * BF16
    flops = 2.0 * pairs * s.expert_params
    return least_seconds(nbytes, flops)


def decode_attn_call_seconds(s: Shapes, rows: int, keys: int) -> float:
    """Least time of one layer's decode attention call: the valid K and V
    entries read once, each row's query read and output written once;
    4 * head_dim operations per (query head, valid key) pair."""
    kv = keys * s.kv_heads * s.head_dim * 2 * BF16
    qo = rows * s.heads * s.head_dim * 2 * BF16
    flops = 4.0 * s.heads * s.head_dim * keys
    return least_seconds(kv + qo, flops)
