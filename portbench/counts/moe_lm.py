"""Useful operations and bytes of the ``deepseek_v3`` text embedder
(Moonlight-16B-A3B), from the answers' unpadded token counts (BOS
included): products count a multiply-add as 2; norms, RoPE, the softmax
and the activations are not counted.  Attention counts the causal half of
each answer's scores and values, the pairs a query really attends.
"""

from __future__ import annotations

from typing import Iterable, Mapping, Tuple

from portbench.counts.peaks import bound_s


def _attention_token(m: Mapping) -> float:
    """One token through a layer's attention projections."""
    h, nh = m["hidden_size"], m["num_attention_heads"]
    dn, dr, dv = m["qk_nope_head_dim"], m["qk_rope_head_dim"], m["v_head_dim"]
    r = m["kv_lora_rank"]
    return 2 * (h * nh * (dn + dr) + h * (r + dr) + r * nh * (dn + dv)
                + nh * dv * h)


def _scores(tokens: int, m: Mapping) -> float:
    """One answer's scores and values over its causal pairs, a layer."""
    pairs = tokens * (tokens + 1) // 2
    return 2 * pairs * m["num_attention_heads"] * (
        m["qk_nope_head_dim"] + m["qk_rope_head_dim"] + m["v_head_dim"])


def moe_experts(tokens: int, m: Mapping) -> Tuple[float, float]:
    """(operations, least time in s) of one expert layer's two
    grouped-expert launches over ``tokens`` real tokens, each launch bound
    by the larger of its operations at the fp32 peak and its bytes at the
    memory rate.  Gate and up: the k slots' rows read, both weights read,
    the activation written; down: the activation and the slots' weights
    read, the down weights read, the outputs written.  Each expert's
    weights count once and every expert as used (a cohort call routes
    hundreds of rows to each); the offsets count in both."""
    h, i, e = (m["hidden_size"], m["moe_intermediate_size"],
               m["n_routed_experts"])
    rows = tokens * m["num_experts_per_tok"]
    offsets = 4 * (e + 1)
    gate_up = (2 * rows * h * i * 2,
               4 * (rows * h + 2 * e * i * h + rows * i) + offsets)
    down = (2 * rows * i * h,
            4 * (rows * i + rows + e * h * i + rows * h) + offsets)
    return (gate_up[0] + down[0],
            bound_s(*gate_up) + bound_s(*down))


def lm_call(token_counts: Iterable[int], m: Mapping) -> Tuple[float, float]:
    """(useful operations, the grouped-expert launches' least time in s)
    of one call's answers through the decoder."""
    counts = list(token_counts)
    n = sum(counts)
    h = m["hidden_size"]
    layers = m["num_hidden_layers"]
    dense = m["first_k_dense_replace"]
    shared = m["moe_intermediate_size"] * m["n_shared_experts"]
    flops = layers * (n * _attention_token(m)
                      + sum(_scores(t, m) for t in counts))
    flops += dense * 2 * n * h * m["intermediate_size"] * 3
    experts_flops, experts_s = moe_experts(n, m)
    per_layer = (2 * n * h * m["n_routed_experts"] + 2 * n * h * shared * 3
                 + experts_flops)
    flops += (layers - dense) * per_layer
    return flops, (layers - dense) * experts_s
