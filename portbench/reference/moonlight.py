"""Plain Moonlight-16B-A3B sentence embedding: the ``deepseek_v3`` decoder
of the published modeling code (``modeling_deepseek.py`` beside
https://huggingface.co/moonshotai/Moonlight-16B-A3B/blob/main/config.json),
one answer at a time, then the mean of the final normalised hidden states
over the answer's tokens, BOS left out.

* a decoder layer: ``x + attn(input_layernorm(x))``, then ``x +
  mlp(post_attention_layernorm(x))``; RMSNorm ``w * x * rsqrt(mean(x^2) +
  eps)``;
* attention (no query compression): ``q = q_proj(x)`` per head split into
  ``qk_nope_head_dim`` and ``qk_rope_head_dim``; ``kv_a_proj_with_mqa(x)``
  split into the ``kv_lora_rank`` latent and one rotary key for all
  heads; ``kv_b_proj(kv_a_layernorm(latent))`` per head split into the
  key's no-position part and the value; RoPE (theta from the config, no
  scaling) on the rotary parts after ``view(..., d / 2, 2).transpose``,
  then ``x cos + rotate_half(x) sin``; scores times ``(nope + rope) **
  -0.5``, causal, softmax in float32, ``o_proj``;
* layers before ``first_k_dense_replace``: ``down(silu(gate(x)) * up(x))``
  at ``intermediate_size``;
* the others: ``s = sigmoid(x W_gate^T)``; the top
  ``num_experts_per_tok`` of ``s + e_score_correction_bias`` (one group);
  their ``s`` over their sum (plus 1e-20) times ``routed_scaling_factor``;
  a plain loop over the experts, each ``down(silu(gate(x)) * up(x))`` at
  ``moe_intermediate_size`` on the tokens routed to it, times the weight;
  plus the shared experts, one MLP at ``n_shared_experts`` times that
  width;
* a final RMSNorm.

Departures from the published description, each forced or assumed (the
configuration's ``assumed`` lists them): the weights are random and held
as the program's flat dict (each layer's routed experts stacked [E, ...],
read here one expert at a time); tokens are CJK characters (and latin or
digit runs) mapped to ids by an assumed lexicon, not the released
tokenizer, with an assumed BOS and unknown id; ``kv_a_layernorm``'s eps is
its norm class's default, 1e-6; the output head is left out.  No cache, no
batching across answers.  Products run through :mod:`.precision`: float32
with TF32 off, or the control's TF32.

Beside each answer's features :func:`embed` gives its routing: for each
expert layer the experts each token selected (sorted) and the token's
selection margin, the gap between the last selected and the first
unselected of ``s + bias``.
"""

from __future__ import annotations

from typing import Mapping, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import precision
from portbench.reference.elmo import segment


def _mm(a: torch.Tensor, w: torch.Tensor, prec: str) -> torch.Tensor:
    """a @ w^T (an ``nn.Linear`` without bias)."""
    return precision.matmul(a, w.transpose(-1, -2), prec)


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    var = x.pow(2).mean(-1, keepdim=True)
    return w * (x * torch.rsqrt(var + eps))


def _mlp(x, gate, up, down, prec):
    return _mm(F.silu(_mm(x, gate, prec)) * _mm(x, up, prec), down, prec)


def _rotary(q, k, cos, sin):
    def rotate_half(x):
        half = x.shape[-1] // 2
        return torch.cat((-x[..., half:], x[..., :half]), dim=-1)

    def deinterleave(x):
        *lead, d = x.shape
        return x.view(*lead, d // 2, 2).transpose(-1, -2).reshape(*lead, d)

    q, k = deinterleave(q), deinterleave(k)
    return q * cos + rotate_half(q) * sin, k * cos + rotate_half(k) * sin


def _attention(x, w, p, cfg, cos, sin, prec):
    t = x.shape[0]
    nh, dn = cfg["num_attention_heads"], cfg["qk_nope_head_dim"]
    dr, dv = cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    q = _mm(x, w[p + "self_attn.q_proj.weight"], prec).view(
        t, nh, dn + dr).transpose(0, 1)
    q_nope, q_pe = torch.split(q, [dn, dr], dim=-1)
    latent, k_pe = torch.split(
        _mm(x, w[p + "self_attn.kv_a_proj_with_mqa.weight"], prec),
        [cfg["kv_lora_rank"], dr], dim=-1)
    latent = _rms(latent, w[p + "self_attn.kv_a_layernorm.weight"],
                  cfg["kv_a_norm_eps"])
    kv = _mm(latent, w[p + "self_attn.kv_b_proj.weight"], prec).view(
        t, nh, dn + dv).transpose(0, 1)
    k_nope, value = torch.split(kv, [dn, dv], dim=-1)
    q_pe, k_pe = _rotary(q_pe, k_pe.view(1, t, dr), cos, sin)
    query = torch.cat([q_nope, q_pe], dim=-1)
    key = torch.cat([k_nope, k_pe.expand(nh, t, dr)], dim=-1)
    scores = precision.matmul(query, key.transpose(1, 2), prec) \
        * (dn + dr) ** -0.5
    causal = torch.ones(t, t, dtype=torch.bool, device=x.device).triu(1)
    scores = scores.masked_fill(causal, float("-inf"))
    probs = torch.softmax(scores, dim=-1, dtype=torch.float32)
    out = precision.matmul(probs, value, prec).transpose(0, 1).reshape(
        t, nh * dv)
    return _mm(out, w[p + "self_attn.o_proj.weight"], prec)


def _experts(x, w, p, cfg, prec):
    """(routed experts plus shared experts [T, H], the selected experts
    [T, k] sorted, the selection margins [T])."""
    k = cfg["num_experts_per_tok"]
    scores = torch.sigmoid(_mm(x, w[p + "mlp.gate.weight"], prec))
    choice = scores + w[p + "mlp.gate.e_score_correction_bias"]
    ranked = torch.sort(choice, dim=-1, descending=True)
    top = ranked.indices[:, :k]
    margins = ranked.values[:, k - 1] - ranked.values[:, k]
    weights = scores.gather(1, top)
    if cfg["norm_topk_prob"] and k > 1:
        weights = weights / (weights.sum(dim=-1, keepdim=True) + 1e-20)
    weights = weights * cfg["routed_scaling_factor"]
    out = torch.zeros_like(x)
    gate, up, down = (w[p + f"mlp.experts.{n}_proj"]
                      for n in ("gate", "up", "down"))
    for e in range(cfg["n_routed_experts"]):
        token, slot = torch.nonzero(top == e, as_tuple=True)
        if token.numel() == 0:
            continue
        y = _mlp(x[token], gate[e], up[e], down[e], prec)
        out.index_add_(0, token, y * weights[token, slot, None])
    shared = _mlp(x, w[p + "mlp.shared_experts.gate_proj.weight"],
                  w[p + "mlp.shared_experts.up_proj.weight"],
                  w[p + "mlp.shared_experts.down_proj.weight"], prec)
    return out + shared, top.sort(dim=-1).values, margins


def _answer(ids: Sequence[int], w: Mapping[str, torch.Tensor], cfg: Mapping,
            prec: str) -> Tuple[torch.Tensor, list]:
    device = w["embed_tokens.weight"].device
    eps = cfg["rms_norm_eps"]
    x = w["embed_tokens.weight"][torch.tensor(ids, device=device)]
    t, d = len(ids), cfg["qk_rope_head_dim"]
    inv_freq = 1.0 / (cfg["rope_theta"] ** (torch.arange(
        0, d, 2, dtype=torch.int64, device=device).float() / d))
    freqs = torch.outer(torch.arange(t, device=device).float(), inv_freq)
    emb = torch.cat((freqs, freqs), dim=-1)
    cos, sin = emb.cos(), emb.sin()
    routing = []
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}."
        x = x + _attention(_rms(x, w[p + "input_layernorm.weight"], eps),
                           w, p, cfg, cos, sin, prec)
        h = _rms(x, w[p + "post_attention_layernorm.weight"], eps)
        if i < cfg["first_k_dense_replace"]:
            x = x + _mlp(h, w[p + "mlp.gate_proj.weight"],
                         w[p + "mlp.up_proj.weight"],
                         w[p + "mlp.down_proj.weight"], prec)
        else:
            y, top, margins = _experts(h, w, p, cfg, prec)
            x = x + y
            routing.append((top.cpu().numpy(), margins.cpu().numpy()))
    x = _rms(x, w["norm.weight"], eps)
    if t == 1:
        return torch.zeros_like(x[0]), routing
    return x[1:].mean(dim=0), routing


def token_ids(text: str, lexicon: Mapping[str, int], cfg: Mapping) -> list:
    return [cfg["bos_id"]] + [lexicon.get(tok, cfg["unk_id"])
                              for tok in segment(text)]


def embed(texts: Sequence[str], weights: Mapping[str, torch.Tensor],
          lexicon: Mapping[str, int], cfg: Mapping, prec: str = "fp32"
          ) -> Tuple[np.ndarray, list]:
    """Answers -> (features [n, hidden_size], each answer's routing: for
    each expert layer (selected experts [T, k] sorted, margins [T])), on
    the weights' device."""
    feats, routing = [], []
    with torch.no_grad():
        for text in texts:
            f, r = _answer(token_ids(text, lexicon, cfg), weights, cfg, prec)
            feats.append(f.cpu().numpy())
            routing.append(r)
    return (np.stack(feats).astype(np.float32) if feats
            else np.zeros((0, cfg["hidden_size"]), np.float32), routing)
