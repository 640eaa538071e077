"""A ``deepseek_v3`` decoder (Moonlight-16B-A3B by default) as a sentence
embedder: the mean of the final normalised hidden states over an answer's
tokens, the BOS token left out (no counterpart in the JAX package).

The equations follow the published ``deepseek_v3`` modeling code, in
float32: pre-norm residual blocks (RMSNorm); latent attention (MLA)
without query compression: ``q_proj`` split per head into a no-position
part and a rotary part, ``kv_a_proj_with_mqa`` into the latent and one
rotary key all heads share, the latent through ``kv_a_layernorm`` and
``kv_b_proj`` into each head's key and value, RoPE after the modeling
code's de-interleave of the rotary dims, scores scaled by
``(nope + rope) ** -0.5`` under a causal mask; the first
``first_k_dense_replace`` layers a SiLU MLP, the rest
:func:`..ops.moe.moe`'s routed experts plus the shared experts (one SiLU
MLP of ``n_shared_experts`` times the expert width); a final RMSNorm.

Weights are a flat dict under the published checkpoint's names less the
``model.`` prefix (:func:`param_shapes`), except that each layer's routed
experts are stacked: ``layers.{i}.mlp.experts.{gate,up,down}_proj`` [E, I,
H], [E, I, H], [E, H, I] in place of ``experts.{e}.*.weight``.  The output
head is absent: an embedder never reads it.  Tokens map to ids through a
lexicon held with the weights (``{"weights": ..., "lexicon": {token:
id}}``); a token it lacks is ``cfg.unk_id``, and every answer starts with
``cfg.bos_id``.

A call's answers run packed: every projection, the router and the experts
see only real tokens ([N, H], N the call's tokens), and only attention's
scores use a padded [answers, longest] layout, whose padding no real query
attends (the causal mask excludes every later position).  The forward
reads no device value: the ids go up in one pinned, non-blocking copy,
and the expert offsets stay on the device.  Regions (:mod:`..utils.
profiling`): ``lm/embed`` (a call), ``lm/ids`` (the lexicon lookup and
the upload), ``lm/attention`` (a layer's attention block), ``lm/moe`` (an
expert layer's block) and ``lm/pool``.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from icassp2022_depression_tpu_torch.config import MoeLmConfig
from icassp2022_depression_tpu_torch.ops import moe as moe_ops
from icassp2022_depression_tpu_torch.utils import profiling

#: answers a forward holds at once
CHUNK = 128


def param_shapes(cfg: MoeLmConfig) -> Dict[str, Tuple[int, ...]]:
    """Every weight's name and shape, in the order of the layers."""
    h, nh = cfg.hidden_size, cfg.num_attention_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    r, e, ie = cfg.kv_lora_rank, cfg.n_routed_experts, \
        cfg.moe_intermediate_size
    shapes = {"embed_tokens.weight": (cfg.vocab_size, h)}
    for i in range(cfg.num_hidden_layers):
        p = f"layers.{i}."
        shapes.update({
            p + "input_layernorm.weight": (h,),
            p + "self_attn.q_proj.weight": (nh * (dn + dr), h),
            p + "self_attn.kv_a_proj_with_mqa.weight": (r + dr, h),
            p + "self_attn.kv_a_layernorm.weight": (r,),
            p + "self_attn.kv_b_proj.weight": (nh * (dn + dv), r),
            p + "self_attn.o_proj.weight": (h, nh * dv),
            p + "post_attention_layernorm.weight": (h,)})
        if i < cfg.first_k_dense_replace:
            width = cfg.intermediate_size
            shapes.update({p + "mlp.gate_proj.weight": (width, h),
                           p + "mlp.up_proj.weight": (width, h),
                           p + "mlp.down_proj.weight": (h, width)})
            continue
        ish = ie * cfg.n_shared_experts
        shapes.update({
            p + "mlp.gate.weight": (e, h),
            p + "mlp.gate.e_score_correction_bias": (e,),
            p + "mlp.experts.gate_proj": (e, ie, h),
            p + "mlp.experts.up_proj": (e, ie, h),
            p + "mlp.experts.down_proj": (e, h, ie),
            p + "mlp.shared_experts.gate_proj.weight": (ish, h),
            p + "mlp.shared_experts.up_proj.weight": (ish, h),
            p + "mlp.shared_experts.down_proj.weight": (h, ish)})
    shapes["norm.weight"] = (h,)
    return shapes


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return w * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps))


def mlp(x: torch.Tensor, gate: torch.Tensor, up: torch.Tensor,
        down: torch.Tensor) -> torch.Tensor:
    return F.linear(F.silu(F.linear(x, gate)) * F.linear(x, up), down)


def rope_tables(pos: torch.Tensor, cfg: MoeLmConfig):
    """Positions [N] -> (cos, sin) [N, rope dims], the modeling code's
    ``DeepseekV3RotaryEmbedding`` (no scaling)."""
    d = cfg.qk_rope_head_dim
    inv_freq = 1.0 / (cfg.rope_theta ** (torch.arange(
        0, d, 2, dtype=torch.int64, device=pos.device).float() / d))
    freqs = pos.float()[:, None] * inv_freq[None, :]
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos(), emb.sin()


def deinterleave(x: torch.Tensor) -> torch.Tensor:
    """[..., d] -> the even dims, then the odd ones (``apply_rotary_pos_emb``'s
    ``view(..., d // 2, 2).transpose(-1, -2)``)."""
    d = x.shape[-1]
    return x.reshape(*x.shape[:-1], d // 2, 2).transpose(-1, -2) \
        .reshape(x.shape)


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
           ) -> torch.Tensor:
    x = deinterleave(x)
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos + rotated * sin


class _Batch:
    """A chunk of answers, packed: ids and positions [N], and the maps to
    and from the padded [answers, longest] layout."""

    def __init__(self, ids: Sequence[Sequence[int]], device):
        lengths = np.array([len(s) for s in ids], np.int64)
        n, b, t = int(lengths.sum()), len(ids), int(lengths.max())
        pos = np.concatenate([np.arange(k) for k in lengths])
        answer = np.repeat(np.arange(b), lengths)
        padded_at = answer * t + pos              # flat token -> padded slot
        flat_at = np.full(b * t, n, np.int64)     # padded slot -> token or n
        flat_at[padded_at] = np.arange(n)
        host = np.concatenate([np.concatenate(ids).astype(np.int64), pos,
                               padded_at, flat_at, lengths - 1])
        host = torch.from_numpy(host)
        if torch.device(device).type == "cuda":
            # one upload that the host does not wait for
            host = host.pin_memory()
        dev = host.to(device, non_blocking=True)
        self.answers, self.longest = b, t
        self.ids, self.pos, self.padded_at, self.flat_at, counts = \
            dev.split([n, n, n, b * t, b])
        self.counts = counts.clamp(min=1).float()

    def pad(self, x: torch.Tensor) -> torch.Tensor:
        """Packed [N, ...] -> [answers, longest, ...], padding zero."""
        x = torch.cat([x, x.new_zeros((1,) + x.shape[1:])])
        return x.index_select(0, self.flat_at).view(
            (self.answers, self.longest) + x.shape[1:])

    def unpad(self, x: torch.Tensor) -> torch.Tensor:
        """[answers, longest, ...] -> packed [N, ...]."""
        return x.reshape((-1,) + x.shape[2:]).index_select(0, self.padded_at)


def attention(x: torch.Tensor, w: Mapping[str, torch.Tensor], p: str,
              cfg: MoeLmConfig, cos, sin, batch: _Batch) -> torch.Tensor:
    """MLA over packed tokens x [N, H] (already normalised) -> [N, H]."""
    n, nh = x.shape[0], cfg.num_attention_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    q = F.linear(x, w[p + "self_attn.q_proj.weight"]).view(n, nh, dn + dr)
    q_nope, q_pe = q.split([dn, dr], dim=-1)
    latent, k_pe = F.linear(x, w[p + "self_attn.kv_a_proj_with_mqa.weight"]) \
        .split([cfg.kv_lora_rank, dr], dim=-1)
    latent = rms_norm(latent, w[p + "self_attn.kv_a_layernorm.weight"],
                      cfg.kv_a_norm_eps)
    kv = F.linear(latent, w[p + "self_attn.kv_b_proj.weight"]) \
        .view(n, nh, dn + dv)
    k_nope, v = kv.split([dn, dv], dim=-1)
    q_pe = rotate(q_pe, cos[:, None], sin[:, None])
    k_pe = rotate(k_pe, cos, sin)[:, None, :].expand(n, nh, dr)
    query = batch.pad(torch.cat([q_nope, q_pe], dim=-1)).transpose(1, 2)
    key = batch.pad(torch.cat([k_nope, k_pe], dim=-1)).transpose(1, 2)
    value = batch.pad(v).transpose(1, 2)
    scores = torch.matmul(query, key.transpose(-1, -2)) * (dn + dr) ** -0.5
    t = batch.longest
    later = torch.ones(t, t, dtype=torch.bool, device=x.device).triu(1)
    probs = torch.softmax(scores.masked_fill(later, float("-inf")), dim=-1)
    out = torch.matmul(probs, value).transpose(1, 2)    # [B, T, nh, dv]
    return F.linear(batch.unpad(out).reshape(n, nh * dv),
                    w[p + "self_attn.o_proj.weight"])


def expert_block(x: torch.Tensor, w: Mapping[str, torch.Tensor], p: str,
                 cfg: MoeLmConfig) -> torch.Tensor:
    """The routed experts' sum plus the shared experts, x [N, H]."""
    routed = moe_ops.moe(
        x, w[p + "mlp.gate.weight"], w[p + "mlp.gate.e_score_correction_bias"],
        w[p + "mlp.experts.gate_proj"], w[p + "mlp.experts.up_proj"],
        w[p + "mlp.experts.down_proj"], cfg.num_experts_per_tok,
        cfg.routed_scaling_factor)
    return routed + mlp(x, w[p + "mlp.shared_experts.gate_proj.weight"],
                        w[p + "mlp.shared_experts.up_proj.weight"],
                        w[p + "mlp.shared_experts.down_proj.weight"])


def hidden_states(w: Mapping[str, torch.Tensor], cfg: MoeLmConfig,
                  batch: _Batch) -> torch.Tensor:
    """The decoder over a packed batch -> final normalised states [N, H]."""
    device = batch.ids.device
    eps = cfg.rms_norm_eps
    x = F.embedding(batch.ids, w["embed_tokens.weight"])
    cos, sin = rope_tables(batch.pos, cfg)
    for i in range(cfg.num_hidden_layers):
        p = f"layers.{i}."
        with profiling.annotate("lm/attention", device):
            x = x + attention(rms_norm(x, w[p + "input_layernorm.weight"],
                                       eps), w, p, cfg, cos, sin, batch)
        if i < cfg.first_k_dense_replace:
            x = x + mlp(rms_norm(x, w[p + "post_attention_layernorm.weight"],
                                 eps), w[p + "mlp.gate_proj.weight"],
                        w[p + "mlp.up_proj.weight"],
                        w[p + "mlp.down_proj.weight"])
            continue
        with profiling.annotate("lm/moe", device):
            x = x + expert_block(rms_norm(
                x, w[p + "post_attention_layernorm.weight"], eps), w, p, cfg)
    return rms_norm(x, w["norm.weight"], eps)


class MoeLmEmbedder:
    """Sentence embedder over explicit weights and lexicon: tokenised
    sentences -> [n, hidden] on the weights' device."""

    def __init__(self, params: Mapping, cfg: MoeLmConfig, device):
        weights, lexicon = params["weights"], params["lexicon"]
        want = param_shapes(cfg)
        missing = sorted(set(want) - set(weights))
        if missing:
            raise ValueError(f"MoE LM weights lack {len(missing)} tensors, "
                             f"the first {missing[0]!r}")
        self.weights = {}
        for name, shape in want.items():
            t = weights[name]
            if tuple(t.shape) != shape or t.dtype is not torch.float32:
                raise ValueError(f"MoE LM weight {name}: expected float32 "
                                 f"{shape}, got {t.dtype} {tuple(t.shape)}")
            # a tensor already on the device is kept, never copied
            self.weights[name] = t.to(device)
        self.lexicon = dict(lexicon)
        self.cfg = cfg
        self.device = torch.device(device)

    def ids(self, tokens: Sequence[str]) -> List[int]:
        get, unk = self.lexicon.get, self.cfg.unk_id
        return [self.cfg.bos_id] + [get(t, unk) for t in tokens]

    def __call__(self, sentences: Sequence[List[str]]) -> torch.Tensor:
        out = []
        with profiling.annotate("lm/embed", self.device), \
                torch.inference_mode():
            for start in range(0, len(sentences), CHUNK):
                with profiling.annotate("lm/ids", self.device):
                    batch = _Batch([self.ids(s) for s in
                                    sentences[start:start + CHUNK]],
                                   self.device)
                states = hidden_states(self.weights, self.cfg, batch)
                with profiling.annotate("lm/pool", self.device):
                    # the BOS token (position 0) left out of the mean
                    out.append(batch.pad(states)[:, 1:].sum(dim=1)
                               / batch.counts[:, None])
        if not out:
            return torch.zeros((0, self.cfg.hidden_size),
                               dtype=torch.float32, device=self.device)
        return torch.cat(out) if len(out) > 1 else out[0]
