"""NetVLAD pooling (port of :mod:`icassp2022_depression_tpu.ops.netvlad`).

Soft-assignment VLAD head: softmax cluster assignment, residual
aggregation, intra-normalisation, global L2 and a projection to
``output_dim``.  Every function accepts leading batch axes on both the
parameters and the frames, so a bucket of utterances, each with its own
weights, is one batched pass (the JAX package ``vmap``s instead).

The reference draws fresh random cluster weights for every utterance and
never trains them (``audio_features_whole.py:65-71``).  The JAX package
keys them by ``fold_in(PRNGKey(seed), ordinal)``; :mod:`.prng` reproduces
those threefry streams bit for bit, so both packages compute the same
features for the same utterance ordinal.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from icassp2022_depression_tpu_torch.ops import prng


def init_params(key: torch.Tensor, feature_size: int, cluster_size: int,
                output_dim: int) -> dict:
    """Keys [..., 2] -> params with the same leading axes (loupe's
    distributions: normal with stddev 1/sqrt(feature_size) for the
    cluster tensors, 1/sqrt(cluster_size) for the projection)."""
    k1, k2, k3, k4 = prng.split(key, 4).unbind(-2)
    s_in = float(np.float32(1.0) / np.sqrt(np.float32(feature_size)))
    s_out = float(np.float32(1.0) / np.sqrt(np.float32(cluster_size)))
    return {
        "cluster_w": prng.normal(k1, (feature_size, cluster_size)) * s_in,
        "cluster_b": prng.normal(k2, (cluster_size,)) * s_in,
        "cluster_w2": prng.normal(k3, (1, feature_size, cluster_size)) * s_in,
        "hidden_w": prng.normal(k4, (feature_size * cluster_size,
                                     output_dim)) * s_out,
    }


def netvlad(params: dict, x: torch.Tensor,
            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: [..., N, D] frame features -> [..., output_dim] descriptors.

    ``mask`` [..., N] (bool/float) excludes padded frames, so utterances
    padded to a common frame count pool only their own frames."""
    d, k = params["cluster_w"].shape[-2:]
    assign = torch.matmul(x, params["cluster_w"]) + \
        params["cluster_b"].unsqueeze(-2)
    assign = torch.softmax(assign, dim=-1)                       # [..., N, K]
    if mask is not None:
        assign = assign * mask.to(assign.dtype).unsqueeze(-1)
    a_sum = assign.sum(dim=-2, keepdim=True)                     # [..., 1, K]
    a = a_sum * params["cluster_w2"][..., 0, :, :]               # [..., D, K]
    # residual aggregation: [D, N] @ [N, K] -> [D, K]
    vlad = torch.matmul(x.transpose(-1, -2), assign) - a
    # intra-normalisation over the feature axis
    vlad = vlad / torch.clamp_min(
        torch.linalg.vector_norm(vlad, dim=-2, keepdim=True), 1e-12)
    flat = vlad.reshape(*vlad.shape[:-2], d * k)
    flat = flat / torch.clamp_min(
        torch.linalg.vector_norm(flat, dim=-1, keepdim=True), 1e-12)
    return torch.matmul(flat.unsqueeze(-2), params["hidden_w"]).squeeze(-2)


def per_utterance_params(seed: int, ordinal: int, feature_size: int,
                         cluster_size: int, output_dim: int,
                         device=None) -> dict:
    """The utterance's weights, keyed by ``fold_in(PRNGKey(seed), ordinal)``."""
    key = prng.fold_in(prng.prng_key(seed, device), ordinal)
    return init_params(key, feature_size, cluster_size, output_dim)


def batched_per_utterance_params(seed: int, ordinals: Sequence[int] |
                                 torch.Tensor, feature_size: int,
                                 cluster_size: int, output_dim: int,
                                 device=None) -> dict:
    """Stacked per-utterance params: row i ==
    ``per_utterance_params(seed, ordinals[i], ...)``."""
    ordinals = torch.as_tensor(ordinals, dtype=torch.int64, device=device)
    keys = prng.fold_in(prng.prng_key(seed, ordinals.device), ordinals)
    return init_params(keys, feature_size, cluster_size, output_dim)
