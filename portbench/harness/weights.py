"""Weights drawn from the seed on the device, in one large call of a
``torch.Generator``, then cut and scaled in place: uniform in
``center +- bound`` a tensor, with ``bound = 1 / sqrt(fan_in)`` for a
matrix or filter (``nn.Linear``'s and ``nn.GRU``'s scale), a small bound
for biases, ``1 +- 0.1`` for a LayerNorm's gain, and the standard
deviation of ``1 / sqrt(dim)`` for embedding tables.  Random weights carry
no learned meaning; they give the products real magnitudes.

The same tensors go to the system under test (a state dict it loads, an
ELMo bundle it reads) and to the plain reference (a host copy).
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Sequence, Tuple

import torch

Spec = Tuple[Tuple[int, ...], float, float]      # shape, bound, center

BIAS_BOUND = 0.1


def draw(specs: Mapping[str, Spec], gen: torch.Generator,
         device) -> Dict[str, torch.Tensor]:
    """{name: (shape, bound, center)} -> {name: float32 tensor} (views of
    one buffer)."""
    total = sum(math.prod(shape) for shape, _, _ in specs.values())
    buf = torch.rand(total, generator=gen, device=device,
                     dtype=torch.float32)
    buf.mul_(2.0).sub_(1.0)
    out, at = {}, 0
    for name, (shape, bound, center) in specs.items():
        n = math.prod(shape)
        t = buf[at:at + n].view(shape)
        t.mul_(bound).add_(center)
        out[name] = t
        at += n
    return out


def state_specs(shapes: Mapping[str, Sequence[int]]) -> Dict[str, Spec]:
    """A model's parameters by name and shape -> their draws."""
    specs = {}
    for name, shape in shapes.items():
        shape = tuple(int(s) for s in shape)
        if name.endswith("ln.weight"):
            specs[name] = (shape, 0.1, 1.0)
        elif len(shape) == 1:
            specs[name] = (shape, BIAS_BOUND, 0.0)
        else:
            specs[name] = (shape, 1.0 / math.sqrt(shape[-1]), 0.0)
    return specs


def elmo_specs(cc: Mapping, lm: Mapping, n_chars: int,
               n_words: int | None) -> Dict[str, Spec]:
    """The char-CNN and the LSTMP biLM, under flat names ``cc/...`` and
    ``enc/<layer>/<dir>/...``."""
    emb = math.sqrt(3.0)
    d = cc["char_dim"]
    f = sum(c for _, c in cc["filters"])
    specs = {"cc/char_emb": ((n_chars, d), emb / math.sqrt(d), 0.0)}
    for i, (w, c) in enumerate(cc["filters"]):
        specs[f"cc/convs/{i}/w"] = ((c, d, w), 1.0 / math.sqrt(d * w), 0.0)
        specs[f"cc/convs/{i}/b"] = ((c,), BIAS_BOUND, 0.0)
    for i in range(cc["n_highway"]):
        specs[f"cc/highways/{i}/w"] = ((2 * f, f), 1.0 / math.sqrt(f), 0.0)
        specs[f"cc/highways/{i}/b"] = ((2 * f,), BIAS_BOUND, 0.0)
    proj_in = f + (cc["word_dim"] if n_words else 0)
    specs["cc/projection/w"] = ((cc["output_dim"], proj_in),
                                1.0 / math.sqrt(proj_in), 0.0)
    specs["cc/projection/b"] = ((cc["output_dim"],), BIAS_BOUND, 0.0)
    if n_words:
        specs["cc/word_emb"] = ((n_words, cc["word_dim"]),
                                emb / math.sqrt(cc["word_dim"]), 0.0)
    c, p = lm["cell_size"], lm["proj_size"]
    for layer in range(lm["layers"]):
        in_dim = cc["output_dim"] if layer == 0 else p
        for dr in ("fwd", "bwd"):
            at = f"enc/{layer}/{dr}"
            specs[f"{at}/w_x"] = ((4 * c, in_dim), 1.0 / math.sqrt(in_dim),
                                  0.0)
            specs[f"{at}/w_h"] = ((4 * c, p), 1.0 / math.sqrt(p), 0.0)
            specs[f"{at}/b"] = ((4 * c,), BIAS_BOUND, 0.0)
            specs[f"{at}/w_p"] = ((p, c), 1.0 / math.sqrt(c), 0.0)
    return specs


def elmo_trees(flat: Mapping[str, torch.Tensor], cc: Mapping, lm: Mapping
               ) -> Tuple[dict, List[dict]]:
    """Flat ``elmo_specs`` draws -> (the char-CNN tree, the biLM layers),
    in the layout of a converted ELMo bundle."""
    tree = {"char_emb": flat["cc/char_emb"],
            "convs": [{"w": flat[f"cc/convs/{i}/w"],
                       "b": flat[f"cc/convs/{i}/b"]}
                      for i in range(len(cc["filters"]))],
            "highways": [{"w": flat[f"cc/highways/{i}/w"],
                          "b": flat[f"cc/highways/{i}/b"]}
                         for i in range(cc["n_highway"])],
            "projection": {"w": flat["cc/projection/w"],
                           "b": flat["cc/projection/b"]}}
    if "cc/word_emb" in flat:
        tree["word_emb"] = flat["cc/word_emb"]
    layers = [{dr: {k: flat[f"enc/{layer}/{dr}/{k}"]
                    for k in ("w_x", "w_h", "b", "w_p")}
               for dr in ("fwd", "bwd")} for layer in range(lm["layers"])]
    return tree, layers


def to_host(tree):
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_host(v) for v in tree]
    return tree.detach().to("cpu", copy=True)
