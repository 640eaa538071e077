"""Optimizers with the reference's exact settings (port of
:mod:`icassp2022_depression_tpu.train.optim`).

* AdamW with per-group weight decay: decay ``cfg.weight_decay`` on
  everything except LayerNorm params, which get 0 -- the
  ``get_param_group`` split on ``'ln'`` (``audio_gru_whole.py:247-255``);
  a param is a LayerNorm param iff a component of its name starts with
  ``ln``, as the JAX package's mask reads its pytree paths.
* Plain Adam (torch defaults) for the regression trainers
  (``Regression/audio_bilstm_perm.py:250``).

A param that gets no gradient (the audio model's unused
``attention_layer``) keeps ``grad is None`` and torch's optimizers skip it,
decay included, which is what the JAX package's ``dead_paths`` mask does.

On a card the optimizers are ``capturable`` (their step count lives on
the device), so that a fold's epoch can be captured into a CUDA graph;
:func:`init_state` creates their state before the capture.  Stacked folds
(``--vmap-folds``) train with :class:`StackedAdam`: one step count per
fold and a masked update, so a fold whose batch is all padding does not
move, as under the JAX package's ``vmap`` of its masked step.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from icassp2022_depression_tpu_torch.config import OptimizerConfig


def is_layernorm(name: str) -> bool:
    return any(part.startswith("ln") for part in name.split("."))


def _groups(cfg: OptimizerConfig, model: nn.Module):
    """[(params, weight_decay)] of the recipe; unknown names raise: a typo
    must not silently train with plain Adam."""
    if cfg.name not in ("adam", "adamw"):
        raise ValueError(f"unknown optimizer {cfg.name!r}: expected "
                         "'adam' or 'adamw'")
    named = list(model.named_parameters())
    if cfg.name == "adamw" and cfg.weight_decay > 0:
        return [([p for n, p in named if not is_layernorm(n)],
                 cfg.weight_decay),
                ([p for n, p in named if is_layernorm(n)], 0.0)]
    return [([p for _, p in named], 0.0)]


def build(cfg: OptimizerConfig, model: nn.Module) -> torch.optim.Optimizer:
    """The recipe's optimizer over ``model``'s parameters, ``capturable``
    where they lie on a card."""
    groups = _groups(cfg, model)
    kw = dict(lr=cfg.learning_rate, betas=(cfg.b1, cfg.b2), eps=cfg.eps,
              capturable=next(model.parameters()).is_cuda)
    if cfg.name == "adamw" and cfg.weight_decay > 0:
        return torch.optim.AdamW(
            [{"params": ps, "weight_decay": wd} for ps, wd in groups], **kw)
    return torch.optim.Adam(groups[0][0], **kw)


def _scalar_dtype():
    return (torch.float64 if torch.get_default_dtype() == torch.float64
            else torch.float32)


def init_state(optimizer: torch.optim.Optimizer) -> None:
    """Create the Adam state of every parameter that has none, as the
    optimizer's first step would (a graph must not capture its creation:
    every replay would zero it again)."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            state = optimizer.state[p]
            if state:
                continue
            state["step"] = torch.zeros(
                (), dtype=_scalar_dtype(),
                device=p.device if group["capturable"] else "cpu")
            state["exp_avg"] = torch.zeros_like(
                p, memory_format=torch.preserve_format)
            state["exp_avg_sq"] = torch.zeros_like(
                p, memory_format=torch.preserve_format)


_FIELDS = ("step", "exp_avg", "exp_avg_sq")


def _slots(optimizer):
    """(index, param, state) of every parameter in group order."""
    params = [p for g in optimizer.param_groups for p in g["params"]]
    return [(i, p, optimizer.state[p]) for i, p in enumerate(params)]


def state_tensors(optimizer) -> list:
    """Every state tensor of ``optimizer``, in a fixed order."""
    return [st[f] for _, _, st in _slots(optimizer) for f in _FIELDS
            if f in st]


def state_arrays(optimizer) -> dict:
    """The optimizer's state as host arrays named ``"{index}/{field}"``,
    for a resume bundle."""
    out = {}
    for i, _, st in _slots(optimizer):
        for f in _FIELDS:
            if f in st:
                out[f"{i}/{f}"] = st[f].detach().cpu().numpy()
    return out


def load_state_arrays(optimizer, arrays: dict) -> None:
    """Put :func:`state_arrays` output back: into the existing state
    tensors in place, or as new state where the optimizer has none yet."""
    for i, p, st in _slots(optimizer):
        for f in _FIELDS:
            a = arrays.get(f"{i}/{f}")
            if a is None:
                continue
            t = torch.from_numpy(np.asarray(a))
            if f in st:
                st[f].copy_(t)
            elif f == "step":
                capt = optimizer.param_groups[0].get("capturable", False)
                st[f] = t.to(p.device if capt else "cpu")
            else:
                st[f] = t.to(p.device)


class StackedAdam:
    """Adam (AdamW with ``decoupled``) over parameters with a leading fold
    axis ``[F, ...]``, with torch's per-parameter state layout: each
    parameter's ``state["step"]`` is one count per fold ([F] on the
    device), created with the moments up front, and :meth:`step`
    ``(active)`` updates only the folds in ``active`` -- parameters,
    moments and counts -- as F separate ``torch.optim`` optimizers stepped
    where their batch has rows.  The arithmetic is torch's capturable
    Adam, written per fold."""

    def __init__(self, groups, folds: int, lr: float, betas, eps: float,
                 decoupled: bool):
        self.param_groups = [{"params": list(ps), "weight_decay": wd}
                             for ps, wd in groups]
        self.lr, (self.b1, self.b2), self.eps = lr, betas, eps
        self.decoupled = decoupled
        self.state = {p: {"step": torch.zeros(folds, dtype=_scalar_dtype(),
                                              device=p.device),
                          "exp_avg": torch.zeros_like(p),
                          "exp_avg_sq": torch.zeros_like(p)}
                      for g in self.param_groups for p in g["params"]}

    def zero_grad(self, set_to_none: bool = True) -> None:
        for g in self.param_groups:
            for p in g["params"]:
                p.grad = None

    @torch.no_grad()
    def step(self, active: torch.Tensor) -> None:
        """One step of the folds where ``active`` ([F] bool) is set."""
        lr, b1, b2 = self.lr, self.b1, self.b2
        for group in self.param_groups:
            wd = group["weight_decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                lead = (-1,) + (1,) * (p.dim() - 1)
                on = active.reshape(lead)
                grad, st = p.grad, self.state[p]
                st["step"].add_(active.to(st["step"].dtype))
                # the bias corrections in the parameter's precision
                steps = st["step"].to(p.dtype)
                step_size_neg = -(lr / (1 - b1 ** steps))
                bc2_sqrt = (1 - b2 ** steps).sqrt()
                new_p = p
                if wd:
                    if self.decoupled:
                        new_p = p * (1 - lr * wd)
                    else:
                        grad = grad + wd * p
                m = st["exp_avg"].lerp(grad, 1 - b1)
                v = st["exp_avg_sq"] * b2 + (1 - b2) * grad * grad
                denom = (v.sqrt() / (bc2_sqrt * step_size_neg).reshape(lead)
                         + (self.eps / step_size_neg).reshape(lead))
                new_p = new_p + m / denom
                p.copy_(torch.where(on, new_p, p))
                st["exp_avg"].copy_(torch.where(on, m, st["exp_avg"]))
                st["exp_avg_sq"].copy_(torch.where(on, v, st["exp_avg_sq"]))


def build_stacked(cfg: OptimizerConfig, model: nn.Module) -> StackedAdam:
    """The recipe's optimizer over a fold-stacked model
    (:func:`..models.folds.stack`)."""
    return StackedAdam(_groups(cfg, model), model.folds, cfg.learning_rate,
                       (cfg.b1, cfg.b2), cfg.eps, cfg.name == "adamw")
