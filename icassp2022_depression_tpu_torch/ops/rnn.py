"""Multi-layer, bidirectional GRU (port of :mod:`icassp2022_depression_tpu.ops.rnn`).

* The input projection ``x @ W_ih^T + b_ih`` for all time steps is one
  ``torch.matmul`` outside the recurrence, as in the JAX package
  (``rnn_pallas.py:981-983``).
* The recurrence goes through one backend seam, :func:`resolve_backend`,
  and one autograd Function, :class:`.rnn_cuda.GRUSequence`: ``"cuda"``
  runs the hand-written forward and backward kernels of :mod:`.rnn_cuda`,
  ``"torch"`` the plain PyTorch loops beside them, ``"auto"`` picks the
  kernels for CUDA tensors and the plain loops for CPU tensors.  The
  kernels take any batch size and sequence length, so the TPU package's
  VMEM-fit guards (and its streamed kernels) have no counterpart here.
* Parameters keep torch's layout (row-stacked ``[3H, D]`` matrices in gate
  order r, z, n), and :class:`RNN` registers them under ``nn.GRU``'s
  names, so reference checkpoints load tensor for tensor.  ``nn.GRU``
  itself is not used: cuDNN must not run the recurrence.

The LSTM cell arrives with the text slice.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from icassp2022_depression_tpu_torch.ops import initializers, rnn_cuda
from icassp2022_depression_tpu_torch.ops.nn import dropout as _dropout

GATES = {"gru": 3, "lstm": 4}
BACKENDS = ("auto", "torch", "cuda")


def _check_cell(cell: str) -> None:
    if cell == "lstm":
        raise NotImplementedError(
            "cell='lstm' (the text branch and its LSTM kernels) arrives with "
            "the text slice of the port")
    if cell != "gru":
        raise ValueError(f"unknown cell {cell!r}")


def init_params(cell: str, input_size: int, hidden: int, num_layers: int,
                bidirectional: bool, init: str = "torch",
                generator: Optional[torch.Generator] = None,
                dtype=torch.float32, device=None) -> list:
    """Parameter list over layers; each layer is a dict with direction keys
    ``fwd`` (and ``bwd`` when bidirectional) of
    ``{w_ih, w_hh, b_ih, b_hh}``."""
    _check_cell(cell)
    if init != "torch":
        raise NotImplementedError(
            f"init={init!r}: the xavier scheme of the text model arrives "
            "with the text slice of the port")
    num_dirs = 2 if bidirectional else 1
    layers = []
    for layer in range(num_layers):
        in_size = input_size if layer == 0 else hidden * num_dirs
        layers.append({
            d: initializers.torch_rnn_layer(GATES[cell], hidden, in_size,
                                            generator, dtype, device)
            for d in ("fwd", "bwd")[:num_dirs]})
    return layers


def resolve_backend(backend: str, x: torch.Tensor) -> str:
    """'auto' -> 'cuda' for CUDA tensors, 'torch' for CPU tensors.  An
    explicit 'cuda' on a tensor that is not on a card raises."""
    if backend not in BACKENDS:
        raise ValueError(f"rnn backend must be one of {BACKENDS}, "
                         f"got {backend!r}")
    if backend == "auto":
        return "cuda" if x.device.type == "cuda" else "torch"
    if backend == "cuda" and x.device.type != "cuda":
        raise ValueError(f"rnn backend 'cuda' needs CUDA tensors, got a "
                         f"tensor on {x.device}")
    return backend


def gru_layer(p: dict, x: torch.Tensor, reverse: bool = False,
              backend: str = "auto"):
    """One GRU direction.  ``p``: {w_ih [3H, D], w_hh [3H, H], b_ih [3H],
    b_hh [3H]}; x: [B, T, D].  Returns (ys [B, T, H], h_last [B, H])."""
    backend = resolve_backend(backend, x)
    if reverse:
        x = torch.flip(x, dims=(1,))
    xp = torch.matmul(x, p["w_ih"].t()) + p["b_ih"]
    xp = xp.transpose(0, 1).contiguous()                  # [T, B, 3H]
    w_hh_t = p["w_hh"].t().contiguous()
    b_hh = p["b_hh"].reshape(1, -1)
    # "torch": the plain forward and backward, no kernel on any device
    ys = rnn_cuda.GRUSequence.apply(xp, w_hh_t, b_hh, backend == "torch")
    h_last = ys[-1]
    ys = ys.transpose(0, 1)
    if reverse:
        ys = torch.flip(ys, dims=(1,))
    return ys, h_last


def rnn(params: Sequence[dict], x: torch.Tensor, cell: str = "gru",
        dropout: float = 0.0, train: bool = False,
        generator: Optional[torch.Generator] = None, backend: str = "auto"):
    """Multi-layer (bi)directional GRU.

    Args:
      params: list from :func:`init_params` (or :meth:`RNN.layers`).
      x: [B, T, D] batch-first input.
      dropout: inter-layer dropout rate (every layer's output but the
        last, torch's RNN ``dropout=`` semantics), applied when ``train``.
      backend: "auto" | "torch" | "cuda" (see :func:`resolve_backend`).

    Returns:
      (output [B, T, H * num_dirs], h_n [B, num_layers * num_dirs, H] in
      torch's order, None for the GRU's absent c_n)
    """
    _check_cell(cell)
    h_finals = []
    y = x
    for layer_idx, layer in enumerate(params):
        ys_f, h_f = gru_layer(layer["fwd"], y, False, backend)
        h_finals.append(h_f)
        if "bwd" in layer:
            ys_b, h_b = gru_layer(layer["bwd"], y, True, backend)
            h_finals.append(h_b)
            y = torch.cat([ys_f, ys_b], dim=-1)
        else:
            y = ys_f
        if train and dropout > 0.0 and layer_idx < len(params) - 1:
            y = _dropout(y, dropout, True, generator)
    return y, torch.stack(h_finals, dim=1), None


class RNN(nn.Module):
    """Multi-layer GRU whose parameters carry ``nn.GRU``'s names
    (``weight_ih_l{k}[_reverse]``, ``weight_hh_l{k}``, ``bias_ih_l{k}``,
    ``bias_hh_l{k}``), run through :func:`rnn`."""

    _NAMES = {"w_ih": "weight_ih", "w_hh": "weight_hh", "b_ih": "bias_ih",
              "b_hh": "bias_hh"}

    def __init__(self, input_size: int, hidden: int, num_layers: int,
                 bidirectional: bool = False, dropout: float = 0.0,
                 cell: str = "gru", init: str = "torch",
                 backend: str = "auto",
                 generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        self.cell = cell
        self.num_layers = num_layers
        self.bidirectional = bidirectional
        self.dropout = dropout
        self.backend = backend
        layers = init_params(cell, input_size, hidden, num_layers,
                             bidirectional, init, generator, device=device)
        for k, layer in enumerate(layers):
            for d, p in layer.items():
                suffix = "_reverse" if d == "bwd" else ""
                for short, long in self._NAMES.items():
                    self.register_parameter(f"{long}_l{k}{suffix}",
                                            nn.Parameter(p[short]))

    def layers(self) -> list:
        """The parameters as :func:`rnn`'s layer list."""
        dirs = (("fwd", ""), ("bwd", "_reverse"))[:2 if self.bidirectional
                                                    else 1]
        return [{d: {short: getattr(self, f"{long}_l{k}{suffix}")
                     for short, long in self._NAMES.items()}
                 for d, suffix in dirs}
                for k in range(self.num_layers)]

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        return rnn(self.layers(), x, self.cell, self.dropout, self.training,
                   generator, self.backend)
