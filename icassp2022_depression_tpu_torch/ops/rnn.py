"""Multi-layer, bidirectional GRU and LSTM, and the ELMo biLM's LSTM with
projection (port of :mod:`icassp2022_depression_tpu.ops.rnn`).

* The input projection ``x @ W_ih^T + b_ih`` for all time steps is one
  ``torch.matmul`` outside the recurrence, as in the JAX package
  (``rnn_pallas.py:981-983``).
* The recurrence goes through one backend seam, :func:`resolve_backend`,
  and one autograd Function per cell, :class:`.rnn_cuda.GRUSequence` and
  :class:`.rnn_cuda.LSTMSequence`: ``"cuda"`` runs the hand-written
  forward and backward kernels of :mod:`.rnn_cuda`,
  ``"torch"`` the plain PyTorch loops beside them, ``"auto"`` picks the
  kernels for CUDA tensors and the plain loops for CPU tensors.
  :func:`lstmp_layer` takes the same seam to
  :class:`.rnn_cuda.LSTMPSequence`; :func:`lstmp_layer_stateful` (carried
  states, the stateful ELMo mode) is a plain step loop, as the JAX package
  runs it.  The kernels take any batch size,
  sequence length and geometry, so the TPU package's VMEM-fit guards
  (``_pallas_fits``, ``_lstmp_pallas_fits``) and its streamed kernels have
  no counterpart here.
* Parameters keep torch's layout (row-stacked ``[G*H, D]`` matrices in
  gate order r, z, n for the GRU and i, f, g, o for the LSTM), and
  :class:`RNN` registers them under ``nn.GRU``'s / ``nn.LSTM``'s names, so
  reference checkpoints load tensor for tensor.  ``nn.GRU`` and ``nn.LSTM``
  themselves are not used: cuDNN must not run the recurrence.
* Initial weights and the inter-layer dropout masks come from threefry keys
  split in the JAX package's order (:func:`init_params`, :func:`rnn`), so a
  key gives the JAX package's numbers.
* Fold axis (``--vmap-folds``): layers whose parameters carry a leading
  fold axis ``[F, ...]`` run on inputs ``[F, B, T, D]``, and the kernels
  take all F folds in one launch (:mod:`.rnn_cuda`).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from icassp2022_depression_tpu_torch.ops import initializers, prng, rnn_cuda
from icassp2022_depression_tpu_torch.ops.nn import dropout as _dropout
from icassp2022_depression_tpu_torch.ops.nn import linear

GATES = {"gru": 3, "lstm": 4}
BACKENDS = ("auto", "torch", "cuda")


def _check_cell(cell: str) -> None:
    if cell not in GATES:
        raise ValueError(f"unknown cell {cell!r}")


_INITS = {"torch": initializers.torch_rnn_layer,
          "xavier": initializers.xavier_rnn_layer}


def init_params(cell: str, input_size: int, hidden: int, num_layers: int,
                bidirectional: bool, init: str = "torch",
                key: Optional[torch.Tensor] = None) -> list:
    """Parameter list over layers; each layer is a dict with direction keys
    ``fwd`` (and ``bwd`` when bidirectional) of
    ``{w_ih, w_hh, b_ih, b_hh}``; ``init`` is "torch" (``nn.GRU`` /
    ``nn.LSTM`` defaults) or "xavier" (the text model's scheme).  Layer l,
    direction d draws from ``split(key, L * D)[l * D + d]``, as the JAX
    package's ``rnn.init_params`` (a None key: zeros)."""
    _check_cell(cell)
    if init not in _INITS:
        raise ValueError(f"unknown init {init!r}")
    num_dirs = 2 if bidirectional else 1
    keys = ([None] * (num_layers * num_dirs) if key is None
            else list(prng.split(key, num_layers * num_dirs)))
    layers = []
    for layer in range(num_layers):
        in_size = input_size if layer == 0 else hidden * num_dirs
        layers.append({
            d: _INITS[init](keys[layer * num_dirs + i], GATES[cell], hidden,
                            in_size)
            for i, d in enumerate(("fwd", "bwd")[:num_dirs])})
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


def _sequence_inputs(p: dict, x: torch.Tensor, reverse: bool):
    """The hoisted input projection ``xp [T, B, G*H]`` (time-reversed for
    the backward direction) and the recurrent weights in the kernels'
    layout (each with the fold axis in front, when the layer has one)."""
    if reverse:
        x = torch.flip(x, dims=(-2,))
    xp = linear(x, p["w_ih"], p["b_ih"])
    return (xp.transpose(-3, -2).contiguous(),
            p["w_hh"].transpose(-1, -2).contiguous(),
            p["b_hh"].unsqueeze(-2))


def _batch_first(ys: torch.Tensor, reverse: bool) -> torch.Tensor:
    ys = ys.transpose(-3, -2)
    return torch.flip(ys, dims=(-2,)) if reverse else ys


def gru_layer(p: dict, x: torch.Tensor, reverse: bool = False,
              backend: str = "auto"):
    """One GRU direction.  ``p``: {w_ih [3H, D], w_hh [3H, H], b_ih [3H],
    b_hh [3H]}; x: [B, T, D].  Returns (ys [B, T, H], h_last [B, H]).
    With a fold axis: ``p`` [F, ...], x [F, B, T, D], results [F, ...]."""
    backend = resolve_backend(backend, x)
    # "torch": the plain forward and backward, no kernel on any device
    ys = rnn_cuda.GRUSequence.apply(*_sequence_inputs(p, x, reverse),
                                    backend == "torch")
    return _batch_first(ys, reverse), ys[..., -1, :, :]


def lstm_layer(p: dict, x: torch.Tensor, reverse: bool = False,
               backend: str = "auto"):
    """One LSTM direction (``rnn_pallas.lstm_layer``).  ``p``: {w_ih
    [4H, D], w_hh [4H, H], b_ih [4H], b_hh [4H]}; x: [B, T, D].  Returns
    (ys [B, T, H], h_last [B, H], c_last [B, H]); a fold axis as in
    :func:`gru_layer`."""
    backend = resolve_backend(backend, x)
    ys, cs = rnn_cuda.LSTMSequence.apply(*_sequence_inputs(p, x, reverse),
                                         backend == "torch")
    return (_batch_first(ys, reverse), ys[..., -1, :, :],
            cs[..., -1, :, :])


def init_lstmp(key: torch.Tensor, input_size: int, cell: int,
               proj: int) -> dict:
    """One LSTMP direction drawn from the threefry ``key`` exactly as the
    JAX package's ``init_lstmp`` draws it (same split and bounds), on the
    key's device: {w_x [4C, In], w_h [4C, P], b [4C] (zeros), w_p [P, C]}."""
    k1, k2, k3 = prng.split(key, 3)

    def uni(k, shape, bound):
        return prng.uniform(k, shape, -bound, bound)

    return {"w_x": uni(k1, (4 * cell, input_size), 1.0 / input_size ** 0.5),
            "w_h": uni(k2, (4 * cell, proj), 1.0 / proj ** 0.5),
            "b": torch.zeros((4 * cell,), dtype=torch.float32,
                             device=key.device),
            "w_p": uni(k3, (proj, cell), 1.0 / cell ** 0.5)}


def lstmp_layer(p: dict, x: torch.Tensor, reverse: bool = False,
                cell_clip: float = 3.0, proj_clip: float = 3.0,
                backend: str = "auto"):
    """LSTM with projection, the ELMo biLM cell (allennlp
    ``LstmCellWithProjection``; ``rnn.lstmp_layer`` / ``rnn_pallas.
    lstmp_layer_streamed`` in the JAX package): gate order i, f, g, o, the
    cell clipped to +-``cell_clip`` and the projected state to
    +-``proj_clip`` (0: no clip), zero initial state.  ``p``: {w_x [4C, In]
    (no bias), w_h [4C, P], b [4C], w_p [P, C]}; x: [B, T, In].  The input
    projection is one ``torch.matmul`` outside the recurrence
    (``rnn_pallas.py:841-842``).  Returns (ys [B, T, P], h_last [B, P],
    c_last [B, C])."""
    backend = resolve_backend(backend, x)
    if reverse:
        x = torch.flip(x, dims=(1,))
    b, t_steps, _ = x.shape
    p_dim, c_dim = p["w_p"].shape
    xp = torch.matmul(x, p["w_x"].t())
    xp4 = xp.transpose(0, 1).reshape(t_steps, b, 4, c_dim).contiguous()
    w_h_t3 = p["w_h"].t().reshape(p_dim, 4, c_dim).contiguous()
    ys, cs_pre = rnn_cuda.LSTMPSequence.apply(
        xp4, w_h_t3, p["b"].reshape(1, 4, c_dim), p["w_p"].t().contiguous(),
        cell_clip, proj_clip, backend == "torch")
    c_last = cs_pre[-1].clamp(-cell_clip, cell_clip) if cell_clip \
        else cs_pre[-1]
    h_last = ys[-1]
    ys = ys.transpose(0, 1)
    if reverse:
        ys = torch.flip(ys, dims=(1,))
    return ys, h_last, c_last


def lstmp_layer_stateful(p: dict, x: torch.Tensor, valid: torch.Tensor,
                         h0: torch.Tensor, c0: torch.Tensor,
                         cell_clip: float = 3.0, proj_clip: float = 3.0):
    """:func:`lstmp_layer` with initial states and per-row validity
    (``rnn.lstmp_layer_stateful`` in the JAX package, the allennlp
    ``LstmCellWithProjection`` contract with an ``initial_state``): a
    row's state advances only on its valid steps, so ``h_last`` /
    ``c_last`` are its states at its last valid step, and a row with no
    valid step returns ``h0`` / ``c0`` unchanged.

    The stateful pretrained-ELMo mode's recurrence.  A plain step loop in
    torch, as the JAX package runs an XLA scan here: the ``lstmp_fwd``
    kernel, like the Pallas kernel it ports, is zero-state by contract.

    x: [B, T, In]; valid: [B, T] bool; h0: [B, P]; c0: [B, C].  Outputs at
    invalid positions are the would-be step outputs (callers mask them).
    Returns (ys [B, T, P], h_last [B, P], c_last [B, C])."""
    c_dim = p["w_x"].shape[0] // 4
    xp = torch.matmul(x, p["w_x"].t())
    w_h_t, w_p_t = p["w_h"].t(), p["w_p"].t()
    h, c = h0, c0
    ys = []
    for t in range(x.shape[1]):
        gp = xp[:, t] + torch.matmul(h, w_h_t) + p["b"]
        i = torch.sigmoid(gp[:, :c_dim])
        f = torch.sigmoid(gp[:, c_dim:2 * c_dim])
        g = torch.tanh(gp[:, 2 * c_dim:3 * c_dim])
        o = torch.sigmoid(gp[:, 3 * c_dim:])
        c_new = f * c + i * g
        if cell_clip:
            c_new = c_new.clamp(-cell_clip, cell_clip)
        h_new = torch.matmul(o * torch.tanh(c_new), w_p_t)
        if proj_clip:
            h_new = h_new.clamp(-proj_clip, proj_clip)
        keep = valid[:, t, None]
        h = torch.where(keep, h_new, h)
        c = torch.where(keep, c_new, c)
        ys.append(h_new)
    return torch.stack(ys, dim=1), h, c


def _run_direction(p: dict, x: torch.Tensor, cell: str, reverse: bool,
                   backend: str):
    if cell == "gru":
        ys, h_last = gru_layer(p, x, reverse, backend)
        return ys, h_last, None
    return lstm_layer(p, x, reverse, backend)


def rnn(params: Sequence[dict], x: torch.Tensor, cell: str = "gru",
        dropout: float = 0.0, train: bool = False,
        key: Optional[torch.Tensor] = None, backend: str = "auto",
        rows=None):
    """Multi-layer (bi)directional GRU or LSTM.

    Args:
      params: list from :func:`init_params` (or :meth:`RNN.layers`).
      x: [B, T, D] batch-first input ([F, B, T, D] for layers with a fold
        axis).
      dropout: inter-layer dropout rate (every layer's output but the
        last, torch's RNN ``dropout=`` semantics), applied when ``train``
        and ``key`` is given: each layer's mask from ``key, sub =
        split(key)``, as the JAX package draws them (keys [F, 2] with a
        fold axis).
      backend: "auto" | "torch" | "cuda" (see :func:`resolve_backend`).
      rows: the dropout masks' rows of a larger batch (see
        :func:`..ops.nn.dropout`).

    Returns:
      (output [B, T, H * num_dirs], h_n [B, num_layers * num_dirs, H] and
      c_n (the LSTM's, same layout; None for the GRU) in torch's order:
      layer 0 forward, layer 0 backward, layer 1 forward, ...)
    """
    _check_cell(cell)
    h_finals, c_finals = [], []
    y = x
    for layer_idx, layer in enumerate(params):
        outs = []
        for dirn in ("fwd", "bwd")[:len(layer)]:
            ys, h_last, c_last = _run_direction(layer[dirn], y, cell,
                                                dirn == "bwd", backend)
            outs.append(ys)
            h_finals.append(h_last)
            c_finals.append(c_last)
        y = torch.cat(outs, dim=-1) if len(outs) > 1 else outs[0]
        if train and dropout > 0.0 and key is not None and \
                layer_idx < len(params) - 1:
            key, sub = prng.split2(key)
            y = _dropout(y, dropout, True, sub, rows)
    c_n = torch.stack(c_finals, dim=-2) if cell == "lstm" else None
    return y, torch.stack(h_finals, dim=-2), c_n


class RNN(nn.Module):
    """Multi-layer GRU or LSTM whose parameters carry ``nn.GRU``'s /
    ``nn.LSTM``'s names (``weight_ih_l{k}[_reverse]``, ``weight_hh_l{k}``,
    ``bias_ih_l{k}``, ``bias_hh_l{k}``), run through :func:`rnn`."""

    _NAMES = {"w_ih": "weight_ih", "w_hh": "weight_hh", "b_ih": "bias_ih",
              "b_hh": "bias_hh"}

    def __init__(self, input_size: int, hidden: int, num_layers: int,
                 bidirectional: bool = False, dropout: float = 0.0,
                 cell: str = "gru", init: str = "torch",
                 backend: str = "auto",
                 key: Optional[torch.Tensor] = None, device=None):
        super().__init__()
        self.cell = cell
        self.num_layers = num_layers
        self.bidirectional = bidirectional
        self.dropout = dropout
        self.backend = backend
        layers = init_params(cell, input_size, hidden, num_layers,
                             bidirectional, init, key)
        for k, layer in enumerate(layers):
            for d, p in layer.items():
                suffix = "_reverse" if d == "bwd" else ""
                for short, long in self._NAMES.items():
                    self.register_parameter(
                        f"{long}_l{k}{suffix}",
                        nn.Parameter(p[short].to(device)))

    def layers(self) -> list:
        """The parameters as :func:`rnn`'s layer list."""
        dirs = (("fwd", ""), ("bwd", "_reverse"))[:2 if self.bidirectional
                                                    else 1]
        return [{d: {short: getattr(self, f"{long}_l{k}{suffix}")
                     for short, long in self._NAMES.items()}
                 for d, suffix in dirs}
                for k in range(self.num_layers)]

    def forward(self, x: torch.Tensor, key: Optional[torch.Tensor] = None,
                rows=None):
        return rnn(self.layers(), x, self.cell, self.dropout, self.training,
                   key, self.backend, rows)
