"""A mixture-of-experts layer's routing, dispatch and combine, on the
device (no counterpart in the JAX package, whose models have no experts;
:mod:`..models.moe_lm` uses it).

* :func:`route`: DeepSeek-V3's router (``noaux_tc`` with one group):
  ``s = sigmoid(x @ W^T)``, the top ``k`` of ``s + bias``
  selected, their ``s`` divided by their sum (the published
  ``norm_topk_prob``) and scaled by the routed scaling factor.
* :func:`dispatch`: the token-expert slots sorted by expert (a stable
  sort, so the order within an expert is the slots' order) and each
  expert's first row, ``offsets`` [E + 1], found on the device by a
  search of the sorted ids: no count is read back to the host.
* :func:`experts`: every routed expert's SiLU MLP over its rows, each
  row's output scaled by its slot's weight.  On a CUDA tensor it is two
  launches of ``csrc/moe_experts.cu`` (built with ``nvcc`` at first use,
  :mod:`.._build`), which read the offsets on the device and add two to
  :data:`LAUNCHES`; on a CPU tensor it is :func:`experts_torch`, the
  kernel's oracle, a loop over the experts.
* :func:`moe`: the three, then each token's ``k`` slots gathered back and
  summed in slot order: a fixed order, no atomics, so a rerun gives the
  same bits.

Only the rows given are routed: a caller passes its real tokens, never
padding.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from icassp2022_depression_tpu_torch import _build

#: launches of the grouped-expert kernels in this process, two a layer
LAUNCHES = 0

#: the kernel's tiles: the columns of the gate-and-up product's tile and of
#: the down product's, and the depth of one step
GATE_UP_COLS, DOWN_COLS, TILE_DEPTH = 64, 128, 16
#: the most experts the kernel's tile schedule holds
MAX_EXPERTS = 256


def route(x: torch.Tensor, w_gate: torch.Tensor, bias: torch.Tensor,
          k: int, scale: float):
    """x [N, H], router weight [E, H], selection bias [E] -> (expert ids
    [N, k] int64, routing weights [N, k] float32), DeepSeek-V3's
    ``MoEGate`` with one group."""
    scores = torch.sigmoid(F.linear(x, w_gate))
    idx = torch.topk(scores + bias, k, dim=-1).indices
    weights = scores.gather(1, idx)
    if k > 1:
        weights = weights / (weights.sum(dim=-1, keepdim=True) + 1e-20)
    return idx, weights * scale


def dispatch(idx: torch.Tensor, n_experts: int):
    """Expert ids [N, k] -> (the slots in expert order [N k] int64, each
    expert's first sorted row [E + 1] int32, the last being N k)."""
    experts_sorted, order = torch.sort(idx.reshape(-1), stable=True)
    bounds = torch.arange(n_experts + 1, device=idx.device,
                          dtype=experts_sorted.dtype)
    offsets = torch.searchsorted(experts_sorted, bounds)
    return order, offsets.to(torch.int32)


def experts_torch(xs: torch.Tensor, w_gate: torch.Tensor,
                  w_up: torch.Tensor, w_down: torch.Tensor,
                  slot_w: torch.Tensor, offsets: torch.Tensor
                  ) -> torch.Tensor:
    """The plain version: rows [M, H] in expert order, the experts' gate
    and up weights [E, I, H] and down weights [E, H, I], the rows' routing
    weights [M] and :func:`dispatch`'s offsets -> [M, H], row r
    ``slot_w[r] * down(silu(gate(x_r)) * up(x_r))`` of its expert.  It
    reads the offsets on the host."""
    ys = torch.zeros_like(xs)
    bounds = offsets.tolist()
    for e in range(w_gate.shape[0]):
        a, b = bounds[e], bounds[e + 1]
        if a == b:
            continue
        x = xs[a:b]
        h = F.silu(x @ w_gate[e].T) * (x @ w_up[e].T)
        ys[a:b] = (h @ w_down[e].T) * slot_w[a:b, None]
    return ys


def _check(xs, w_gate, w_up, w_down, slot_w, offsets) -> None:
    """Raises on what the kernel does not take."""
    m, h = xs.shape
    e, i, _ = w_gate.shape
    want = {"xs": (xs, (m, h)), "w_gate": (w_gate, (e, i, h)),
            "w_up": (w_up, (e, i, h)), "w_down": (w_down, (e, h, i)),
            "slot_w": (slot_w, (m,))}
    for name, (t, shape) in want.items():
        if t.dtype is not torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"moe_experts: {name} must be float32 "
                             f"{shape}, got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous() or t.device != xs.device:
            raise ValueError(f"moe_experts: {name} must be contiguous on "
                             f"{xs.device}")
    if (offsets.dtype is not torch.int32 or tuple(offsets.shape) != (e + 1,)
            or offsets.device != xs.device or not offsets.is_contiguous()):
        raise ValueError(f"moe_experts: offsets must be int32 [{e + 1}] on "
                         f"{xs.device}")
    if (h % DOWN_COLS or h % TILE_DEPTH or i % GATE_UP_COLS
            or i % TILE_DEPTH or not 0 < e <= MAX_EXPERTS):
        raise ValueError(
            f"moe_experts: hidden {h} must be a multiple of {DOWN_COLS}, "
            f"the expert width {i} of {GATE_UP_COLS}, and 1-{MAX_EXPERTS} "
            f"experts (got {e})")


_fn = None


def _kernel():
    """The C entry ``moe_experts_f32``, built and bound at first use."""
    global _fn
    if _fn is None:
        fn = _build.load("moe_experts").moe_experts_f32
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def experts(xs: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
            w_down: torch.Tensor, slot_w: torch.Tensor,
            offsets: torch.Tensor) -> torch.Tensor:
    """:func:`experts_torch`'s function: on a CUDA tensor the two kernel
    launches on the current stream (the gate-and-up product with
    ``silu(g) * u`` in its epilogue into a scratch [M, I], then the down
    product with the slot's weight in its epilogue), else the plain
    version."""
    global LAUNCHES
    if xs.device.type == "cpu":
        return experts_torch(xs, w_gate, w_up, w_down, slot_w, offsets)
    if xs.device.type != "cuda":
        raise ValueError(f"moe_experts: unsupported device {xs.device}")
    _check(xs, w_gate, w_up, w_down, slot_w, offsets)
    m, h = xs.shape
    e, i, _ = w_gate.shape
    ys = torch.empty_like(xs)
    if m == 0:
        return ys
    act = torch.empty((m, i), dtype=torch.float32, device=xs.device)
    with torch.cuda.device(xs.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(xs.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(),
                        w_down.data_ptr(), slot_w.data_ptr(),
                        offsets.data_ptr(), act.data_ptr(), ys.data_ptr(),
                        m, e, h, i, stream)
    if err != 0:
        raise RuntimeError(f"moe_experts_f32 launch failed: cudaError {err}")
    LAUNCHES += 2
    return ys


def moe(x: torch.Tensor, w_router: torch.Tensor, bias: torch.Tensor,
        w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
        k: int, scale: float) -> torch.Tensor:
    """The routed experts' sum for tokens x [N, H] -> [N, H]: route,
    dispatch, the experts, then each token's slots summed in slot order."""
    n, h = x.shape
    idx, weights = route(x, w_router, bias, k, scale)
    order, offsets = dispatch(idx, w_gate.shape[0])
    xs = x.index_select(0, torch.div(order, k, rounding_mode="floor"))
    ys = experts(xs, w_gate, w_up, w_down,
                 weights.reshape(-1).index_select(0, order), offsets)
    slots = torch.empty_like(order).scatter_(
        0, order, torch.arange(order.numel(), device=x.device))
    return ys.index_select(0, slots).view(n, k, h).sum(dim=1)
