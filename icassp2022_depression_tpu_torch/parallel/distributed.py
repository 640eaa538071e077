"""Process groups, the rank launcher and the fold-parallel layout (port of
:mod:`icassp2022_depression_tpu.parallel.distributed`).

The JAX package scales the three independent fold programs by sharding
their stacked fold axis over a device mesh (``fold_mesh``), and each
fold's batch axis over a second mesh axis (``fold_data_mesh``): one SPMD
program over many devices.  Here every device is one process (a rank of a
``torch.distributed`` group) and every rank runs the same program on its
share:

* :func:`launch` starts one rank per device (``spawn``: CUDA forbids a
  fork after it initialised) over NCCL on cards, one rank per card, or
  Gloo on ranks the caller puts on the CPU (or on a shared card), joined
  through a ``file://`` rendezvous in a fresh
  temporary directory; :func:`initialize` joins a group that ``torchrun``
  launched (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` /
  ``MASTER_PORT``), and does nothing in a single process;
* :func:`fold_mesh` / :func:`fold_data_mesh` give a rank its folds (F
  over the fold groups, one fold a group) and, with data parallelism, its
  place in its fold's data group; :func:`shard_over_folds` and
  :func:`shard_stacked_fold_data` cut a stacked-fold tree and a stacked
  :class:`..train.loop.FoldData` to the rank's share;
* :func:`gather_folds` puts every fold group's results (or stacked state)
  back together, in fold order, on every rank.

Only rank 0 writes files (:func:`is_main`).
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile
import time
from pathlib import Path
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from icassp2022_depression_tpu_torch.utils import device as device_mod

#: a collective that waits longer than this raises (a rank that failed
#: leaves the others blocked in one otherwise)
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=600)


def world_size() -> int:
    """The default group's size (1 outside a group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    """This process's rank in the default group (0 outside a group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def is_main() -> bool:
    """Rank 0 (or a single process): the one rank that writes files."""
    return rank() == 0


def _join(backend: str, init_method: str, world: int, rank_: int,
          device) -> None:
    device_mod.set_rank_device(device)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank_,
                            timeout=COLLECTIVE_TIMEOUT)


def initialize(backend: Optional[str] = None) -> bool:
    """Join the group that ``torchrun`` launched this process into: NCCL
    with the card ``cuda:LOCAL_RANK`` (backend None; raises where there is
    no such card), or with ``backend="gloo"`` Gloo on the CPU.  With
    ``WORLD_SIZE`` unset or 1, or a group already joined, it does nothing.
    Returns whether this process is in a group."""
    n = int(os.environ.get("WORLD_SIZE", "1"))
    if n <= 1 or dist.is_initialized():
        return dist.is_initialized()
    rank_ = int(os.environ["RANK"])
    if backend is None:
        device_mod.require_card()
        backend = "nccl"
    device = (device_mod.local_rank_device(
        int(os.environ.get("LOCAL_RANK", rank_)))
        if backend == "nccl" else torch.device("cpu"))
    _join(backend, "env://", n, rank_, device)
    return True


def _host(tree):
    """``tree`` with every tensor moved to the host (what a rank hands
    back to the launcher)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_host(v) for v in tree]
        return tuple(out) if isinstance(tree, tuple) else out
    return tree


def _worker(index: int, fn, args, kwargs, world: int, devices, backend: str,
            out_dir: str, with_launches: bool) -> None:
    if backend == "gloo":
        # every rank of a launch is on this host
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    if devices[index] == "cpu":
        # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    _join(backend, f"file://{Path(out_dir) / 'rendezvous'}", world, index,
          torch.device(devices[index]))
    try:
        value = _host(fn(*args, **kwargs))
        if with_launches:
            from icassp2022_depression_tpu_torch.ops import rnn_cuda

            value = (value, rnn_cuda.launch_counts())
        tmp = Path(out_dir) / f".{index}.pkl"
        with open(tmp, "wb") as f:
            pickle.dump(value, f)
        tmp.rename(Path(out_dir) / f"{index}.pkl")
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, world: int, devices: Optional[Sequence] = None,
           backend: Optional[str] = None,
           args: tuple = (), kwargs: Optional[dict] = None,
           timeout: float = 3600.0, with_launches: bool = False) -> list:
    """Run ``fn(*args, **kwargs)`` on ``world`` ranks of a new group and
    return each rank's value (its tensors on the host), in rank order.

    ``devices[r]`` is rank r's device (default: one card a rank,
    ``cuda:0 .. cuda:world-1``, and an error when the host has fewer; CPU
    ranks are asked for as ``["cpu"] * world``); ``backend`` defaults to
    NCCL on cards and Gloo on the CPU (NCCL takes one rank per card; Gloo
    lets ranks share one).  ``fn`` must be a module-level function of this
    package: a rank is a fresh process (``spawn``) that imports it, and
    nothing else of the caller.  Kernels a rank runs are loaded from
    ``_build/``: build them before launching.  The rendezvous is a file in
    a fresh temporary directory.  The ranks are joined within ``timeout``
    seconds; a rank that raises ends the launch with its traceback, and
    the other ranks are stopped.  ``with_launches``: each value comes back
    as ``(value, the rank's kernel launch counts)``."""
    import torch.multiprocessing as mp

    if devices is None:
        devices = [device_mod.local_rank_device(r) for r in range(world)]
    devices = [str(torch.device(d)) for d in devices]
    if len(devices) != world:
        raise ValueError(f"{len(devices)} devices for {world} ranks")
    if backend is None:
        backend = "nccl" if devices[0].startswith("cuda") else "gloo"
    with tempfile.TemporaryDirectory(prefix="icassp_ranks_") as tmp:
        ctx = mp.start_processes(
            _worker, args=(fn, tuple(args), dict(kwargs or {}), world,
                           devices, backend, tmp, with_launches),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"{world} ranks of {fn.__module__}.{fn.__name__} "
                        f"did not finish within {timeout:.0f} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                p.join(10)
                if p.is_alive():
                    p.kill()
        values = []
        for r in range(world):
            with open(Path(tmp) / f"{r}.pkl", "rb") as f:
                values.append(pickle.load(f))
        return values


# -- the fold-parallel layout ------------------------------------------------


class FoldMesh(NamedTuple):
    """A rank's place in the ``(fold, data)`` grid of ranks: rank ``r``
    trains fold ``r // data_parallel`` as row ``r % data_parallel`` of its
    fold's data group (the JAX package's ``devices.reshape(n_folds,
    data_parallel)``)."""

    n_folds: int
    data_parallel: int
    folds: slice                    # this rank's folds (0-based)
    data_rank: int                  # its place in its fold's data group
    data_group: Optional[object]    # that group (None: no data parallelism)


def devices_needed(n_folds: int, data_parallel: int, have: int) -> None:
    """The JAX package's assertions (``AssertionError``, raised whatever
    ``-O`` says) when a layout has too few devices."""
    need = n_folds * data_parallel
    if have >= need:
        return
    raise AssertionError(
        f"need >= {n_folds} devices for fold parallelism, have {have}"
        if data_parallel == 1 else
        f"need >= {need} devices for {n_folds} folds x {data_parallel} DP")


def fold_data_mesh(n_folds: int, data_parallel: int) -> FoldMesh:
    """The ``(fold, data)`` layout over the default group: one fold a fold
    group, ``data_parallel`` ranks a fold group.  Every rank of the group
    must call it (it makes the data groups).  The group must have exactly
    ``n_folds * data_parallel`` ranks (fewer: the JAX package's assertion;
    more would leave ranks with no fold)."""
    world = world_size()
    devices_needed(n_folds, data_parallel, world)
    if world != n_folds * data_parallel:
        raise ValueError(
            f"{world} ranks for {n_folds} folds x {data_parallel} DP: the "
            f"layout takes exactly {n_folds * data_parallel}")
    r = rank()
    group = None
    if data_parallel > 1:
        for f in range(n_folds):
            ranks = list(range(f * data_parallel, (f + 1) * data_parallel))
            g = dist.new_group(ranks)
            if f == r // data_parallel:
                group = g
    fold = r // data_parallel
    return FoldMesh(n_folds, data_parallel, slice(fold, fold + 1),
                    r % data_parallel, group)


def fold_mesh(n_folds: int) -> FoldMesh:
    """The fold layout without data parallelism: one rank a fold."""
    return fold_data_mesh(n_folds, 1)


def shard_over_folds(mesh: FoldMesh, tree):
    """A stacked-fold tree (leading fold axis on every tensor; a stacked
    :class:`..train.loop.FoldData` too) cut to the rank's folds; the rest
    of each tensor stays whole (replicated within the fold's data group,
    as params, optimizer state and keys are)."""
    if isinstance(tree, torch.Tensor):
        return tree[mesh.folds]
    if isinstance(tree, dict):
        return {k: shard_over_folds(mesh, v) for k, v in tree.items()}
    if hasattr(tree, "n_train"):        # FoldData: one n_train a fold
        return tree._replace(
            **{k: shard_over_folds(mesh, getattr(tree, k))
               for k in tree._fields if k != "n_train"},
            n_train=tuple(tree.n_train[mesh.folds]))
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_over_folds(mesh, v) for v in tree)
    return tree


def shard_batch_rows(mesh: FoldMesh, data):
    """A stacked :class:`..train.loop.FoldData` of the rank's folds with
    each train batch's features ``[F, NB, B, ...]`` cut to its data rank's
    ``B / data_parallel`` rows.  The labels and masks stay whole (a rank's
    :class:`..train.loop.FoldRun` takes its rows of them, and its metric
    gate reads all of them), as does the test split (each data rank
    evaluates all of it: the same numbers, no gather)."""
    dp = mesh.data_parallel
    b = data.train_y.shape[2]
    n = data.test_y.shape[1]
    if b % dp:
        raise AssertionError(
            f"in-fold batch size {b} not divisible by data_parallel={dp}")
    if n % dp:
        raise AssertionError(
            f"padded test size {n} not divisible by data_parallel={dp}")
    rows = b // dp
    return data._replace(train_x=tuple(
        a.narrow(2, mesh.data_rank * rows, rows).contiguous()
        for a in data.train_x))


def shard_stacked_fold_data(mesh: FoldMesh, data):
    """A stacked :class:`..train.loop.FoldData` of all folds cut to the
    rank's share: its folds (:func:`shard_over_folds`), then its rows of
    every train batch (:func:`shard_batch_rows`)."""
    return shard_batch_rows(mesh, shard_over_folds(mesh, data))


def gather_folds(mesh: FoldMesh, value):
    """Every fold group's ``value`` on every rank, in fold order: a list
    of per-fold items is concatenated, a dict of arrays with a leading
    fold axis is concatenated along it (0-d arrays, the same on every
    rank, are taken once).  One rank a fold group (data rank 0) is read."""
    parts = [None] * world_size()
    dist.all_gather_object(parts, value if mesh.data_rank == 0 else None)
    parts = parts[::mesh.data_parallel]
    if isinstance(value, dict):
        return {k: (v if np.ndim(v) == 0
                    else np.concatenate([p[k] for p in parts]))
                for k, v in parts[0].items()}
    return [item for p in parts for item in p]
