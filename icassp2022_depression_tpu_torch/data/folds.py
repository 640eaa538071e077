"""3-fold evaluation recipes (port of
:mod:`icassp2022_depression_tpu.data.folds`, NumPy only, line for line).

Classification track: the reference loads persisted winning train-index
files ``train_idxs_{f1:.2f}_{fold}.npy`` (``audio_gru_whole.py:261-263``)
that were originally produced by a shuffled KFold (commented at ``:258-260``)
and then re-saved whenever a checkpoint gate fired.  Regression track: the
reference loads persisted shuffles ``dep_idxs.npy``/``non_idxs.npy`` and
slices 10 depressed + 44 non-depressed test speakers per fold
(``Regression/audio_bilstm_perm.py:21-30,215-219``).

This module supports both loading those artifact files (for parity runs on
the real corpus) and deterministic PRNG-seeded generation (for fresh runs
and tests), since the artifacts are not part of the repository.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Sequence, Tuple

import numpy as np


def load_index_file(path) -> np.ndarray:
    return np.load(Path(path), allow_pickle=True)


def generate_clf_folds(targets: np.ndarray, n_folds: int = 3,
                       seed: int = 0) -> List[np.ndarray]:
    """Deterministic stratified K-fold over speakers -> list of train-index
    arrays (one per fold), the generated analogue of the reference's saved
    ``train_idxs_*.npy`` files."""
    targets = np.asarray(targets).ravel()
    rng = np.random.default_rng(seed)
    train_folds = []
    test_folds: List[np.ndarray] = [np.empty(0, np.int64)] * n_folds
    for label in np.unique(targets):
        idxs = np.where(targets == label)[0]
        rng.shuffle(idxs)
        for fold, chunk in enumerate(np.array_split(idxs, n_folds)):
            test_folds[fold] = np.concatenate([test_folds[fold], chunk])
    all_idxs = np.arange(len(targets))
    for fold in range(n_folds):
        test_set = set(test_folds[fold].tolist())
        train_folds.append(np.array([i for i in all_idxs if i not in test_set],
                                    dtype=np.int64))
    return train_folds


def generate_reg_shuffles(targets: np.ndarray, threshold: float = 53.0,
                          seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Shuffled (dep_idxs, non_idxs) — the generated analogue of the
    persisted ``dep_idxs.npy``/``non_idxs.npy`` (the commented generator at
    ``audio_bilstm_perm.py:21-28`` used ``random.sample``)."""
    targets = np.asarray(targets).ravel()
    dep = np.where(targets >= threshold)[0]
    non = np.where(targets < threshold)[0]
    rng = np.random.default_rng(seed)
    dep = dep[rng.permutation(len(dep))]
    non = non[rng.permutation(len(non))]
    return dep, non


def reg_fold_split(dep_idxs: np.ndarray, non_idxs: np.ndarray, fold: int,
                   test_dep: int = 10, test_non: int = 44):
    """Fold ``fold`` of the regression recipe
    (``audio_bilstm_perm.py:215-219``):

    test = dep[fold*10:(fold+1)*10] + non[fold*44:(fold+1)*44];
    train = the complements.  The reference takes the complements through
    ``list(set(a) - set(b))`` whose ordering is CPython-hash dependent; we
    use ascending order deterministically (documented deviation — the
    reference's own ordering is unspecified behaviour; the order only
    decides *which* 14 depressed speakers get augmented).
    """
    dep_idxs = np.asarray(dep_idxs).ravel()
    non_idxs = np.asarray(non_idxs).ravel()
    test_dep_idxs = dep_idxs[fold * test_dep:(fold + 1) * test_dep]
    test_non_idxs = non_idxs[fold * test_non:(fold + 1) * test_non]
    train_dep = np.array(sorted(set(dep_idxs.tolist()) -
                                set(test_dep_idxs.tolist())), dtype=np.int64)
    train_non = np.array(sorted(set(non_idxs.tolist()) -
                                set(test_non_idxs.tolist())), dtype=np.int64)
    return train_dep, train_non, test_dep_idxs, test_non_idxs


def ascending_complement(universe, exclude) -> list:
    """Sorted members of ``universe`` not in ``exclude`` — THE complement
    ordering for every fold recipe (the documented deterministic stand-in
    for the reference's CPython set-difference ordering)."""
    excl = set(int(i) for i in np.asarray(list(exclude)).ravel())
    return [i for i in sorted(set(int(i) for i in universe))
            if i not in excl]


def clf_test_complement(train_idxs: Sequence[int], n_total: int) -> np.ndarray:
    """Ascending complement — the classification fold's test speakers."""
    return np.array(ascending_complement(range(n_total), train_idxs),
                    dtype=np.int64)
