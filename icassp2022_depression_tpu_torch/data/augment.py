"""Permutation augmentation of the 3 interview answers, as pure functions
(port of :mod:`icassp2022_depression_tpu.data.augment`, NumPy only, line
for line).

The reference grows the global feature array in place inside every fold loop
(``Classification/audio_gru_whole.py:264-298``,
``Regression/audio_bilstm_perm.py:215-241``,
``Classification/fuse_net_whole.py:533-564``): each depressed sample's
``[3, D]`` feature block is expanded into ``itertools.permutations`` of its
3 rows (6 orders, lexicographic by index: 012, 021, 102, 120, 201, 210);
*train* keeps permutation ids [0..5], *test* keeps [0,1,4,5] (test-set
augmentation — methodologically questionable but reproduced exactly), and
indices into the mutated array are collected.

Here the same selection is computed functionally: given the pristine arrays
and a fold's train indices, we materialise the augmented train/test feature
and target arrays in exactly the row order the reference's index
bookkeeping would produce (proved by the oracle test in
``tests/test_augment.py`` which replays the reference's vstack-growth
algorithm; ``tests/test_torch_train.py`` holds this port to it).
Fusion-style lockstep augmentation (audio and text permuted by
``zip`` in the same order, ``fuse_net_whole.py:541``) falls out by passing
multiple feature arrays.
"""

from __future__ import annotations

import itertools
from typing import NamedTuple, Sequence

import numpy as np

#: the 6 permutations of (0,1,2) in itertools order
PERMS = tuple(itertools.permutations(range(3)))
#: the same table as an indexable [6, 3] array (``PERM_TABLE[pid]`` = the
#: answer order for permutation id ``pid``)
PERM_TABLE = np.asarray(PERMS, np.int32)

TRAIN_PERM_IDS = (0, 1, 2, 3, 4, 5)
TEST_PERM_IDS = (0, 1, 4, 5)


class SplitPlan(NamedTuple):
    """Index form of one augmented split: output row ``r`` is speaker
    ``spk[r]``'s three answers reordered by ``PERMS[perm[r]]``, labelled
    ``targets[r]``.  The plan is pure host metadata (three tiny arrays), so
    the feature rows themselves can be materialised wherever the pristine
    ``[N, 3, ...]`` arrays live — as NumPy gathers on host or as torch
    gathers on the device (``train.loop.fold_data_from_plans``), which is
    how the fused extract->train pipeline avoids reading features back."""

    spk: np.ndarray        # int32 [R] speaker index into the pristine array
    perm: np.ndarray       # int32 [R] permutation id (0 = identity)
    targets: np.ndarray    # [R] row labels


def plan_split(targets: np.ndarray,
               idxs: Sequence[int],
               dep_idxs: Sequence[int],
               perm_ids: Sequence[int],
               augment_first_n: int | None = None,
               dep_target_value=None) -> SplitPlan:
    """Compute one (train or test) split's :class:`SplitPlan`.

    Args:
      targets: pristine [N] targets.
      idxs: the split's speaker indices, in reference iteration order.
      dep_idxs: indices of depressed speakers (augmentation applies to them).
      perm_ids: which of the 6 permutations to keep for augmented samples.
      augment_first_n: if set, only the first n *depressed* samples
        encountered get augmented (regression-track rule,
        ``audio_bilstm_perm.py:225``); later depressed samples pass through
        unaugmented.  None = augment all depressed samples.
      dep_target_value: target written for augmented rows; None copies the
        sample's own target (regression), otherwise the constant is used
        (classification writes literal 1 — ``audio_gru_whole.py:279``).

    Returns rows in the exact order the reference's index lists would
    select (proved by the vstack-replay oracle in ``tests/test_augment.py``
    through :func:`augment_split`).
    """
    dep_set = set(int(i) for i in np.asarray(dep_idxs).ravel())
    spk, perm, tgts = [], [], []
    dep_seen = 0
    for idx in idxs:
        idx = int(idx)
        is_dep = idx in dep_set
        do_augment = is_dep and (augment_first_n is None
                                 or dep_seen < augment_first_n)
        if is_dep:
            dep_seen += 1
        if do_augment:
            for pid in perm_ids:
                spk.append(idx)
                perm.append(pid)
                tgts.append(targets[idx] if dep_target_value is None
                            else dep_target_value)
        else:
            spk.append(idx)
            perm.append(0)
            tgts.append(targets[idx])
    return SplitPlan(np.asarray(spk, np.int32), np.asarray(perm, np.int32),
                     np.asarray(tgts))


def materialize_plan(feature_arrays: Sequence[np.ndarray], plan: SplitPlan):
    """Gather a plan's rows from pristine [N, 3, ...] arrays (NumPy, host).

    Row ``r`` of each output is ``arr[plan.spk[r]][PERMS[plan.perm[r]]]`` —
    a pure double gather with no arithmetic, so the device-side twin
    (``train.loop.fold_data_from_plans``) is bit-identical.
    """
    out = []
    for arr in feature_arrays:
        sel = arr[plan.spk]                                  # [R, 3, ...]
        order = PERM_TABLE[plan.perm]                        # [R, 3]
        order = order.reshape(order.shape + (1,) * (arr.ndim - 2))
        out.append(np.take_along_axis(sel, order, axis=1))
    return out


def augment_split(feature_arrays: Sequence[np.ndarray],
                  targets: np.ndarray,
                  idxs: Sequence[int],
                  dep_idxs: Sequence[int],
                  perm_ids: Sequence[int],
                  augment_first_n: int | None = None,
                  dep_target_value=None):
    """Materialise one split with permutation augmentation: the
    :func:`plan_split` index plan applied to host arrays.

    ``feature_arrays``: one or more pristine [N, 3, ...] arrays permuted in
    lockstep (1 for unimodal, 2 for fusion).  Returns (list of augmented
    feature arrays, augmented targets); see :func:`plan_split` for the
    selection semantics and reference citations.
    """
    plan = plan_split(targets, idxs, dep_idxs, perm_ids,
                      augment_first_n=augment_first_n,
                      dep_target_value=dep_target_value)
    return materialize_plan(feature_arrays, plan), plan.targets


def plan_classification_fold(targets, train_idxs_tmp, dep_idxs, non_idxs,
                             train_perm_ids=TRAIN_PERM_IDS,
                             test_perm_ids=TEST_PERM_IDS):
    """Index plans for one classification fold: train gets all 6 perms for
    depressed speakers, test gets perms [0,1,4,5]; non-depressed pass
    through.  Augmented rows are labelled 1
    (``audio_gru_whole.py:279,294``).

    Test indices are the complement of ``train_idxs_tmp`` in ascending
    order (the reference's ``list(set(...) - set(...))`` — CPython int-set
    iteration is ascending for these index magnitudes).
    """
    from icassp2022_depression_tpu_torch.data.folds import ascending_complement

    universe = (list(np.asarray(dep_idxs).ravel()) +
                list(np.asarray(non_idxs).ravel()))
    test_idxs_tmp = ascending_complement(universe,
                                         np.asarray(train_idxs_tmp).ravel())
    train = plan_split(targets, list(train_idxs_tmp), dep_idxs,
                       train_perm_ids, dep_target_value=1)
    test = plan_split(targets, test_idxs_tmp, dep_idxs, test_perm_ids,
                      dep_target_value=1)
    return train, test


def augment_classification_fold(feature_arrays, targets, train_idxs_tmp,
                                dep_idxs, non_idxs,
                                train_perm_ids=TRAIN_PERM_IDS,
                                test_perm_ids=TEST_PERM_IDS):
    """One classification fold materialised on host; selection semantics
    and citations in :func:`plan_classification_fold`."""
    tr_plan, te_plan = plan_classification_fold(
        targets, train_idxs_tmp, dep_idxs, non_idxs,
        train_perm_ids=train_perm_ids, test_perm_ids=test_perm_ids)
    return ((materialize_plan(feature_arrays, tr_plan), tr_plan.targets),
            (materialize_plan(feature_arrays, te_plan), te_plan.targets))


def plan_regression_fold(targets, train_dep_idxs_tmp, train_non_idxs,
                         test_dep_idxs, test_non_idxs,
                         augment_first_n: int = 14):
    """Index plans for one regression fold: only the first
    ``augment_first_n`` train depressed speakers get all 6 perms (labels
    copied, not constant); the test split is never augmented
    (``audio_bilstm_perm.py:221-241``).

    Row order matches the reference: depressed train rows first (in
    ``train_dep_idxs_tmp`` order, expanded), then non-depressed train rows;
    test = depressed then non-depressed.
    """
    train_idxs = list(train_dep_idxs_tmp) + list(train_non_idxs)
    train = plan_split(targets, train_idxs, train_dep_idxs_tmp,
                       TRAIN_PERM_IDS, augment_first_n=augment_first_n,
                       dep_target_value=None)
    test_idxs = np.asarray(list(test_dep_idxs) + list(test_non_idxs),
                           np.int64)
    test = SplitPlan(test_idxs.astype(np.int32),
                     np.zeros(len(test_idxs), np.int32),
                     targets[test_idxs])
    return train, test


def augment_regression_fold(feature_arrays, targets,
                            train_dep_idxs_tmp, train_non_idxs,
                            test_dep_idxs, test_non_idxs,
                            augment_first_n: int = 14):
    """One regression fold materialised on host; selection semantics and
    citations in :func:`plan_regression_fold`."""
    tr_plan, te_plan = plan_regression_fold(
        targets, train_dep_idxs_tmp, train_non_idxs, test_dep_idxs,
        test_non_idxs, augment_first_n=augment_first_n)
    return ((materialize_plan(feature_arrays, tr_plan), tr_plan.targets),
            (materialize_plan(feature_arrays, te_plan), te_plan.targets))
