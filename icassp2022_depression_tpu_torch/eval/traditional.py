"""Traditional (sklearn) baselines, on the host (port of
:mod:`icassp2022_depression_tpu.eval.traditional`).

Reference: ``Classification/AudioTraditionalClassifiers.py`` (RandomForest
n_estimators=50 active, SVM/LR commented) and
``Classification/TextTraditionalClassifiers.py`` (DecisionTree max_depth=20
active), both on the neural trainers' folds and augmentation with
flattened [3*D] features and NaN->0 metrics
(``AudioTraditionalClassifiers.py:112-114``); the regression scripts'
commented SVR/DT/RF/AdaBoost blocks (``Regression/audio_bilstm_perm.py:
268-376``) made runnable.  Every variant is selectable.

sklearn runs on the CPU and is imported when a model is made, so the rest
of the port imports on a machine without it.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from icassp2022_depression_tpu_torch.data import augment
from icassp2022_depression_tpu_torch.data import folds as folds_lib
from icassp2022_depression_tpu_torch.eval import metrics

CLASSIFIERS = ("rf", "dt", "svm", "lr")
REGRESSORS = ("svr", "dt", "rf", "ada")


def _make_classifier(name: str, seed: int = 0):
    if name == "rf":
        from sklearn.ensemble import RandomForestClassifier
        return RandomForestClassifier(n_estimators=50, random_state=seed)
    if name == "dt":
        from sklearn.tree import DecisionTreeClassifier
        return DecisionTreeClassifier(max_depth=20, random_state=seed)
    if name == "svm":
        from sklearn.svm import SVC
        return SVC(kernel="linear")
    if name == "lr":
        from sklearn.linear_model import LogisticRegression
        return LogisticRegression(max_iter=1000)
    raise ValueError(f"unknown classifier {name!r}; one of {CLASSIFIERS}")


def _make_regressor(name: str, seed: int = 0):
    if name == "svr":
        from sklearn.svm import SVR
        return SVR(kernel="linear", gamma="auto")
    if name == "dt":
        from sklearn.tree import DecisionTreeRegressor
        return DecisionTreeRegressor(max_depth=100, random_state=seed)
    if name == "rf":
        from sklearn.ensemble import RandomForestRegressor
        return RandomForestRegressor(max_depth=100, random_state=seed)
    if name == "ada":
        from sklearn.ensemble import AdaBoostRegressor
        return AdaBoostRegressor(n_estimators=50, random_state=seed)
    raise ValueError(f"unknown regressor {name!r}; one of {REGRESSORS}")


def classify(features: np.ndarray, targets: np.ndarray,
             train_folds_idx: Sequence[np.ndarray],
             model: str = "rf", seed: int = 0):
    """3-fold traditional classification with the reference's recipe:
    augmented folds, flattened features, NaN-safe mean P/R/F1.  Returns
    (per-fold metric dicts, their mean)."""
    dep = np.where(targets == 1)[0]
    non = np.where(targets == 0)[0]
    results: List[dict] = []
    for fold, tr_idx in enumerate(train_folds_idx, start=1):
        (xtr, ytr), (xte, yte) = augment.augment_classification_fold(
            [features], targets, tr_idx, dep, non)
        clf = _make_classifier(model, seed)
        clf.fit(xtr[0].reshape(len(ytr), -1), ytr)
        pred = clf.predict(xte[0].reshape(len(yte), -1))
        cm = metrics.standard_confusion_matrix(yte, pred)
        m = metrics.safe_classification_metrics(cm)
        m["fold"] = fold
        results.append(m)
    summary = metrics.fold_mean(results,
                                ("precision", "recall", "f1", "accuracy"))
    return results, summary


def regress(features: np.ndarray, targets: np.ndarray,
            dep_idxs: np.ndarray, non_idxs: np.ndarray,
            model: str = "svr", seed: int = 0, n_folds: int = 3,
            test_dep: int = 10, test_non: int = 44,
            augment_first_n: int = 14):
    """3-fold traditional regression: fit on the augmented train split
    the neural trainer builds (the first ``augment_first_n`` depressed
    train speakers expanded to all 6 answer orders), score MAE / RMSE on
    the trainer's unaugmented test split of each fold (the JAX package's
    documented choice: the reference's commented block re-splits with a
    fresh ``KFold`` against a commented-out validation set).  Returns
    (per-fold metric dicts, their mean)."""
    results: List[dict] = []
    for fold in range(n_folds):
        tr_d, tr_n, te_d, te_n = folds_lib.reg_fold_split(
            dep_idxs, non_idxs, fold, test_dep, test_non)
        (xtr, ytr), (xte, yte) = augment.augment_regression_fold(
            [features], targets, tr_d, tr_n, te_d, te_n, augment_first_n)
        reg = _make_regressor(model, seed)
        reg.fit(xtr[0].reshape(len(ytr), -1), ytr)
        pred = reg.predict(xte[0].reshape(len(yte), -1))
        results.append({
            "fold": fold + 1,
            "mae": metrics.mean_absolute_error(yte, pred),
            "rmse": metrics.root_mean_squared_error(yte, pred),
        })
    summary = metrics.fold_mean(results, ("mae", "rmse"))
    return results, summary
