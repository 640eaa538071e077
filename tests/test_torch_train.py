"""The port's training slice against the JAX package on the same numpy
inputs: fold recipes and augmentation plans (identical), fold tensors
(bit-equal), losses and device metrics (1e-6), the fold loop's gate and
padding semantics, the optimizers against optax (float64, 1e-10), the two
audio trainers against the JAX trainers (float32, 1e-5), and ``cli train``
end to end on a tiny synthetic corpus.

Dropout masks come from different generators in the two packages
(threefry against ``torch.Generator``), so the trajectory comparisons run
with dropout 0 and carry the JAX package's initial weights across."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from icassp2022_depression_tpu import config as jconfig
from icassp2022_depression_tpu.data import augment as jaugment
from icassp2022_depression_tpu.data import eatd as jeatd
from icassp2022_depression_tpu.data import folds as jfolds
from icassp2022_depression_tpu.eval import metrics as jmetrics
from icassp2022_depression_tpu.models import audio_net as jaudio_net
from icassp2022_depression_tpu.models import porting as jporting
from icassp2022_depression_tpu.ops import nn as jnn
from icassp2022_depression_tpu.train import loop as jloop
from icassp2022_depression_tpu.train import optim as joptim
from icassp2022_depression_tpu.train import trainers as jtrainers
from icassp2022_depression_tpu.utils import logging as jlogging
from icassp2022_depression_tpu_torch import cli
from icassp2022_depression_tpu_torch import config as tconfig
from icassp2022_depression_tpu_torch.data import augment as taugment
from icassp2022_depression_tpu_torch.data import eatd as teatd
from icassp2022_depression_tpu_torch.data import folds as tfolds
from icassp2022_depression_tpu_torch.eval import metrics as tmetrics
from icassp2022_depression_tpu_torch.models import porting as tporting
from icassp2022_depression_tpu_torch.models.audio_net import AudioNet
from icassp2022_depression_tpu_torch.ops import nn as tnn
from icassp2022_depression_tpu_torch.train import checkpoints as tckpt
from icassp2022_depression_tpu_torch.train import loop as tloop
from icassp2022_depression_tpu_torch.train import optim as toptim
from icassp2022_depression_tpu_torch.train import trainers as ttrainers
from icassp2022_depression_tpu_torch.utils import logging as tlogging
from icassp2022_depression_tpu_torch.ops import prng as tprng

TRAJ_TOL = 1e-5     # float32 trajectories, reductions in another order
LOSS_TOL = 1e-6     # one float32 loss / metric evaluation
OPT_TOL = 1e-10     # float64 optimizer arithmetic
D, H = 32, 16


def _targets(n=30, seed=0):
    rng = np.random.default_rng(seed)
    sds = rng.integers(25, 75, n).astype(np.float32)
    return jeatd.eatd_targets(sds)


# -- data layer -------------------------------------------------------------


def test_eatd_targets_and_speakers_equal(tmp_path):
    sds = [52.9, 53.0, 70.0, 30.0]
    for a, b in zip(teatd.eatd_targets(sds), jeatd.eatd_targets(sds)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    teatd.make_synthetic_corpus(tmp_path, n_data=3, n_validation=2,
                                seconds=0.2, seed=1)
    got = teatd.load_speakers(tmp_path)
    want = jeatd.load_speakers(tmp_path, use_native=False)
    assert [(s.split, s.number, s.sds) for s in got] == \
        [(s.split, s.number, s.sds) for s in want]
    for a, b in zip(got, want):
        for wa, wb in zip(a.waveforms, b.waveforms):
            np.testing.assert_array_equal(wa, wb)


@pytest.mark.parametrize("seed", [0, 3])
def test_folds_identical(seed, tmp_path):
    sds, clf = _targets(40, seed)
    for a, b in zip(tfolds.generate_clf_folds(clf, 3, seed=seed),
                    jfolds.generate_clf_folds(clf, 3, seed=seed)):
        np.testing.assert_array_equal(a, b)
    dep, non = tfolds.generate_reg_shuffles(sds, seed=seed)
    jdep, jnon = jfolds.generate_reg_shuffles(sds, seed=seed)
    np.testing.assert_array_equal(dep, jdep)
    np.testing.assert_array_equal(non, jnon)
    for fold in range(3):
        for a, b in zip(tfolds.reg_fold_split(dep, non, fold, 3, 8),
                        jfolds.reg_fold_split(jdep, jnon, fold, 3, 8)):
            np.testing.assert_array_equal(a, b)
    train = tfolds.generate_clf_folds(clf, 3, seed=seed)[0]
    np.testing.assert_array_equal(tfolds.clf_test_complement(train, 40),
                                  jfolds.clf_test_complement(train, 40))
    assert tfolds.ascending_complement([5, 1, 3, 2], [3]) == \
        jfolds.ascending_complement([5, 1, 3, 2], [3])
    np.save(tmp_path / "idx.npy", train)
    np.testing.assert_array_equal(tfolds.load_index_file(tmp_path / "idx.npy"),
                                  jfolds.load_index_file(tmp_path / "idx.npy"))


def _assert_plans_equal(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def test_augment_plans_identical():
    sds, clf = _targets(30, 1)
    assert taugment.PERMS == jaugment.PERMS
    np.testing.assert_array_equal(taugment.PERM_TABLE, jaugment.PERM_TABLE)
    dep, non = np.where(clf == 1)[0], np.where(clf == 0)[0]
    feats = np.random.default_rng(2).standard_normal((30, 3, 4)).astype(
        np.float32)
    for train in jfolds.generate_clf_folds(clf, 3, seed=1):
        for a, b in zip(taugment.plan_classification_fold(clf, train, dep,
                                                          non),
                        jaugment.plan_classification_fold(clf, train, dep,
                                                          non)):
            _assert_plans_equal(a, b)
        (tx, ty), (ux, uy) = taugment.augment_classification_fold(
            [feats], clf, train, dep, non)
        (jx, jy), (vx, vy) = jaugment.augment_classification_fold(
            [feats], clf, train, dep, non)
        for a, b in ((tx[0], jx[0]), (ty, jy), (ux[0], vx[0]), (uy, vy)):
            np.testing.assert_array_equal(a, b)
    rdep, rnon = jfolds.generate_reg_shuffles(sds, seed=1)
    for fold in range(3):
        split = jfolds.reg_fold_split(rdep, rnon, fold, 3, 8)
        for a, b in zip(taugment.plan_regression_fold(sds, *split, 4),
                        jaugment.plan_regression_fold(sds, *split, 4)):
            _assert_plans_equal(a, b)
        (tx, ty), _ = taugment.augment_regression_fold([feats], sds, *split,
                                                       augment_first_n=4)
        (jx, jy), _ = jaugment.augment_regression_fold([feats], sds, *split,
                                                       augment_first_n=4)
        np.testing.assert_array_equal(tx[0], jx[0])
        np.testing.assert_array_equal(ty, jy)


def _assert_fold_data_equal(t, j):
    np.testing.assert_array_equal(t.train_x[0].numpy(),
                                  np.asarray(j.train_x[0]))
    for name in ("train_y", "train_mask", "test_y", "test_mask"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(t.test_x[0].numpy(),
                                  np.asarray(j.test_x[0]))
    assert t.n_train == int(np.asarray(j.train_mask).sum())


@pytest.mark.parametrize("track", ["clf", "reg"])
def test_fold_data_from_plans_bit_equal(track):
    sds, clf = _targets(30, 4)
    feats = np.random.default_rng(5).standard_normal((30, 3, 6)).astype(
        np.float32)
    if track == "clf":
        dep, non = np.where(clf == 1)[0], np.where(clf == 0)[0]
        plans = [jaugment.plan_classification_fold(clf, tr, dep, non)
                 for tr in jfolds.generate_clf_folds(clf, 3, seed=4)]
        raw = [jaugment.augment_classification_fold([feats], clf, tr, dep,
                                                    non)
               for tr in jfolds.generate_clf_folds(clf, 3, seed=4)]
        batch = 8
    else:
        rdep, rnon = jfolds.generate_reg_shuffles(sds, seed=4)
        splits = [jfolds.reg_fold_split(rdep, rnon, f, 3, 8)
                  for f in range(3)]
        plans = [jaugment.plan_regression_fold(sds, *s, 4) for s in splits]
        raw = [jaugment.augment_regression_fold([feats], sds, *s, 4)
               for s in splits]
        batch = 2
    train_total = max(len(tr.targets) for tr, _ in plans) + 2 * batch
    test_total = max(len(te.targets) for _, te in plans)
    for (tr, te), ((xtr, ytr), (xte, yte)) in zip(plans, raw):
        want = jloop.fold_data_from_plans([jnp.asarray(feats)], tr, te,
                                          batch, test_total, train_total)
        got = tloop.fold_data_from_plans([torch.from_numpy(feats)], tr, te,
                                         batch, test_total, train_total)
        _assert_fold_data_equal(got, want)
        host = tloop.make_fold_data(xtr, ytr, xte, yte, batch, test_total,
                                    train_total)
        _assert_fold_data_equal(host, want)


# -- losses and metrics -----------------------------------------------------


def test_losses_match_jax():
    rng = np.random.default_rng(6)
    logits = rng.standard_normal((8, 2)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    labels = rng.integers(0, 2, 8)
    mask = np.array([1, 1, 1, 1, 1, 0, 0, 0], np.float32)
    pred = rng.standard_normal(8).astype(np.float32) * 3
    target = rng.standard_normal(8).astype(np.float32) * 3
    t = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    cases = [
        (tnn.cross_entropy_on_probs(t(probs), t(labels), 2),
         jnn.cross_entropy_on_probs(probs, labels, 2)),
        (tnn.masked_cross_entropy_on_probs(t(probs), t(labels), t(mask), 2),
         jnn.masked_cross_entropy_on_probs(probs, labels, mask, 2)),
        (tnn.l1_loss(t(pred), t(target)), jnn.l1_loss(pred, target)),
        (tnn.l1_loss(t(pred), t(target), t(mask)),
         jnn.l1_loss(pred, target, mask)),
        (tnn.smooth_l1_loss(t(pred), t(target)),
         jnn.smooth_l1_loss(pred, target)),
        (tnn.smooth_l1_loss(t(pred), t(target), t(mask)),
         jnn.smooth_l1_loss(pred, target, mask)),
        (tnn.l1_loss(t(pred), t(target), t(np.zeros(8, np.float32))),
         jnn.l1_loss(pred, target, np.zeros(8, np.float32))),
    ]
    for got, want in cases:
        np.testing.assert_allclose(got.item(), float(want), rtol=0,
                                   atol=LOSS_TOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_device_metrics_match_jax(seed):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 2, 12)
    yp = rng.integers(0, 2, 12) if seed else np.zeros(12, np.int64)
    mask = (rng.random(12) < 0.8).astype(np.float32)
    t = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    for m in (None, mask):
        got = tmetrics.confusion_counts(t(y), t(yp),
                                        None if m is None else t(m))
        want = jmetrics.confusion_counts(jnp.asarray(y), jnp.asarray(yp), m)
        for a, b in zip(got, want):
            assert a.item() == float(b)
        for a, b in zip(tmetrics.f1_from_counts(*got),
                        jmetrics.f1_from_counts(*want)):
            np.testing.assert_allclose(a.item(), float(b), rtol=0,
                                       atol=LOSS_TOL)
    pred = rng.standard_normal(12).astype(np.float32)
    target = rng.standard_normal(12).astype(np.float32)
    for fn, jfn in ((tmetrics.masked_mae, jmetrics.masked_mae),
                    (tmetrics.masked_rmse, jmetrics.masked_rmse)):
        for m in (None, mask):
            np.testing.assert_allclose(
                fn(t(target), t(pred), None if m is None else t(m)).item(),
                float(jfn(jnp.asarray(target), jnp.asarray(pred), m)),
                rtol=0, atol=LOSS_TOL)


def test_host_metrics_and_logging_equal(tmp_path):
    y, yp = [1, 0, 1, 1, 0, 0], [1, 1, 0, 1, 0, 0]
    cm = tmetrics.standard_confusion_matrix(y, yp)
    np.testing.assert_array_equal(cm, jmetrics.standard_confusion_matrix(y,
                                                                         yp))
    assert tmetrics.classification_metrics(cm) == \
        jmetrics.classification_metrics(cm)
    zero = np.array([[0, 0], [3, 2]])
    assert tmetrics.safe_classification_metrics(zero) == \
        jmetrics.safe_classification_metrics(zero)
    rows = [{"f1": 0.5, "mae": 3.0}, {"f1": 0.7, "mae": 5.0}]
    assert tmetrics.fold_mean(rows, ["f1", "mae"]) == \
        jmetrics.fold_mean(rows, ["f1", "mae"])
    assert tmetrics.mean_absolute_error([1, 2], [2, 4]) == \
        jmetrics.mean_absolute_error([1, 2], [2, 4])
    assert tmetrics.root_mean_squared_error([1, 2], [2, 4]) == \
        jmetrics.root_mean_squared_error([1, 2], [2, 4])
    assert tlogging.format_confusion_matrix(cm) == \
        jlogging.format_confusion_matrix(cm)
    assert tlogging.format_epoch_clf(3, 1e-5, 0.25, 7, 9) == \
        jlogging.format_epoch_clf(3, 1e-5, 0.25, 7, 9)
    m = jmetrics.classification_metrics(cm)
    assert tlogging.format_eval_clf(m) == jlogging.format_eval_clf(m)
    assert tlogging.format_eval_reg(3.5, 4.25) == \
        jlogging.format_eval_reg(3.5, 4.25)
    logs = {"loss": np.array([0.5, 0.25]), "f1": np.array([0.1, 0.2])}
    for mod, name in ((tlogging, "t"), (jlogging, "j")):
        mod.MetricsLogger(tmp_path / f"{name}.jsonl").log_fold(
            "audio_clf", 1, logs, {"f1": 0.2, "params": None})
    strip = [[{k: v for k, v in json.loads(line).items() if k != "time"}
              for line in (tmp_path / f"{n}.jsonl").read_text().splitlines()]
             for n in ("t", "j")]
    assert strip[0] == strip[1]


# -- the fold loop ----------------------------------------------------------


class _Oracle(torch.nn.Module):
    """A 'model' whose class is fixed by its input (argmax of x[:, 0, :2]),
    with one weight so there is something to optimise."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(2))

    def forward(self, x, generator=None):
        return torch.softmax(5.0 * x[:, 0, :2] + self.w, dim=-1)


def _oracle_data(n_correct, n=10, batch=4, extra_batches=0):
    """``n`` train rows of which ``n_correct`` are predicted right, and a
    test split predicted right (F1 = 1)."""
    y = np.array([1, 0] * (n // 2), np.int64)
    pred = y.copy()
    pred[n_correct:] = 1 - pred[n_correct:]
    x = np.zeros((n, 3, 2), np.float32)
    x[np.arange(n), 0, pred] = 1.0
    ty = np.array([1, 0, 1, 0], np.int64)
    tx = np.zeros((4, 3, 2), np.float32)
    tx[np.arange(4), 0, ty] = 1.0
    nb = -(-n // batch) + extra_batches
    return tloop.make_fold_data([x], y, [tx], ty, batch,
                                train_total=nb * batch)


def _oracle_run(data, gate, epochs=2):
    model = _Oracle()
    opt = toptim.build(tconfig.AUDIO_REG.optimizer, model)
    loss = ttrainers._branch_fns(tconfig.AUDIO_CLF)
    best, logs, step_losses = tloop.run_fold(model, opt,
                                             *tloop.model_fns(model, loss),
                                             data, "classification", gate,
                                             epochs)
    return model, opt, best, logs, step_losses


@pytest.mark.parametrize("n_correct,fires", [(9, False), (10, True)])
def test_train_accuracy_gate_is_the_exact_rational_compare(n_correct, fires):
    """The reference's ``train_acc > n * 0.9`` in float64: 9 of 10 does not
    gate (the JAX package's ``correct * 10 > 9 * n``)."""
    gate = tconfig.AUDIO_CLF.gate
    _, _, best, logs, _ = _oracle_run(_oracle_data(n_correct), gate)
    assert logs["train_correct"][0] == n_correct
    assert logs["f1"][0] == 1.0
    assert best["epoch"] == (0.0 if fires else -1.0)
    lax = tconfig.replace(gate, train_acc_strict=False)
    _, _, best, _, _ = _oracle_run(_oracle_data(n_correct), lax)
    assert best["epoch"] == 0.0


def test_fully_masked_batch_is_skipped():
    """A padding-only batch updates nothing, not even Adam's step count."""
    runs = [_oracle_run(_oracle_data(7, extra_batches=extra), tconfig.GateConfig(),
                        epochs=4)
            for extra in (0, 2)]
    (m0, o0, _, l0, s0), (m1, o1, _, l1, s1) = runs
    assert torch.equal(m0.w, m1.w) and not torch.equal(m0.w,
                                                        torch.zeros(2))
    steps = [int(o.state[m.w]["step"]) for m, o in ((m0, o0), (m1, o1))]
    assert steps == [3 * 3, 3 * 3]          # 3 epochs x 3 batches with rows
    np.testing.assert_array_equal(s0, s1)
    assert s1.shape == (3, 3)
    np.testing.assert_array_equal(l1["steps"], [3.0, 3.0, 3.0])
    np.testing.assert_array_equal(l0["loss"], l1["loss"])


# -- optimizers against optax (float64) -------------------------------------


@pytest.mark.parametrize("preset", ["AUDIO_CLF", "AUDIO_REG"])
def test_optimizer_trajectory_matches_optax(preset):
    with jax.enable_x64(True):
        cfg = tconfig.replace(getattr(tconfig, preset).model,
                              embedding_size=8, hidden_dims=4)
        ocfg = tconfig.replace(getattr(tconfig, preset).optimizer,
                               learning_rate=1e-2, weight_decay=1e-2
                               if preset == "AUDIO_CLF" else 0.0)
        model = AudioNet(cfg, key=tprng.prng_key(0))
        model = model.double()
        sd0 = {k: v.detach().numpy().copy()
               for k, v in model.state_dict().items()}
        jcfg = jconfig.replace(getattr(jconfig, preset).model,
                               embedding_size=8, hidden_dims=4)
        params = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64),
            jporting.audio_net_from_state_dict(sd0, jcfg))
        jopt = joptim.build(jconfig.replace(
            getattr(jconfig, preset).optimizer,
            learning_rate=ocfg.learning_rate,
            weight_decay=ocfg.weight_decay), params, ("attn",))
        state = jopt.init(params)
        opt = toptim.build(ocfg, model)
        rng = np.random.default_rng(7)
        named = dict(model.named_parameters())
        for _ in range(20):
            grads = {k: rng.standard_normal(v.shape) * 1e-2
                     for k, v in sd0.items()}
            for k, p in named.items():
                # the dead attention layer gets no gradient at all
                p.grad = (None if k.startswith("attention_layer")
                          else torch.from_numpy(grads[k]))
            opt.step()
            jgrads = jporting.audio_net_from_state_dict(
                {k: (np.zeros_like(v) if k.startswith("attention_layer")
                     else v) for k, v in grads.items()}, jcfg)
            jgrads = jax.tree_util.tree_map(
                lambda a: jnp.asarray(a, jnp.float64), jgrads)
            updates, state = jopt.update(jgrads, state, params)
            params = optax.apply_updates(params, updates)
        sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
        got = jporting.audio_net_from_state_dict(sd, jcfg)
        for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got),
                                jax.tree_util.tree_leaves(params)):
            assert a.dtype == b.dtype == jnp.float64
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                                       atol=OPT_TOL, err_msg=str(path))
        for k in ("attention_layer.0.weight", "attention_layer.0.bias"):
            np.testing.assert_array_equal(sd[k], sd0[k])


def test_optimizer_groups_and_unknown_name():
    cfg = tconfig.replace(tconfig.AUDIO_CLF.model, embedding_size=8,
                          hidden_dims=4)
    model = AudioNet(cfg)
    opt = toptim.build(tconfig.AUDIO_CLF.optimizer, model)
    assert isinstance(opt, torch.optim.AdamW)
    decay, no_decay = opt.param_groups
    assert decay["weight_decay"] == 1e-5 and no_decay["weight_decay"] == 0.0
    ids = {id(p) for p in no_decay["params"]}
    assert ids == {id(model.ln.weight), id(model.ln.bias)}
    assert isinstance(toptim.build(tconfig.AUDIO_REG.optimizer, model),
                      torch.optim.Adam)
    with pytest.raises(ValueError, match="unknown optimizer"):
        toptim.build(tconfig.replace(tconfig.AUDIO_CLF.optimizer,
                                     name="sgd"), model)
    with pytest.raises(ValueError, match="not valid for track"):
        ttrainers._branch_fns(tconfig.replace(tconfig.AUDIO_CLF, loss="l1"))


# -- the trainers against the JAX trainers ----------------------------------


def _trainer_cfgs(preset, epochs, gate):
    """The preset at a small width, dropout 0, few epochs.  It keeps the
    recipe's learning rate: at 1e-3 Adam turns float32 noise in near-zero
    gradients into +-lr steps and the trajectories part by ~1e-4 in a few
    epochs (see ``tests/test_optim_parity.py``)."""
    jt, tt = getattr(jconfig, preset), getattr(tconfig, preset)
    model = dict(embedding_size=D, hidden_dims=H, dropout=0.0)
    jcfg = jconfig.replace(jt, epochs=epochs,
                           model=jconfig.replace(jt.model, **model),
                           gate=jconfig.replace(jt.gate, **gate))
    tcfg = tconfig.replace(tt, epochs=epochs,
                           model=tconfig.replace(tt.model, **model),
                           gate=tconfig.replace(tt.gate, **gate))
    return jcfg, tcfg


def _assert_trainer_results(got, want, tcfg, init):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["fold"] == w["fold"]
        for k, v in w["logs"].items():
            np.testing.assert_allclose(g["logs"][k], np.asarray(v), rtol=0,
                                       atol=TRAJ_TOL, err_msg=k)
        for k, v in w["best"].items():
            if k != "params":
                np.testing.assert_allclose(g["best"][k], v, rtol=0,
                                           atol=TRAJ_TOL, err_msg=k)
        sd = g["best"]["params"]
        want_sd = tporting.audio_net_state_dict_from_jax(
            jax.device_get(w["best"]["params"]), tcfg.model)
        for k, v in want_sd.items():
            np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=0,
                                       atol=TRAJ_TOL, err_msg=k)
        # the dead attention layer never changes
        for k in ("attention_layer.0.weight", "attention_layer.0.bias"):
            assert torch.equal(sd[k], init[g["fold"] - 1][k])


def _jax_init(jcfg, n_folds=3):
    params = [jaudio_net.init(jax.random.PRNGKey(10 + f), jcfg.model)
              for f in range(n_folds)]
    return params


def test_train_audio_clf_matches_jax_trainer():
    sds, clf = _targets(30, 8)
    rng = np.random.default_rng(9)
    feats = (rng.standard_normal((30, 3, D))
             + 0.5 * clf[:, None, None]).astype(np.float32)
    train_idx = jfolds.generate_clf_folds(clf, 3, seed=8)
    gate = dict(f1_floor=-1.0, train_acc_frac=0.0)
    jcfg, tcfg = _trainer_cfgs("AUDIO_CLF", 5, gate)
    jparams = _jax_init(jcfg)
    init = [tporting.audio_net_state_dict_from_jax(p, tcfg.model)
            for p in jparams]
    jdatas = jtrainers._clf_fold_datas([feats], clf, train_idx,
                                       jcfg.batch_size)
    want = jtrainers._run_folds(jaudio_net, jcfg, jdatas, 0,
                                init_params_per_fold=jparams)
    got = ttrainers.train_audio_clf(feats, clf, train_idx, tcfg=tcfg,
                                    init_params_per_fold=init, device="cpu")
    _assert_trainer_results(got, want, tcfg, init)
    assert all(g["best"]["epoch"] >= 0 for g in got)
    assert got[0]["step_losses"].shape == (4, got[0]["logs"]["steps"][0])


def test_train_audio_reg_matches_jax_trainer(tmp_path):
    sds, _ = _targets(30, 11)
    rng = np.random.default_rng(12)
    feats = (rng.standard_normal((30, 3, D))
             + (sds[:, None, None] - 50.0) / 25.0).astype(np.float32)
    dep, non = jfolds.generate_reg_shuffles(sds, seed=11)
    # SDS in units of 50 points keeps the losses near 1, where an absolute
    # 1e-5 is above float32's resolution
    sds = sds / 50.0
    fold_cfg = dict(reg_test_dep=3, reg_test_non=6, reg_augment_first_n=4)
    gate = dict(mae_ceiling=1e9, train_mae_ceiling=1e9)
    jcfg, tcfg = _trainer_cfgs("AUDIO_REG", 4, gate)
    jparams = _jax_init(jcfg)
    init = [tporting.audio_net_state_dict_from_jax(p, tcfg.model)
            for p in jparams]
    jdatas = jtrainers._reg_fold_datas(
        [feats], sds, dep, non, jcfg.batch_size,
        jconfig.FoldConfig(**fold_cfg))
    want = jtrainers._run_folds(jaudio_net, jcfg, jdatas, 0,
                                init_params_per_fold=jparams)
    got = ttrainers.train_audio_reg(
        feats, sds, dep, non, tcfg=tcfg, out_dir=tmp_path,
        fold_cfg=tconfig.FoldConfig(**fold_cfg), init_params_per_fold=init,
        device="cpu")
    _assert_trainer_results(got, want, tcfg, init)
    # the gated checkpoints load in the JAX package, in its layout
    for r in got:
        name = tckpt.audio_reg_name(D, H, r["best"]["mae"])
        path = tmp_path / f"Audio{r['fold']}" / f"{name}.npz"
        meta = tckpt.load_meta(path)
        assert meta["fold"] == r["fold"] and meta["task"] == "audio_reg"
        assert meta["dep_idxs"] == [int(i) for i in dep]
        from icassp2022_depression_tpu.train import checkpoints as jckpt
        back = jckpt.load(path, like=jparams[0])
        want_sd = tporting.audio_net_state_dict_from_jax(back, tcfg.model)
        for k, v in want_sd.items():
            assert torch.equal(v, r["best"]["params"][k])


def test_fold_model_init_and_dropout_streams():
    """A fold's init is the JAX trainer's ``model.init(fold_in(PRNGKey(
    seed), fold))`` bit for bit, and its dropout key ``fold_in(PRNGKey(seed
    + 1000), fold)``."""
    cfg = tconfig.replace(tconfig.AUDIO_CLF, model=tconfig.replace(
        tconfig.AUDIO_CLF.model, embedding_size=8, hidden_dims=4))
    jcfg = jconfig.replace(jconfig.AUDIO_CLF.model, embedding_size=8,
                           hidden_dims=4)
    a = ttrainers.init_model(cfg, 0, 1, "cpu").state_dict()
    b = ttrainers.init_model(cfg, 0, 1, "cpu").state_dict()
    c = ttrainers.init_model(cfg, 0, 2, "cpu").state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["fc_audio.1.weight"], c["fc_audio.1.weight"])
    want = jporting.audio_net_to_state_dict(jaudio_net.init(
        jax.random.fold_in(jax.random.PRNGKey(0), 2), jcfg), jcfg)
    for k, v in want.items():
        np.testing.assert_array_equal(c[k].numpy(), np.asarray(v))
    for seed, fold in ((0, 1), (3, 2)):
        np.testing.assert_array_equal(
            ttrainers.dropout_key(seed, fold, "cpu").numpy(),
            np.asarray(jax.random.key_data(jax.random.fold_in(
                jax.random.PRNGKey(seed + 1000), fold))))


# -- the CLI ----------------------------------------------------------------


def test_cli_train_corpus_writes_artifacts(tmp_path, monkeypatch, capsys):
    root = tmp_path / "corpus"
    teatd.make_synthetic_corpus(root, n_data=8, n_validation=4,
                                seconds=0.5, seed=0)
    clf = tconfig.AUDIO_CLF
    monkeypatch.setattr(tconfig, "AUDIO_CLF", tconfig.replace(
        clf, epochs=3, model=tconfig.replace(clf.model, hidden_dims=8),
        gate=tconfig.replace(clf.gate, f1_floor=-1.0, train_acc_frac=0.0)))
    rc = cli.main(["train", "--task", "audio_clf", "--root", str(root),
                   "--corpus", str(root), "--device", "cpu"])
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split(":")[0] for ln in lines] == ["fold 1", "fold 2",
                                                  "fold 3"]
    records = [json.loads(ln) for ln in
               (root / "Model" / "audio_clf_metrics.jsonl")
               .read_text().splitlines()]
    epochs = [r for r in records if r["event"] == "epoch"]
    bests = [r for r in records if r["event"] == "fold_best"]
    assert len(epochs) == 3 * 2 and len(bests) == 3
    assert all(np.isfinite(r["loss"]) and r["steps"] > 0 for r in epochs)
    out = root / "Model" / "ClassificationWhole" / "Audio"
    for r in bests:
        name = tckpt.audio_clf_name(256, 8, r["f1"], r["fold"])
        assert (out / f"{name}.npz").is_file()
        meta = tckpt.load_meta(out / f"{name}.npz")
        assert meta["task"] == "audio_clf" and meta["fold"] == r["fold"]
        idx = np.load(out / "train_idxs_{:.2f}_{}.npy".format(r["f1"],
                                                              r["fold"]))
        assert list(idx) == meta["train_idx"]


@pytest.mark.parametrize("argv,match", [
    # --corpus for a text task is ported: it passes to the corpus check
    (["--task", "text_clf", "--corpus", "x", "--device", "cpu",
      "--elmo-weights", "", "--segmenter", "fallback"], "no speakers found"),
    # --vmap-folds, --resume-dir and --chunk-epochs are ported: they pass
    # to the feature check
    (["--task", "audio_clf", "--vmap-folds", "--device", "cpu"],
     "Features/AudioWhole"),
    (["--task", "audio_clf", "--resume-dir", "x", "--chunk-epochs", "3",
      "--device", "cpu"], "Features/AudioWhole"),
    # --fold-parallel is ported: its 3 CPU ranks pass to the feature
    # check, whose refusal the launcher raises
    (["--task", "audio_reg", "--fold-parallel", "--device", "cpu"],
     "Features/AudioWhole"),
    # --audio-dim is ported (test_torch_vggish.py): it passes to the
    # feature check, and with --corpus it is refused as the JAX CLI does
    (["--task", "audio_clf", "--audio-dim", "128", "--device", "cpu"],
     "Features/AudioWhole"),
    (["--task", "audio_clf", "--audio-dim", "128", "--corpus", "x"],
     "--audio-dim must stay 256"),
    # --data-parallel without --fold-parallel exits as in the JAX CLI
    (["--task", "audio_reg", "--data-parallel", "2", "--device", "cpu"],
     "--data-parallel requires --fold-parallel"),
])
def test_cli_train_unported_options_name_their_slice(argv, match, tmp_path):
    with pytest.raises(SystemExit, match=match):
        cli.main(["train", "--root", str(tmp_path), *argv])


def test_cli_train_needs_features_or_corpus(tmp_path):
    with pytest.raises(SystemExit, match="Features/AudioWhole"):
        cli.main(["train", "--task", "audio_reg", "--root", str(tmp_path),
                  "--device", "cpu"])
