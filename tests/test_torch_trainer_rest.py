"""The rest of the JAX trainer in the port, against the JAX package on the
same numpy inputs and the same seed:

* initial weights drawn from threefry keys in the JAX split order: bitwise
  the JAX ``init`` of all six recipes' models and of ``fusion.init``;
* dropout masks (``bernoulli``, ``dropout``): bitwise JAX's;
* the trainers with dropout ON and no weights carried across: per-step
  losses within 1e-5 of the largest loss and the same gated epochs;
* ``vmap_folds`` (one stacked program over the folds, its
  :class:`StackedAdam` and the plain fold-axis recurrences) against the
  serial port and against the JAX package's vmapped trainers;
* chunked execution with resume bundles (the single-device cases of
  ``tests/test_resume.py``): bitwise equal to single-shot runs.

Everything runs on the CPU, where the recurrences are the plain PyTorch
loops; the card's kernels and CUDA graphs are held to them by
``chip_smoke.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from icassp2022_depression_tpu import config as jconfig
from icassp2022_depression_tpu.data import eatd as jeatd
from icassp2022_depression_tpu.data import folds as jfolds
from icassp2022_depression_tpu.models import audio_net as jaudio_net
from icassp2022_depression_tpu.models import fusion as jfusion
from icassp2022_depression_tpu.models import porting as jporting
from icassp2022_depression_tpu.models import text_net as jtext_net
from icassp2022_depression_tpu.ops import nn as jnn
from icassp2022_depression_tpu.train import optim as joptim
from icassp2022_depression_tpu.train import trainers as jtrainers
from icassp2022_depression_tpu_torch import config as tconfig
from icassp2022_depression_tpu_torch.models import folds as tfolds
from icassp2022_depression_tpu_torch.models import porting as tporting
from icassp2022_depression_tpu_torch.models.audio_net import AudioNet
from icassp2022_depression_tpu_torch.models.fusion import FusionNet
from icassp2022_depression_tpu_torch.models.text_net import TextNet
from icassp2022_depression_tpu_torch.ops import nn as tnn
from icassp2022_depression_tpu_torch.ops import prng as tprng
from icassp2022_depression_tpu_torch.ops import rnn_cuda
from icassp2022_depression_tpu_torch.train import loop as tloop
from icassp2022_depression_tpu_torch.train import optim as toptim
from icassp2022_depression_tpu_torch.train import trainers as ttrainers

STEP_TOL = 1e-5     # of the largest loss: float32 steps, another order
TRAJ_TOL = 1e-5
DA, DT, H = 24, 32, 16
CLF_GATE = dict(f1_floor=-1.0, train_acc_frac=0.0)
REG_GATE = dict(mae_ceiling=1e9, train_mae_ceiling=1e9)
REG_FOLDS = dict(reg_test_dep=3, reg_test_non=6, reg_augment_first_n=4)


def _data(seed, n=30):
    rng = np.random.default_rng(seed)
    sds = rng.integers(25, 75, n).astype(np.float32)
    _, clf = jeatd.eatd_targets(sds)
    xa = rng.standard_normal((n, 3, DA)) + 0.5 * clf[:, None, None]
    xt = rng.standard_normal((n, 3, DT)) - 0.5 * clf[:, None, None]
    return sds, clf, xa.astype(np.float32), xt.astype(np.float32)


def _cfgs(preset, epochs=4, gate=None, dim=DA, dropout=0.5):
    """(JAX, port) trainer configs of ``preset`` at a small width, dropout
    on (the recipes' 0.5), the recipe's learning rate."""
    out = []
    for mod in (jconfig, tconfig):
        t = getattr(mod, preset)
        out.append(mod.replace(
            t, epochs=epochs,
            model=mod.replace(t.model, embedding_size=dim, hidden_dims=H,
                              dropout=dropout),
            gate=mod.replace(t.gate, **(gate or {}))))
    return out


def _fusion_cfgs(track, epochs=4, gate=None):
    fuse, trainer = {"clf": ("FUSE_CLF", "FUSE_CLF_TRAINER"),
                     "reg": ("FUSE_REG", "FUSE_REG_TRAINER")}[track]
    kw = dict(audio_embed_size=DA, text_embed_size=DT, audio_hidden_dims=H,
              text_hidden_dims=H)
    out = []
    for mod in (jconfig, tconfig):
        t = getattr(mod, trainer)
        out.append((mod.replace(getattr(mod, fuse), **kw),
                    mod.replace(t, epochs=epochs,
                                gate=mod.replace(t.gate, **(gate or {})))))
    return out


# -- init and masks -----------------------------------------------------------


@pytest.mark.parametrize("preset", ["AUDIO_CLF", "TEXT_CLF", "AUDIO_REG",
                                    "TEXT_REG", "FUSE_CLF", "FUSE_REG"])
def test_init_is_bitwise_the_jax_init(preset):
    """Every recipe's model (the fusion's ``fusion.init``) from the same key,
    and every trainer's per-fold key ``fold_in(PRNGKey(seed), fold)``."""
    if preset.startswith("FUSE"):
        (jf, _), (tf, _) = _fusion_cfgs(preset[-3:].lower())
        want = jporting.fusion_to_state_dict(
            jfusion.init(jax.random.fold_in(jax.random.PRNGKey(4), 2), jf),
            jf)
        got = FusionNet(tf, ttrainers.init_key(4, 2)).state_dict()
    else:
        jcfg, tcfg = _cfgs(preset, dim=DT if "TEXT" in preset else DA)
        mod = jaudio_net if "AUDIO" in preset else jtext_net
        to_sd = (jporting.audio_net_to_state_dict if "AUDIO" in preset
                 else jporting.text_net_to_state_dict)
        want = to_sd(mod.init(jax.random.fold_in(jax.random.PRNGKey(4), 2),
                              jcfg.model), jcfg.model)
        got = ttrainers.init_model(tcfg, 4, 2, "cpu").state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v),
                                      err_msg=k)


@pytest.mark.parametrize("rate", [0.5, 0.2])
def test_bernoulli_and_dropout_masks_are_bitwise_jax(rate):
    x = np.random.default_rng(3).standard_normal((6, 3, 40)).astype(
        np.float32)
    for seed in (0, 7, 2 ** 31 + 5):
        key = jax.random.PRNGKey(seed)
        np.testing.assert_array_equal(
            tprng.bernoulli(tprng.prng_key(seed), 1 - rate, x.shape).numpy(),
            np.asarray(jax.random.bernoulli(key, 1 - rate, x.shape)))
        got = tnn.dropout(torch.from_numpy(x), rate, True,
                          tprng.prng_key(seed))
        want = jnn.dropout(key, jnp.asarray(x), rate, True)
        np.testing.assert_array_equal(got.numpy() == 0,
                                      np.asarray(want) == 0)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)
    # one key per fold: each fold's mask is the one it draws alone
    keys = torch.stack([tprng.prng_key(s) for s in (1, 2, 3)])
    folded = tnn.dropout(torch.from_numpy(np.stack([x] * 3)), rate, True,
                         keys)
    for f, s in enumerate((1, 2, 3)):
        assert torch.equal(folded[f], tnn.dropout(
            torch.from_numpy(x), rate, True, tprng.prng_key(s)))


# -- the trainers with dropout on ---------------------------------------------


def _jax_step_losses(train_loss, optimizer, params, data, key, n_epochs,
                     opt_state=None):
    """Every step's loss of the JAX package's fold program (``loop.py``'s
    ``batch_step``: ``key, sub = split(key)`` every batch, a batch without
    rows a no-op), run step by step, and the final params / opt state."""
    grad_fn = jax.jit(jax.value_and_grad(train_loss, has_aux=True))
    if opt_state is None:
        opt_state = optimizer.init(params)
    out = []
    for _ in range(n_epochs):
        row = []
        for i in range(data.train_y.shape[0]):
            key, sub = jax.random.split(key)
            if float(jnp.sum(data.train_mask[i])) == 0:
                continue
            (loss, _), grads = grad_fn(params, tuple(x[i] for x in
                                                     data.train_x),
                                       data.train_y[i], data.train_mask[i],
                                       sub)
            updates, opt_state = optimizer.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            row.append(float(loss))
        out.append(row)
    return np.array(out), params, opt_state


def _assert_steps(got, want):
    tol = STEP_TOL * float(np.abs(want).max())
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def _assert_folds(got, want):
    for g, w in zip(got, want):
        assert g["best"]["epoch"] == w["best"]["epoch"]
        for k, v in w["logs"].items():
            np.testing.assert_allclose(g["logs"][k], np.asarray(v), rtol=0,
                                       atol=TRAJ_TOL, err_msg=k)


@pytest.mark.parametrize("task", ["audio_clf", "text_reg"])
def test_branch_trainer_with_dropout_matches_jax(task):
    """No weights carried across: the seed alone gives the JAX trainer's
    init and masks, so every step's loss agrees."""
    sds, clf, xa, xt = _data(5)
    seed = 3
    if task == "audio_clf":
        jcfg, tcfg = _cfgs("AUDIO_CLF", 4, CLF_GATE)
        train_idx = jfolds.generate_clf_folds(clf, 3, seed=5)
        jdatas = jtrainers._clf_fold_datas([xa], clf, train_idx,
                                           jcfg.batch_size)
        got = ttrainers.train_audio_clf(xa, clf, train_idx, tcfg=tcfg,
                                        seed=seed, device="cpu")
        module, dead = jaudio_net, ("attn",)
    else:
        jcfg, tcfg = _cfgs("TEXT_REG", 4, REG_GATE, DT)
        dep, non = jfolds.generate_reg_shuffles(sds, seed=5)
        y = sds / 50.0
        jdatas = jtrainers._reg_fold_datas([xt], y, dep, non,
                                           jcfg.batch_size,
                                           jconfig.FoldConfig(**REG_FOLDS))
        got = ttrainers.train_text_reg(
            xt, y, dep, non, tcfg=tcfg, seed=seed,
            fold_cfg=tconfig.FoldConfig(**REG_FOLDS), device="cpu")
        module, dead = jtext_net, ()
    want = jtrainers._run_folds(module, jcfg, jdatas, seed)
    _assert_folds(got, want)
    train_loss, _ = jtrainers._branch_fns(module, jcfg.model, jcfg)
    for fold in (1, 3):
        params = module.init(jax.random.fold_in(jax.random.PRNGKey(seed),
                                                fold), jcfg.model)
        steps, _, _ = _jax_step_losses(
            train_loss, joptim.build(jcfg.optimizer, params, dead), params,
            jdatas[fold - 1],
            jax.random.fold_in(jax.random.PRNGKey(seed + 1000), fold),
            jcfg.epochs - 1)
        _assert_steps(got[fold - 1]["step_losses"], steps)
        np.testing.assert_allclose(got[fold - 1]["logs"]["loss"],
                                   steps.sum(axis=1), rtol=0, atol=TRAJ_TOL)


def _branches(seed, track):
    audio, text = {"clf": ("AUDIO_CLF", "TEXT_CLF"),
                   "reg": ("AUDIO_REG", "TEXT_REG")}[track]
    ja, ta = _cfgs(audio)
    jt, tt = _cfgs(text, dim=DT)
    jb, tb = [], []
    for f in range(3):
        tp = jtext_net.init(jax.random.PRNGKey(seed + 2 * f), jt.model)
        ap = jaudio_net.init(jax.random.PRNGKey(seed + 2 * f + 1), ja.model)
        jb.append((tp, ap))
        tb.append((tporting.text_net_state_dict_from_jax(tp, tt.model),
                   tporting.audio_net_state_dict_from_jax(ap, ta.model)))
    return jb, tb


def test_fuse_clf_with_dropout_matches_jax():
    """The clf fusion from ``PRNGKey(seed)``, its model and Adam state
    carried from fold to fold, dropout in the frozen branches: every
    step of every fold agrees with the JAX trainer."""
    sds, clf, xa, xt = _data(6)
    train_idx = jfolds.generate_clf_folds(clf, 3, seed=6)
    (jf, jt), (tf, tt) = _fusion_cfgs("clf", 4, CLF_GATE)
    jb, tb = _branches(60, "clf")
    seed = 2
    want = jtrainers.train_fuse_clf(xa, xt, clf, train_idx, jb, fcfg=jf,
                                    tcfg=jt, seed=seed)
    got = ttrainers.train_fuse_clf(xa, xt, clf, train_idx, tb, fcfg=tf,
                                   tcfg=tt, seed=seed, device="cpu")
    _assert_folds(got, want)
    datas = jtrainers._clf_fold_datas([xa, xt], clf, train_idx,
                                      jt.batch_size)
    train_loss, _ = jtrainers._fusion_fns(jf, jt)
    base, opt_state, optimizer = jfusion.init(jax.random.PRNGKey(seed),
                                              jf), None, None
    for fold in (1, 2, 3):
        params = jfusion.init_from_branches(base, jf, *jb[fold - 1],
                                            "classification")
        optimizer = optimizer or joptim.build(jt.optimizer, params)
        steps, base, opt_state = _jax_step_losses(
            train_loss, optimizer, params, datas[fold - 1],
            jax.random.fold_in(jax.random.PRNGKey(seed + 1000), fold),
            jt.epochs - 1, opt_state)
        _assert_steps(got[fold - 1]["step_losses"], steps)


# -- stacked folds ------------------------------------------------------------


def test_stacked_adam_equals_three_torch_optimizers():
    """Per-fold counts and a masked update: fold f steps only where
    ``active[f]``; float64, against three ``torch.optim`` runs stepped
    where their fold is active."""
    torch.manual_seed(0)
    for name, wd in (("adamw", 1e-2), ("adam", 0.0)):
        cfg = tconfig.replace(tconfig.AUDIO_CLF.optimizer, name=name,
                              learning_rate=1e-2, weight_decay=wd)
        mcfg = tconfig.replace(tconfig.AUDIO_CLF.model, embedding_size=6,
                               hidden_dims=4)
        models = [AudioNet(mcfg, tprng.prng_key(f)).double()
                  for f in range(3)]
        stacked = tfolds.stack(models)
        opts = [toptim.build(cfg, m) for m in models]
        sopt = toptim.build_stacked(cfg, stacked)
        rng = np.random.default_rng(1)
        active = rng.random((12, 3)) < 0.7
        for act in active:
            grads = {n: torch.from_numpy(rng.standard_normal((3,) + tuple(
                p.shape[1:])) * 1e-2)
                for n, p in stacked.named_parameters()
                if not n.startswith("attention_layer")}
            sopt.zero_grad()
            for n, p in stacked.named_parameters():
                p.grad = grads.get(n)
            sopt.step(torch.from_numpy(act))
            for f, (m, opt) in enumerate(zip(models, opts)):
                opt.zero_grad()
                if not act[f]:
                    continue
                for n, p in m.named_parameters():
                    g = grads.get(n)
                    p.grad = None if g is None else g[f].clone()
                opt.step()
        for n, p in stacked.named_parameters():
            serial = [opt.state[m.get_parameter(n)] for m, opt in
                      zip(models, opts)]
            want = [float(st["step"]) if st else 0.0 for st in serial]
            np.testing.assert_array_equal(
                want, active.sum(0) if n in grads else 0, err_msg=n)
            np.testing.assert_array_equal(sopt.state[p]["step"].numpy(),
                                          want, err_msg=n)
        for f, m in enumerate(models):
            for n, p in m.named_parameters():
                np.testing.assert_allclose(
                    stacked.get_parameter(n)[f].detach().numpy(),
                    p.detach().numpy(), rtol=0, atol=1e-12, err_msg=n)


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_plain_fold_axis_recurrences_equal_single_fold_calls(cell):
    """The fold-axis oracles of the four kernels (#1, #2/#3, #4, #8/#5):
    bitwise three single-fold calls, forward and backward."""
    gates = 3 if cell == "gru" else 4
    rng = np.random.default_rng(2)
    t, b, h, f = 3, 4, 8, 3

    def arr(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32) * 0.5)

    xp, w, bias = arr(f, t, b, gates * h), arr(f, h, gates * h), arr(
        f, 1, gates * h)
    dys = arr(f, t, b, h)
    if cell == "gru":
        ys = rnn_cuda.gru_sequence(xp, w, bias)
        grads = rnn_cuda.gru_sequence_bwd(xp, w, bias, ys, dys)
        singles = [(rnn_cuda.gru_sequence(xp[i], w[i], bias[i]),)
                   for i in range(f)]
        sgrads = [rnn_cuda.gru_sequence_bwd(xp[i], w[i], bias[i],
                                            singles[i][0], dys[i])
                  for i in range(f)]
        outs = (ys,)
    else:
        dcs = arr(f, t, b, h)
        outs = rnn_cuda.lstm_sequence(xp, w, bias)
        grads = rnn_cuda.lstm_sequence_bwd(xp, w, bias, *outs, dys, dcs)
        singles = [rnn_cuda.lstm_sequence(xp[i], w[i], bias[i])
                   for i in range(f)]
        sgrads = [rnn_cuda.lstm_sequence_bwd(xp[i], w[i], bias[i],
                                             *singles[i], dys[i], dcs[i])
                  for i in range(f)]
    for i in range(f):
        for got, want in zip(outs, singles[i]):
            assert torch.equal(got[i], want)
        for got, want in zip(grads, sgrads[i]):
            assert torch.equal(got[i], want)
    # and through the autograd Function, as a stacked model runs it
    fn = rnn_cuda.GRUSequence if cell == "gru" else rnn_cuda.LSTMSequence
    wl = w.clone().requires_grad_()
    out = fn.apply(xp, wl, bias, False)
    (out if cell == "gru" else out[0]).mul(dys).sum().backward()
    for i in range(f):
        wi = w[i].clone().requires_grad_()
        oi = fn.apply(xp[i], wi, bias[i], False)
        (oi if cell == "gru" else oi[0]).mul(dys[i]).sum().backward()
        assert torch.equal(wl.grad[i], wi.grad)


@pytest.mark.parametrize("task", ["audio_clf", "text_reg"])
def test_vmapped_folds_match_serial_and_jax_vmap(task):
    """The folds as one stacked program -- for the clf folds, of unequal
    batch counts (padding batches for the shorter folds) -- give the serial
    port's trajectories and the JAX package's vmapped trainer's."""
    sds, clf, xa, xt = _data(8)
    if task == "audio_clf":
        jcfg, tcfg = _cfgs("AUDIO_CLF", 4, CLF_GATE)
        train_idx = jfolds.generate_clf_folds(clf, 3, seed=8)
        args = (xa, clf, train_idx)
        jfn, tfn = jtrainers.train_audio_clf, ttrainers.train_audio_clf
        fold_kw = jfold_kw = {}
    else:
        jcfg, tcfg = _cfgs("TEXT_REG", 4, REG_GATE, DT)
        dep, non = jfolds.generate_reg_shuffles(sds, seed=8)
        args = (xt, sds / 50.0, dep, non)
        jfn, tfn = jtrainers.train_text_reg, ttrainers.train_text_reg
        fold_kw = {"fold_cfg": tconfig.FoldConfig(**REG_FOLDS)}
        jfold_kw = {"fold_cfg": jconfig.FoldConfig(**REG_FOLDS)}
    serial = tfn(*args, tcfg=tcfg, seed=1, device="cpu", **fold_kw)
    vmapped = tfn(*args, tcfg=tcfg, seed=1, device="cpu", vmap_folds=True,
                  **fold_kw)
    steps = [r["logs"]["steps"][0] for r in serial]
    if task == "audio_clf":     # the reg folds have equal batch counts
        assert len(set(steps)) > 1, "the folds must differ in batch count"
    want = jfn(*args, jcfg, seed=1, vmap_folds=True, **jfold_kw)
    for s, v, w in zip(serial, vmapped, want):
        assert s["best"]["epoch"] == v["best"]["epoch"] == w["best"]["epoch"]
        np.testing.assert_array_equal(s["logs"]["steps"], v["logs"]["steps"])
        _assert_steps(v["step_losses"], s["step_losses"])
        for k, val in w["logs"].items():
            np.testing.assert_allclose(v["logs"][k], np.asarray(val),
                                       rtol=0, atol=TRAJ_TOL, err_msg=k)
            np.testing.assert_allclose(v["logs"][k], s["logs"][k], rtol=0,
                                       atol=TRAJ_TOL, err_msg=k)
        for k, p in s["best"]["params"].items():
            np.testing.assert_allclose(v["best"]["params"][k].numpy(),
                                       p.numpy(), rtol=0, atol=TRAJ_TOL,
                                       err_msg=k)


def test_vmapped_fuse_reg_matches_serial_and_jax_vmap():
    sds, _, xa, xt = _data(9)
    dep, non = jfolds.generate_reg_shuffles(sds, seed=9)
    y = sds / 50.0
    (jf, jt), (tf, tt) = _fusion_cfgs("reg", 4, REG_GATE)
    jb, tb = _branches(70, "reg")
    kw = dict(fcfg=tf, tcfg=tt, seed=4,
              fold_cfg=tconfig.FoldConfig(**REG_FOLDS), device="cpu")
    serial = ttrainers.train_fuse_reg(xa, xt, y, dep, non, tb, **kw)
    vmapped = ttrainers.train_fuse_reg(xa, xt, y, dep, non, tb,
                                       vmap_folds=True, **kw)
    want = jtrainers.train_fuse_reg(xa, xt, y, dep, non, jb, fcfg=jf,
                                    tcfg=jt, seed=4, vmap_folds=True,
                                    fold_cfg=jconfig.FoldConfig(**REG_FOLDS))
    for s, v, w in zip(serial, vmapped, want):
        assert s["best"]["epoch"] == v["best"]["epoch"] == w["best"]["epoch"]
        _assert_steps(v["step_losses"], s["step_losses"])
        for k, val in w["logs"].items():
            np.testing.assert_allclose(v["logs"][k], np.asarray(val),
                                       rtol=0, atol=TRAJ_TOL, err_msg=k)
    with pytest.raises(ValueError, match="clf fusion"):
        ttrainers.train_fuse_clf(xa, xt, y > 1, [np.arange(10)] * 3, tb,
                                 vmap_folds=True, device="cpu")


# -- chunked execution and resume (tests/test_resume.py's cases) -------------


RCFG = _cfgs("AUDIO_CLF", 13, {}, 16)[1]
RCFG = tconfig.replace(RCFG, optimizer=tconfig.replace(
    RCFG.optimizer, learning_rate=5e-3))


def _rdata(seed):
    rng = np.random.default_rng(seed)
    n = 30
    y = (rng.random(n) < 0.35).astype(np.int64)
    x = (np.where(y[:, None, None] == 1, .8, -.8)
         + rng.standard_normal((n, 3, 16))).astype(np.float32)
    return x, y


def _run(x, y, tf_idx, cfg=RCFG, **kw):
    return ttrainers.train_audio_clf(x, y, tf_idx, tcfg=cfg, device="cpu",
                                     **kw)


def _assert_same(a, b):
    for ra, rb in zip(a, b):
        for k in ("f1", "loss"):
            np.testing.assert_array_equal(ra["logs"][k], rb["logs"][k])
        np.testing.assert_array_equal(ra["step_losses"], rb["step_losses"])
        assert ra["best"] == {**rb["best"], "params": ra["best"]["params"]}
        for k, v in ra["best"]["params"].items():
            assert torch.equal(v, rb["best"]["params"][k])


@pytest.mark.parametrize("vmap", [False, True])
def test_chunked_equals_single_shot(vmap, tmp_path, capsys):
    x, y = _rdata(0)
    tf_idx = jfolds.generate_clf_folds(y, 3, seed=0)[:1 if not vmap else 3]
    single = _run(x, y, tf_idx, seed=3, vmap_folds=vmap)
    chunked = _run(x, y, tf_idx, seed=3, vmap_folds=vmap, chunk_epochs=5,
                   resume_dir=tmp_path)
    _assert_same(single, chunked)
    name = "audio_clf_folds" if vmap else "audio_clf_fold1"
    assert (tmp_path / f"{name}.npz").exists()
    assert (tmp_path / f"{name}_logs.npz").exists()
    err = capsys.readouterr().err
    assert f"# chunk starting: {name} epochs 0->5/12" in err
    assert f"# chunk committed: {name} epochs 12/12" in err


@pytest.mark.parametrize("vmap", [False, True])
def test_resume_after_interruption(vmap, tmp_path):
    x, y = _rdata(1 if not vmap else 4)
    tf_idx = jfolds.generate_clf_folds(y, 3, seed=1)[:1 if not vmap else 3]
    # "killed" after the first chunk: a run of 5 epochs leaves the bundle
    _run(x, y, tf_idx, tconfig.replace(RCFG, epochs=6), seed=7,
         vmap_folds=vmap, chunk_epochs=5, resume_dir=tmp_path)
    resumed = _run(x, y, tf_idx, seed=7, vmap_folds=vmap, chunk_epochs=5,
                   resume_dir=tmp_path)
    full = _run(x, y, tf_idx, seed=7, vmap_folds=vmap)
    _assert_same(full, resumed)


def test_resume_truncates_overrun_logs_sidecar(tmp_path):
    x, y = _rdata(6)
    tf_idx = jfolds.generate_clf_folds(y, 3, seed=6)[:1]
    _run(x, y, tf_idx, tconfig.replace(RCFG, epochs=6), seed=17,
         chunk_epochs=5, resume_dir=tmp_path)
    logs_path = tmp_path / "audio_clf_fold1_logs.npz"
    with np.load(logs_path) as z:
        overrun = {k: np.concatenate([z[k], np.full((2,) + z[k].shape[1:],
                                                    77.0, z[k].dtype)])
                   for k in z.files}
    np.savez(logs_path, **overrun)
    resumed = _run(x, y, tf_idx, seed=17, chunk_epochs=5,
                   resume_dir=tmp_path)
    full = _run(x, y, tf_idx, seed=17)
    assert len(resumed[0]["logs"]["f1"]) == RCFG.epochs - 1
    _assert_same(full, resumed)


def test_resume_noop_when_complete(tmp_path):
    x, y = _rdata(2)
    tf_idx = jfolds.generate_clf_folds(y, 3, seed=2)[:1]
    first = _run(x, y, tf_idx, seed=9, chunk_epochs=4, resume_dir=tmp_path)
    stamp = (tmp_path / "audio_clf_fold1.npz").stat().st_mtime_ns
    again = _run(x, y, tf_idx, seed=9, chunk_epochs=4, resume_dir=tmp_path)
    _assert_same(first, again)
    assert (tmp_path / "audio_clf_fold1.npz").stat().st_mtime_ns == stamp


def test_fuse_clf_resume_carries_the_chained_state(tmp_path, monkeypatch):
    """The clf fusion chains its folds: a run killed in fold 2 resumes
    from fold 1's completed bundle (its final model and Adam state feed
    fold 2) and fold 2's first chunk, and matches the uninterrupted run."""
    sds, clf, xa, xt = _data(7)
    train_idx = jfolds.generate_clf_folds(clf, 3, seed=7)
    _, (tf, tt) = _fusion_cfgs("clf", 6, CLF_GATE)
    _, tb = _branches(80, "clf")
    kw = dict(fcfg=tf, tcfg=tt, seed=1, device="cpu")
    full = ttrainers.train_fuse_clf(xa, xt, clf, train_idx, tb, **kw)
    run = tloop.FoldRun.run
    chunks = []

    def killed_after_four_chunks(self, n):
        if len(chunks) == 4:     # fold 1: 2 + 2 + 1 epochs, fold 2: 2
            raise KeyboardInterrupt
        chunks.append(n)
        run(self, n)

    monkeypatch.setattr(tloop.FoldRun, "run", killed_after_four_chunks)
    with pytest.raises(KeyboardInterrupt):
        ttrainers.train_fuse_clf(xa, xt, clf, train_idx, tb, chunk_epochs=2,
                                 resume_dir=tmp_path, **kw)
    monkeypatch.setattr(tloop.FoldRun, "run", run)
    with np.load(tmp_path / "fuse_clf_fold2.npz") as z:
        assert int(z["epoch_done"]) == 2
    assert not (tmp_path / "fuse_clf_fold3.npz").exists()
    resumed = ttrainers.train_fuse_clf(xa, xt, clf, train_idx, tb,
                                       chunk_epochs=2, resume_dir=tmp_path,
                                       **kw)
    _assert_same(full, resumed)


def test_cli_train_vmap_folds_with_resume_dir(tmp_path, monkeypatch, capsys):
    """``cli train --vmap-folds --resume-dir R --chunk-epochs 1``: the
    stacked folds' one bundle, the JAX CLI's chunk lines, and a rerun that
    finds the bundle complete prints the same folds."""
    from icassp2022_depression_tpu_torch import cli
    from icassp2022_depression_tpu_torch.data import eatd as teatd

    root = tmp_path / "corpus"
    teatd.make_synthetic_corpus(root, n_data=8, n_validation=4, seconds=0.5,
                                seed=0)
    clf = tconfig.AUDIO_CLF
    monkeypatch.setattr(tconfig, "AUDIO_CLF", tconfig.replace(
        clf, epochs=3, model=tconfig.replace(clf.model, hidden_dims=8),
        gate=tconfig.replace(clf.gate, **CLF_GATE)))
    argv = ["train", "--task", "audio_clf", "--root", str(root), "--corpus",
            str(root), "--device", "cpu", "--vmap-folds", "--resume-dir",
            str(tmp_path / "resume"), "--chunk-epochs", "1"]
    outs = []
    for _ in range(2):
        assert cli.main(argv) == 0
        outs.append(capsys.readouterr())
    assert outs[0].out == outs[1].out
    assert [ln.split(":")[0] for ln in outs[0].out.splitlines()] == \
        ["fold 1", "fold 2", "fold 3"]
    assert "# chunk starting: audio_clf_folds epochs 0->1/2" in outs[0].err
    assert "# chunk committed: audio_clf_folds epochs 2/2" in outs[0].err
    assert "# chunk" not in outs[1].err         # complete: read back only
    with np.load(tmp_path / "resume" / "audio_clf_folds.npz") as z:
        assert int(z["epoch_done"]) == 2
        assert z["opt/0/step"].shape == (3,)     # one count per fold
