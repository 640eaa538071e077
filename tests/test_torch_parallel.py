"""The port's multi-rank training (``parallel/distributed.py``,
``collectives.py``, ``mesh.py``) on Gloo process groups of CPU ranks,
held against the JAX package's fold-parallel and fold x data-parallel
trainers on the conftest's 8-device virtual mesh, on inputs drawn from a
numpy seed (H = 16, 10 epochs, dropout on: the port draws the JAX
package's threefry masks, a data-parallel rank its rows of the whole
batch's).

Tolerances: per-step losses within 1e-5 of their largest, per-epoch logs
(f1 and the rest) within 1e-5, the same gated epoch; a fold-parallel rank
runs the stacked program of its fold, bitwise the single-process
``vmap_folds`` run.  Every launch is bounded by a time limit."""

import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icassp2022_depression_tpu import config as jconfig
from icassp2022_depression_tpu.data import folds as jfolds
from icassp2022_depression_tpu.models import audio_net as jaudio_net
from icassp2022_depression_tpu.models import text_net as jtext_net
from icassp2022_depression_tpu.parallel import collectives as jcoll
from icassp2022_depression_tpu.parallel import distributed as jdist
from icassp2022_depression_tpu.parallel import mesh as jmesh
from icassp2022_depression_tpu.train import optim as joptim
from icassp2022_depression_tpu.train import trainers as jtrainers
from icassp2022_depression_tpu_torch import cli
from icassp2022_depression_tpu_torch import config as tconfig
from icassp2022_depression_tpu_torch.models import porting as tporting
from icassp2022_depression_tpu_torch.models.audio_net import AudioNet
from icassp2022_depression_tpu_torch.parallel import distributed, dryrun
from icassp2022_depression_tpu_torch.parallel import mesh as tmesh
from icassp2022_depression_tpu_torch.train import loop as tloop
from icassp2022_depression_tpu_torch.train import trainers as ttrainers

TIMEOUT = 180       # seconds a launch may take
STEP_TOL = 1e-5     # of the largest loss
TRAJ_TOL = 1e-5
D, DT, H = 16, 32, 16
CLF_GATE = dict(f1_floor=-1.0, train_acc_frac=0.0)
REG_GATE = dict(mae_ceiling=1e9, train_mae_ceiling=1e9)
# 4 + 6 test speakers a fold: an even padded test split, as 2-way DP needs
REG_FOLDS = dict(reg_test_dep=4, reg_test_non=6, reg_augment_first_n=2)
TASKS = ("audio_clf", "text_reg", "fuse_reg")


def _cfgs(preset, dim, gate, epochs=10, lr=None, **trainer):
    """(JAX, port) configs of a branch preset at H = 16, dropout on."""
    out = []
    for mod in (jconfig, tconfig):
        t = getattr(mod, preset)
        opt = t.optimizer if lr is None else mod.replace(
            t.optimizer, learning_rate=lr)
        out.append(mod.replace(
            t, epochs=epochs, optimizer=opt, **trainer,
            model=mod.replace(t.model, embedding_size=dim, hidden_dims=H),
            gate=mod.replace(t.gate, **gate)))
    return out


def _clf_data(seed=4, n=30):
    """The JAX package's fold-parallel test data."""
    rng = np.random.default_rng(seed)
    y = (rng.random(n) < 0.35).astype(np.int64)
    x = (np.where(y[:, None, None] == 1, .8, -.8)
         + rng.standard_normal((n, 3, D))).astype(np.float32)
    return x, y, jfolds.generate_clf_folds(y, 3, seed=0)


def _reg_data(seed=2, n=34):
    rng = np.random.default_rng(seed)
    sds = np.concatenate([rng.integers(55, 75, 13),
                          rng.integers(25, 50, n - 13)]).astype(np.float32)
    rng.shuffle(sds)
    clf = (sds >= 53).astype(np.float32)
    xa = rng.standard_normal((n, 3, D)) + 0.5 * clf[:, None, None]
    xt = rng.standard_normal((n, 3, DT)) - 0.5 * clf[:, None, None]
    dep, non = jfolds.generate_reg_shuffles(sds, seed=seed)
    return sds / 50.0, xa.astype(np.float32), xt.astype(np.float32), dep, non


def _branches(seed):
    """Seeded (text, audio) branch params of the reg fusion, JAX trees and
    the port's state dicts."""
    ja, ta = _cfgs("AUDIO_REG", D, {})
    jt, tt = _cfgs("TEXT_REG", DT, {})
    jb, tb = [], []
    for f in range(3):
        tp = jtext_net.init(jax.random.PRNGKey(seed + 2 * f), jt.model)
        ap = jaudio_net.init(jax.random.PRNGKey(seed + 2 * f + 1), ja.model)
        jb.append((tp, ap))
        tb.append((tporting.text_net_state_dict_from_jax(tp, tt.model),
                   tporting.audio_net_state_dict_from_jax(ap, ta.model)))
    return jb, tb


def _fusion_cfgs():
    kw = dict(audio_embed_size=D, text_embed_size=DT, audio_hidden_dims=H,
              text_hidden_dims=H)
    out = []
    for mod in (jconfig, tconfig):
        t = mod.FUSE_REG_TRAINER
        out.append((mod.replace(mod.FUSE_REG, **kw),
                    mod.replace(t, epochs=10,
                                gate=mod.replace(t.gate, **REG_GATE))))
    return out


def _calls(mode: dict) -> tuple:
    """The three trainers' (JAX call, port call) at one layout: ``mode``
    the fold options (``fold_parallel`` / ``data_parallel``; {} serial)."""
    x, y, tf_idx = _clf_data()
    ja, ta = _cfgs("AUDIO_CLF", D, CLF_GATE, lr=5e-3)
    y_reg, xa, xt, dep, non = _reg_data()
    # batches of 4 (the recipe's 2): half the steps, 2 rows a DP rank
    jt, tt = _cfgs("TEXT_REG", DT, REG_GATE, lr=1e-3, batch_size=4)
    (jf, jft), (tf, tft) = _fusion_cfgs()
    jb, tb = _branches(50)
    jfold = dict(fold_cfg=jconfig.FoldConfig(**REG_FOLDS))
    tfold = dict(fold_cfg=tconfig.FoldConfig(**REG_FOLDS), device="cpu")
    jmode = dict(mode, vmap_folds=True) if mode else {}
    jfuse_mode = {k: v for k, v in jmode.items() if k != "data_parallel"}
    jax_calls = [
        (jtrainers.train_audio_clf, (x, y, tf_idx),
         dict(tcfg=ja, seed=7, **jmode)),
        (jtrainers.train_text_reg, (xt, y_reg, dep, non),
         dict(tcfg=jt, seed=3, **jfold, **jmode)),
        (jtrainers.train_fuse_reg, (xa, xt, y_reg, dep, non, jb),
         dict(fcfg=jf, tcfg=jft, seed=4, **jfold, **jfuse_mode)),
    ]
    port_calls = [
        (ttrainers.train_audio_clf, (x, y, tf_idx),
         dict(tcfg=ta, seed=7, device="cpu", **mode)),
        (ttrainers.train_text_reg, (xt, y_reg, dep, non),
         dict(tcfg=tt, seed=3, **tfold, **mode)),
        (ttrainers.train_fuse_reg, (xa, xt, y_reg, dep, non, tb),
         dict(fcfg=tf, tcfg=tft, seed=4, **tfold, **mode)),
    ]
    return jax_calls, port_calls


def _run(calls):
    return [fn(*args, **kw) for fn, args, kw in calls]


@pytest.fixture(scope="module")
def runs():
    """Every trainer fold-parallel on 3 ranks and fold x DP on 6 (one
    launch each), the JAX trainers' ``fold_parallel=True[,
    data_parallel=2]``, and the port's ``vmap_folds`` in this process (its
    folds are the serial folds': ``test_torch_trainer_rest.py``)."""
    out = {}
    for name, mode, world in (
            ("fp", dict(fold_parallel=True), 3),
            ("dp", dict(fold_parallel=True, data_parallel=2), 6)):
        jcalls, tcalls = _calls(mode)
        ranks = distributed.launch(dryrun.several, world, ["cpu"] * world,
                                   args=(tcalls,), timeout=TIMEOUT)
        out[name] = {"jax": _run(jcalls), "ranks": ranks}
    out["vmap"] = _run(_calls({"vmap_folds": True})[1])
    return out


def _assert_steps(got, want):
    tol = STEP_TOL * float(np.abs(want).max())
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize("mode", ["fp", "dp"])
@pytest.mark.parametrize("task", TASKS)
def test_fold_parallel_trainers_match_jax(runs, task, mode):
    """Fold-parallel (and fold x DP) against the JAX trainer at the same
    layout and against the port's stacked folds in one process: per-epoch
    logs within 1e-5, per-step losses within 1e-5 of their largest, the
    same gated epoch; every rank returns every fold's results."""
    i = TASKS.index(task)
    ranks = runs[mode]["ranks"]
    got, want = ranks[0][i], runs[mode]["jax"][i]
    serial = runs["vmap"][i]
    assert [r["fold"] for r in got] == [1, 2, 3]
    for g, w, s in zip(got, want, serial):
        assert g["best"]["epoch"] == w["best"]["epoch"] == s["best"]["epoch"]
        for k, v in w["logs"].items():
            np.testing.assert_allclose(g["logs"][k], np.asarray(v), rtol=0,
                                       atol=TRAJ_TOL, err_msg=k)
        _assert_steps(g["step_losses"], s["step_losses"])
    for other in ranks[1:]:
        for g, o in zip(got, other[i]):
            np.testing.assert_array_equal(g["step_losses"],
                                          o["step_losses"])
            for k, v in g["best"]["params"].items():
                assert torch.equal(v, o["best"]["params"][k])


@pytest.mark.parametrize("task", TASKS)
def test_fold_parallel_is_bitwise_the_vmapped_run(runs, task):
    """One fold a rank is the stacked program of one fold over all folds'
    steps: on the CPU its logs, per-step losses and gated params are
    bitwise the single-process ``vmap_folds`` run's (on the card a
    one-fold product may take another cuBLAS algorithm than the 3-fold
    batched one: ``chip_smoke.py`` holds it there to 1e-5)."""
    i = TASKS.index(task)
    for g, v in zip(runs["fp"]["ranks"][0][i], runs["vmap"][i]):
        assert g["best"] == dict(v["best"], params=g["best"]["params"])
        for k in v["logs"]:
            np.testing.assert_array_equal(g["logs"][k], v["logs"][k])
        np.testing.assert_array_equal(g["step_losses"], v["step_losses"])
        for k, p in v["best"]["params"].items():
            assert torch.equal(g["best"]["params"][k], p), k


def test_fuse_clf_refuses_fold_parallel():
    """The clf fusion chains its folds (JAX ``trainers.py:637-643``)."""
    _, tb = _branches(60)
    x, y, tf_idx = _clf_data()
    with pytest.raises(ValueError, match="clf fusion"):
        ttrainers.train_fuse_clf(x, x, y, tf_idx, tb, fold_parallel=True,
                                 device="cpu")


@pytest.mark.parametrize("trainer", ["train_audio_clf", "train_fuse_reg"])
def test_data_parallel_needs_fold_parallel(trainer):
    with pytest.raises(ValueError, match="requires fold_parallel=True"):
        ttrainers._run_folds(tconfig.AUDIO_CLF, [], 0, data_parallel=2) \
            if trainer == "train_audio_clf" else \
            ttrainers._run_fusion_folds(tconfig.FUSE_REG,
                                        tconfig.FUSE_REG_TRAINER, [], [], 0,
                                        data_parallel=2)


# -- the rank layout ----------------------------------------------------------


@pytest.mark.parametrize("folds,dp,match", [
    (3, 1, "need >= 3 devices for fold parallelism, have 1"),
    (3, 2, "need >= 6 devices for 3 folds x 2 DP"),
])
def test_layout_needs_its_ranks_as_jax_does(folds, dp, match):
    """One process has one rank: JAX's assertion messages (JAX's virtual
    mesh has 8 devices, so it refuses 3 x 3)."""
    with pytest.raises(AssertionError, match=match):
        distributed.fold_data_mesh(folds, dp)
    with pytest.raises(AssertionError, match="need >= 9 devices for 3 "
                       "folds x 3 DP"):
        jdist.fold_data_mesh(3, 3)
    with pytest.raises(AssertionError, match="need >= 9 devices for 3 "
                       "folds x 3 DP"):
        distributed.devices_needed(3, 3, 8)


@pytest.mark.parametrize("b,n,match", [
    (8, 12, "in-fold batch size 8 not divisible by data_parallel=3"),
    (9, 10, "padded test size 10 not divisible by data_parallel=3"),
])
def test_shard_stacked_fold_data_errors_as_jax(b, n, match):
    mesh = distributed.FoldMesh(3, 3, slice(0, 1), 0, None)
    data = tloop.FoldData((torch.zeros(3, 2, b, 4),), torch.zeros(3, 2, b),
                          torch.zeros(3, 2, b), (torch.zeros(3, n, 4),),
                          torch.zeros(3, n), torch.zeros(3, n), (4, 4, 4))
    with pytest.raises(AssertionError, match=match):
        distributed.shard_stacked_fold_data(mesh, data)


def test_shard_stacked_fold_data_takes_the_ranks_share():
    mesh = distributed.FoldMesh(3, 2, slice(1, 2), 1, None)
    x = torch.arange(3 * 2 * 4 * 5, dtype=torch.float32).reshape(3, 2, 4, 5)
    y = torch.arange(3 * 2 * 4).reshape(3, 2, 4)
    data = tloop.FoldData((x,), y, y.float(), (x[:, 0],), y[:, 0],
                          y[:, 0].float(), (7, 8, 6))
    got = distributed.shard_stacked_fold_data(mesh, data)
    assert torch.equal(got.train_x[0], x[1:2, :, 2:4])
    assert torch.equal(got.train_y, y[1:2]) and got.n_train == (8,)
    assert torch.equal(got.test_x[0], x[1:2, 0])
    assert distributed.shard_over_folds(mesh, {"k": y})["k"].shape == \
        (1, 2, 4)


def test_initialize_single_process_noop(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert distributed.initialize() is False
    assert not torch.distributed.is_initialized()
    assert distributed.world_size() == 1 and distributed.is_main()


@pytest.mark.parametrize("entry", ["initialize", "launch"])
def test_no_card_raises_without_cpu_ranks(entry, monkeypatch):
    """Without a card, joining a ``torchrun`` group with the default
    backend and launching ranks without ``devices`` raise the no-card
    error; CPU ranks are only ever asked for (``backend="gloo"``,
    ``devices=["cpu"] * n``)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        if entry == "initialize":
            monkeypatch.setenv("WORLD_SIZE", "2")
            monkeypatch.setenv("RANK", "0")
            distributed.initialize()
        else:
            distributed.launch(dryrun.collectives, 2, timeout=TIMEOUT)
    assert not torch.distributed.is_initialized()


def test_mesh_and_param_spec_rule_match_jax():
    """The ``(data, model)`` grid in one process, and the placement rule
    of every audio-model parameter against JAX's ``param_shardings`` on a
    (4, 2) mesh (gate rows split over ``model``, the rest replicated)."""
    m = tmesh.make_mesh()
    assert m.shape == {"data": 1, "model": 1}
    x = torch.arange(8).reshape(4, 2)
    assert torch.equal(tmesh.batch_sharding(m, x), x)
    cfg = tconfig.replace(tconfig.AUDIO_CLF.model, embedding_size=D,
                          hidden_dims=H)
    jcfg = jconfig.replace(jconfig.AUDIO_CLF.model, embedding_size=D,
                           hidden_dims=H)
    got = tmesh.param_shardings(m._replace(data=4, model=2), AudioNet(cfg))
    want = jmesh.param_shardings(jmesh.make_mesh(8, model_parallel=2),
                                 jaudio_net.init(jax.random.PRNGKey(0),
                                                 jcfg))
    for k in range(cfg.rnn_layers):
        for d, suffix in (("fwd", ""), ("bwd", "_reverse")):
            if d not in want["rnn"][k]:
                continue
            for short, long in (("w_ih", "weight_ih"), ("w_hh", "weight_hh"),
                                ("b_ih", "bias_ih"), ("b_hh", "bias_hh")):
                name = f"lstm_net_audio.{long}_l{k}{suffix}"
                assert got[name] == tuple(want["rnn"][k][d][short].spec), \
                    name
    assert got["ln.weight"] == tuple(want["ln"]["w"].spec) == ()
    assert all(spec == () for name, spec in got.items()
               if "fc_audio" in name)


# -- the explicit DP step -------------------------------------------------------


def _jax_dp_steps(jcfg, params, batches, key_seed=9):
    """JAX's ``collectives.dp_train_step`` on 2 devices of the virtual mesh
    (``data`` = 2), each batch from ``params`` and a fresh optimizer:
    (loss, updated params, Adam counts, predictions) per batch."""
    train_loss, _ = jtrainers._branch_fns(jaudio_net, jcfg.model, jcfg)
    optimizer = joptim.build(jcfg.optimizer, params,
                             jtrainers._dead_paths(jaudio_net))
    step = jcoll.dp_train_step(train_loss, optimizer, jmesh.make_mesh(2))
    out = []
    for x, y, mask in batches:
        p, state, loss, pred = step(params, optimizer.init(params),
                                    jax.random.PRNGKey(key_seed),
                                    (jnp.asarray(x),), jnp.asarray(y),
                                    jnp.asarray(mask))
        counts = [int(v) for path, v in
                  jax.tree_util.tree_leaves_with_path(state)
                  if "count" in jax.tree_util.keystr(path)]
        out.append((float(loss), p, counts, np.asarray(pred)))
    return out


@pytest.fixture(scope="module")
def dp_steps():
    """On 2 ranks (one launch): three steps from JAX's seeded init carried
    across -- a random batch, a batch of one repeated row, a fully masked
    batch --, the collectives, and the random batch from the port's seeded
    init; JAX's step on the virtual mesh from the same init; the
    one-process reference of the port's step."""
    jcfg, tcfg = _cfgs("AUDIO_CLF", D, {})
    params = jaudio_net.init(jax.random.PRNGKey(5), jcfg.model)
    init_sd = tporting.audio_net_state_dict_from_jax(params, tcfg.model)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, 3, D)).astype(np.float32)
    y = rng.integers(0, 2, 8)
    batches = [(x, y, np.ones(8, np.float32)),
               (np.repeat(x[:1], 8, axis=0), np.zeros(8, np.int64),
                np.ones(8, np.float32)),
               (x, y, np.zeros(8, np.float32))]
    calls = [(dryrun.dp_step, (tcfg, *b), dict(init_sd=init_sd))
             for b in batches]
    calls += [(dryrun.collectives, (), {}),
              (dryrun.dp_step, (tcfg, *batches[0]), {})]
    ranks = distributed.launch(dryrun.several, 2, ["cpu"] * 2, args=(calls,),
                               timeout=TIMEOUT)
    jax_steps = [(loss, tporting.audio_net_state_dict_from_jax(p, tcfg.model),
                  counts, pred)
                 for loss, p, counts, pred in _jax_dp_steps(jcfg, params,
                                                            batches)]
    ref = dryrun.dp_step_reference(tcfg, *batches[0], shards=2, device="cpu")
    return ranks, jax_steps, init_sd, ref


@pytest.mark.parametrize("batch", [0, 1])
def test_dp_train_step_matches_jax(dp_steps, batch):
    """The 2-rank step against JAX's ``dp_train_step`` on a 2-device data
    mesh, from the same init, batch and key (dropout on, each shard's key
    ``fold_in(key, shard)``): the global loss within 1e-5, every updated
    parameter within 1e-6, one Adam step, each rank's predictions its rows
    of JAX's (1e-6); both ranks hold the same parameters."""
    ranks, jax_steps, _, _ = dp_steps
    loss, params, counts, pred = jax_steps[batch]
    assert counts and set(counts) == {1}
    for r in ranks:
        got = r[batch]
        assert abs(got["loss"] - loss) < 1e-5
        assert set(got["adam_steps"]) == {1.0}
        for k, v in params.items():
            np.testing.assert_allclose(got["params"][k].numpy(),
                                       np.asarray(v), rtol=0, atol=1e-6,
                                       err_msg=k)
    for k, v in ranks[0][batch]["params"].items():
        assert torch.equal(v, ranks[1][batch]["params"][k]), k
    got = torch.cat([r[batch]["pred"] for r in ranks]).numpy()
    np.testing.assert_allclose(got, pred, rtol=0, atol=1e-6)


def test_dp_train_step_matches_one_process(dp_steps):
    """As JAX ``test_multihost.py``, from the port's seeded init: the
    2-rank step's loss within 1e-5 and updated params' L1 within 1e-4 of
    the one-process step with the same per-shard keys; both ranks
    agree."""
    ranks, _, _, ref = dp_steps
    for r in ranks:
        got = r[4]
        assert abs(got["loss"] - ref["loss"]) < 1e-5
        assert abs(got["param_l1"] - ref["param_l1"]) < 1e-4
    assert ranks[0][4]["param_l1"] == ranks[1][4]["param_l1"]
    pred = torch.cat([r[4]["pred"] for r in ranks])
    np.testing.assert_allclose(pred.numpy(), ref["pred"].numpy(), rtol=0,
                               atol=1e-6)


def test_dp_train_step_dropout_differs_per_shard(dp_steps):
    """The replicated key is folded with the rank: one row repeated on
    both ranks gives different predictions (dropout 0.5), as JAX's
    shards' do."""
    ranks, jax_steps, _, _ = dp_steps
    a, b = (r[1]["pred"] for r in ranks)
    assert not torch.allclose(a, b)
    pred = jax_steps[1][3]
    assert not np.allclose(pred[:4], pred[4:])


def test_dp_train_step_fully_masked_is_a_noop(dp_steps):
    """No valid row in the global batch: as JAX's step, the params, the
    Adam count and the weight decay do not move, and the loss is 0."""
    ranks, jax_steps, init_sd, _ = dp_steps
    loss, params, counts, _ = jax_steps[2]
    assert loss == 0.0 and set(counts) == {0}
    for r in ranks:
        got = r[2]
        assert got["loss"] == 0.0 and got["adam_steps"] == []
        for k, v in init_sd.items():
            assert torch.equal(got["params"][k], v), k
            np.testing.assert_array_equal(np.asarray(params[k]), v.numpy())


def test_collectives_on_gloo(dp_steps):
    """Each collective the port uses, on 2 Gloo ranks."""
    ranks, _, _, _ = dp_steps
    base = torch.arange(8, dtype=torch.float32)
    for r, rank in enumerate(ranks):
        c = rank[3]
        assert torch.equal(c["all_reduce"], 2 * base + 1)
        assert torch.equal(c["broadcast"], base)
        assert torch.equal(c["all_gather"], torch.stack([base, base + 1]))
        assert c["all_gather_object"] == [{"rank": 0}, {"rank": 1}]
        assert c["broadcast_object_list"] == {"from": 0}


# -- resume bundles -------------------------------------------------------------


RCFG = _cfgs("AUDIO_CLF", D, {}, epochs=7, lr=5e-3)[1]


def _resume_calls(cfg, **kw):
    x, y, tf_idx = _clf_data(seed=5)
    return [(ttrainers.train_audio_clf, (x, y, tf_idx),
             dict(tcfg=cfg, seed=2, device="cpu", **kw))]


def _assert_same(a, b):
    for ra, rb in zip(a, b):
        assert ra["best"]["epoch"] == rb["best"]["epoch"]
        for k in ("f1", "loss"):
            np.testing.assert_array_equal(ra["logs"][k], rb["logs"][k])
        np.testing.assert_array_equal(ra["step_losses"], rb["step_losses"])
        for k, v in ra["best"]["params"].items():
            assert torch.equal(v.cpu(), rb["best"]["params"][k].cpu()), k


def test_fold_parallel_resume_bundles(tmp_path, monkeypatch):
    """``fold_parallel`` with ``resume_dir``: rank 0 writes the stacked
    run's one ``audio_clf_folds`` bundle (every array bitwise the
    ``vmap_folds`` run's at the same chunk, in the same order); a
    ``vmap_folds`` run continues it, and a fold-parallel run continues a
    killed ``vmap_folds`` run, both bitwise the single shot."""
    part = tconfig.replace(RCFG, epochs=4)
    full = _run(_resume_calls(RCFG, vmap_folds=True))[0]
    fp_dir, vm_dir, killed = (tmp_path / d for d in ("fp", "vm", "killed"))
    # the first fold-parallel run: 3 epochs in chunks of 2
    distributed.launch(dryrun.several, 3, ["cpu"] * 3, timeout=TIMEOUT,
                       args=(_resume_calls(part, fold_parallel=True,
                                           resume_dir=fp_dir,
                                           chunk_epochs=2),))
    _run(_resume_calls(part, vmap_folds=True, resume_dir=vm_dir,
                       chunk_epochs=2))
    for name in ("audio_clf_folds.npz", "audio_clf_folds_logs.npz"):
        with np.load(fp_dir / name) as a, np.load(vm_dir / name) as b:
            assert a.files == b.files
            for k in a.files:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # vmap_folds continues the fold-parallel bundle to the end
    _assert_same(_run(_resume_calls(RCFG, vmap_folds=True,
                                    resume_dir=fp_dir, chunk_epochs=3))[0],
                 full)
    # a vmap_folds run killed after one chunk, continued fold-parallel
    run = tloop.FoldRun.run
    chunks = []

    def killed_after_one_chunk(self, n):
        if chunks:
            raise KeyboardInterrupt
        chunks.append(n)
        run(self, n)

    monkeypatch.setattr(tloop.FoldRun, "run", killed_after_one_chunk)
    with pytest.raises(KeyboardInterrupt):
        _run(_resume_calls(RCFG, vmap_folds=True, resume_dir=killed,
                           chunk_epochs=4))
    monkeypatch.setattr(tloop.FoldRun, "run", run)
    with np.load(killed / "audio_clf_folds.npz") as z:
        assert int(z["epoch_done"]) == 4
    ranks = distributed.launch(dryrun.several, 3, ["cpu"] * 3,
                               timeout=TIMEOUT,
                               args=(_resume_calls(RCFG, fold_parallel=True,
                                                   resume_dir=killed,
                                                   chunk_epochs=3),))
    for rank in ranks:
        _assert_same(rank[0], full)


# -- the CLI --------------------------------------------------------------------


def _npz_root(root, n=26, seed=5):
    """Features/{AudioWhole,TextWhole} in the JAX package's npz layout
    (clf track; every fold's padded test split even, as 2-way DP needs)."""
    rng = np.random.default_rng(seed)
    sds = rng.integers(25, 75, n).astype(np.float32)
    clf = (sds >= 53).astype(np.int64)
    audio = root / "Features" / "AudioWhole"
    text = root / "Features" / "TextWhole"
    audio.mkdir(parents=True)
    text.mkdir(parents=True)
    xa = rng.standard_normal((n, 3, 1, 256)) + 0.3 * clf[:, None, None, None]
    xt = rng.standard_normal((n, 3, 1024)) - 0.3 * clf[:, None, None]
    np.savez(audio / "whole_samples_clf_256.npz", xa.astype(np.float32))
    np.savez(audio / "whole_labels_clf_256.npz", clf)
    np.savez(text / "whole_samples_clf_avg.npz", xt.astype(np.float32))
    np.savez(text / "whole_labels_clf_avg.npz", clf)


def _small_presets(monkeypatch, epochs=3, hidden=8) -> dict:
    """The clf presets cut to size in this process; returns them by name,
    for the ranks (:func:`dryrun.cli_main`)."""
    presets = {}
    for name in ("AUDIO_CLF", "TEXT_CLF", "FUSE_CLF_TRAINER"):
        t = getattr(tconfig, name)
        model = t.model if name.startswith("FUSE") else tconfig.replace(
            t.model, hidden_dims=hidden)
        presets[name] = tconfig.replace(
            t, epochs=epochs, model=model,
            gate=tconfig.replace(t.gate, **CLF_GATE))
    presets["FUSE_CLF"] = tconfig.replace(
        tconfig.FUSE_CLF, audio_hidden_dims=hidden, text_hidden_dims=hidden)
    for name, value in presets.items():
        monkeypatch.setattr(tconfig, name, value)
    return presets


def _cli_ranks(argv, presets, world) -> str:
    """``cli.main(argv)`` on ``world`` Gloo ranks on the CPU that hold
    ``presets``, as under ``torchrun`` -> rank 0's standard output; every
    rank exits 0."""
    ranks = distributed.launch(dryrun.cli_main, world, ["cpu"] * world,
                               args=(argv, presets), timeout=TIMEOUT)
    assert [(rc, code) for rc, _, code in ranks] == [(0, None)] * world
    assert all(out == "" for _, out, _ in ranks[1:])
    return ranks[0][1]


def _folds_out(text):
    out = {}
    for ln in text.strip().splitlines():
        fold, _, best = ln.partition(": ")
        out[fold] = eval(best, {"__builtins__": {}})     # a printed dict
    return out


@pytest.mark.parametrize("extra", [["--fold-parallel"],
                                   ["--fold-parallel", "--data-parallel",
                                    "2"]])
def test_cli_train_fold_parallel_matches_vmap_folds(extra, tmp_path,
                                                    monkeypatch, capsys):
    """``cli train --fold-parallel [--data-parallel 2] --device cpu`` on
    the 3 (6) Gloo ranks of a launched group: the fold lines of
    ``--vmap-folds`` (the same best epoch, metrics within 1e-4), and rank
    0 alone writes the checkpoints and the metrics log."""
    root = tmp_path / "root"
    _npz_root(root)
    presets = _small_presets(monkeypatch)
    base = ["train", "--task", "audio_clf", "--root", str(root), "--device",
            "cpu"]
    assert cli.main(base + ["--model-dir", str(tmp_path / "vm"),
                            "--vmap-folds"]) == 0
    want = _folds_out(capsys.readouterr().out)
    got = _folds_out(_cli_ranks(base + ["--model-dir", str(tmp_path / "fp")]
                                + extra, presets, 3 * (1 + len(extra) // 2)))
    assert list(got) == ["fold 1", "fold 2", "fold 3"]
    for fold, best in want.items():
        assert got[fold]["epoch"] == best["epoch"]
        for k, v in best.items():
            assert abs(got[fold][k] - v) <= 1e-4, (fold, k)
    lines = (tmp_path / "fp" / "audio_clf_metrics.jsonl").read_text()
    assert len(lines.splitlines()) == 3 * 2 + 3     # epochs, fold bests
    names = {p.name for p in (tmp_path / "vm").rglob("*.npy")}
    assert {p.name for p in (tmp_path / "fp").rglob("*.npy")} == names
    assert len(names) == 3


def test_cli_pipeline_fold_parallel_matches_vmap_folds(tmp_path, monkeypatch,
                                                       capsys):
    """``cli pipeline --track clf --fold-parallel --device cpu`` on 3 Gloo
    ranks: the branches fold-parallel, the clf fusion serial on each (it
    chains its folds), the summary of ``--vmap-folds``."""
    root = tmp_path / "root"
    _npz_root(root)
    presets = _small_presets(monkeypatch, epochs=2)
    base = ["pipeline", "--track", "clf", "--root", str(root), "--device",
            "cpu"]
    assert cli.main(base + ["--model-dir", str(tmp_path / "vm"),
                            "--vmap-folds"]) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    out = _cli_ranks(base + ["--model-dir", str(tmp_path / "fp"),
                             "--fold-parallel"], presets, 3)
    assert json.loads(out.strip().splitlines()[-1]) == want
    fuse = tmp_path / "fp" / "ClassificationWhole" / "Fuse"
    assert len(list(fuse.glob("*.npz"))) == 3


def test_cli_refuses_more_ranks_than_cards(monkeypatch):
    """On the card the CLI launches one rank a card, and says how many it
    needs when the host has fewer (JAX's message); it never puts two
    ranks on one card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(cli, "default_device", lambda: torch.device("cuda"))
    for argv, match in (
            (["train", "--task", "audio_clf", "--fold-parallel"],
             "need >= 3 devices for fold parallelism, have 1"),
            (["train", "--task", "audio_clf", "--fold-parallel",
              "--data-parallel", "2"],
             "need >= 6 devices for 3 folds x 2 DP"),
            (["pipeline", "--track", "clf", "--fold-parallel"],
             "need >= 3 devices for fold parallelism"),
            (["extract-text", "--elmo-tp", "2"], "--elmo-tp 2 needs >= 2")):
        with pytest.raises(SystemExit, match=match):
            cli.main(argv + ["--root", "nowhere"])


def test_parallel_package_imports_no_jax():
    code = ("import sys\n"
            "from icassp2022_depression_tpu_torch.parallel import "
            "collectives, distributed, dryrun, elmo_tp, mesh\n"
            "from icassp2022_depression_tpu_torch import cli\n"
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'icassp2022_depression_tpu.'))\n"
            "       or m == 'icassp2022_depression_tpu']\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          cwd=str(__import__("pathlib").Path(
                              __file__).resolve().parent.parent))
    assert proc.returncode == 0, proc.stderr[-2000:]
