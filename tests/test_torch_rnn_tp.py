"""The port's gate-row tensor parallelism (``parallel/mesh.py::
shard_params``, ``parallel/rnn_tp.py``) and the clf fusion's DP x TP step
(``parallel/collectives.py::dp_tp_train_step``) against the JAX package:

* (a) ``shard_params`` against JAX's ``param_shardings`` placement of the
  same params on the conftest's (4, 2) virtual mesh: the same rows, shapes
  and values on every device;
* (b) ``rnn_tp`` on a (2, 2) mesh of 4 Gloo ranks of the CPU against JAX's
  ``rnn.rnn`` (the audio GRU and the 2-layer BiLSTM, dropout on, the same
  key, each data rank its rows of the masks);
* (c) ``dp_tp_fusion_step`` on the same mesh at ``dryrun_multichip``'s
  tiny widths against JAX's step run unsharded (a copy of its ``loss_fn``,
  ``jax.value_and_grad`` and Adam), with every row valid and with masked
  rows;
* (d) ``rnn_tp`` refuses to run where autograd would record it, and on a
  one-process mesh is the serial math.

All rank cases run in ONE 4-rank launch.  Tolerance 1e-5 (the gathered
slices sum in another order than JAX's scan); the frozen parameters
bitwise."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from icassp2022_depression_tpu import config as jconfig
from icassp2022_depression_tpu.models import fusion as jfusion
from icassp2022_depression_tpu.models import losses as jlosses
from icassp2022_depression_tpu.ops import rnn as jrnn
from icassp2022_depression_tpu.parallel import mesh as jmesh
from icassp2022_depression_tpu.train import optim as joptim
from icassp2022_depression_tpu_torch import config as tconfig
from icassp2022_depression_tpu_torch.models import porting as tporting
from icassp2022_depression_tpu_torch.models.fusion import FusionNet
from icassp2022_depression_tpu_torch.ops import prng
from icassp2022_depression_tpu_torch.ops import rnn as trnn
from icassp2022_depression_tpu_torch.parallel import distributed, dryrun
from icassp2022_depression_tpu_torch.parallel import mesh as tmesh
from icassp2022_depression_tpu_torch.parallel import rnn_tp

TIMEOUT = 240
ATOL = 1e-5
WORLD, MODEL = 4, 2
B, T = 8, 3           # dryrun_multichip's batch: 2 * n_devices
DROPOUT, RNN_KEY, STEP_KEY = 0.5, 3, 1
# dryrun_multichip's tiny fusion: hidden dims divisible by the model axis
TINY = dict(audio_embed_size=16, text_embed_size=32, audio_hidden_dims=8,
            text_hidden_dims=8)
JFCFG = jconfig.replace(jconfig.FUSE_CLF, **TINY)
TFCFG = tconfig.replace(tconfig.FUSE_CLF, **TINY)
JTCFG, TTCFG = jconfig.FUSE_CLF_TRAINER, tconfig.FUSE_CLF_TRAINER
# (cell, input, hidden, layers, bidirectional): the audio GRU, the BiLSTM
RNNS = {"gru": ("gru", 16, 8, 2, False), "lstm": ("lstm", 32, 8, 2, True)}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rnn_inputs(name):
    cell, din, hidden, layers, bidir = RNNS[name]
    params = _np(jrnn.init_params(jax.random.PRNGKey(7), cell, din, hidden,
                                  layers, bidir))
    x = np.random.default_rng(len(name)).standard_normal(
        (B, T, din)).astype(np.float32)
    return params, x


def _batches():
    """dryrun_multichip's batch (every row valid), and the same batch with
    3 of data rank 0's 4 rows masked out (the ranks' shares differ)."""
    rng = np.random.default_rng(0)
    xa = rng.standard_normal((B, T, 16)).astype(np.float32)
    xt = rng.standard_normal((B, T, 32)).astype(np.float32)
    y = rng.integers(0, 2, B)
    masked = np.ones(B, np.float32)
    masked[[0, 1, 3]] = 0.0
    return [(xa, xt, y, np.ones(B, np.float32)), (xa, xt, y, masked)]


def _jax_params():
    return jfusion.init(jax.random.PRNGKey(0), JFCFG)


def _state_dict():
    return tporting.fusion_state_dict_from_jax(_np(_jax_params()), TFCFG)


@jax.jit
def _jax_train_step(params, opt_state, key, xa, xt, y, mask):
    """``dryrun_multichip``'s train step, unsharded (its ``loss_fn`` with
    the features as aux)."""
    def loss_fn(p):
        tf, af = jfusion.pretrained_feature(p, JFCFG, xa, xt, train=True,
                                            key=key)
        return jlosses.myloss_ce(tf, af, y.astype(jnp.int32),
                                 p["fc_final"]["w"], JFCFG.text_hidden_dims,
                                 mask), (tf, af)

    (loss, (tf, af)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        params)
    updates, _ = _optimizer(params).update(grads, opt_state, params)
    return loss, tf, af, grads, optax.apply_updates(params, updates)


def _optimizer(params):
    return joptim.build(JTCFG.optimizer, params)


def _jax_step(xa, xt, y, mask):
    """JAX's step from the seeded params on one batch -> (loss, tf, af,
    fc_final's gradient, updated fc_final, updated params)."""
    params = _jax_params()
    loss, tf, af, grads, new = _jax_train_step(
        params, _optimizer(params).init(params),
        jax.random.PRNGKey(STEP_KEY), xa, xt, y, mask)
    return (float(loss), np.asarray(tf), np.asarray(af),
            np.asarray(grads["fc_final"]["w"]),
            np.asarray(new["fc_final"]["w"]), _np(new))


@pytest.fixture(scope="module")
def ranks():
    """Every rank case of this file in one 4-rank launch on a (2, 2)
    mesh."""
    sd = _state_dict()
    calls = [(dryrun.rnn_tp, _rnn_inputs(name) + (RNNS[name][0], DROPOUT,
                                                  RNN_KEY, MODEL), {})
             for name in RNNS]
    calls += [(dryrun.dp_tp_fusion_step, (TFCFG, TTCFG, sd) + batch,
               dict(key_seed=STEP_KEY, model_parallel=MODEL))
              for batch in _batches()]
    return distributed.launch(dryrun.several, WORLD, ["cpu"] * WORLD,
                              args=(calls,), timeout=TIMEOUT)


def _rows(ranks, case, pick):
    """The global batch from the data ranks' rows (model index 0), after
    checking that each model group's ranks agree bitwise."""
    for r in range(WORLD):
        peer = r - r % MODEL
        a, b = pick(ranks[r][case]), pick(ranks[peer][case])
        assert torch.equal(a, b), (case, r)
    return torch.cat([pick(ranks[d * MODEL][case])
                      for d in range(WORLD // MODEL)]).numpy()


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=ATOL * max(np.abs(want).max(), 1.0))


def test_shard_params_match_jax_placement():
    """(a) Each device of JAX's (4, 2) mesh holds, of every fusion
    parameter, what ``shard_params`` gives the rank at that place: gate
    rows ``[m R / 2, (m + 1) R / 2)`` of the GRU / LSTM matrices and
    biases, every other parameter whole."""
    params = _jax_params()
    mesh = jmesh.make_mesh(8, model_parallel=MODEL)
    placed = jax.tree_util.tree_map(jax.device_put, params,
                                    jmesh.param_shardings(mesh, params))
    model = FusionNet(TFCFG)
    model.load_state_dict(_state_dict())
    n_split = 0
    for d in range(4):
        for m in range(MODEL):
            device = mesh.devices[d, m]
            local = jax.tree_util.tree_map(
                lambda a: next(np.asarray(s.data) for s in
                               a.addressable_shards if s.device == device),
                placed)
            want = tporting.fusion_state_dict_from_jax(local, TFCFG)
            got = tmesh.shard_params(tmesh.Mesh(4, MODEL, d, m, None, None),
                                     model)
            assert set(got) == set(want)
            for name, t in got.items():
                assert tuple(t.shape) == want[name].shape, name
                assert np.array_equal(t.detach().numpy(), want[name]), name
            for path, leaf in jax.tree_util.tree_leaves_with_path(placed):
                index = next(s.index for s in leaf.addressable_shards
                             if s.device == device)
                if jax.tree_util.keystr(path).endswith(
                        ("['w_ih']", "['w_hh']", "['b_ih']", "['b_hh']")):
                    rows = leaf.shape[0] // MODEL
                    assert index[0] == slice(m * rows, (m + 1) * rows)
                    n_split += 1
    # 2 GRU layers + 2 x 2 LSTM directions, 4 tensors each, 8 devices
    assert n_split == 6 * 4 * 8


@pytest.mark.parametrize("name", list(RNNS))
def test_rnn_tp_matches_jax(ranks, name):
    """(b) ``rnn_tp`` at M = 2 against JAX's ``rnn.rnn`` of the whole
    batch with dropout on and the same key: ``y``, ``h_n`` and ``c_n``
    within 1e-5; the ranks of a model group agree bitwise."""
    params, x = _rnn_inputs(name)
    cell = RNNS[name][0]
    want = jrnn.rnn(params, jnp.asarray(x), cell, DROPOUT, True,
                    jax.random.PRNGKey(RNN_KEY))
    case = list(RNNS).index(name)
    for i in range(2 if cell == "gru" else 3):
        _close(_rows(ranks, case, lambda v: v[i]), np.asarray(want[i]))
    if cell == "gru":
        assert want[2] is None and all(r[case][2] is None for r in ranks)


@pytest.mark.parametrize("batch", [0, 1])
def test_dp_tp_fusion_step_matches_jax(ranks, batch):
    """(c) The (2, 2) DP x TP step against JAX's unsharded step from the
    same params, batch and key: the global loss, ``tf``, ``af`` and
    ``fc_final``'s gradient within 1e-5, the updated ``fc_final`` too
    (Adam at lr 8e-6 moves it by about 8e-6: the gradient is the check
    that bites); every frozen parameter bitwise its initial value, as
    JAX leaves them; every rank the same global loss and update."""
    loss, tf, af, grad, fc_final, new = _jax_step(*_batches()[batch])
    case = len(RNNS) + batch
    _close(_rows(ranks, case, lambda v: v["tf"]), tf)
    _close(_rows(ranks, case, lambda v: v["af"]), af)
    sd = tporting.fusion_state_dict_from_jax(new, TFCFG)
    for r in ranks:
        got = r[case]
        assert abs(got["loss"] - loss) <= ATOL * max(abs(loss), 1.0)
        _close(got["grad"].numpy(), grad)
        _close(got["fc_final"].numpy(), fc_final)
        assert got["frozen_same"]
        assert got["loss"] == ranks[0][case]["loss"]
        assert torch.equal(got["grad"], ranks[0][case]["grad"])
        assert torch.equal(got["fc_final"], ranks[0][case]["fc_final"])
    init = _state_dict()
    for k, v in sd.items():
        if k != "fc_final.0.weight":
            np.testing.assert_array_equal(v, init[k], err_msg=k)


def test_dp_tp_fusion_step_matches_one_process(ranks):
    """The one-process reference (the serial ``pretrained_feature``) gives
    the ranks' step: loss, gradient and the frozen parameters' L1."""
    ref = dryrun.dp_tp_fusion_step_reference(TFCFG, TTCFG, _state_dict(),
                                             *_batches()[0],
                                             key_seed=STEP_KEY, device="cpu")
    case = len(RNNS)
    _close(_rows(ranks, case, lambda v: v["tf"]), ref["tf"].numpy())
    for r in ranks:
        assert abs(r[case]["loss"] - ref["loss"]) <= ATOL
        _close(r[case]["grad"].numpy(), ref["grad"].numpy())
        assert r[case]["frozen_l1"] == ref["frozen_l1"]
    assert ref["frozen_same"]


def _one_process(name):
    params, x = _rnn_inputs(name)
    layers = [{d: {k: torch.tensor(v) for k, v in p.items()}
               for d, p in layer.items()} for layer in params]
    return layers, torch.from_numpy(x)


@pytest.mark.parametrize("name", list(RNNS))
def test_rnn_tp_one_process_is_the_serial_math(name):
    """(d) On a one-process mesh (no groups, no collective) ``rnn_tp`` is
    the serial plain recurrence, dropout keys and rows included."""
    layers, x = _one_process(name)
    cell = RNNS[name][0]
    key = prng.prng_key(RNN_KEY)
    mesh = tmesh.make_mesh()
    assert mesh.model_group is None
    got = rnn_tp.rnn_tp(mesh, layers, x, cell, DROPOUT, True, key, (2, 16))
    want = trnn.rnn(layers, x, cell, DROPOUT, True, key, "torch", (2, 16))
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                       atol=1e-6)


@pytest.mark.parametrize("what", ["input", "weight"])
def test_rnn_tp_refuses_to_record_gradients(what):
    """(d) With grad enabled and an input that requires it, ``rnn_tp``
    raises (``all_gather`` would drop the other ranks' gradients); under
    ``torch.no_grad`` the same call runs."""
    layers, x = _one_process("lstm")
    if what == "input":
        x.requires_grad_(True)
    else:
        layers[1]["bwd"]["w_hh"].requires_grad_(True)
    mesh = tmesh.make_mesh()
    with pytest.raises(RuntimeError, match="forward only"):
        rnn_tp.rnn_tp(mesh, layers, x, "lstm")
    with torch.no_grad():
        y, _, _ = rnn_tp.rnn_tp(mesh, layers, x, "lstm")
    assert y.shape == (B, T, 16) and not y.requires_grad
