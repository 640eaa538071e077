"""The port's text branch against the JAX package: the additive attention
``attention_net_with_w``, the clf and reg ``TextNet`` forward against
``text_net.apply`` (the Pallas LSTM in interpret mode on the CPU, and the
scan path), the JAX-tree converter in both directions (``strict=True``
loads, npz checkpoints either way), the xavier init's distribution, and
the explicit dropout generator.

Tolerance: 1e-5 absolute in float32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icassp2022_depression_tpu import config as jconfig
from icassp2022_depression_tpu.models import porting as jporting
from icassp2022_depression_tpu.models import text_net as jtext_net
from icassp2022_depression_tpu.ops import attention as jattention
from icassp2022_depression_tpu.ops import initializers as jinit
from icassp2022_depression_tpu.train import checkpoints as jcheckpoints
from icassp2022_depression_tpu_torch import config as tconfig
from icassp2022_depression_tpu_torch.models import porting as tporting
from icassp2022_depression_tpu_torch.models.text_net import TextNet
from icassp2022_depression_tpu_torch.ops import attention as tattention
from icassp2022_depression_tpu_torch.ops import initializers as tinit
from icassp2022_depression_tpu_torch.train import checkpoints as tcheckpoints
from icassp2022_depression_tpu_torch.ops import prng as tprng

ATOL = 1e-5
SMALL = dict(embedding_size=32, hidden_dims=16)


def _cfgs(preset, backend="pallas", **kw):
    """(JAX cfg, port cfg) of one preset at a small width."""
    kw = dict(SMALL, **kw)
    jcfg = jconfig.replace(getattr(jconfig, preset).model,
                           rnn_backend=backend, **kw)
    tcfg = tconfig.replace(getattr(tconfig, preset).model, **kw)
    return jcfg, tcfg


def _port(params, tcfg):
    model = TextNet(tcfg)
    model.load_state_dict(tporting.text_net_state_dict_from_jax(params, tcfg),
                          strict=True)
    return model.eval()


@pytest.mark.parametrize("b,t,h", [(4, 3, 8), (2, 5, 16)])
def test_attention_matches_jax(b, t, h):
    rng = np.random.default_rng(b * 10 + t)
    out = rng.standard_normal((b, t, 2 * h)).astype(np.float32)
    hidden = rng.standard_normal((b, 4, h)).astype(np.float32)
    w = (rng.standard_normal((h, h)) / np.sqrt(h)).astype(np.float32)
    bias = rng.standard_normal(h).astype(np.float32)
    want = jattention.attention_net_with_w({"w": w, "b": bias},
                                           jnp.asarray(out),
                                           jnp.asarray(hidden))
    got = tattention.attention_net_with_w(
        *(torch.from_numpy(a) for a in (w, bias, out, hidden)))
    assert tuple(got.shape) == (b, h)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("preset,backend", [("TEXT_CLF", "pallas"),
                                            ("TEXT_REG", "pallas"),
                                            ("TEXT_CLF", "xla")])
def test_forward_matches_jax(preset, backend):
    jcfg, tcfg = _cfgs(preset, backend)
    params = jtext_net.init(jax.random.PRNGKey(1), jcfg)
    x = np.random.default_rng(2).standard_normal((5, 3, 32)).astype(
        np.float32)
    want = np.asarray(jtext_net.apply(params, jcfg, jnp.asarray(x)))
    with torch.no_grad():
        got = _port(params, tcfg)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (5, tcfg.num_classes)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    ctx = np.asarray(jtext_net.features(params, jcfg, jnp.asarray(x)))
    with torch.no_grad():
        got_ctx = _port(params, tcfg).features(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got_ctx, ctx, rtol=0, atol=ATOL)


@pytest.mark.parametrize("preset", ["TEXT_CLF", "TEXT_REG"])
def test_converter_round_trips_strict(preset, tmp_path):
    jcfg, tcfg = _cfgs(preset)
    params = jtext_net.init(jax.random.PRNGKey(3), jcfg)
    want = jporting.text_net_to_state_dict(params, jcfg)
    got = tporting.text_net_state_dict_from_jax(params, tcfg)
    assert set(got) == set(want) == set(TextNet(tcfg).state_dict())
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    head = {"TEXT_CLF": ("fc_out.0.weight", "fc_out.3.weight"),
            "TEXT_REG": ("fc_out.1.weight", "fc_out.4.weight")}[preset]
    assert set(head) <= set(got)
    model = _port(params, tcfg)
    tree = tporting.text_net_tree_from_state_dict(model.state_dict(), tcfg)
    assert jax.tree_util.tree_structure(tree) == \
        jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(tree),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, np.asarray(b))
    # npz both ways: the port writes, the JAX package reads, and back
    path = tcheckpoints.save(tmp_path / "text", tree, {"task": preset})
    back = jcheckpoints.load(path, like=params)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    again = _port(tcheckpoints.load(path), tcfg)
    for k, v in again.state_dict().items():
        assert torch.equal(v, model.state_dict()[k])


def test_xavier_init_distribution():
    """Bounds sqrt(6 / (fan_in + fan_out)) over each whole matrix (the
    stacked [4H, D] LSTM ones included), uniform spread, zero biases and
    identity LayerNorms, as the JAX package's xavier init."""
    _, tcfg = _cfgs("TEXT_CLF", embedding_size=256, hidden_dims=64)
    sd = TextNet(tcfg, key=tprng.prng_key(0)) \
        .state_dict()
    jparams = jtext_net.init(jax.random.PRNGKey(0), jconfig.replace(
        jconfig.TEXT_CLF.model, embedding_size=256, hidden_dims=64))
    jsd = jporting.text_net_to_state_dict(jparams, jconfig.TEXT_CLF.model)
    assert set(sd) == set(jsd)
    for name, v in sd.items():
        assert tuple(v.shape) == jsd[name].shape, name
        if name.startswith("ln"):
            want = 1.0 if name.endswith("weight") else 0.0
            assert torch.all(v == want), name
        elif "bias" in name:
            assert torch.all(v == 0), name
            assert np.all(jsd[name] == 0), name
        else:
            fan_out, fan_in = v.shape
            bound = np.sqrt(6.0 / (fan_in + fan_out))
            assert float(v.abs().max()) <= bound, name
            # U(-a, a): mean 0, std a / sqrt(3); both packages draw the
            # same law (4-sigma bounds of the sample statistics at n draws)
            n, sd_a = v.numel(), bound / np.sqrt(3)
            for arr in (v.numpy(), jsd[name]):
                assert abs(arr.std() / sd_a - 1) < 4 * 0.45 / np.sqrt(n), name
                assert abs(arr.mean()) < 4 * sd_a / np.sqrt(n), name
    lin = tinit.xavier_linear(tprng.prng_key(1), 5, 7)
    jlin = jinit.xavier_linear(jax.random.PRNGKey(1), 5, 7)
    assert lin["w"].shape == jlin["w"].shape and torch.all(lin["b"] == 0)
    # the same key draws the same numbers: the JAX package's init
    np.testing.assert_array_equal(lin["w"].numpy(), np.asarray(jlin["w"]))
    for name, v in sd.items():
        np.testing.assert_array_equal(v.numpy(), jsd[name], err_msg=name)


@pytest.mark.parametrize("preset", ["TEXT_CLF", "TEXT_REG"])
def test_every_dropout_draws_from_the_explicit_generator(preset):
    """Every mask comes from the explicit threefry key: the same key gives
    the same forward whatever torch's global generator does, another key
    another one, the JAX package's train-mode ``apply`` with that key the
    same numbers; eval mode ignores the key."""
    jcfg, tcfg = _cfgs(preset)
    model = TextNet(tcfg, key=tprng.prng_key(0))
    x = torch.randn(6, 3, 32, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        model.fc_out[-1].bias.fill_(5.0)    # lift the reg head's ReLU
    model.train()
    with torch.no_grad():
        torch.manual_seed(1)
        a = model(x, tprng.prng_key(7))
        torch.manual_seed(2)
        b = model(x, tprng.prng_key(7))
        c = model(x, tprng.prng_key(8))
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    params = jporting.text_net_from_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()}, jcfg)
    want = jtext_net.apply(params, jconfig.replace(jcfg, rnn_backend="xla"),
                           jnp.asarray(x.numpy()), train=True,
                           key=jax.random.PRNGKey(7))
    np.testing.assert_allclose(a.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    model.eval()
    with torch.no_grad():
        assert torch.equal(model(x, tprng.prng_key(7)), model(x))
