"""The port's AudioNet, JAX-tree converter and npz checkpoints against the
JAX package: the converter yields ``porting.audio_net_to_state_dict``'s
keys and values, and the forward matches ``audio_net.apply`` with the
Pallas GRU (interpret mode on the CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icassp2022_depression_tpu import config as jconfig
from icassp2022_depression_tpu.models import audio_net as jaudio_net
from icassp2022_depression_tpu.models import porting as jporting
from icassp2022_depression_tpu.ops import nn as jnn
from icassp2022_depression_tpu.train import checkpoints as jcheckpoints
from icassp2022_depression_tpu_torch import config as tconfig
from icassp2022_depression_tpu_torch.models import porting as tporting
from icassp2022_depression_tpu_torch.models.audio_net import AudioNet
from icassp2022_depression_tpu_torch.ops import nn as tnn
from icassp2022_depression_tpu_torch.train import checkpoints as tcheckpoints
from icassp2022_depression_tpu_torch.ops import prng as tprng

ATOL = 1e-5
SMALL = dict(embedding_size=32, hidden_dims=16)


def _cfgs(preset, **kw):
    """(JAX cfg on the Pallas backend, port cfg) of one preset."""
    jcfg = jconfig.replace(getattr(jconfig, preset).model,
                           rnn_backend="pallas", **kw)
    tcfg = tconfig.replace(getattr(tconfig, preset).model, **kw)
    return jcfg, tcfg


def _port(params, jcfg, tcfg):
    model = AudioNet(tcfg)
    model.load_state_dict(tporting.audio_net_state_dict_from_jax(params,
                                                                 tcfg),
                          strict=True)
    return model.eval()


@pytest.mark.parametrize("preset,kw", [
    ("AUDIO_CLF", SMALL), ("AUDIO_REG", SMALL),
    ("AUDIO_CLF", dict(SMALL, head_input_dropout=False, bidirectional=True,
                       rnn_layers=1))])
def test_converter_matches_jax_state_dict(preset, kw):
    jcfg, tcfg = _cfgs(preset, **kw)
    params = jaudio_net.init(jax.random.PRNGKey(0), jcfg)
    want = jporting.audio_net_to_state_dict(params, jcfg)
    got = tporting.audio_net_state_dict_from_jax(params, tcfg)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    model = AudioNet(tcfg)
    assert set(model.state_dict()) == set(want)
    model.load_state_dict(got, strict=True)
    # the flat '/'-joined layout converts the same
    flat = jcheckpoints._flatten(params)
    for k, v in tporting.audio_net_state_dict_from_jax(flat, tcfg).items():
        assert torch.equal(v, got[k])
    # and the inverse gives the JAX tree back
    tree = tporting.audio_net_tree_from_state_dict(model.state_dict(), tcfg)
    assert jax.tree_util.tree_structure(tree) == \
        jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(tree),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("preset", ["AUDIO_CLF", "AUDIO_REG"])
def test_forward_matches_jax_pallas(preset):
    jcfg, tcfg = _cfgs(preset, **SMALL)
    params = jaudio_net.init(jax.random.PRNGKey(1), jcfg)
    x = np.random.default_rng(2).standard_normal((5, 3, 32)).astype(
        np.float32)
    want = np.asarray(jaudio_net.apply(params, jcfg, jnp.asarray(x),
                                       train=False))
    with torch.inference_mode():
        got = _port(params, jcfg, tcfg)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (5, jcfg.num_classes)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_forward_matches_jax_pallas_full_width():
    jcfg, tcfg = _cfgs("AUDIO_CLF")
    assert tcfg.hidden_dims == 256 and tcfg.embedding_size == 256
    params = jaudio_net.init(jax.random.PRNGKey(3), jcfg)
    x = np.random.default_rng(4).standard_normal((4, 3, 256)).astype(
        np.float32)
    want = np.asarray(jaudio_net.apply(params, jcfg, jnp.asarray(x),
                                       train=False))
    with torch.inference_mode():
        got = _port(params, jcfg, tcfg)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=0, atol=1e-6)


def test_checkpoints_cross_load(tmp_path):
    jcfg, tcfg = _cfgs("AUDIO_CLF", **SMALL)
    params = jaudio_net.init(jax.random.PRNGKey(5), jcfg)
    # JAX writes, the port reads
    jcheckpoints.save(tmp_path / "jax", params, {"task": "audio_clf"})
    model = _port(tcheckpoints.load(tmp_path / "jax.npz"), jcfg, tcfg)
    assert tcheckpoints.load_meta(tmp_path / "jax.npz") == \
        {"task": "audio_clf"}
    # the port writes, JAX reads against its template
    path = tcheckpoints.save(
        tmp_path / "port.npz",
        tporting.audio_net_tree_from_state_dict(model.state_dict(), tcfg))
    assert path.name == "port.npz"
    back = jcheckpoints.load(path, like=params)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # a reference .pt is not probed as ref.pt.npz: the error names the
    # extension-dispatched loader
    with pytest.raises(ValueError, match="load_model"):
        tcheckpoints.load(tmp_path / "ref.pt")


def test_training_mode_dropout_and_eval_identity():
    _, tcfg = _cfgs("AUDIO_CLF", **SMALL)
    model = AudioNet(tcfg, key=tprng.prng_key(0))
    x = torch.randn(4, 3, 32, generator=torch.Generator().manual_seed(1))
    model.eval()
    with torch.no_grad():
        assert torch.equal(model(x), model(x))
    model.train()
    torch.manual_seed(0)
    with torch.no_grad():
        out = model(x)
    assert out.shape == (4, 2) and torch.isfinite(out).all()


def test_nn_primitives_match_jax():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((4, 3, 10)).astype(np.float32) * 3.0 + 1.0
    w = rng.standard_normal((7, 10)).astype(np.float32)
    b = rng.standard_normal(7).astype(np.float32)
    g = rng.standard_normal(10).astype(np.float32)
    t = {k: torch.from_numpy(v) for k, v in dict(x=x, w=w, b=b, g=g).items()}
    np.testing.assert_allclose(
        tnn.linear(t["x"], t["w"], t["b"]).numpy(),
        np.asarray(jnn.linear({"w": w, "b": b}, jnp.asarray(x))),
        rtol=0, atol=ATOL)
    np.testing.assert_allclose(
        tnn.layer_norm(t["x"], t["g"], t["g"]).numpy(),
        np.asarray(jnn.layer_norm({"w": g, "b": g}, jnp.asarray(x))),
        rtol=0, atol=ATOL)
    assert tnn.dropout(t["x"], 0.5, train=False) is t["x"]
    dropped = tnn.dropout(t["x"], 0.5, train=True, key=tprng.prng_key(0))
    kept = dropped != 0
    assert 0 < kept.float().mean() < 1
    torch.testing.assert_close(dropped[kept], t["x"][kept] / 0.5)
    # the JAX package's mask and values, bit for bit
    np.testing.assert_array_equal(
        dropped.numpy(), np.asarray(jnn.dropout(jax.random.PRNGKey(0),
                                                jnp.asarray(x), 0.5, True)))


@pytest.mark.parametrize("preset", ["AUDIO_CLF", "AUDIO_REG"])
def test_every_dropout_draws_from_the_explicit_generator(preset):
    """Train-mode forwards with the same threefry key agree even when
    torch's global generator moves in between, and give the JAX package's
    train-mode ``apply`` with that key; other keys differ; eval mode is
    unchanged by the key."""
    _, tcfg = _cfgs(preset, **SMALL)
    model = AudioNet(tcfg, key=tprng.prng_key(0))
    x = torch.randn(6, 3, 32, generator=torch.Generator().manual_seed(1))
    # the reg head ends in a ReLU; lift it so dropout shows in the output
    with torch.no_grad():
        model.fc_audio[-1].bias.fill_(5.0)
    model.train()
    with torch.no_grad():
        torch.manual_seed(1)
        a = model(x, tprng.prng_key(7))
        torch.manual_seed(2)
        torch.rand(100)
        b = model(x, tprng.prng_key(7))
        c = model(x, tprng.prng_key(8))
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    jcfg, _ = _cfgs(preset, **SMALL)
    params = jporting.audio_net_from_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()}, jcfg)
    want = jaudio_net.apply(params, jconfig.replace(jcfg, rnn_backend="xla"),
                            jnp.asarray(x.numpy()), train=True,
                            key=jax.random.PRNGKey(7))
    np.testing.assert_allclose(a.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    # the head's own masks follow the key too, not only the GRU's
    pooled = torch.randn(6, 16, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        torch.manual_seed(3)
        h1 = model.head(pooled, tprng.prng_key(9))
        torch.manual_seed(4)
        h2 = model.head(pooled, tprng.prng_key(9))
    assert torch.equal(h1, h2)
    model.eval()
    with torch.no_grad():
        e1 = model(x, tprng.prng_key(7))
        e2 = model(x)
    assert torch.equal(e1, e2)
    assert set(model.state_dict()) == set(AudioNet(tcfg).state_dict())
