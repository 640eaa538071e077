"""The port's fusion net against the JAX package: the frozen branch
features (``pretrained_feature``), the head (``forward``, with the reg
track's modal attention), MyLoss for both tracks, the JAX-tree converter
both ways, and ``init_from_branches``' key rules (the text fc transfers
only in the reg track, the audio LayerNorm only in clf).

Tolerance: 1e-5 absolute in float32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icassp2022_depression_tpu import config as jconfig
from icassp2022_depression_tpu.models import audio_net as jaudio_net
from icassp2022_depression_tpu.models import fusion as jfusion
from icassp2022_depression_tpu.models import losses as jlosses
from icassp2022_depression_tpu.models import porting as jporting
from icassp2022_depression_tpu.models import text_net as jtext_net
from icassp2022_depression_tpu_torch import config as tconfig
from icassp2022_depression_tpu_torch.models import losses as tlosses
from icassp2022_depression_tpu_torch.models import porting as tporting
from icassp2022_depression_tpu_torch.models.fusion import FusionNet
from icassp2022_depression_tpu_torch.ops import prng as tprng

ATOL = 1e-5
SMALL = dict(audio_embed_size=24, text_embed_size=32, audio_hidden_dims=16,
             text_hidden_dims=8)
TRACKS = {"clf": ("FUSE_CLF", "AUDIO_CLF", "TEXT_CLF", "classification"),
          "reg": ("FUSE_REG", "AUDIO_REG", "TEXT_REG", "regression")}


def _cfgs(track):
    fuse, _, _, _ = TRACKS[track]
    return (jconfig.replace(getattr(jconfig, fuse), rnn_backend="pallas",
                            **SMALL),
            tconfig.replace(getattr(tconfig, fuse), **SMALL))


def _port(params, tcfg):
    model = FusionNet(tcfg)
    model.load_state_dict(tporting.fusion_state_dict_from_jax(params, tcfg),
                          strict=True)
    return model


def _inputs(seed, b=5):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, 3, 24)).astype(np.float32),
            rng.standard_normal((b, 3, 32)).astype(np.float32))


@pytest.mark.parametrize("track", ["clf", "reg"])
def test_pretrained_feature_and_forward_match_jax(track):
    jcfg, tcfg = _cfgs(track)
    params = jfusion.init(jax.random.PRNGKey(0), jcfg)
    xa, xt = _inputs(1)
    (want, (tf, af)) = jfusion.apply(params, jcfg, jnp.asarray(xa),
                                     jnp.asarray(xt))
    model = _port(params, tcfg).eval()
    got_tf, got_af = model.pretrained_feature(torch.from_numpy(xa),
                                              torch.from_numpy(xt))
    assert not got_tf.requires_grad and not got_af.requires_grad
    np.testing.assert_allclose(got_tf.numpy(), np.asarray(tf), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(got_af.numpy(), np.asarray(af), rtol=0,
                               atol=ATOL)
    with torch.no_grad():
        got = model(torch.cat([got_tf, got_af], dim=-1))
    assert tuple(got.shape) == (5, tcfg.num_classes)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


def test_pretrained_feature_dropout_fires_in_train_mode_without_a_graph():
    _, tcfg = _cfgs("clf")
    model = FusionNet(tcfg, key=tprng.prng_key(0))
    xa, xt = (torch.from_numpy(a) for a in _inputs(2))
    model.eval()
    ev = model.pretrained_feature(xa, xt)
    model.train()
    a = model.pretrained_feature(xa, xt, tprng.prng_key(3))
    b = model.pretrained_feature(xa, xt, tprng.prng_key(3))
    for x, y, e in zip(a, b, ev):
        assert torch.equal(x, y) and not torch.equal(x, e)
        assert x.grad_fn is None
    # the JAX package's masks: its train-mode pretrained_feature, same key
    jcfg, _ = _cfgs("clf")
    params = jporting.fusion_from_state_dict(
        {k: v.detach().numpy() for k, v in model.state_dict().items()},
        jconfig.replace(jcfg, rnn_backend="xla"))
    want = jfusion.pretrained_feature(
        params, jconfig.replace(jcfg, rnn_backend="xla"),
        jnp.asarray(xa.numpy()), jnp.asarray(xt.numpy()), train=True,
        key=jax.random.PRNGKey(3))
    for x, w in zip(a, want):
        np.testing.assert_allclose(x.numpy(), np.asarray(w), rtol=0,
                                   atol=ATOL)
    # only fc_final's weight gets a gradient through MyLoss
    tf, af = a
    loss = tlosses.myloss_ce(tf, af, torch.tensor([0, 1, 0, 1, 1]),
                             model.fc_final[0].weight, 8)
    loss.backward()
    assert [n for n, p in model.named_parameters() if p.grad is not None] \
        == ["fc_final.0.weight"]


@pytest.mark.parametrize("masked", [False, True])
def test_myloss_matches_jax(masked):
    rng = np.random.default_rng(4)
    tf = rng.standard_normal((6, 8)).astype(np.float32)
    af = rng.standard_normal((6, 16)).astype(np.float32)
    labels = rng.integers(0, 2, 6)
    sds = rng.uniform(20, 70, 6).astype(np.float32)
    mask = np.array([1, 1, 1, 1, 0, 0], np.float32) if masked else None
    w2 = rng.standard_normal((2, 24)).astype(np.float32) * 0.3
    w1 = rng.standard_normal((1, 24)).astype(np.float32) * 3.0
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    got = tlosses.myloss_ce(t(tf), t(af), t(labels), t(w2), 8, t(mask))
    want = jlosses.myloss_ce(tf, af, labels, w2, 8, mask)
    np.testing.assert_allclose(got.item(), float(want), rtol=0, atol=ATOL)
    got = tlosses.myloss_smooth_l1(t(tf), t(af), t(sds), t(w1), 8, t(mask))
    want = jlosses.myloss_smooth_l1(tf, af, sds, w1, 8, mask)
    np.testing.assert_allclose(got.item(), float(want), rtol=0,
                               atol=ATOL * max(1.0, abs(float(want))))


@pytest.mark.parametrize("track", ["clf", "reg"])
def test_converter_round_trips_strict(track):
    jcfg, tcfg = _cfgs(track)
    params = jfusion.init(jax.random.PRNGKey(5), jcfg)
    want = jporting.fusion_to_state_dict(params, jcfg)
    got = tporting.fusion_state_dict_from_jax(params, tcfg)
    assert set(got) == set(want) == set(FusionNet(tcfg).state_dict())
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    tree = tporting.fusion_tree_from_state_dict(
        _port(params, tcfg).state_dict(), tcfg)
    assert jax.tree_util.tree_structure(tree) == \
        jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(tree),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("track", ["clf", "reg"])
def test_init_from_branches_key_rules_match_jax(track):
    """What transfers: the text LSTM and attention always, the text fc only
    in reg (the clf text model names it ``fc_out.0``); the audio GRU and
    ``fc_audio.1`` always, ``ln`` only in clf; ``modal_attn``/``fc_final``
    never."""
    fuse, audio, text, name = TRACKS[track]
    jcfg, tcfg = _cfgs(track)
    small_t = dict(embedding_size=32, hidden_dims=8)
    small_a = dict(embedding_size=24, hidden_dims=16)
    jt = jconfig.replace(getattr(jconfig, text).model, **small_t)
    ja = jconfig.replace(getattr(jconfig, audio).model, **small_a)
    tt = tconfig.replace(getattr(tconfig, text).model, **small_t)
    ta = tconfig.replace(getattr(tconfig, audio).model, **small_a)
    base = jfusion.init(jax.random.PRNGKey(6), jcfg)
    text_p = jtext_net.init(jax.random.PRNGKey(7), jt)
    audio_p = jaudio_net.init(jax.random.PRNGKey(8), ja)
    if "ln" in audio_p:         # a LayerNorm that differs from a fresh one
        audio_p["ln"] = {"w": audio_p["ln"]["w"] * 2.0 + 0.1,
                         "b": audio_p["ln"]["b"] + 0.3}
    want = jporting.fusion_to_state_dict(
        jfusion.init_from_branches(base, jcfg, text_p, audio_p, name), jcfg)
    model = _port(base, tcfg)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    ids = [id(p) for p in model.parameters()]
    model.init_from_branches(tporting.text_net_state_dict_from_jax(text_p, tt),
                             tporting.audio_net_state_dict_from_jax(audio_p,
                                                                    ta),
                             name)
    assert [id(p) for p in model.parameters()] == ids
    got = model.state_dict()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    moved = {k for k in got if not torch.equal(got[k], before[k])}
    expect = {k for k in got if k.startswith(
        ("lstm_net.", "lstm_net_audio.", "attention_layer.", "fc_audio.1."))}
    expect |= ({"fc_out.1.weight", "fc_out.1.bias"} if track == "reg"
               else {"ln.weight", "ln.bias"})
    assert moved == expect
