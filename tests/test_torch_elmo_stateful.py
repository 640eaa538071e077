"""The port's stateful pretrained-ELMo mode (upstream ``ElmobiLm``'s
cross-batch state) against the JAX package's: ``lstmp_layer_stateful``
with nonzero initial states and rows without a valid step, the stateful
biLM, :class:`PretrainedElmo` with ``stateful=True`` over two calls whose
batches grow and shrink (the carried states too), the provenance id's
``:stateful`` suffix and ``cli extract-text --elmo-stateful`` of both
CLIs.  Tolerance: 1e-5 absolute in float32."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icassp2022_depression_tpu import cli as jcli
from icassp2022_depression_tpu.frontend import text as jtext
from icassp2022_depression_tpu.models import elmo as jelmo
from icassp2022_depression_tpu.models import elmo_pretrained as jpre
from icassp2022_depression_tpu.ops import rnn as jrnn
from icassp2022_depression_tpu_torch import cli as tcli
from icassp2022_depression_tpu_torch.data import eatd as teatd
from icassp2022_depression_tpu_torch.frontend import text as ttext
from icassp2022_depression_tpu_torch.models import elmo as telmo
from icassp2022_depression_tpu_torch.models import elmo_pretrained as tpre
from icassp2022_depression_tpu_torch.models import porting
from icassp2022_depression_tpu_torch.ops import rnn as trnn
from test_torch_elmo import SENTS, model_dir  # noqa: F401 (fixture)

ATOL = 1e-5
MORE = [["好"], ["我", "今天", "很", "累", "了"], [], ["谢谢谢谢谢谢"],
        ["天气", "不", "太", "好", "我", "想", "说话"], ["我"], ["很", "好"]]


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _close(got, want):
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=ATOL)


def _pair(model_dir):
    """(port, JAX) :class:`PretrainedElmo` of ``model_dir`` with the biLM
    weights halved.  At the directory's own scale (chosen to engage the
    clips) the states at EOS are chaotic: a float32 run of either package
    sits 3.5e-5 from float64 after one batch, and every carried batch
    parts them further; halved, the recurrence contracts and the packages
    agree to about 1e-6 over many carried batches."""
    pe = tpre.convert_model_dir(model_dir)
    je = jpre.convert_model_dir(model_dir)
    je.enc_params = jax.tree_util.tree_map(lambda a: a * 0.5, je.enc_params)
    pe.enc_params = jax.tree_util.tree_map(lambda a: a * 0.5, pe.enc_params)
    return pe, je


def test_lstmp_layer_stateful_matches_jax():
    """Small widths, weights scaled so both clips engage, nonzero
    ``h0`` / ``c0``; a row with no valid step returns them unchanged."""
    rng = np.random.default_rng(0)
    b, t, d, c, p = 4, 6, 5, 7, 3
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) * 4.0,
        jrnn.init_lstmp(jax.random.PRNGKey(1), d, c, p))
    params["b"] = (rng.standard_normal(4 * c) * 0.5).astype(np.float32)
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    lengths = np.array([6, 2, 0, 4])
    valid = np.arange(t)[None, :] < lengths[:, None]
    h0 = rng.standard_normal((b, p)).astype(np.float32)
    c0 = (rng.standard_normal((b, c)) * 2).astype(np.float32)
    want = jrnn.lstmp_layer_stateful(params, x, valid, h0, c0)
    got = trnn.lstmp_layer_stateful(
        porting.elmo_tree_from_jax(params), torch.from_numpy(x),
        torch.from_numpy(valid), torch.from_numpy(h0), torch.from_numpy(c0))
    for g, w in zip(got, want):
        _close(g, w)
    assert torch.equal(got[1][2], torch.from_numpy(h0[2]))
    assert torch.equal(got[2][2], torch.from_numpy(c0[2]))
    assert float(got[2][[0, 1, 3]].abs().max()) == 3.0   # the cell clip
    # with zero states and every step valid it is the stateless layer
    zero = trnn.lstmp_layer_stateful(
        porting.elmo_tree_from_jax(params), torch.from_numpy(x),
        torch.ones((b, t), dtype=torch.bool), torch.zeros(b, p),
        torch.zeros(b, c))
    plain = trnn.lstmp_layer(porting.elmo_tree_from_jax(params),
                             torch.from_numpy(x))
    for g, w in zip(zero, plain):
        _close(g, w)


def test_encode_stateful_matches_jax():
    kw = dict(vocab_size=1, input_dim=4, cell_size=10, proj_size=4)
    jcfg, cfg = jelmo.ElmoLstmpConfig(**kw), telmo.ElmoLstmpConfig(**kw)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) * 3.0,
        jelmo.init_lstmp_encoder(jax.random.PRNGKey(2), jcfg))
    rng = np.random.default_rng(3)
    reps = rng.standard_normal((3, 7, 4)).astype(np.float32)
    lengths = np.array([7, 3, 2])
    h0 = rng.standard_normal((2, 3, 8)).astype(np.float32)
    c0 = rng.standard_normal((2, 3, 20)).astype(np.float32)
    want = jelmo.encode_lstmp_from_reps_stateful(
        params, jnp.asarray(reps), jnp.asarray(lengths), jnp.asarray(h0),
        jnp.asarray(c0), jcfg)
    got = telmo.encode_lstmp_from_reps_stateful(
        porting.elmo_tree_from_jax(params), torch.from_numpy(reps),
        torch.from_numpy(lengths), torch.from_numpy(h0),
        torch.from_numpy(c0), cfg)
    for g, w in zip(got, want):
        _close(g, w)
    zh, zc = telmo.zero_lstmp_states(3, cfg)
    wh, wc = jelmo.zero_lstmp_states(3, jcfg)
    assert zh.shape == wh.shape and zc.shape == wc.shape
    assert not zh.any() and not zc.any()


def test_pretrained_stateful_over_two_calls(model_dir):  # noqa: F811
    """Two ``embed_sentences`` calls (batches of 2, 2, 1, then 4, 3: the
    store grows and shrinks): every output and the carried states within
    1e-5 of the JAX package's; ``reset_states`` gives the stateless first
    batch back."""
    pe, je = _pair(model_dir)
    pe.stateful = je.stateful = True
    for sents, bs in ((SENTS, 2), (MORE, 4)):
        _close(pe.embed_sentences(sents, batch_size=bs),
               je.embed_sentences(sents, batch_size=bs))
        for g, w in zip(pe._states, je._states):
            _close(g, w)
    assert pe._states[0].shape[1] == 4              # the store never shrinks
    carried = pe.embed_sentences(SENTS, batch_size=2)
    pe.reset_states()
    fresh = pe.embed_sentences(SENTS[:2], batch_size=2)
    pe.stateful = False
    _close(fresh, pe.embed_sentences(SENTS[:2]))
    assert float((carried[:2] - fresh).abs().max()) > 1e-4
    assert tuple(pe.embed_sentences([]).shape) == (0, pe.output_dim)


def test_stateful_id_and_refusals(model_dir, tmp_path, monkeypatch):  # noqa: F811
    """The provenance id is the JAX package's, ``:stateful`` suffix and
    all; explicit params and a missing bundle raise the JAX messages."""
    jpre.save_npz(tmp_path / "b.npz", jpre.convert_model_dir(model_dir))
    _, _, jid = jtext.make_embedder(elmo_weights=str(tmp_path / "b.npz"),
                                    with_id=True, elmo_stateful=True)
    _, dim, tid = ttext.make_embedder(elmo_weights=str(tmp_path / "b.npz"),
                                      with_id=True, elmo_stateful=True,
                                      device="cpu")
    assert tid == jid and tid.endswith(":stateful") and dim == 32
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.delenv("ICASSP_ELMO_WEIGHTS", raising=False)
    for kw in ({"params": {"embed": torch.zeros(1)}}, {}):
        with pytest.raises(ValueError, match="elmo_stateful"):
            ttext.make_embedder(elmo_stateful=True, device="cpu", **kw)


def test_cli_extract_text_stateful_matches_jax(model_dir, tmp_path,  # noqa: F811
                                               capsys):
    """Both CLIs' ``extract-text --elmo-stateful`` with one bundle: one
    embedding call per speaker, the state carried across speakers; the
    npz within 1e-5, ``extraction_meta.json`` byte-identical, the features
    unlike the stateless ones after the first speaker."""
    corpus = tmp_path / "corpus"
    teatd.make_synthetic_corpus(corpus, n_data=3, n_validation=2,
                                seconds=0.2, seed=4)
    jpre.save_npz(tmp_path / "b.npz", _pair(model_dir)[1])
    outs = {}
    for name, cli, extra in (("jax", jcli, []),
                             ("torch", tcli, ["--device", "cpu"]),
                             ("stateless", tcli, ["--device", "cpu"])):
        outs[name] = tmp_path / name
        flag = [] if name == "stateless" else ["--elmo-stateful"]
        assert (cli.main(["extract-text", "--root", str(corpus), "--out",
                          str(outs[name]), "--elmo-weights",
                          str(tmp_path / "b.npz"), "--segmenter",
                          "fallback"] + flag + extra) or 0) == 0
    capsys.readouterr()
    for f in ("whole_samples_clf_avg.npz", "whole_labels_reg_avg.npz"):
        with np.load(outs["torch"] / f) as g, np.load(outs["jax"] / f) as w:
            _close(g["arr_0"], w["arr_0"])
    assert (outs["torch"] / "extraction_meta.json").read_bytes() == \
        (outs["jax"] / "extraction_meta.json").read_bytes()
    meta = json.loads((outs["torch"] / "extraction_meta.json").read_text())
    assert meta["embedder"].endswith(":stateful")
    with np.load(outs["torch"] / "whole_samples_clf_avg.npz") as s, \
            np.load(outs["stateless"] / "whole_samples_clf_avg.npz") as z:
        assert s["arr_0"].shape == (5, 3, 32)
        assert np.abs(s["arr_0"][1:] - z["arr_0"][1:]).max() > 1e-4
