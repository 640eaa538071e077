"""The port's ELMo text encoders against the JAX package on the same inputs
and weights: the char-CNN token embedder, the seeded weights of the
stand-in and of the LSTMP biLM (the port's threefry draws the JAX
package's numbers), both encoders, :class:`PretrainedElmo` on a converted
model directory in the released zhs layout (small geometry, upstream key
names, tab-separated lexicons), and the bundle npz written by either
package and read by the other.

Tolerances: 1e-5 absolute in float32 (sums in another order); seeded
uniforms bitwise, seeded normals within 1e-6 (the inverse error function
is XLA's polynomial in both packages, evaluated in another order)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icassp2022_depression_tpu.models import char_cnn as jchar_cnn
from icassp2022_depression_tpu.models import elmo as jelmo
from icassp2022_depression_tpu.models import elmo_pretrained as jpre
from icassp2022_depression_tpu_torch.models import char_cnn, elmo, porting
from icassp2022_depression_tpu_torch.models import elmo_pretrained as tpre
from icassp2022_depression_tpu_torch.ops import prng

ATOL = 1e-5
NORMAL_TOL = 1e-6

CHAR_DIM, FILTERS, N_HIGHWAY, WORD_DIM = 8, [[1, 4], [2, 8], [3, 12]], 2, 6
NFILT = 4 + 8 + 12
PROJ, CELL, LAYERS, MAX_CHARS = 16, 32, 2, 6
SPECIALS = ["<pad>", "<oov>", "<bos>", "<eos>", "<bow>", "<eow>"]
CHARS = list("今天气很好我有点累高兴不太想说话了谢") + ["　"]
WORDS = ["今天", "天气", "很", "好", "我", "有点", "累", "不", "太", "想",
         "说话", "了"]
SENTS = [["今天", "天气", "很", "好"],
         ["我", "有点", "累", "不", "太", "想", "说话", "了"],
         ["我", "很", "高兴"],
         ["谢谢谢谢谢谢", "好"],
         []]


def _tree_close(got, want, tol=ATOL, exact=False, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _tree_close(got[k], want[k], tol, exact, f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _tree_close(g, w, tol, exact, f"{path}/{i}")
    else:
        g = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
            else np.asarray(got)
        if exact:
            np.testing.assert_array_equal(g, np.asarray(want), err_msg=path)
        else:
            np.testing.assert_allclose(g, np.asarray(want), rtol=0, atol=tol,
                                       err_msg=path)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """A released-layout model directory at a small geometry."""
    root = tmp_path_factory.mktemp("zhs.model")
    rng = np.random.default_rng(0)
    char_lex = {tok: i for i, tok in enumerate(SPECIALS + CHARS)}
    word_lex = {tok: i for i, tok in enumerate(SPECIALS[:4] + WORDS)}
    for name, lex in (("char.dic", char_lex), ("word.dic", word_lex)):
        with open(root / name, "w", encoding="utf-8") as f:
            for tok, i in lex.items():
                # upstream writes the ideographic space as a bare id line
                f.write(f"{i}\n" if tok == "　" else f"{tok}\t{i}\n")
    arch = {"encoder": {"name": "elmo", "projection_dim": PROJ, "dim": CELL,
                        "n_layers": LAYERS, "cell_clip": 3, "proj_clip": 3},
            "token_embedder": {"name": "cnn", "activation": "relu",
                               "filters": FILTERS, "n_highway": N_HIGHWAY,
                               "word_dim": WORD_DIM, "char_dim": CHAR_DIM,
                               "max_characters_per_token": MAX_CHARS}}
    (root / "cnn_small.json").write_text(json.dumps(arch))
    (root / "config.json").write_text(json.dumps(
        {"config_path": "/elsewhere/configs/cnn_small.json"}))

    def t(*shape, scale=1.0):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32))

    te = {"char_emb_layer.embedding.weight": t(len(char_lex), CHAR_DIM),
          "word_emb_layer.embedding.weight": t(len(word_lex), WORD_DIM),
          "projection.weight": t(PROJ, WORD_DIM + NFILT, scale=0.3),
          "projection.bias": t(PROJ, scale=0.1)}
    for i, (w, out) in enumerate(FILTERS):
        te[f"convolutions.{i}.weight"] = t(out, CHAR_DIM, w, scale=0.3)
        te[f"convolutions.{i}.bias"] = t(out, scale=0.1)
    for i in range(N_HIGHWAY):
        te[f"highways._layers.{i}.weight"] = t(2 * NFILT, NFILT, scale=0.2)
        te[f"highways._layers.{i}.bias"] = t(2 * NFILT, scale=0.1)
    torch.save(te, root / "token_embedder.pkl")
    enc = {}
    for d in ("forward", "backward"):
        for k in range(LAYERS):
            p = f"{d}_layer_{k}"
            # scaled so the cell and projection clips engage
            enc[f"{p}.input_linearity.weight"] = t(4 * CELL, PROJ, scale=0.6)
            enc[f"{p}.state_linearity.weight"] = t(4 * CELL, PROJ, scale=0.6)
            enc[f"{p}.state_linearity.bias"] = t(4 * CELL, scale=0.1)
            enc[f"{p}.state_projection.weight"] = t(PROJ, CELL, scale=0.6)
    torch.save(enc, root / "encoder.pkl")
    return root


def test_lexicon_and_build_batch_equal(model_dir):
    lex = tpre.load_lexicon(model_dir / "char.dic")
    assert lex == jpre.load_lexicon(model_dir / "char.dic")
    assert lex["　"] == len(SPECIALS) + len(CHARS) - 1
    wlex = tpre.load_lexicon(model_dir / "word.dic")
    got = tpre.build_batch(SENTS, lex, wlex, MAX_CHARS, pad_to=16)
    want = jpre.build_batch(SENTS, lex, wlex, MAX_CHARS, pad_to=16)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_embed_tokens_matches_jax(model_dir):
    """The char-CNN (conv, max over every position, highways, word branch
    with the upstream column order) on the converted weights."""
    pe = tpre.convert_model_dir(model_dir)
    je = jpre.convert_model_dir(model_dir)
    _tree_close(pe.cc_params, je.cc_params, exact=True)
    char_ids, word_ids, _ = jpre.build_batch(SENTS, je.char_lexicon,
                                             je.word_lexicon, MAX_CHARS)
    want = jchar_cnn.embed_tokens(je.cc_params, jnp.asarray(char_ids),
                                  je.char_cfg, jnp.asarray(word_ids))
    got = char_cnn.embed_tokens(pe.cc_params,
                                torch.from_numpy(char_ids).long(),
                                pe.char_cfg,
                                torch.from_numpy(word_ids).long())
    _tree_close(got, want)
    # the tanh-configured embedder: the highway stays ReLU
    cfg = char_cnn.CharCnnConfig(**{**pe.char_cfg.__dict__,
                                    "activation": "tanh"})
    jcfg = jchar_cnn.CharCnnConfig(**{**je.char_cfg.__dict__,
                                      "activation": "tanh"})
    _tree_close(char_cnn.embed_tokens(pe.cc_params,
                                      torch.from_numpy(char_ids).long(), cfg,
                                      torch.from_numpy(word_ids).long()),
                jchar_cnn.embed_tokens(je.cc_params, jnp.asarray(char_ids),
                                       jcfg, jnp.asarray(word_ids)))


def _normals_and_uniforms(got, want, path=""):
    """Embedding tables (normals) within 1e-6, everything else bitwise."""
    if isinstance(want, dict):
        for k in want:
            _normals_and_uniforms(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        for i, (g, w) in enumerate(zip(got, want)):
            _normals_and_uniforms(g, w, f"{path}/{i}")
    elif path.endswith(("embed", "char_emb", "word_emb")):
        _tree_close(got, want, NORMAL_TOL, path=path)
    else:
        _tree_close(got, want, exact=True, path=path)


def test_seeded_weights_match_jax():
    """``prng:seed=S`` and ``prng-lstmp:seed=S`` name the same weights in
    both packages, and so does a seeded char-CNN."""
    cfg = elmo.ElmoConfig(vocab_size=300, embed_dim=12, hidden=8, layers=2)
    jcfg = jelmo.ElmoConfig(vocab_size=300, embed_dim=12, hidden=8, layers=2)
    _normals_and_uniforms(elmo.init(prng.prng_key(4), cfg),
                          jelmo.init(jax.random.PRNGKey(4), jcfg))
    lcfg = elmo.ElmoLstmpConfig(vocab_size=200, input_dim=8, cell_size=24,
                                proj_size=8, layers=2)
    jlcfg = jelmo.ElmoLstmpConfig(vocab_size=200, input_dim=8, cell_size=24,
                                  proj_size=8, layers=2)
    _normals_and_uniforms(elmo.init_lstmp_encoder(prng.prng_key(9), lcfg),
                          jelmo.init_lstmp_encoder(jax.random.PRNGKey(9),
                                                   jlcfg))
    ccfg = dict(n_chars=40, char_dim=6, filters=((1, 4), (3, 8)),
                n_highway=1, output_dim=8, word_vocab=20, word_dim=5)
    _normals_and_uniforms(
        char_cnn.init(prng.prng_key(2), char_cnn.CharCnnConfig(**ccfg)),
        jchar_cnn.init(jax.random.PRNGKey(2), jchar_cnn.CharCnnConfig(**ccfg)))


def _ids(seed, rows, t, vocab):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, t + 1, rows).astype(np.int32)
    ids = rng.integers(0, vocab, (rows, t)).astype(np.int32)
    return ids, lengths


@pytest.mark.parametrize("kind", ["standin", "lstmp", "standin_full"])
def test_encoders_match_jax(kind):
    """Both hashed-id encoders on ragged rows, the JAX weights carried
    across by :func:`porting.elmo_tree_from_jax`.  ``standin_full``: the
    stand-in at its default widths (embed 256, hidden 512, 2 layers), the
    encoder a text path runs without an ELMo bundle, on 8 rows of up to 16
    tokens."""
    ids, lengths = _ids(1, 5, 7, 50)
    if kind == "standin_full":
        jcfg, cfg = jelmo.ElmoConfig(), elmo.ElmoConfig()
        ids, lengths = _ids(2, 8, 16, cfg.vocab_size)
        params = jelmo.init(jax.random.PRNGKey(5), jcfg)
        want = jelmo.encode(params, jnp.asarray(ids), jnp.asarray(lengths),
                            jcfg)
        got = elmo.encode(porting.elmo_tree_from_jax(params),
                          torch.from_numpy(ids).long(),
                          torch.from_numpy(lengths).long(), cfg)
    elif kind == "standin":
        jcfg = jelmo.ElmoConfig(vocab_size=50, embed_dim=12, hidden=8)
        cfg = elmo.ElmoConfig(vocab_size=50, embed_dim=12, hidden=8)
        params = jelmo.init(jax.random.PRNGKey(3), jcfg)
        want = jelmo.encode(params, jnp.asarray(ids), jnp.asarray(lengths),
                            jcfg)
        got = elmo.encode(porting.elmo_tree_from_jax(params),
                          torch.from_numpy(ids).long(),
                          torch.from_numpy(lengths).long(), cfg)
    else:
        kw = dict(vocab_size=50, input_dim=8, cell_size=24, proj_size=8)
        jcfg, cfg = jelmo.ElmoLstmpConfig(**kw), elmo.ElmoLstmpConfig(**kw)
        params = jelmo.init_lstmp_encoder(jax.random.PRNGKey(3), jcfg)
        params = jax.tree_util.tree_map(lambda a: a * 3.0, params)
        want = jelmo.encode_lstmp(params, jnp.asarray(ids),
                                  jnp.asarray(lengths), jcfg)
        got = elmo.encode_lstmp(porting.elmo_tree_from_jax(params),
                                torch.from_numpy(ids).long(),
                                torch.from_numpy(lengths).long(), cfg)
    for g, w in zip(got, want):
        _tree_close(g, w)


def test_reverse_padded_matches_jax():
    x = np.arange(2 * 5 * 3, dtype=np.float32).reshape(2, 5, 3)
    lengths = np.asarray([3, 5])
    got = elmo.reverse_padded(torch.from_numpy(x),
                              torch.from_numpy(lengths))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jelmo.reverse_padded(jnp.asarray(x),
                                                     jnp.asarray(lengths))))
    assert got[0, 3:].tolist() == x[0, 3:].tolist()   # padding stays put


def test_pretrained_elmo_matches_jax_and_is_batch_invariant(model_dir):
    """Pooled sentence vectors of a converted released-layout directory
    against the JAX package's, at two batch sizes (rows padded to 8 and
    tokens to 16 either way)."""
    pe = tpre.convert_model_dir(model_dir)
    je = jpre.convert_model_dir(model_dir)
    want = np.asarray(je.embed_sentences(SENTS))
    got = pe.embed_sentences(SENTS)
    assert tuple(got.shape) == (len(SENTS), 2 * PROJ)
    _tree_close(got, want)
    small = pe.embed_sentences(SENTS, batch_size=2)
    _tree_close(small, got.numpy())
    assert tuple(pe.embed_sentences([]).shape) == (0, 2 * PROJ)


def test_bundle_cross_loads(model_dir, tmp_path):
    """A bundle written by either package's ``save_npz`` loads in the
    other's ``load_npz`` with the same arrays, configs and lexicons."""
    pe = tpre.convert_model_dir(model_dir)
    je = jpre.convert_model_dir(model_dir)
    tpre.save_npz(tmp_path / "port.npz", pe)
    jpre.save_npz(tmp_path / "jax.npz", je)
    from_port = jpre.load_npz(tmp_path / "port.npz")
    from_jax = tpre.load_npz(tmp_path / "jax.npz", "cpu")
    assert from_port.char_cfg == je.char_cfg
    assert from_port.lstmp_cfg == je.lstmp_cfg
    assert from_jax.char_cfg == pe.char_cfg
    assert from_jax.lstmp_cfg == pe.lstmp_cfg
    assert from_port.char_lexicon == from_jax.char_lexicon == je.char_lexicon
    assert from_port.word_lexicon == from_jax.word_lexicon == je.word_lexicon
    _tree_close(from_port.cc_params, je.cc_params, exact=True)
    _tree_close(from_port.enc_params, je.enc_params, exact=True)
    _tree_close(from_jax.cc_params, je.cc_params, exact=True)
    _tree_close(from_jax.enc_params, je.enc_params, exact=True)
    _tree_close(from_jax.embed_sentences(SENTS),
                np.asarray(from_port.embed_sentences(SENTS)))


def test_load_npz_defaults_to_the_card(model_dir, tmp_path, monkeypatch):
    """Without a device, ``load_npz`` takes the card, and without a card it
    raises, naming the CPU option, instead of returning CPU tensors."""
    tpre.save_npz(tmp_path / "b.npz", tpre.convert_model_dir(model_dir))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        tpre.load_npz(tmp_path / "b.npz")


def test_default_weights_path_reads_the_env(tmp_path, monkeypatch):
    monkeypatch.delenv("ICASSP_ELMO_WEIGHTS", raising=False)
    assert tpre.default_weights_path() is None
    monkeypatch.setenv("ICASSP_ELMO_WEIGHTS", str(tmp_path / "none.npz"))
    assert tpre.default_weights_path() is None
    (tmp_path / "b.npz").write_bytes(b"")
    monkeypatch.setenv("ICASSP_ELMO_WEIGHTS", str(tmp_path / "b.npz"))
    assert tpre.default_weights_path() == tmp_path / "b.npz"
