"""The port's tensor-parallel LSTMP biLM (``parallel/elmo_tp.py``) on 2
Gloo ranks of the CPU against the JAX package's on a 4-device model mesh
of the conftest's virtual devices, and both against their serial
encoders: the layer (forward, reverse, both clips engaged), the stacked
biLM, the zhs geometry (C = 4096, P = 512, a few tokens),
``PretrainedElmo.enable_tp`` through ``make_embedder(elmo_tp=2)``, the
seeded LSTMP stand-in, and both CLIs' ``extract-text --elmo-tp 2`` and
``extract-daic --multimodal --elmo-tp 2``.

Tolerances: 1e-5 (the all-reduce sums the partial projections in
another order than the serial product); the zhs geometry at the JAX
package's own 1e-3.  Every launch is bounded by a time limit."""

import json

import jax
import numpy as np
import pytest
import torch

from icassp2022_depression_tpu import cli as jcli
from icassp2022_depression_tpu.frontend import text as jtext
from icassp2022_depression_tpu.models import char_cnn as jchar_cnn
from icassp2022_depression_tpu.models import elmo as jelmo
from icassp2022_depression_tpu.models import elmo_pretrained as jpre
from icassp2022_depression_tpu.ops import rnn as jrnn
from icassp2022_depression_tpu.parallel import elmo_tp as jtp
from icassp2022_depression_tpu.parallel import mesh as jmesh
from icassp2022_depression_tpu_torch import cli as tcli
from icassp2022_depression_tpu_torch.data import eatd as teatd
from icassp2022_depression_tpu_torch.frontend import text as ttext
from icassp2022_depression_tpu_torch.models import elmo as telmo
from icassp2022_depression_tpu_torch.models import elmo_pretrained as tpre
from icassp2022_depression_tpu_torch.ops import rnn as trnn
from icassp2022_depression_tpu_torch.parallel import distributed, dryrun
from icassp2022_depression_tpu_torch.parallel import elmo_tp as ttp

TIMEOUT = 180
ATOL = 1e-5
ZHS_ATOL = 1e-3     # the JAX package's tolerance at the zhs geometry
CELL, PROJ, DIN = 32, 16, 16
TEXTS = ["我 最近 很 难过 睡不着", "I feel ok 今天 还 可以", "  有点累  ",
         "谢谢你们", "开心 你好"]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _lstmp(seed, scale=1.0, forget_bias=0.0):
    """An LSTMP cell; ``scale`` multiplies every weight but the recurrent
    ``w_h`` (a small recurrent gain keeps float32 runs in either summation
    order within 1e-5 of each other)."""
    p = {k: np.array(v) * (1.0 if k == "w_h" else scale) for k, v in
         jrnn.init_lstmp(jax.random.PRNGKey(seed), DIN, CELL, PROJ).items()}
    p["b"][CELL:2 * CELL] += forget_bias       # gates i, f, g, o
    return p


def _encoder(cfg, seed):
    return {"layers": _np(jelmo.init_lstmp_encoder(
        jax.random.PRNGKey(seed), cfg)["layers"])}


SMALL = jelmo.ElmoLstmpConfig(input_dim=DIN, cell_size=CELL, proj_size=DIN,
                              layers=2)
TSMALL = telmo.ElmoLstmpConfig(input_dim=DIN, cell_size=CELL,
                               proj_size=DIN, layers=2)
# the zhs cell and projection, one layer, a few tokens
ZHS = jelmo.ElmoLstmpConfig(vocab_size=64, layers=1)
TZHS = telmo.ElmoLstmpConfig(vocab_size=64, layers=1)


@pytest.fixture(scope="module")
def tp_mesh():
    return jmesh.make_mesh(4, model_parallel=4)


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    """A JAX-written bundle at the zhs stream widths (P = 512) with a
    16-cell biLM, clips engaged (``test_torch_text_frontend.py``'s)."""
    chars = sorted(set("".join(TEXTS) + "我最近很难过睡不着感觉还不错开心"
                       "你好可以有点累谢们今天answerpto"))
    lex = {tok: i for i, tok in enumerate(
        ["<pad>", "<oov>", "<bos>", "<eos>", "<bow>", "<eow>"] + chars)}
    ccfg = jchar_cnn.CharCnnConfig(n_chars=len(lex), char_dim=8,
                                   filters=((1, 8), (2, 8), (3, 16)),
                                   n_highway=1, output_dim=512, max_chars=10)
    lcfg = jelmo.ElmoLstmpConfig(vocab_size=1, input_dim=512, cell_size=16,
                                 proj_size=512, layers=2)
    enc = jelmo.init_lstmp_encoder(jax.random.PRNGKey(1), lcfg)
    enc = {"layers": jax.tree_util.tree_map(lambda a: a * 2.0,
                                            enc["layers"])}
    pe = jpre.PretrainedElmo(ccfg, lcfg,
                             jchar_cnn.init(jax.random.PRNGKey(0), ccfg),
                             enc, lex, None)
    path = tmp_path_factory.mktemp("bundle") / "elmo_small.npz"
    jpre.save_npz(path, pe)
    return path


def _sents():
    return [ttext.tokenize(t, "fallback") for t in TEXTS]


@pytest.fixture(scope="module")
def ranks(bundle):
    """Every rank program of this file in one 2-rank launch."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((5, 12, DIN)).astype(np.float32)
    xc = 2.0 * rng.standard_normal((3, 9, DIN)).astype(np.float32)
    reps = rng.standard_normal((4, 10, DIN)).astype(np.float32)
    lengths = np.asarray([10, 7, 4, 2])
    zreps = rng.standard_normal((4, 6, 512)).astype(np.float32)
    zlengths = np.asarray([6, 5, 3, 2])
    inputs = {
        "layer": (_lstmp(0), x, False),
        # the cell accumulates (forget bias +5) past both clips
        "clips": (_lstmp(2, 6.0, 5.0), xc, True),
        "encoder": (_encoder(SMALL, 4), reps, lengths),
        "zhs": (_encoder(ZHS, 6), zreps, zlengths),
    }
    lcfg = dict(vocab_size=64, input_dim=16, cell_size=32, proj_size=16,
                layers=2)
    calls = [
        (dryrun.lstmp_tp, inputs["layer"], {}),
        (dryrun.lstmp_tp, inputs["clips"], {}),
        (dryrun.encode_tp, inputs["encoder"] + (TSMALL,), {}),
        (dryrun.encode_tp, inputs["zhs"] + (TZHS,), {}),
        (dryrun.embed, (_sents(), 2),
         dict(elmo_weights=str(bundle))),
        (dryrun.embed, (_sents(), 2),
         dict(elmo_weights=None, seed=5,
              cfg=telmo.ElmoLstmpConfig(**lcfg))),
    ]
    out = distributed.launch(dryrun.several, 2, ["cpu"] * 2, args=(calls,),
                             timeout=TIMEOUT)
    return inputs, out


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


@pytest.mark.parametrize("case", ["layer", "clips"])
def test_lstmp_layer_tp_matches_jax_and_serial(ranks, tp_mesh, case):
    """ys, h_last and c_last (gathered from the ranks' slices) of the TP
    layer against the port's serial layer and JAX's TP and serial ones
    (``clips``: input and projection weights x6, a forget bias, inputs
    x2, reverse, both clips engaged)."""
    inputs, out = ranks
    p, x, reverse = inputs[case]
    i = ("layer", "clips").index(case)
    serial = trnn.lstmp_layer({k: torch.from_numpy(v) for k, v in p.items()},
                              torch.from_numpy(x), reverse, 3.0, 3.0,
                              backend="torch")
    jp = jtp.shard_lstmp_params(tp_mesh, p)
    jgot = jtp.lstmp_layer_tp(tp_mesh, jp, x, reverse=reverse)
    jwant = jrnn.lstmp_layer(p, x, reverse=reverse, backend="xla")
    if case == "clips":       # both clips bind
        assert float(np.abs(np.asarray(jwant[0])).max()) == 3.0
        assert float(np.abs(np.asarray(jwant[2])).max()) == 3.0
    for rank in out:
        for g, s, jg, jw in zip(rank[i], serial, jgot, jwant):
            _close(g, s)
            _close(g, jg)
            _close(g, jw)
    for a, b in zip(out[0][i], out[1][i]):
        assert torch.equal(a, b)


def test_encode_lstmp_from_reps_tp_matches_jax(ranks, tp_mesh):
    inputs, out = ranks
    params, reps, lengths = inputs["encoder"]
    rep_t, pooled_t = out[0][2]
    jrep, jpooled = jtp.encode_lstmp_from_reps_tp(
        tp_mesh, jtp.shard_encoder_params(tp_mesh, params), reps, lengths,
        SMALL)
    srep, spooled = jelmo.encode_lstmp_from_reps(params, reps, lengths,
                                                 SMALL)
    prep, ppooled = telmo.encode_lstmp_from_reps(
        tpre.tree_to(params, "cpu"), torch.from_numpy(reps),
        torch.from_numpy(lengths), TSMALL)
    for want in ((jrep, jpooled), (srep, spooled), (prep, ppooled)):
        _close(rep_t, want[0])
        _close(pooled_t, want[1])


def test_encode_tp_at_the_zhs_geometry(ranks):
    """C = 4096, P = 512 (one layer of the zhs biLM, a few tokens): the
    2-way TP encoder against the port's serial one (the ``lstmp_fwd``
    contract's plain version here) within 1e-5, and against the JAX
    serial encoder at the JAX package's 1e-3."""
    inputs, out = ranks
    params, reps, lengths = inputs["zhs"]
    rep_t, pooled_t = out[0][3]
    prep, ppooled = telmo.encode_lstmp_from_reps(
        tpre.tree_to(params, "cpu"), torch.from_numpy(reps),
        torch.from_numpy(lengths), TZHS)
    _close(rep_t, prep)
    _close(pooled_t, ppooled)
    jrep, jpooled = jelmo.encode_lstmp_from_reps(params, reps, lengths, ZHS)
    _close(rep_t, jrep, ZHS_ATOL)
    _close(pooled_t, jpooled, ZHS_ATOL)


def test_pretrained_elmo_tp_matches_serial_and_jax(ranks, bundle, tp_mesh):
    """``make_embedder(elmo_tp=2)`` with a bundle: ``PretrainedElmo``
    with ``enable_tp`` (char-CNN on every rank, the TP biLM, the interior
    mean) against the serial embedder and JAX's TP ``PretrainedElmo``;
    the provenance id is the serial one's."""
    _, out = ranks
    sents = _sents()
    serial, _, ident = ttext.make_embedder(elmo_weights=str(bundle),
                                           with_id=True, device="cpu")
    pe = jpre.load_npz(bundle)
    pe.enable_tp(tp_mesh)
    jgot = pe.embed_sentences(sents)
    for rank in out:
        got, got_id = rank[4]
        assert got_id == ident
        _close(got, serial(sents))
        _close(got, jgot)


def test_standin_lstmp_tp_matches_serial(ranks):
    """The seeded LSTMP stand-in through ``make_tp_encode``: the serial
    vectors and id (``prng-lstmp:seed=5``), as JAX's embedder gives."""
    _, out = ranks
    lcfg = dict(vocab_size=64, input_dim=16, cell_size=32, proj_size=16,
                layers=2)
    sents = _sents()
    serial, _, ident = ttext.make_embedder(
        elmo_weights=None, seed=5, cfg=telmo.ElmoLstmpConfig(**lcfg),
        with_id=True, device="cpu")
    jfn, _, jid = jtext.make_embedder(elmo_weights=None, seed=5,
                                      cfg=jelmo.ElmoLstmpConfig(**lcfg),
                                      with_id=True, elmo_tp=4)
    got, got_id = out[0][5]
    assert got_id == ident == jid == "prng-lstmp:seed=5"
    _close(got, serial(sents))
    _close(got, jfn(sents))


def test_enable_tp_rejects_stateful(bundle):
    pe = tpre.load_npz(bundle, "cpu")
    pe.stateful = True
    with pytest.raises(ValueError, match="stateless-only"):
        pe.enable_tp(ttp.model_mesh(1))


def test_model_mesh_clear_error_when_too_few_devices():
    with pytest.raises(ValueError, match="needs >= 100 devices"):
        ttp.model_mesh(100)
    with pytest.raises(ValueError, match="needs >= 2 devices"):
        ttext.make_embedder(elmo_weights=None, device="cpu", elmo_tp=2)


def test_shard_lstmp_params_cuts_the_cell_axis():
    p = {k: torch.from_numpy(v) for k, v in _lstmp(0).items()}
    mesh = ttp.model_mesh(1)._replace(model=4, model_index=2)
    got = ttp.shard_lstmp_params(mesh, p)
    assert got["w_x"].shape == (4, CELL // 4, DIN)
    assert torch.equal(got["w_h"], p["w_h"].reshape(4, CELL, PROJ)[:, 16:24])
    assert torch.equal(got["b"], p["b"].reshape(4, CELL)[:, 16:24])
    assert torch.equal(got["w_p"], p["w_p"][:, 16:24])
    with pytest.raises(AssertionError, match="cell dim 32 not divisible"):
        ttp.shard_lstmp_params(mesh._replace(model=3), p)


def test_plain_bilstm_has_no_tp_layout():
    """As in JAX: the plain ``ElmoConfig`` stand-in raises under
    ``elmo_tp`` (raised on the ranks, carried back by the launcher)."""
    with pytest.raises(Exception, match="no tensor-parallel layout"):
        distributed.launch(dryrun.embed, 2, ["cpu"] * 2,
                           args=(_sents(), 2),
                           kwargs=dict(elmo_weights=None,
                                       cfg=telmo.ElmoConfig(vocab_size=64)),
                           timeout=TIMEOUT)


def test_cli_extract_text_elmo_tp_matches_jax_cli(bundle, tmp_path, capsys):
    """``extract-text --elmo-tp 2 --device cpu`` (2 Gloo ranks, rank 0
    writes) against the JAX CLI's ``--elmo-tp 2``: the npz files within
    1e-5, labels equal, ``extraction_meta.json`` byte-identical (it names
    ``elmo_tp: 2``)."""
    corpus = tmp_path / "corpus"
    teatd.make_synthetic_corpus(corpus, n_data=4, n_validation=2,
                                seconds=0.3, seed=2)
    jout, tout = tmp_path / "jax", tmp_path / "port"
    argv = ["extract-text", "--root", str(corpus), "--segmenter",
            "fallback", "--elmo-weights", str(bundle), "--elmo-tp", "2"]
    assert jcli.main(argv + ["--out", str(jout)]) in (0, None)
    assert tcli.main(argv + ["--out", str(tout), "--device", "cpu"]) == 0
    assert capsys.readouterr().out.strip().splitlines()[-1] == \
        f"text features (6, 3, 1024) -> {tout}"
    for track in ("clf", "reg"):
        for kind in ("samples", "labels"):
            name = f"whole_{kind}_{track}_avg.npz"
            got = np.load(tout / name)["arr_0"]
            want = np.load(jout / name)["arr_0"]
            assert got.shape == want.shape and got.dtype == want.dtype
            _close(got, want)
    meta = (tout / "extraction_meta.json").read_bytes()
    assert meta == (jout / "extraction_meta.json").read_bytes()
    assert json.loads(meta)["elmo_tp"] == 2


def test_cli_extract_daic_multimodal_elmo_tp_matches_jax_cli(bundle,
                                                            tmp_path):
    """``extract-daic --multimodal --elmo-tp 2 --device cpu`` against the
    JAX CLI: the per-response text blocks within 1e-5, the audio blocks
    within 1e-5, ``extraction_meta.json`` byte-identical."""
    from test_torch_daic import _make_corpus

    queries, train_csv, _ = _make_corpus(tmp_path, pids=(300, 301))
    argv = ["extract-daic", "--daic-dir", str(tmp_path), "--queries",
            str(queries), "--split-csv", str(train_csv), "--multimodal",
            "--elmo-weights", str(bundle), "--segmenter", "fallback",
            "--elmo-tp", "2"]
    jout, tout = tmp_path / "J", tmp_path / "T"
    assert jcli.main(argv + ["--out", str(jout)]) in (0, None)
    assert tcli.main(argv + ["--out", str(tout), "--device", "cpu"]) == 0
    for name in ("train_text_samples.npz", "train_samples_clf.npz"):
        with np.load(tout / name, allow_pickle=True) as g, \
                np.load(jout / name, allow_pickle=True) as w:
            for a, b in zip(g["arr_0"], w["arr_0"]):
                _close(a, b)
    meta = (tout / "extraction_meta.json").read_bytes()
    assert meta == (jout / "extraction_meta.json").read_bytes()
    assert json.loads(meta)["elmo_tp"] == 2
