"""The port's reference ``.pt`` loader and exporter against the JAX
package's (``models/porting.py``): whole-module and state-dict pickles in
torch's zipfile and legacy formats give the JAX mapper's outputs, an
``export-pt`` of either package loads in both and into the reference
module under ``strict=True``, and the restricted unpickler runs no
pickled code, ``torch.storage._load_from_bytes`` included (the JAX
package's allowlist resolves that one to an unrestricted ``torch.load``)."""

import io
import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as tnn

from icassp2022_depression_tpu import cli as jcli
from icassp2022_depression_tpu import config as jconfig
from icassp2022_depression_tpu.models import audio_net as jaudio_net
from icassp2022_depression_tpu.models import fusion as jfusion
from icassp2022_depression_tpu.models import porting as jporting
from icassp2022_depression_tpu.models import text_net as jtext_net
from icassp2022_depression_tpu.serving.predictors import Predictor as JPredictor
from icassp2022_depression_tpu.train import checkpoints as jckpt
from icassp2022_depression_tpu_torch import cli as tcli
from icassp2022_depression_tpu_torch import config as tconfig
from icassp2022_depression_tpu_torch.models import porting as tporting
from icassp2022_depression_tpu_torch.serving.predictors import Predictor
from icassp2022_depression_tpu_torch.train import checkpoints as tckpt

ATOL = 1e-5
TASKS = ["audio_clf", "audio_reg", "text_clf", "text_reg", "fuse_clf",
         "fuse_reg"]


class _RefAudio(tnn.Module):
    """The reference AudioBiLSTM's layout (``audio_gru_whole.py:24-108``
    names; the regression variant has no ``ln`` and a Linear(H, 1))."""

    def __init__(self, d=32, h=16, clf=True):
        super().__init__()
        self.attention_layer = tnn.Sequential(tnn.Linear(h, h),
                                              tnn.ReLU(inplace=True))
        self.lstm_net_audio = tnn.GRU(d, h, num_layers=2, batch_first=True)
        if clf:
            self.ln = tnn.LayerNorm(d)
        self.fc_audio = tnn.Sequential(
            tnn.Dropout(0.5), tnn.Linear(h, h), tnn.ReLU(),
            tnn.Dropout(0.5), tnn.Linear(h, 2 if clf else 1),
            tnn.Softmax(dim=1) if clf else tnn.ReLU())
        self.clf = clf

    def forward(self, x):
        if self.clf:
            x = self.ln(x)
        x, _ = self.lstm_net_audio(x)
        return self.fc_audio(x.mean(dim=1) if self.clf else x.sum(dim=1))


class _RefText(tnn.Module):
    """The reference TextBiLSTM's layout (``text_bilstm_whole.py``; the
    regression head has a leading Dropout, so its Linears are ``.1`` /
    ``.4``)."""

    def __init__(self, d=24, h=8, clf=True):
        super().__init__()
        self.attention_layer = tnn.Sequential(tnn.Linear(h, h),
                                              tnn.ReLU(inplace=True))
        self.lstm_net = tnn.LSTM(d, h, num_layers=2, bidirectional=True)
        head = [tnn.Linear(h, h), tnn.ReLU(), tnn.Dropout(0.5),
                tnn.Linear(h, 2 if clf else 1),
                tnn.Softmax(dim=1) if clf else tnn.ReLU()]
        if not clf:
            head.insert(0, tnn.Dropout(0.5))
        self.fc_out = tnn.Sequential(*head)
        self.ln1 = tnn.LayerNorm(d)
        self.ln2 = tnn.LayerNorm(h)

    def forward(self, x):
        out, (h_n, _) = self.lstm_net(x.permute(1, 0, 2))
        out = out.permute(1, 0, 2)
        h_n = h_n.permute(1, 0, 2)
        half = out.shape[-1] // 2
        h = out[..., :half] + out[..., half:]
        q = h_n.sum(dim=1, keepdim=True)
        aw = torch.relu(self.attention_layer[0](q))
        scores = torch.softmax(torch.bmm(aw, torch.tanh(h).transpose(1, 2)),
                               dim=-1)
        return self.fc_out(torch.bmm(scores, h).squeeze(1))


class _RefFusion(tnn.Module):
    """The reference fusion_net's layout (``fuse_net_whole.py:245-308``;
    the regression fusion has no ``ln``)."""

    def __init__(self, ae=12, te=20, ah=8, th=8, clf=True):
        super().__init__()
        self.attention_layer = tnn.Sequential(tnn.Linear(th, th),
                                              tnn.ReLU(inplace=True))
        self.lstm_net = tnn.LSTM(te, th, num_layers=2, bidirectional=True)
        self.fc_out = tnn.Sequential(tnn.Dropout(0.0), tnn.Linear(th, th),
                                     tnn.ReLU(), tnn.Dropout(0.0))
        self.lstm_net_audio = tnn.GRU(ae, ah, num_layers=2, batch_first=True)
        self.fc_audio = tnn.Sequential(tnn.Dropout(0.0), tnn.Linear(ah, ah),
                                       tnn.ReLU(), tnn.Dropout(0.0))
        if clf:
            self.ln = tnn.LayerNorm(ae)
        self.modal_attn = tnn.Linear(th + ah, th + ah, bias=False)
        self.fc_final = tnn.Sequential(
            tnn.Linear(th + ah, 2 if clf else 1, bias=False),
            tnn.Softmax(dim=1) if clf else tnn.ReLU())


def _cfgs(task):
    """(kind, JAX config, port config, reference module) at small widths."""
    branch, track = task.split("_")
    clf = track == "clf"
    if branch == "fuse":
        small = dict(audio_embed_size=12, text_embed_size=20,
                     audio_hidden_dims=8, text_hidden_dims=8)
        name = "FUSE_CLF" if clf else "FUSE_REG"
        return ("fusion", jconfig.replace(getattr(jconfig, name), **small),
                tconfig.replace(getattr(tconfig, name), **small),
                _RefFusion(clf=clf))
    name = f"{branch.upper()}_{track.upper()}"
    d, h = (32, 16) if branch == "audio" else (24, 8)
    jcfg = jconfig.replace(getattr(jconfig, name).model, embedding_size=d,
                           hidden_dims=h)
    tcfg = tconfig.replace(getattr(tconfig, name).model, embedding_size=d,
                           hidden_dims=h)
    ref = (_RefAudio if branch == "audio" else _RefText)(d, h, clf)
    return branch, jcfg, tcfg, ref


def _inputs(task, n=5, seed=0):
    rng = np.random.default_rng(seed)
    branch = task.split("_")[0]
    xa = rng.standard_normal((n, 3, 12 if branch == "fuse" else 32))
    xt = rng.standard_normal((n, 3, 20 if branch == "fuse" else 24))
    return xa.astype(np.float32), xt.astype(np.float32)


def _jax_out(task, params, jcfg, xa, xt):
    branch = task.split("_")[0]
    if branch == "fuse":
        return np.asarray(jfusion.apply(params, jcfg, jnp.asarray(xa),
                                        jnp.asarray(xt), train=False)[0])
    module = jaudio_net if branch == "audio" else jtext_net
    return np.asarray(module.apply(params, jcfg, jnp.asarray(
        xa if branch == "audio" else xt), train=False))


def _torch_out(task, model, xa, xt):
    branch = task.split("_")[0]
    with torch.no_grad():
        if branch == "fuse":
            tf, af = model.pretrained_feature(torch.from_numpy(xa),
                                              torch.from_numpy(xt))
            return model(torch.cat([tf, af], dim=-1)).numpy()
        return model(torch.from_numpy(xa if branch == "audio"
                                      else xt)).numpy()


def _seeded(ref, seed):
    torch.manual_seed(seed)
    for p in ref.parameters():
        torch.nn.init.uniform_(p, -0.5, 0.5)
    return ref.eval()


# -- loading ------------------------------------------------------------------


@pytest.mark.parametrize("fmt", ["zipfile", "legacy"])
@pytest.mark.parametrize("whole", [True, False], ids=["module", "state_dict"])
@pytest.mark.parametrize("task", TASKS)
def test_pt_loads_as_the_jax_mapper_reads_it(task, whole, fmt, tmp_path):
    """A reference checkpoint (the whole module or its state dict, zipfile
    or legacy stream) -> the port's model: the same outputs as the JAX
    package's mapper and apply on the same file (1e-5), and, for the
    branch models, as the reference module's own forward."""
    kind, jcfg, tcfg, ref = _cfgs(task)
    _seeded(ref, TASKS.index(task))
    path = tmp_path / "ref.pt"
    torch.save(ref if whole else ref.state_dict(), path,
               _use_new_zipfile_serialization=fmt == "zipfile")
    model = tckpt.load_model(path, kind, tcfg, "cpu")
    assert not model.training
    xa, xt = _inputs(task)
    got = _torch_out(task, model, xa, xt)
    want = _jax_out(task, jporting.params_from_reference_pt(path, kind, jcfg),
                    jcfg, xa, xt)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    if kind != "fusion":
        with torch.no_grad():
            ref_out = ref(torch.from_numpy(xa if kind == "audio" else xt))
        np.testing.assert_allclose(got, ref_out.numpy(), rtol=0, atol=ATOL)


@pytest.mark.parametrize("fmt", ["zipfile", "legacy"])
def test_load_reference_pt_equals_the_jax_loader(fmt, tmp_path):
    _, _, _, ref = _cfgs("fuse_clf")
    _seeded(ref, 7)
    torch.save(ref, tmp_path / "f.pt",
               _use_new_zipfile_serialization=fmt == "zipfile")
    got = tporting.load_reference_pt(tmp_path / "f.pt")
    want = jporting.load_reference_pt(tmp_path / "f.pt")
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_text_pt_without_ln_gets_ones_and_zeros(tmp_path):
    """The reference text module's unused ``ln1`` / ``ln2`` may be absent:
    both packages fill them with ones / zeros."""
    kind, jcfg, tcfg, ref = _cfgs("text_clf")
    sd = {k: v for k, v in _seeded(ref, 3).state_dict().items()
          if not k.startswith("ln")}
    torch.save(sd, tmp_path / "t.pt")
    model = tckpt.load_model(tmp_path / "t.pt", kind, tcfg, "cpu")
    np.testing.assert_array_equal(model.ln1.weight.detach().numpy(),
                                  np.ones(24, np.float32))
    np.testing.assert_array_equal(model.ln2.bias.detach().numpy(),
                                  np.zeros(8, np.float32))
    xa, xt = _inputs("text_clf")
    np.testing.assert_allclose(
        _torch_out("text_clf", model, xa, xt),
        _jax_out("text_clf", jporting.params_from_reference_pt(
            tmp_path / "t.pt", kind, jcfg), jcfg, xa, xt),
        rtol=0, atol=ATOL)


def test_checkpoints_load_points_pt_at_the_loader(tmp_path):
    (tmp_path / "x.pt").write_bytes(b"")
    with pytest.raises(ValueError, match="load_model"):
        tckpt.load(tmp_path / "x.pt")


# -- exporting ----------------------------------------------------------------


@pytest.mark.parametrize("task", TASKS)
def test_export_pt_of_either_package_loads_in_both(task, tmp_path):
    """The two packages' ``export_reference_pt`` of the same params write
    the same names and tensors; each file loads in the other package (same
    outputs) and in the reference module under ``strict=True``."""
    kind, jcfg, tcfg, ref = _cfgs(task)
    init = {"audio": jaudio_net.init, "text": jtext_net.init,
            "fusion": jfusion.init}[kind]
    params = init(jax.random.PRNGKey(TASKS.index(task)), jcfg)
    jpath, tpath = tmp_path / "jax.pt", tmp_path / "torch.pt"
    jporting.export_reference_pt(params, kind, jcfg, jpath)
    model = tckpt.load_model(jax.tree_util.tree_map(np.asarray, params),
                             kind, tcfg, "cpu")
    exported = tporting.export_reference_pt(model, kind, tcfg, tpath)
    jsd = torch.load(jpath, weights_only=True)
    tsd = torch.load(tpath, weights_only=True)
    assert set(tsd) == set(jsd) == set(exported)
    for k in jsd:
        assert tsd[k].dtype == jsd[k].dtype == torch.float32
        torch.testing.assert_close(tsd[k], jsd[k], rtol=0, atol=0)
    ref.load_state_dict(tsd, strict=True)
    xa, xt = _inputs(task, seed=1)
    want = _jax_out(task, params, jcfg, xa, xt)
    np.testing.assert_allclose(
        _torch_out(task, tckpt.load_model(jpath, kind, tcfg, "cpu"), xa, xt),
        want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(
        _jax_out(task, jporting.params_from_reference_pt(tpath, kind, jcfg),
                 jcfg, xa, xt), want, rtol=0, atol=ATOL)


def test_export_of_a_tree_equals_export_of_its_model(tmp_path):
    kind, _, tcfg, _ = _cfgs("audio_clf")
    model = tckpt.load_model(
        tporting.audio_net_tree_from_state_dict(
            _seeded(_cfgs("audio_clf")[3], 4).state_dict(), tcfg),
        kind, tcfg, "cpu")
    a = tporting.export_reference_pt(model, kind, tcfg, tmp_path / "a.pt")
    b = tporting.export_reference_pt(
        tporting.audio_net_tree_from_state_dict(model.state_dict(), tcfg),
        kind, tcfg, tmp_path / "b.pt")
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("task", ["audio_clf", "fuse_reg"])
def test_cli_export_pt_matches_jax(task, tmp_path, capsys):
    """``cli export-pt`` of one npz in both packages: the same JSON line and
    the same state dict; the exported ``.pt`` re-exports to itself."""
    kind, mcfg = ("fusion" if task.startswith("fuse")
                  else "audio"), None
    if kind == "fusion":
        mcfg = getattr(jconfig, task.upper())
        params = jfusion.init(jax.random.PRNGKey(3), mcfg)
    else:
        mcfg = jconfig.AUDIO_CLF.model
        params = jaudio_net.init(jax.random.PRNGKey(3), mcfg)
    npz = jckpt.save(tmp_path / "ckpt", params)
    lines = {}
    for name, cli in (("jax", jcli), ("torch", tcli)):
        out = tmp_path / f"{name}.pt"
        assert (cli.main(["export-pt", "--task", task, "--ckpt", str(npz),
                          "--out", str(out)]) or 0) == 0
        lines[name] = json.loads(capsys.readouterr().out.strip()
                                 .splitlines()[-1])
        assert lines[name].pop("exported") == str(out)
    assert lines["torch"] == lines["jax"]
    jsd = torch.load(tmp_path / "jax.pt", weights_only=True)
    tsd = torch.load(tmp_path / "torch.pt", weights_only=True)
    assert set(tsd) == set(jsd)
    for k in jsd:
        torch.testing.assert_close(tsd[k], jsd[k], rtol=0, atol=0)
    assert tcli.main(["export-pt", "--task", task, "--ckpt",
                      str(tmp_path / "torch.pt"), "--out",
                      str(tmp_path / "again.pt")]) == 0
    again = torch.load(tmp_path / "again.pt", weights_only=True)
    for k in tsd:
        torch.testing.assert_close(again[k], tsd[k], rtol=0, atol=0)


# -- serving a .pt -------------------------------------------------------------


@pytest.mark.parametrize("fmt", ["zipfile", "legacy"])
def test_predictor_from_checkpoint_pt_matches_jax(fmt, tmp_path):
    kind, jcfg, tcfg, ref = _cfgs("audio_clf")
    _seeded(ref, 5)
    path = tmp_path / "served.pt"
    torch.save(ref, path, _use_new_zipfile_serialization=fmt == "zipfile")
    xa, _ = _inputs("audio_clf", n=3, seed=2)
    got = Predictor.from_checkpoint(path, "audio_clf", model_cfg=tcfg,
                                    device="cpu").predict_features(
        audio_feats=xa)
    want = JPredictor.from_checkpoint(path, "audio_clf",
                                      model_cfg=jcfg).predict_features(
        audio_feats=xa)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_reference_text_model_on_the_standin_warns(tmp_path, capsys,
                                                   monkeypatch):
    monkeypatch.delenv("ICASSP_ELMO_WEIGHTS", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    _, _, tcfg, ref = _cfgs("text_clf")
    p = Predictor.from_torch_state_dict(ref.state_dict(), "text_clf",
                                        model_cfg=tcfg, device="cpu")
    assert p.embedder_id.startswith("prng")
    assert "reference-trained text/fusion model" in capsys.readouterr().err


def test_cli_predict_pt_matches_jax(tmp_path, capsys):
    """``cli predict --ckpt x.pt`` (a full-width reference audio module) in
    both packages on one corpus speaker."""
    from icassp2022_depression_tpu_torch.data import eatd

    corpus = tmp_path / "corpus"
    eatd.make_synthetic_corpus(corpus, 2, 1, seconds=0.4, seed=4)
    ref = _seeded(_RefAudio(256, 256), 6)
    torch.save(ref, tmp_path / "a.pt", _use_new_zipfile_serialization=False)
    out = {}
    for name, cli, extra in (("jax", jcli, []),
                             ("torch", tcli, ["--device", "cpu"])):
        assert (cli.main(["predict", "--task", "audio_clf", "--root",
                          str(corpus), "--ckpt", str(tmp_path / "a.pt"),
                          "--speaker", "Data/2"] + extra) or 0) == 0
        out[name] = json.loads(capsys.readouterr().out.strip()
                               .splitlines()[-1])
    assert out["torch"]["label"] == out["jax"]["label"]
    np.testing.assert_allclose(out["torch"]["probs"], out["jax"]["probs"],
                               rtol=0, atol=ATOL)
    assert out["torch"]["true_sds"] == out["jax"]["true_sds"]


# -- the unpickler runs nothing ------------------------------------------------


def test_pickled_callables_never_execute(tmp_path):
    """A hostile pickle comes back inert (or is refused): every global
    outside the allowlist is a shim."""
    marker = tmp_path / "pwned"

    class Evil:
        def __reduce__(self):
            import os

            return (os.system, (f"touch {marker}",))

    with open(tmp_path / "evil.pt", "wb") as f:
        pickle.dump({"payload": Evil()}, f)
    try:
        tporting.load_reference_pt(tmp_path / "evil.pt")
    except Exception:
        pass   # a refusal is fine, a run is not
    assert not marker.exists(), "a pickled os.system call ran"


@pytest.mark.parametrize("module,name", [
    ("numpy", "load"), ("torch.serialization", "load"),
    ("numpy.f2py", "compile"), ("torch._utils", "classproperty"),
    ("torch.storage", "_load_from_bytes")])
def test_allowed_module_callables_never_execute(module, name):
    """Callables of the allowlisted modules shim unless their NAME is
    allowlisted: REDUCE calls whatever ``find_class`` returns.  The string
    argument would make the real callable fail loudly."""
    payload = (b"\x80\x02"
               + b"c" + module.encode() + b"\n" + name.encode() + b"\n"
               + b"X\x14\x00\x00\x00/definitely/missing_"
               + b"\x85R.")
    obj = tporting._SafeRefUnpickler(io.BytesIO(payload)).load()
    assert isinstance(obj, tporting._ShimBase), (
        f"{module}.{name} resolved for real: REDUCE ran it")


def _load_from_bytes_stream(inner: bytes) -> bytes:
    """GLOBAL torch.storage._load_from_bytes; BINBYTES inner; TUPLE1;
    REDUCE; STOP."""
    return (b"\x80\x02ctorch.storage\n_load_from_bytes\n"
            + b"B" + len(inner).to_bytes(4, "little") + inner
            + b"\x85R.")


def test_load_from_bytes_runs_no_inner_pickle(tmp_path):
    """ref-a: ``torch.storage._load_from_bytes`` is an unrestricted
    ``torch.load`` of its argument.  A stream whose inner pickle would
    ``touch`` a marker runs nothing through the port's loader, whether the
    stream is the file itself or the payload of a legacy ``.pt``."""
    marker = tmp_path / "pwned"

    class Evil:
        def __reduce__(self):
            import os

            return (os.system, (f"touch {marker}",))

    stream = _load_from_bytes_stream(pickle.dumps(Evil(), protocol=2))
    assert b"_load_from_bytes" in stream and b"system" in stream
    obj = tporting._SafeRefUnpickler(io.BytesIO(stream)).load()
    assert isinstance(obj, tporting._ShimBase)
    assert not marker.exists()
    # a legacy torch.save stream: magic number, protocol, sys info, then
    # the main pickle, whose value here is the crafted call
    legacy = io.BytesIO()
    for header in (0x1950A86A20F9469CFC6C, 1001,
                   {"protocol_version": 1001, "little_endian": True}):
        pickle.dump(header, legacy, protocol=2)
    legacy.write(_load_from_bytes_stream(pickle.dumps(
        {"w": Evil()}, protocol=2)))
    pickle.dump([], legacy, protocol=2)
    (tmp_path / "crafted.pt").write_bytes(legacy.getvalue())
    try:
        tporting.load_reference_pt(tmp_path / "crafted.pt")
    except Exception:
        pass   # a refusal is fine, a run is not
    assert not marker.exists(), "the inner pickle of _load_from_bytes ran"


@pytest.mark.parametrize("fmt", ["zipfile", "legacy"])
def test_torch_save_never_names_load_from_bytes(fmt):
    """Why shimming ``_load_from_bytes`` loses no real checkpoint: a
    ``torch.save`` stream sends storages by persistent id, in either
    format."""
    buf = io.BytesIO()
    torch.save(_RefFusion(), buf,
               _use_new_zipfile_serialization=fmt == "zipfile")
    raw = buf.getvalue()
    if fmt == "zipfile":
        import zipfile

        with zipfile.ZipFile(io.BytesIO(raw)) as z:
            raw = b"".join(z.read(n) for n in z.namelist()
                           if n.endswith(".pkl"))
    assert b"_rebuild_tensor_v2" in raw
    assert b"_load_from_bytes" not in raw
