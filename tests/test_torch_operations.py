"""The port's operational entry points against the JAX package's: the weight
converters (``icassp2022_depression_tpu_torch.scripts``), ``cli warmup``
and ``cli doctor``, the profiling regions (``utils/profiling.py``), the
``serve`` facade, ``register_segmenter`` and the last public functions
(``ops/mel.py``'s MFCC family, ``eatd.binary_label``,
``config.DataPaths``, ``cli.script_main``), plus the build directory of
``_build.py`` with a stand-in compiler.

Tolerances: converted bundles bitwise; ``--check`` norms 1e-5; MFCCs 1e-5
of their largest magnitude (float32 sums in another order, in dB)."""

import contextlib
import importlib.util
import io
import json
import os
import re
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icassp2022_depression_tpu import cli as jcli
from icassp2022_depression_tpu import config as jconfig
from icassp2022_depression_tpu import serve as jserve
from icassp2022_depression_tpu.data import eatd as jeatd
from icassp2022_depression_tpu.frontend import text as jtext
from icassp2022_depression_tpu.models import elmo_pretrained as jpre
from icassp2022_depression_tpu.ops import mel as jmel
from icassp2022_depression_tpu_torch import _build
from icassp2022_depression_tpu_torch import cli as tcli
from icassp2022_depression_tpu_torch import config as tconfig
from icassp2022_depression_tpu_torch import serve as tserve
from icassp2022_depression_tpu_torch.data import eatd as teatd
from icassp2022_depression_tpu_torch.frontend import audio as taudio
from icassp2022_depression_tpu_torch.frontend import text as ttext
from icassp2022_depression_tpu_torch.models import elmo as telmo
from icassp2022_depression_tpu_torch.models import elmo_pretrained as tpre
from icassp2022_depression_tpu_torch.ops import mel as tmel
from icassp2022_depression_tpu_torch.scripts import convert_elmo_zhs
from icassp2022_depression_tpu_torch.serving import predictors, transport
from icassp2022_depression_tpu_torch.train import trainers
from icassp2022_depression_tpu_torch.utils import profiling
from test_torch_elmo import model_dir  # noqa: F401  (fixture)

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "icassp2022_depression_tpu_torch"
ATOL = 1e-5
SMALL_FE = tconfig.FrontendConfig(n_fft=256, hop_length=64, n_mels=16,
                                  netvlad_clusters=4, netvlad_output_dim=32)


def _jax_script(name: str):
    """The JAX repo's ``scripts/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _norms(out: str) -> list:
    return [float(line.split("norm")[-1]) for line in out.splitlines()
            if " norm " in line]


def _json_lines(out: str) -> list:
    return [json.loads(line) for line in out.strip().splitlines()
            if line.startswith("{")]


# -- converters -------------------------------------------------------------


@pytest.fixture(scope="module")
def converted(model_dir, tmp_path_factory):  # noqa: F811
    """Both converters on the released-layout dir, ``--check`` on the CPU:
    {package: (bundle path, printed output)}."""
    out = tmp_path_factory.mktemp("converted")
    runs = {}
    for name, main, extra in (
            ("torch", convert_elmo_zhs.main, ["--device", "cpu"]),
            ("jax", _jax_script("convert_elmo_zhs").main, [])):
        path = out / f"{name}.npz"
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main([str(model_dir), "-o", str(path), "--check",
                         *extra]) == 0
        runs[name] = (path, buf.getvalue())
    return runs


def test_convert_elmo_zhs_bundle_equals_jax(converted):
    """Every array of the port's bundle is bitwise the JAX converter's, the
    metadata (configs, lexicons) equal, and the summary lines match."""
    (tpath, tout), (jpath, jout) = converted["torch"], converted["jax"]
    with np.load(tpath) as t, np.load(jpath) as j:
        assert sorted(t.files) == sorted(j.files)
        for k in j.files:
            if k == "__meta__":
                assert json.loads(str(t[k])) == json.loads(str(j[k]))
            else:
                assert t[k].dtype == j[k].dtype, k
                np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    assert tout.splitlines()[0].split("(")[1] == \
        jout.splitlines()[0].split("(")[1]


def test_convert_elmo_zhs_bundles_cross_load(converted):
    """Either package's ``load_npz`` reads either converter's bundle into
    the parameters of the JAX converter's."""
    import jax

    want = jpre.load_npz(converted["jax"][0])
    leaves = [np.asarray(a) for a in jax.tree_util.tree_leaves(
        (want.cc_params, want.enc_params))]
    for src in ("torch", "jax"):
        je = jpre.load_npz(converted[src][0])
        for a, b in zip(jax.tree_util.tree_leaves(
                (je.cc_params, je.enc_params)), leaves):
            np.testing.assert_array_equal(np.asarray(a), b)
        pe = tpre.load_npz(converted[src][0], "cpu")
        assert pe.char_lexicon == want.char_lexicon
        assert pe.word_lexicon == want.word_lexicon
        got = {}
        tpre._flatten((pe.cc_params, pe.enc_params), "", got)
        flat = {}
        tpre._flatten((want.cc_params, want.enc_params), "", flat)
        assert sorted(got) == sorted(flat)
        for k in flat:
            np.testing.assert_array_equal(got[k], flat[k], err_msg=k)


def test_convert_elmo_zhs_check_norms_match_jax(converted):
    got, want = _norms(converted["torch"][1]), _norms(converted["jax"][1])
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    shapes = re.findall(r"-> (\(\d+,?\)) norm", converted["torch"][1])
    assert shapes == re.findall(r"-> (\(\d+,?\)) norm", converted["jax"][1])


def test_convert_elmo_zhs_runs_with_jax_blocked(model_dir,  # noqa: F811
                                                tmp_path):
    """``python -m ...scripts.convert_elmo_zhs`` runs in a process where
    ``import jax`` fails (and the JAX package cannot be imported), and
    ``scripts/``, ``utils/profiling.py`` and ``serve.py`` import there."""
    out = tmp_path / "b.npz"
    code = textwrap.dedent(f"""
        import runpy, sys
        sys.modules["jax"] = None
        sys.modules["icassp2022_depression_tpu"] = None
        import icassp2022_depression_tpu_torch.scripts.convert_vggish
        import icassp2022_depression_tpu_torch.utils.profiling
        import icassp2022_depression_tpu_torch.serve
        sys.argv = ["convert_elmo_zhs", {str(model_dir)!r}, "-o",
                    {str(out)!r}, "--check", "--device", "cpu"]
        try:
            runpy.run_module(
                "icassp2022_depression_tpu_torch.scripts.convert_elmo_zhs",
                run_name="__main__")
        except SystemExit as e:
            assert e.code == 0, e.code
        assert "jax" not in [m.split(".")[0] for m in sys.modules
                             if sys.modules[m] is not None]
        """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert len(_norms(proc.stdout)) == 2 and out.exists()


def test_convert_elmo_zhs_check_needs_a_card(model_dir, tmp_path):  # noqa: F811
    """``--check`` embeds on the card by default; converting alone does
    not need one."""
    assert convert_elmo_zhs.main([str(model_dir), "-o",
                                  str(tmp_path / "a.npz")]) == 0
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert_elmo_zhs.main([str(model_dir), "-o", str(tmp_path / "b.npz"),
                               "--check"])


#: one process (one tensorflow import): with jax blocked, a TF-slim
#: checkpoint in the released layout (the full conv stack, narrow FC
#: widths: the converter checks only the last FC's 128) and the port's
#: converter; then, jax unblocked, the JAX script
_VGGISH_RUN = """
import runpy, sys
sys.modules["jax"] = None
sys.modules["icassp2022_depression_tpu"] = None
from pathlib import Path
import numpy as np
import tensorflow as tf

out = Path(sys.argv[1])
tf1 = tf.compat.v1
convs = ["vggish/conv1", "vggish/conv2", "vggish/conv3/conv3_1",
         "vggish/conv3/conv3_2", "vggish/conv4/conv4_1",
         "vggish/conv4/conv4_2"]
chans = [(1, 64), (64, 128), (128, 256), (256, 256), (256, 512), (512, 512)]
fcs = [("vggish/fc1/fc1_1", (6 * 4 * 512, 8)), ("vggish/fc1/fc1_2", (8, 8)),
       ("vggish/fc2", (8, 128))]
rng = np.random.default_rng(0)
graph = tf1.Graph()
with graph.as_default():
    for scope, (cin, cout) in zip(convs, chans):
        tf1.get_variable(f"{scope}/weights", initializer=rng.standard_normal(
            (3, 3, cin, cout)).astype(np.float32) * 0.05)
        tf1.get_variable(f"{scope}/biases", initializer=rng.standard_normal(
            cout).astype(np.float32) * 0.05)
    for scope, shape in fcs:
        tf1.get_variable(f"{scope}/weights", initializer=rng.standard_normal(
            shape).astype(np.float32) * 0.01)
        tf1.get_variable(f"{scope}/biases", initializer=rng.standard_normal(
            shape[1]).astype(np.float32) * 0.01)
    saver = tf1.train.Saver()
    with tf1.Session(graph=graph) as sess:
        sess.run(tf1.global_variables_initializer())
        ckpt = saver.save(sess, str(out / "vggish_model.ckpt"))
q, _ = np.linalg.qr(rng.standard_normal((128, 128)))
np.savez(out / "pca.npz", pca_eigen_vectors=q.astype(np.float32),
         pca_means=rng.standard_normal(128).astype(np.float32))
variants = {"pca": ["--pca", str(out / "pca.npz")], "plain": []}

for name, extra in variants.items():
    sys.argv = ["convert_vggish", ckpt, *extra, "-o",
                str(out / f"torch_{name}")]
    try:
        runpy.run_module("icassp2022_depression_tpu_torch.scripts."
                         "convert_vggish", run_name="__main__")
    except SystemExit as e:
        assert e.code == 0, e.code
del sys.modules["jax"], sys.modules["icassp2022_depression_tpu"]
sys.path.insert(0, str(Path.cwd()))
sys.path.insert(0, str(Path.cwd() / "scripts"))
import convert_vggish
for name, extra in variants.items():
    assert convert_vggish.main([ckpt, *extra, "-o",
                                str(out / f"jax_{name}")]) == 0
"""


@pytest.fixture(scope="module")
def vggish_converted(tmp_path_factory):
    if importlib.util.find_spec("tensorflow") is None:
        pytest.skip("tensorflow is not installed (the VGGish converter "
                    "reads the TF checkpoint with it)")
    out = tmp_path_factory.mktemp("vggish")
    env = dict(os.environ, TF_CPP_MIN_LOG_LEVEL="3", JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _VGGISH_RUN, str(out)],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return out, proc.stdout


@pytest.mark.parametrize("variant", ["pca", "plain"])
def test_convert_vggish_matches_jax(vggish_converted, variant):
    """The port's converter, run with jax blocked, writes the JAX script's
    bundle bitwise (with and without ``--pca``), and either package's
    ``load_npz`` reads it."""
    out, stdout = vggish_converted
    lines = [ln for ln in stdout.splitlines() if ln.startswith("wrote")]
    assert len(lines) == 4
    tpath, jpath = out / f"torch_{variant}.npz", out / f"jax_{variant}.npz"
    with np.load(tpath) as t, np.load(jpath) as j:
        assert sorted(t.files) == sorted(j.files)
        assert ("pca/matrix" in t.files) == (variant == "pca")
        for k in j.files:
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    from icassp2022_depression_tpu.train import checkpoints as jckpt
    from icassp2022_depression_tpu_torch.train import checkpoints as tckpt

    for path in (tpath, jpath):
        got = tckpt._flatten(tckpt.load(path))
        want = tckpt._flatten(jckpt.load(path))
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_port_sources_name_no_root_converter_scripts():
    """The port sends its users to its own converters, never to the JAX
    repo's scripts (which import jax)."""
    pattern = re.compile(r"scripts/convert_(elmo_zhs|vggish)\.py")
    sources = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    for src in sources:
        assert not pattern.search(src.read_text()), src


# -- warmup, doctor, the build directory --------------------------------------


def test_warmup_command_audio_buckets_only(capsys):
    """As the JAX CLI's test: ``--skip-text --skip-train`` runs the audio
    length buckets and prints one JSON line a stage plus ``done``, with
    JAX's stage name and keys; on the CPU there is no ``kernel_builds``
    stage."""
    argv = ["warmup", "--skip-text", "--skip-train", "--min-seconds", "0.25",
            "--max-seconds", "0.5"]
    assert tcli.main(argv + ["--device", "cpu"]) == 0
    got = {ln["warmup"]: ln for ln in _json_lines(capsys.readouterr().out)}
    assert jcli.main(argv) == 0
    want = {ln["warmup"]: ln for ln in _json_lines(capsys.readouterr().out)}
    assert list(got) == list(want) == ["audio_buckets", "done"]
    for stage in want:
        assert sorted(got[stage]) == sorted(want[stage])
    assert got["audio_buckets"]["buckets"] == want["audio_buckets"]["buckets"]
    assert got["done"]["total_s"] >= got["audio_buckets"]["seconds"]


def test_warmup_and_doctor_need_a_card_unless_asked(capsys):
    """Neither runs on the CPU unless ``--device cpu`` is given: warmup
    raises, doctor reports the missing card in ``require_card``'s words
    and exits 1."""
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        tcli.main(["warmup", "--skip-text", "--skip-train"])
    capsys.readouterr()
    assert tcli.main(["doctor"]) == 1
    captured = capsys.readouterr()
    rep = json.loads(captured.out.strip().splitlines()[-1])
    assert "no CUDA device is available" in rep["finding"]
    assert rep["backend"] == "cuda" and rep["devices"] == []
    assert "link" not in rep and "no card" in captured.err


def test_doctor_command(capsys):
    """As the JAX CLI's test: one JSON report line; the probe runs on the
    CPU here; JAX's static keys are present, ``kernel_builds`` and
    ``link`` take the places of ``compile_cache`` and ``relay``."""
    assert tcli.main(["doctor", "--device", "cpu", "--probe-mb", "0.25",
                      "--reps", "2"]) == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert jcli.main(["doctor", "--no-probe"]) == 0
    jrep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for key in ("python", "torch", "backend", "devices", "host_cores"):
        assert key in rep and key in jrep, key
    assert rep["python"] == jrep["python"]
    assert rep["host_cores"] == jrep["host_cores"]
    assert rep["backend"] == "cpu" and rep["devices"] == ["cpu"]
    link = rep["link"]
    assert link["reps"] == 2 and link["up_mb_s"] > 0
    assert link["down_mb_s"] > 0 and link["roundtrip_s"] > 0
    assert link["size_mb"] == 0.25
    assert rep["kernel_builds"]["dir"]
    assert set(rep["kernel_builds"]["sources"]) == set(_build.SOURCES)
    assert "card" in rep and "nvcc" in rep and "cuda" in rep

    assert tcli.main(["doctor", "--device", "cpu", "--no-probe"]) == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert "link" not in rep and rep["torch"]


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """A stand-in compiler that writes its ``-o`` file after a pause, and a
    build directory of its own."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\nsleep 0.2\nwhile [ $# -gt 0 ]; do "
                    "if [ \"$1\" = -o ]; then shift; echo built > \"$1\"; "
                    "fi; shift; done\necho ptxas info\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    (tmp_path / "bin").mkdir()
    os.symlink(nvcc, tmp_path / "bin" / "nvcc")
    build_dir = tmp_path / "builds"
    monkeypatch.setenv("ICASSP_TPU_TORCH_BUILD_DIR", str(build_dir))
    return build_dir


def test_build_dir_override_and_build_all(fake_nvcc):
    """``ICASSP_TPU_TORCH_BUILD_DIR`` moves the builds; ``build_all`` builds
    each source once and then reuses it; ``source_status`` tells built,
    stale and missing apart; doctor reads the same directory."""
    assert _build.build_dir() == fake_nvcc
    assert _build.library_path("gru_fwd").parent == fake_nvcc
    assert {_build.source_status(n) for n in _build.SOURCES} == {"missing"}
    assert _build.build_all() == {n: True for n in _build.SOURCES}
    assert _build.build_all() == {n: False for n in _build.SOURCES}
    assert {_build.source_status(n) for n in _build.SOURCES} == {"built"}
    assert _build.build_log("lstm_fwd").strip() == "ptxas info"
    so = _build.library_path("lstmp_bwd")
    so.rename(so.with_name("liblstmp_bwd-0000000000000000.so"))
    assert _build.source_status("lstmp_bwd") == "stale"
    assert not list(fake_nvcc.glob("*.tmp"))
    facts = tcli._kernel_build_facts()
    assert facts["dir"] == str(fake_nvcc)
    assert facts["entries"] == 2 * len(_build.SOURCES)     # .so and .log
    assert facts["sources"]["lstmp_bwd"] == "stale"


def test_build_is_safe_across_processes(fake_nvcc):
    """Four processes building the same sources into one directory at once
    all succeed and leave one library a source and no temporary file."""
    code = ("from icassp2022_depression_tpu_torch import _build; "
            "_build.build_all(); print('ok')")
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(4)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    libs = sorted(f.name for f in fake_nvcc.glob("*.so"))
    assert libs == sorted(_build.library_path(n).name
                          for n in _build.SOURCES)
    names = [f.name for f in fake_nvcc.iterdir()]
    assert len(names) == 2 * len(_build.SOURCES) and all(
        re.fullmatch(r"lib\w+-[0-9a-f]{16}\.(so|log)", n) for n in names)


# -- profiling ------------------------------------------------------------------


def _trace_names(prof) -> list:
    events = json.loads(Path(prof.trace_path).read_text())["traceEvents"]
    return [e["name"] for e in events if e.get("cat") == "user_annotation"]


def test_trace_names_the_audio_regions(tmp_path):
    """A CPU trace of ``extract_eatd`` holds ``wav2vlad/bucket{blen}`` for
    every length bucket and ``wav2vlad/readback``, the JAX package's
    names, in its Chrome trace file."""
    teatd.make_synthetic_corpus(tmp_path / "c", n_data=2, n_validation=1,
                                seconds=(0.1, 0.4), seed=3)
    with profiling.trace(tmp_path / "log") as prof:
        taudio.extract_eatd(tmp_path / "c", SMALL_FE, device="cpu")
    names = _trace_names(prof)
    assert Path(prof.trace_path).parent == tmp_path / "log"
    buckets = {n for n in names if n.startswith("wav2vlad/bucket")}
    waves = [w for sp in teatd.load_speakers(tmp_path / "c") for w in
             sp.waveforms]
    want = {f"wav2vlad/bucket{taudio._bucket_length(len(w) + 128)}"
            for w in waves}
    assert buckets == want and names.count("wav2vlad/readback") == 1


def test_trace_names_each_fold(tmp_path):
    """A CPU trace of a 1-epoch ``train_audio_clf`` holds one
    ``audio_clf/fold{i}`` region a fold, as JAX's ``{task}/fold{i}``."""
    rng = np.random.default_rng(0)
    y = np.arange(12) % 2
    x = rng.standard_normal((12, 3, 256)).astype(np.float32)
    idx = [np.setdiff1d(np.arange(12), np.arange(f, 12, 3)) for f in range(3)]
    tcfg = tconfig.replace(tconfig.AUDIO_CLF, epochs=2)
    with profiling.trace(tmp_path) as prof:
        trainers.train_audio_clf(x, y, idx, tcfg, device="cpu")
    names = _trace_names(prof)
    # (``prng/fold_in`` is a threefry draw's region, not a fold's)
    assert [n for n in names if "/fold" in n
            and not n.startswith("prng/")] == \
        ["audio_clf/fold1", "audio_clf/fold2", "audio_clf/fold3"]


def test_trace_of_a_region_that_raises(tmp_path):
    """A region that raises still leaves exactly one Chrome trace, which
    holds the region's annotation, and the error goes on (JAX's ``trace``
    stops its trace in a ``finally``)."""
    with pytest.raises(RuntimeError, match="region failed"):
        with profiling.trace(tmp_path) as prof:
            with profiling.annotate("doomed"):
                torch.ones(3).sum()
            raise RuntimeError("region failed")
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert files == [Path(prof.trace_path)]
    assert "doomed" in _trace_names(prof)


def test_stopwatch_and_annotate(monkeypatch):
    """A region on the CPU never touches ``torch.cuda.nvtx`` and is
    recorded, nested in the region around it (the port has no
    stopwatch: its regions' records time the host)."""
    def no_nvtx(*_):
        raise AssertionError("torch.cuda.nvtx touched for a CPU region")

    monkeypatch.setattr(torch.cuda.nvtx, "range_push", no_nvtx)
    monkeypatch.setattr(torch.cuda.nvtx, "range_pop", no_nvtx)
    t0 = time.time_ns()
    with profiling.annotate("outer") as outer:
        with profiling.annotate("inner", "cpu", rows=2) as inner:
            pass
    got = {r.name: r for r in profiling.records(start_ns=t0)}
    assert got["outer"] is outer and got["inner"] is inner
    assert inner.parent == outer.id and inner.root == outer.root == outer.id
    assert inner.counts == {"rows": 2}
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns


# -- the serve facade, the segmenter registry ---------------------------------


def test_serve_facade_matches_jax():
    assert tserve.__all__ == jserve.__all__
    for name in tserve.__all__:
        mod = predictors if hasattr(predictors, name) else transport
        assert getattr(tserve, name) is getattr(mod, name), name
    for name in ("_FeatureCache", "_format_outputs", "_pow2",
                 "_MicroBatcher", "_DaicMicroBatcher"):
        assert hasattr(tserve, name) and hasattr(jserve, name), name


def test_segmenter_registry_extension_point():
    """As JAX's: a registered segmenter is dispatched by name, and
    whitespace-only tokens are dropped; the unknown-name error names the
    extension point."""
    calls = []

    def fake(text):
        calls.append(text)
        return ["A", " ", "B "]

    ttext.register_segmenter("fake-seg", fake)
    jtext.register_segmenter("fake-seg", fake)
    try:
        assert ttext.tokenize("hello", segmenter="fake-seg") == \
            jtext.tokenize("hello", segmenter="fake-seg") == ["A", "B "]
        assert calls == ["hello", "hello"]
    finally:
        del ttext.SEGMENTERS["fake-seg"], jtext.SEGMENTERS["fake-seg"]
    with pytest.raises(ValueError, match="register_segmenter"):
        ttext.tokenize("x", segmenter="nope")


def test_extract_eatd_text_custom_segmenter(tmp_path):
    """As JAX's: ``extract_eatd`` dispatches to a registered segmenter and
    records it in the provenance sidecar, as the JAX pass does."""
    jeatd.make_synthetic_corpus(tmp_path, n_data=2, n_validation=1,
                                seconds=0.1, seed=7)
    seen = []

    def spy(text):
        seen.append(text)
        return ttext.fallback_segment(text)

    ttext.register_segmenter("spy-seg", spy)
    jtext.register_segmenter("spy-seg", spy)
    try:
        cfg = telmo.ElmoConfig(vocab_size=128, embed_dim=8, hidden=8,
                               layers=1, output_dim=16)
        ttext.extract_eatd(tmp_path, cfg=cfg, out_dir=tmp_path / "t",
                           elmo_weights=None, segmenter="spy-seg",
                           device="cpu")
        assert len(seen) == 3 * 3
        from icassp2022_depression_tpu.models import elmo as jelmo
        jtext.extract_eatd(tmp_path, cfg=jelmo.ElmoConfig(
            vocab_size=128, embed_dim=8, hidden=8, layers=1, output_dim=16),
            out_dir=tmp_path / "j", elmo_weights=None, segmenter="spy-seg")
        assert len(seen) == 2 * 3 * 3
        metas = [json.loads((tmp_path / d / "extraction_meta.json")
                            .read_text()) for d in ("t", "j")]
        assert metas[0]["segmenter"] == metas[1]["segmenter"] == "spy-seg"
    finally:
        del ttext.SEGMENTERS["spy-seg"], jtext.SEGMENTERS["spy-seg"]



def test_extract_text_help_names_register_segmenter(capsys):
    with pytest.raises(SystemExit):
        tcli.main(["extract-text", "--help"])
    assert "register_segmenter" in capsys.readouterr().out


# -- the last public functions --------------------------------------------------


@pytest.mark.parametrize("lifter,center", [(0, True), (22, True),
                                           (0, False)])
def test_mfcc_matches_jax(lifter, center):
    """``mfcc`` of a batch of waveforms: each row within 1e-5 of its
    largest magnitude of JAX's ``mfcc`` of that waveform alone."""
    rng = np.random.default_rng(lifter)
    y = (rng.standard_normal((2, 4000)) * 0.1).astype(np.float32)
    y[1, 2000:] *= 1e-4                  # a quiet tail: the top_db clamp
    got = tmel.mfcc(torch.from_numpy(y), sr=8000, n_fft=256, hop=64,
                    n_mels=24, n_mfcc=13, center=center,
                    lifter=lifter).numpy()
    for row in range(2):
        want = np.asarray(jmel.mfcc(jnp.asarray(y[row]), sr=8000, n_fft=256,
                                    hop=64, n_mels=24, n_mfcc=13,
                                    center=center, lifter=lifter))
        assert got[row].shape == want.shape
        np.testing.assert_allclose(got[row], want, rtol=0,
                                   atol=ATOL * np.abs(want).max())


def test_power_to_db_dct_and_num_frames_match_jax():
    rng = np.random.default_rng(1)
    s = (rng.random((7, 12)) ** 6).astype(np.float32)
    s[0, 0] = 0.0
    for top_db in (80.0, 20.0, None):
        np.testing.assert_allclose(
            tmel.power_to_db(torch.from_numpy(s), top_db=top_db).numpy(),
            np.asarray(jmel.power_to_db(jnp.asarray(s), top_db=top_db)),
            rtol=0, atol=ATOL * 100)
    # a batch whose second spectrogram is quiet: the global peak clamps it
    batch = (rng.random((2, 7, 12)) ** 6).astype(np.float32)
    batch[1] *= 1e-6
    for top_db in (80.0, 20.0, None):
        got = tmel.power_to_db(torch.from_numpy(batch), top_db=top_db)
        want = np.asarray(jmel.power_to_db(jnp.asarray(batch),
                                           top_db=top_db))
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=ATOL * np.abs(want).max())
    for norm in ("ortho", None):
        np.testing.assert_array_equal(tmel.dct_ii_matrix(13, 24, norm),
                                      jmel.dct_ii_matrix(13, 24, norm))
    with pytest.raises(ValueError, match="unknown DCT norm"):
        tmel.dct_ii_matrix(4, 4, "bogus")
    for length in (0, 1, 511, 512, 4000):
        for center in (True, False):
            assert tmel.num_frames(length, 2048, 512, center) == \
                jmel.num_frames(length, 2048, 512, center)


def test_binary_label_and_data_paths_match_jax():
    for sds in (0.0, 52.9, 53.0, 53.1, 80.0):
        assert teatd.binary_label(sds) == jeatd.binary_label(sds)
        assert teatd.binary_label(sds, 60.0) == jeatd.binary_label(sds, 60.0)
    tp, jp = tconfig.DataPaths(Path("/r")), jconfig.DataPaths(Path("/r"))
    assert tp == tconfig.DataPaths(root=Path("/r"))
    for f in ("root", "data_dir", "validation_dir", "features_dir",
              "models_dir", "daic_dir", "audio_features", "text_features"):
        assert getattr(tp, f) == getattr(jp, f), f
    assert tp.eatd_speaker_dir("Data", 7) == jp.eatd_speaker_dir("Data", 7)


def test_script_main_and_console_script(capsys, monkeypatch):
    """``pyproject.toml`` installs ``icassp2022-depression-tpu-torch`` as
    ``cli:script_main``, which runs the process's arguments."""
    text = (REPO / "pyproject.toml").read_text()
    assert ('icassp2022-depression-tpu-torch = '
            '"icassp2022_depression_tpu_torch.cli:script_main"') in text
    monkeypatch.setattr(sys, "argv", ["icassp2022-depression-tpu-torch",
                                      "doctor", "--device", "cpu",
                                      "--no-probe"])
    assert tcli.script_main() == 0
    assert json.loads(capsys.readouterr().out.strip()
                      .splitlines()[-1])["backend"] == "cpu"
