"""The port's end-to-end demo (``icassp2022_depression_tpu_torch/scripts/
demo.sh``) without running it: the shell parses, and a run with a
recording stand-in for the Python interpreter (``PYTHON``) makes every
``cli`` call with its shell variables filled in, each one parsing with the
port's ``build_parser()`` and passing ``--device`` wherever the subcommand
takes it; the checkpoint and ``train_idxs_*`` globs find the files that
the port's clf trainer writes (its own ``_save_gated`` and checkpoint
names), so the ``check`` and ``predict`` steps run on them."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

import icassp2022_depression_tpu_torch as pkg
from icassp2022_depression_tpu_torch import cli

DEMO = Path(pkg.__file__).resolve().parent / "scripts" / "demo.sh"
REPO = Path(__file__).resolve().parent.parent
CLI = ["-m", "icassp2022_depression_tpu_torch.cli"]

# the interpreter's stand-in: records each `-m ...cli` call, writes the clf
# pipeline's audio checkpoints and idx files as the port's trainer names
# them, and hands any other call (`-c "import sklearn"`) to Python
STUB = """
import json, os, sys
from pathlib import Path

argv = sys.argv[1:]
if argv[:1] != ["-m"]:
    os.execv(sys.executable, [sys.executable] + argv)
with open(os.environ["DEMO_LOG"], "a") as log:
    log.write(json.dumps(argv) + "\\n")
if argv[2:5] == ["pipeline", "--track", "clf"]:
    import numpy as np
    from icassp2022_depression_tpu_torch import config as C
    from icassp2022_depression_tpu_torch.train import checkpoints, trainers

    root = Path(argv[argv.index("--root") + 1])
    m = C.AUDIO_CLF.model
    for fold, f1 in ((1, 0.6667), (2, 0.5), (3, 0.8)):
        trainers._save_gated(
            root / "Model" / "ClassificationWhole" / "Audio",
            checkpoints.audio_clf_name(m.embedding_size, m.hidden_dims, f1,
                                       fold),
            {"fold": fold, "best": {"f1": f1, "epoch": 4}}, "audio_clf", 0,
            {"w": np.zeros(2, np.float32)}, train_idx=np.arange(5),
            dump_idx=True)
"""


def _has_sklearn() -> bool:
    try:
        import sklearn  # noqa: F401
    except ImportError:
        return False
    return True


def test_demo_shell_parses():
    proc = subprocess.run(["bash", "-n", str(DEMO)], capture_output=True,
                          text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("device", [None, "cpu"])
def test_demo_cli_calls_parse_with_the_port(tmp_path, device):
    """Every ``cli`` line of a demo run parses with the port's parser,
    ``--device`` is ``$DEVICE`` (default ``cuda``) wherever it is taken,
    and ``check`` / ``predict`` get the trainer's checkpoints and idx
    files."""
    stub = tmp_path / "python"
    stub.write_text(f"#!{sys.executable}\n{STUB}")
    stub.chmod(0o755)
    log = tmp_path / "calls.jsonl"
    root = tmp_path / "root"
    env = dict(os.environ, PYTHON=str(stub), DEMO_LOG=str(log),
               PYTHONPATH=str(REPO))
    env.pop("DEVICE", None)
    if device:
        env["DEVICE"] = device
    proc = subprocess.run(["bash", str(DEMO), str(root)], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "demo complete" in proc.stdout
    calls = [json.loads(line) for line in log.read_text().splitlines()]
    want = ["synth-corpus", "extract-audio", "extract-text", "train",
            "pipeline", "pipeline"] + (["baselines"] if _has_sklearn()
                                       else []) + ["check", "predict"]
    assert [c[2] for c in calls] == want
    parser = cli.build_parser()
    takes_device = {name for name, sp in
                    parser._subparsers._group_actions[0].choices.items()
                    if any("--device" in a.option_strings
                           for a in sp._actions)}
    audio = root / "Model" / "ClassificationWhole" / "Audio"
    for argv in calls:
        assert argv[:2] == CLI
        args = parser.parse_args(argv[2:])
        assert str(args.root) == str(root)
        if argv[2] in takes_device:
            assert args.device == (device or "cuda"), argv
        else:
            assert "--device" not in argv
    check = parser.parse_args(calls[-2][2:])

    def by_fold(paths):
        return sorted(paths, key=lambda p: p.stem[-1])

    assert [Path(c + ".npz") for c in check.ckpts] == by_fold(
        audio.glob("BiLSTM_gru_vlad*_*.npz"))
    assert [Path(i) for i in check.idx_files] == by_fold(
        audio.glob("train_idxs_*.npy"))
    predict = parser.parse_args(calls[-1][2:])
    assert predict.ckpt == check.ckpts[0] and predict.speaker == "Data/1"
