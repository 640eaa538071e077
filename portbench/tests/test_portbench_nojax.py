"""Nothing a run imports is JAX or the JAX package, by whole top-level
names, and the plain references import nothing of the port."""

import ast
import subprocess
import sys
from pathlib import Path

from portbench.harness import card, registry

REPO = registry.ROOT.parent


def test_top_level_names_compared_whole():
    assert card.banned_modules(["icassp2022_depression_tpu_torch.ops",
                                "icassp2022_depression_tpu_torch",
                                "jaxtyping", "numpy"]) == []
    assert card.banned_modules(["jax.numpy", "flax.linen",
                                "icassp2022_depression_tpu.ops"]) == [
        "flax", "icassp2022_depression_tpu", "jax"]


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_references_import_nothing_of_the_port():
    for path in (registry.ROOT / "reference").glob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & {"jax", "jaxlib", "flax",
                           "icassp2022_depression_tpu",
                           "icassp2022_depression_tpu_torch"}, path


def test_a_run_loads_no_jax():
    """A whole tiny run on the CPU through the harness, then the modules
    of that process."""
    code = (
        "import sys, json\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        f"sys.path.insert(0, {str(Path(__file__).parent)!r})\n"
        "import tiny\n"
        "import portbench.run as run\n"
        "from portbench.harness import card, registry\n"
        "registry.metrics()\n"
        "result, _ = run.execute(tiny.cell('fuse_clf', 'interactive',\n"
        "    {'wav2vlad_rel': 1e-4, 'elmo_rel': 1e-4, 'probs_abs': 1e-4}))\n"
        "assert result['correct'], result\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
        "print(json.dumps(card.banned_modules()))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=str(REPO))
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert "icassp2022_depression_tpu_torch" in lines[-2]
    assert lines[-1] == "[]"
