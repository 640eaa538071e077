"""The harness finds its parts by name, and every name and unit keeps to
the benchmark's characters."""

import json
import re
import shutil

import pytest

from portbench.harness import registry

REPO = registry.ROOT.parent
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
LINE = re.compile(r"[^\t\n\r]{1,200}")


def test_finds_every_part_by_name():
    readers = registry.metrics()
    for cfg in BENCH["configs"]:
        assert (REPO / cfg["file"]).is_file()
        assert registry.config(cfg["name"])["source"] == cfg["source"]
    for cell in BENCH["workloads"]:
        w = registry.workload(cell["name"])
        assert (w["config"], w["traffic"], w["chips"], w["why"]) == (
            cell["config"], cell["traffic"], cell["chips"], cell["why"])
        mix = registry.traffic(cell["traffic"])
        assert hasattr(registry.driver(mix["driver"]), "run")
    for m in BENCH["per_layer"]:
        assert readers[m["name"]].UNIT == m["unit"]
    assert set(readers) == {m["name"] for m in BENCH["per_layer"]}


def test_names_units_and_lines():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [c["name"] for c in BENCH["configs"] + BENCH["workloads"]]
    names += [c["traffic"] for c in BENCH["workloads"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    for name in names:
        assert registry.NAME.fullmatch(name), name
    assert len(set(names[:len(names) - len(BENCH["workloads"])])) >= 1
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert registry.UNIT.fullmatch(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for text in ([c["why"] for c in BENCH["workloads"] + BENCH["configs"]]
                 + [m["layer"] for m in BENCH["per_layer"]]
                 + [c["source"] for c in BENCH["configs"]]
                 + BENCH["command"]):
        assert LINE.fullmatch(text), text
    for path in (REPO / "portbench").rglob("*"):
        rel = str(path.relative_to(REPO))
        if ".build" in rel or "__pycache__" in rel:
            continue
        assert re.fullmatch(r"[A-Za-z0-9_./-]+", rel), rel


def test_every_per_layer_metric_moves_a_reported_metric():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = {c["name"] for c in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= cells
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
    for cell in cells:
        reported = [n for n, m in e2e.items()
                    if cell in m.get("workloads", cells)]
        assert "setup_s" in reported and len(reported) >= 2
        assert any(cell in m["workloads"] for m in BENCH["per_layer"])


def test_a_metric_and_a_workload_that_exist_only_as_files(tmp_path):
    root = tmp_path / "portbench"
    shutil.copytree(registry.ROOT, root,
                    ignore=shutil.ignore_patterns(".build", "__pycache__"))
    (root / "metrics" / "answers.interactive.py").write_text(
        "UNIT = 'answers'\n\n\ndef read(ctx):\n    return 3.0\n")
    new = dict(registry.workload("fuse_clf.interactive"),
               traffic="interactive")
    (root / "workloads" / "fuse_clf.slow.json").write_text(json.dumps(new))
    (root / "traffic" / "slow.json").write_text(json.dumps(
        dict(registry.traffic("interactive"), pool=8)))
    assert registry.metrics(root)["answers.interactive"].read(None) == 3.0
    assert registry.workload("fuse_clf.slow", root)["config"] == "fuse_clf"
    assert registry.traffic("slow", root)["pool"] == 8
    with pytest.raises(FileNotFoundError):
        registry.workload("fuse_clf.absent", root)
    with pytest.raises(ValueError):
        registry.workload("bad name", root)
