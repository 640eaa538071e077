"""Finds the benchmark's parts by name, each in files of its own:

* ``configs/<config>.json``: a model configuration as it is run;
* ``traffic/<mix>.json``: a traffic mix's parameters, naming the driver
  (``traffic/<driver>.py``) that runs it;
* ``workloads/<cell>.json``: a cell, naming its configuration and mix,
  with its correctness limits;
* ``metrics/<metric>.py``: one reader a per-layer metric, with ``UNIT``
  and ``read(ctx)``.

Adding any of them is adding a file: nothing here lists them.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Dict

ROOT = Path(__file__).resolve().parent.parent

#: a name: a letter, digit or ``_`` first, then at most 63 letters,
#: digits, ``_``, ``.`` and ``-``
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
#: a unit: 1 to 16 letters, digits, ``_``, ``/``, ``%``, ``.`` and ``-``
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


def check_name(name: str) -> str:
    if not NAME.fullmatch(name or ""):
        raise ValueError(f"not a valid name: {name!r}")
    return name


def _json(kind: str, name: str, root: Path) -> dict:
    path = root / kind / f"{check_name(name)}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} entry {name!r} ({path})")
    return json.loads(path.read_text(encoding="utf-8"))


def config(name: str, root: Path = ROOT) -> dict:
    return _json("configs", name, root)


def traffic(name: str, root: Path = ROOT) -> dict:
    return _json("traffic", name, root)


def workload(name: str, root: Path = ROOT) -> dict:
    return _json("workloads", name, root)


def _module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def driver(name: str, root: Path = ROOT) -> ModuleType:
    """``traffic/<name>.py``, which has ``run(cell) -> harness.cell.Run``."""
    path = root / "traffic" / f"{check_name(name)}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no traffic driver {name!r} ({path})")
    return _module(path, f"portbench_traffic_{name.replace('.', '_')}")


def metrics(root: Path = ROOT) -> Dict[str, ModuleType]:
    """Every per-layer metric reader, by metric name."""
    out = {}
    for path in sorted((root / "metrics").glob("*.py")):
        name = check_name(path.name[:-3])
        module = _module(path, f"portbench_metric_{len(out)}")
        if not UNIT.fullmatch(getattr(module, "UNIT", "")):
            raise ValueError(f"metric {name}: bad UNIT")
        out[name] = module
    return out
