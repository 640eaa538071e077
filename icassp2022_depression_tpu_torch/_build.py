"""Builds the package's CUDA sources (``csrc/*.cu``) into shared libraries
with a plain C interface, loaded with :mod:`ctypes`.

A source is compiled at its first use in a process::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas=-v -o _build/lib<name>-<hash>.so csrc/<name>.cu

into ``_build/`` beside this file (listed in ``.gitignore``), or into the
directory ``ICASSP_TPU_TORCH_BUILD_DIR`` names (read at each call; the
counterpart of the JAX package's ``ICASSP_TPU_COMPILE_CACHE``, for an
installed package or a build made ahead of time by ``cli warmup``), keyed
by a hash of the source, the shared headers (``csrc/*.cuh``) and the
flags, so an edited kernel is rebuilt and an unchanged one is reused.
Processes may build into one directory at once: each writes its own
temporary file and renames it into place.  ``nvcc`` is looked up in
``$CUDA_HOME/bin``, then on ``PATH``, then in ``/usr/local/cuda/bin``.  A missing compiler or
a failed build raises: there is no fallback to a plain version.  The
compiler's report (``-Xptxas=-v``: registers, shared memory, spills) is
kept in ``_build/lib<name>-<hash>.log``.

Importing this module runs nothing; only :func:`load`, :func:`build` and
:func:`build_all` build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
#: the build directory unless ``ICASSP_TPU_TORCH_BUILD_DIR`` names another
BUILD_DIR = Path(__file__).resolve().parent / "_build"
#: every CUDA source of the package, one library each
SOURCES = ("gru_fwd", "gru_bwd", "lstm_fwd", "lstm_bwd", "lstmp_fwd",
           "lstmp_bwd", "threefry", "moe_experts")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """Path of ``nvcc``; raises if there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH, /usr/local/cuda/bin): "
        "the CUDA kernels of icassp2022_depression_tpu_torch are compiled at "
        "first use and need the CUDA toolkit")


def build_dir() -> Path:
    """``ICASSP_TPU_TORCH_BUILD_DIR`` when set, else :data:`BUILD_DIR`."""
    env = os.environ.get("ICASSP_TPU_TORCH_BUILD_DIR")
    return Path(env).expanduser() if env else BUILD_DIR


def library_path(name: str) -> Path:
    """Where :func:`load` builds ``csrc/<name>.cu``."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists."""
    so = library_path(name)
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    # unique per process and thread, so concurrent builds of one source
    # never write the same file; the last rename wins, with equal bytes
    stem = f"{so.name}.{os.getpid()}.{threading.get_ident()}"
    tmp, tmp_log = so.with_name(f"{stem}.tmp"), so.with_name(f"{stem}.log")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    tmp_log.write_text(proc.stdout + proc.stderr)
    os.replace(tmp_log, so.with_suffix(".log"))
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}) building "
                           f"{name}.cu:\n{proc.stderr}")
    os.replace(tmp, so)
    return so


def build_all(names=SOURCES) -> dict:
    """Build ``names`` in parallel, one ``nvcc`` process a source ->
    ``{name: True if it was built now, False if an up-to-date library was
    reused}``.  A failed build raises after every build has ended."""
    names = list(dict.fromkeys(names))
    fresh = {name: not library_path(name).exists() for name in names}
    with ThreadPoolExecutor(max(1, len(names))) as pool:
        for future in [pool.submit(build, name) for name in names]:
            future.result()
    return fresh


def source_status(name: str) -> str:
    """``"built"`` (an up-to-date library is in :func:`build_dir`),
    ``"stale"`` (only libraries of an older source, headers or flags) or
    ``"missing"``."""
    if library_path(name).exists():
        return "built"
    return "stale" if any(build_dir().glob(f"lib{name}-*.so")) else "missing"


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process."""
    with _lock:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(str(build(name)))
        return _loaded[name]


def build_log(name: str) -> str:
    """The compiler's report of the last build of ``csrc/<name>.cu``."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""
