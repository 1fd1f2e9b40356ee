"""Build the port's CUDA kernels at first use and load them with ctypes.

Each source under ``kernels/csrc/`` has a plain C interface and is compiled
by ``nvcc`` for ``sm_90a`` into ``<repo>/build/repro_torch_kernels/``, which
``.gitignore`` lists (an installed package builds into a per-user cache
instead, see :func:`_build_dir`).  A library is rebuilt when its source changes (the
source's sha256 is kept beside it).  A missing ``nvcc`` or a failed build
raises with the compiler's output: there is no fallback.

Each library is built once across processes too: :func:`load` holds an
``flock`` on ``lib<name>.lock`` in the build directory while it checks and
builds, so rank processes that start together wait for one ``nvcc``
instead of each running their own.

Nothing here runs at import time; the CPU tests import this module without
a CUDA toolkit.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["BUILD_DIR", "CSRC", "NVCC_FLAGS", "load", "load_all"]

CSRC = Path(__file__).resolve().parent / "csrc"


def _build_dir() -> Path:
    """``<checkout>/build/repro_torch_kernels`` when the package runs from a
    checkout's ``src/``; otherwise (an installed package) a per-user cache,
    never a directory next to the installed sources."""
    pkg = Path(__file__).resolve().parents[1]
    root = pkg.parents[1]
    if pkg.parent.name == "src" and (root / "pyproject.toml").is_file():
        return root / "build" / "repro_torch_kernels"
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "repro_torch_kernels"


BUILD_DIR = _build_dir()
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC")

_LOCK = threading.Lock()
_NAME_LOCKS: dict[str, threading.Lock] = {}
_LOADED: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built from "
                       "source at first use and need the CUDA toolkit")


def _build(src: Path, lib: Path, digest: str) -> None:
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {src.name} failed ({' '.join(cmd)}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent loader sees old or new, whole
    lib.with_suffix(".sha256").write_text(digest)


def load(name: str) -> ctypes.CDLL:
    """The shared library built from ``csrc/<name>.cu``, built if missing or
    stale, loaded once per process.  Different sources build concurrently
    when loaded from different threads; one source builds once however many
    threads and processes load it together."""
    with _LOCK:
        lock = _NAME_LOCKS.setdefault(name, threading.Lock())
    with lock:
        if name in _LOADED:
            return _LOADED[name]
        src = CSRC / f"{name}.cu"
        lib = BUILD_DIR / f"lib{name}.so"
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with open(BUILD_DIR / f"lib{name}.lock", "a") as held:
            fcntl.flock(held, fcntl.LOCK_EX)  # released when the file closes
            digest = hashlib.sha256(src.read_bytes()).hexdigest()
            stamp = lib.with_suffix(".sha256")
            if not (lib.exists() and stamp.exists() and stamp.read_text() == digest):
                _build(src, lib, digest)
        _LOADED[name] = ctypes.CDLL(str(lib))
        return _LOADED[name]


def load_all() -> None:
    """Build (where needed) and load every library of ``csrc/``, one
    ``nvcc`` per source, all started together."""
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(load, names))
