"""Build the port's CUDA kernels from ``kernels/*/csrc/*.cu`` and load them.

Each source compiles on its own into a shared library with a plain C
interface (``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared``),
bound with ctypes.  Libraries go to ``build/kernels/`` at the root of the
checkout, named by the source's stem and a hash of its text and the
flags, so an edited source rebuilds and an unchanged one is reused.
:func:`build_all` starts one ``nvcc`` per source, all at once, and waits
for them.  Nothing here runs at import time; the only thing used from
outside the checkout is the CUDA toolkit.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: dict = {}
# nvcc's stderr per source stem (ptxas registers / spills), for the record
build_logs: dict = {}


def sources() -> dict:
    """``{stem: path}`` of every kernel source in the package."""
    return {p.stem: p for p in sorted(KERNELS_DIR.glob("*/csrc/*.cu"))}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def _target(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> dict:
    """Compile every source that has no up-to-date library, in parallel.
    Returns ``{stem: library path}``; raises with nvcc's output on failure."""
    srcs = sources()
    todo = {stem: (src, _target(src)) for stem, src in srcs.items()
            if not _target(src).exists()}
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        for stem, (src, out) in todo.items():
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            procs[stem] = (subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                tmp, out)
        failed = []
        for stem, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            build_logs[stem] = log
            if proc.returncode != 0:
                failed.append(f"{stem}: nvcc exited {proc.returncode}\n{log}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, out)       # a reader never sees half a file
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return {stem: _target(src) for stem, src in srcs.items()}


def load(stem: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<stem>.cu``, built on first use."""
    with _lock:
        lib = _loaded.get(stem)
        if lib is None:
            lib = ctypes.CDLL(str(build_all()[stem]))
            _loaded[stem] = lib
        return lib
