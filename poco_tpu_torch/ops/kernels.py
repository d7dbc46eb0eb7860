"""Build and load the port's CUDA kernels.

Each source under `poco_tpu_torch/csrc/` is compiled by nvcc, at first
use, into a shared library with a plain C interface that ctypes loads.
Libraries go to `poco_tpu_torch/_build/`, named by a hash of the source
and the flags, so an edited source is rebuilt and never served stale.
`build()` starts one nvcc per missing library, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

SOURCES = {
    "linear_3xtf32": "linear_3xtf32.cu",
    "skinning": "skinning.cu",
    "skinning_backward": "skinning_backward.cu",
    "skinning_backward_simt": "skinning_backward_simt.cu",
    "skinning_simt": "skinning_simt.cu",
}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, /usr/local/cuda, or PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels cannot be built"
        )
    return found


def library_path(name: str) -> Path:
    source = (CSRC_DIR / SOURCES[name]).read_bytes()
    digest = hashlib.sha256(source + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names=None) -> dict[str, dict]:
    """Compile the named kernels (all by default) that are not built yet.

    Returns, for each library compiled now, its build seconds and nvcc's
    output (the `-Xptxas -v` register and shared-memory report). Raises
    with the compiler's output if any build fails.
    """
    names = list(SOURCES) if names is None else list(names)
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        target = library_path(name)
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / SOURCES[name])]
        procs[name] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ),
            tmp,
            target,
            time.perf_counter(),
        )
    reports, failures = {}, []
    for name, (proc, tmp, target, start) in procs.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - start
        if proc.returncode != 0:
            failures.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, target)
        reports[name] = {"seconds": seconds, "log": log}
    if failures:
        raise RuntimeError("kernel build failed: " + "\n".join(failures))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed."""
    if name not in _loaded:
        build([name])
        _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return _loaded[name]
