"""Builds the CUDA kernels in ``csrc/`` at first use and loads them.

Each ``csrc/*.cu`` has a plain C interface and compiles on its own with
``nvcc`` for ``sm_90a`` into a shared library, loaded with ctypes; the
``csrc/*.cuh`` headers hold device code that several sources share.  All
sources build together (one ``nvcc`` process each, started at once) the
first time any kernel is asked for.  Builds go to ``build/peanut_tpu_torch/``
at the root of the checkout (listed in ``.gitignore``), in a directory keyed
on a hash of the sources, headers and flags, so an edited source or header
rebuilds and an unchanged tree is reused.  There is no fallback: a missing
``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "peanut_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_seconds: float = 0.0     # wall time of this process's build, if any


def _nvcc() -> str:
    cands = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                          "bin", "nvcc"), shutil.which("nvcc")]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (CUDA_HOME or PATH); the CUDA "
                       "kernels of peanut_tpu_torch build at first use")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def build_dir() -> Path:
    """Keyed on the flags and every source and header: a source includes
    the headers beside it, so an edited header rebuilds them all."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def _build_all() -> None:
    """Compile every source that has no library yet, all in parallel."""
    global build_seconds
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    todo = [s for s in _sources() if not (out / f"lib{s.stem}.so").exists()]
    if not todo:
        return
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for src in todo:
        tmp = out / f"lib{src.stem}.so.{os.getpid()}.tmp"
        log = open(out / f"{src.stem}.log", "w")
        procs.append((src, tmp, log, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=log, stderr=subprocess.STDOUT)))
    failed = []
    for src, tmp, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(f"{src.name}:\n{(out / f'{src.stem}.log').read_text()}")
        else:
            os.replace(tmp, out / f"lib{src.stem}.so")   # atomic publish
    build_seconds = time.perf_counter() - t0
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


def library(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu`` (building all
    kernels on first use)."""
    with _lock:
        if stem not in _libs:
            _build_all()
            _libs[stem] = ctypes.CDLL(str(build_dir() / f"lib{stem}.so"))
        return _libs[stem]


def ptxas_report() -> Dict[str, str]:
    """``nvcc -Xptxas -v`` lines (registers, shared memory, spills) of each
    kernel, from the logs of the build in this checkout."""
    out = {}
    for src in _sources():
        log = build_dir() / f"{src.stem}.log"
        if log.exists():
            out[src.stem] = "\n".join(
                l for l in log.read_text().splitlines()
                if "ptxas info" in l or "spill" in l)
    return out


def check(err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch function."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
