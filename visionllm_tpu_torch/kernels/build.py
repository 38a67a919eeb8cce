"""Build the hand-written CUDA kernels at first use and load them.

Each `csrc/<name>.cu` is compiled by `nvcc` for `sm_90a` into its own
shared library with a plain C interface under `visionllm_tpu_torch/build/`
and loaded with `ctypes` (no PyTorch headers, so a build takes seconds).
`build_all()` starts one `nvcc` per source at once and waits for all of
them. Every C entry returns `cudaGetLastError()`; `check()` raises on a
nonzero code.

Nothing here runs at import time: the CPU tests import every module of
the package on hosts with no `nvcc`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Sequence

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "build")
KERNELS = ("flash_attn_fwd", "flash_attn_bwd", "ms_deform_attn_fwd",
           "ms_deform_attn_bwd", "int4_matmul", "gather_probes")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_log: Dict[str, str] = {}      # per kernel: nvcc's -Xptxas -v report


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "host with the CUDA toolkit")


def _lib_path(name: str) -> str:
    """The library's path, named by the hash of its source and of every
    header under `csrc/` (a source may include any of them)."""
    h = hashlib.sha256()
    for src in [name + ".cu"] + sorted(
            f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh")):
        with open(os.path.join(CSRC_DIR, src), "rb") as f:
            h.update(f.read())
    digest = h.hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def build_all(names: Sequence[str] = KERNELS) -> None:
    """Compile every kernel that is not built yet, all at once, and load
    them. Raises with nvcc's output if any build fails."""
    with _lock:
        todo = [n for n in names if n not in _libs]
        if not todo:
            return
        os.makedirs(BUILD_DIR, exist_ok=True)
        procs = {}
        for name in todo:
            out = _lib_path(name)
            if os.path.exists(out):
                continue
            tmp = f"{out}.{os.getpid()}.tmp"
            procs[name] = (subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp,
                 os.path.join(CSRC_DIR, name + ".cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                tmp, out)
        errors = []
        for name, (proc, tmp, out) in procs.items():
            text, _ = proc.communicate()
            build_log[name] = text
            if proc.returncode != 0:
                errors.append(f"nvcc failed for {name}.cu "
                              f"(rc={proc.returncode}):\n{text}")
            else:
                os.replace(tmp, out)
        if errors:
            raise RuntimeError("\n".join(errors))
        for name in todo:
            _libs[name] = ctypes.CDLL(_lib_path(name))


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built on first use."""
    if name not in _libs:
        build_all((name,))
    return _libs[name]


def check(code: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}")
