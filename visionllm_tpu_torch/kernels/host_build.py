"""Build the host (CPU) libraries of the data path at first use and load
them.

Each `csrc/host/<name>.cc` (the image resizer, the RLE codec, the JPEG
decoder) is compiled by `g++` into a shared library with a plain C
interface under `visionllm_tpu_torch/build/`, named by the hash of its
source and flags, and loaded with `ctypes.CDLL`: a ctypes call releases
the GIL, so the loader's worker threads run these functions at once.

Several processes (pytest workers, data-loader processes) and threads may
ask for a library that is not built yet. The first takes an exclusive
lock on `<library>.lock`, compiles to a name of its own and moves the
result into place with `os.replace`; the others wait on the lock and find
the finished file, so no process ever loads a half-written library. A
failed build raises with g++'s output: there is no fallback.

Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict

from visionllm_tpu_torch.kernels.build import BUILD_DIR, CSRC_DIR

HOST_SRC_DIR = os.path.join(CSRC_DIR, "host")
HOST_LIBS = ("imageproc", "rle", "jpeg_decode")
# no -march=native and no FMA contraction: the resizer's double
# arithmetic must round as on any other x86-64 or aarch64 host
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _gxx() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found: the port's host libraries "
                           "(csrc/host/*.cc) build with g++")
    return cxx


def host_lib_path(name: str, build_dir: str = None) -> str:
    """The library's path, named by the hash of its source and flags."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(os.path.join(HOST_SRC_DIR, name + ".cc"), "rb") as f:
        h.update(f.read())
    return os.path.join(build_dir or BUILD_DIR,
                        f"lib{name}-{h.hexdigest()[:16]}.so")


def _build(name: str, out: str) -> None:
    """Compile `name` to `out` under the file lock, unless another
    process finished it first."""
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out + ".lock", "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if os.path.exists(out):
                return
            tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
            res = subprocess.run(
                [_gxx(), *GXX_FLAGS, "-o", tmp,
                 os.path.join(HOST_SRC_DIR, name + ".cc")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            if res.returncode != 0:
                if os.path.exists(tmp):
                    os.remove(tmp)
                raise RuntimeError(f"g++ failed for csrc/host/{name}.cc "
                                   f"(rc={res.returncode}):\n{res.stdout}")
            os.replace(tmp, out)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def host_library(name: str) -> ctypes.CDLL:
    """The loaded host library `name` (one of `HOST_LIBS`), built on
    first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            out = host_lib_path(name)
            if not os.path.exists(out):
                _build(name, out)
            _libs[name] = ctypes.CDLL(out)
        return _libs[name]


def build_host_all() -> None:
    """Build and load every host library (the smoke run's build phase)."""
    for name in HOST_LIBS:
        host_library(name)
