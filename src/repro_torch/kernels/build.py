"""Build and load the port's CUDA kernels (``csrc/*.cu``) with ``nvcc``.

Each source compiles on its own into a shared library with a plain C
interface, loaded with ``ctypes``. All sources are compiled together in
parallel (one ``nvcc`` process each) at first use, into a build directory
inside the checkout that ``.gitignore`` lists (``REPRO_TORCH_BUILD_DIR``
overrides it). Libraries are keyed by a hash of their sources and flags,
so an edited source is rebuilt. A failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Dict

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCES = ("lscd_spmm", "lscd_spmm_grouped", "lscd_spmm_splitk",
           "lscd_spmm_splitk_grouped", "lscd_spmm_batched",
           "lscd_spmm_splitk_batched", "dense_gemm")
_REPO_ROOT = pathlib.Path(__file__).resolve().parents[3]
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def build_dir() -> pathlib.Path:
    d = os.environ.get("REPRO_TORCH_BUILD_DIR")
    return pathlib.Path(d) if d else _REPO_ROOT / "build" / "repro_torch_kernels"


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home and (pathlib.Path(cuda_home) / "bin" / "nvcc").exists():
        return str(pathlib.Path(cuda_home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _lib_path(name: str) -> pathlib.Path:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"{name}_{h.hexdigest()[:12]}.so"


_P, _I = ctypes.c_void_p, ctypes.c_int
# C signature of each source's ``<name>_launch``; every one returns a CUDA
# error code.
_LSCD_ARGS = ([_P] * 6     # words, nnz, b, bias, partials, out
              + [_I] * 12  # groups, m, k, n, m_tb, k_tb, n_tb, max_nnz,
                           # split_k, dtype, epilogue, ring
              + [_P])      # stream
ARGTYPES = {name: _LSCD_ARGS for name in SOURCES if name.startswith("lscd")}
ARGTYPES.update({name: ([_P] * 5     # words, nnz, b, partials, out
                        + [_I] * 11  # experts, m, k, n, m_tb, k_tb, n_tb,
                                     # max_nnz, split_k, dtype, ring
                        + [_P])      # stream
                 for name in SOURCES if name.endswith("_batched")})
ARGTYPES["dense_gemm"] = ([_P] * 3     # a, b, out
                          + [_I] * 7   # m, k, n, m_tb, k_tb, n_tb, dtype
                          + [_P])      # stream


def _bind(lib: ctypes.CDLL, name: str) -> None:
    fn = getattr(lib, f"{name}_launch")
    fn.argtypes = ARGTYPES[name]
    fn.restype = ctypes.c_int


def build_all() -> Dict[str, ctypes.CDLL]:
    """Compile every missing library in parallel and load all of them."""
    with _lock:
        if len(_libs) == len(SOURCES):
            return _libs
        out_dir = build_dir()
        out_dir.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name in SOURCES:
            target = _lib_path(name)
            if target.exists():
                continue
            tmp = target.with_suffix(f".{os.getpid()}.tmp")
            log = open(out_dir / f"{name}.log", "w")
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=log,
                                            stderr=subprocess.STDOUT),
                           tmp, target, log)
        failed = []
        for name, (proc, tmp, target, log) in procs.items():
            rc = proc.wait()
            log.close()
            if rc != 0:
                failed.append(name)
            else:
                os.replace(tmp, target)
        if failed:
            logs = "\n".join((out_dir / f"{n}.log").read_text()[-4000:]
                             for n in failed)
            raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
        for name in SOURCES:
            lib = ctypes.CDLL(str(_lib_path(name)))
            _bind(lib, name)
            _libs[name] = lib
        return _libs


def entry(name: str):
    """The C launch function of kernel source ``name``."""
    return getattr(build_all()[name], f"{name}_launch")
