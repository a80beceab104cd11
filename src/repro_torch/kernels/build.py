"""Build the port's CUDA kernels with nvcc at first use and load them with ctypes.

Each ``csrc/<name>.cu`` exports a plain C launcher and is compiled on its own
for Hopper (``sm_90a``) into ``build/kernels/<name>-<digest>.so`` at the root
of the checkout; the digest covers the source and the flags, so an edited
source is rebuilt. :func:`build` starts one ``nvcc`` per source, all at once.
Nothing is compiled when a module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNELS = ("adapter_fused", "flash_attention", "mamba_scan", "rwkv_scan")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
LOG: Dict[str, Dict] = {}     # name -> {"seconds": wall time, "log": nvcc/ptxas output}


def nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the port's CUDA kernels are built on "
                           "a machine with the CUDA toolkit")
    return path


def _target(name: str):
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(FLAGS).encode()).hexdigest()[:12]
    return src, BUILD_DIR / f"{name}-{digest}.so"


def build(names: Iterable[str] = KERNELS, timeout: float = 600.0) -> None:
    """Compile every named kernel that is not built yet, all in parallel."""
    procs = {}
    start = time.perf_counter()
    for name in names:
        src, so = _target(name)
        if so.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp")
        cmd = [nvcc(), *FLAGS, "-o", str(tmp), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp, so)
    failed = []
    for name, (proc, tmp, so) in procs.items():
        try:
            out, _ = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
            failed.append(f"{name}: nvcc timed out after {timeout} s\n{out}")
            continue
        LOG[name] = {"seconds": time.perf_counter() - start, "log": out}
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{out}")
            continue
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))


def lib(name: str) -> ctypes.CDLL:
    """The loaded shared library of kernel ``name``, built first if needed."""
    if name not in _LIBS:
        build((name,))
        so = ctypes.CDLL(str(_target(name)[1]))
        so.cuda_error_string.argtypes = [ctypes.c_int]
        so.cuda_error_string.restype = ctypes.c_char_p
        _LIBS[name] = so
    return _LIBS[name]


def check(name: str, err: int) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if err:
        msg = lib(name).cuda_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} ({msg})")
