"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface and loaded with ``ctypes``.  The
libraries go into ``src/repro_torch/build/`` (listed in ``.gitignore``), named
by a hash of the source, the shared ``csrc/*.cuh`` headers and the flags, so
an edited source or header rebuilds and an unchanged one is reused.  All sources build in parallel, one ``nvcc`` each, at
the first launch of any kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
from typing import Dict, List

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent / "build"

BASE_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# per-source extra flags: the activation quantizer must not contract a*b+c
# into an FMA, so that it matches its plain version bit for bit
EXTRA_FLAGS: Dict[str, List[str]] = {"razer_quantize": ["--fmad=false"]}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_log: Dict[str, str] = {}  # source name -> nvcc's output (registers, spills)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME  # the toolkit torch found

    if CUDA_HOME and (pathlib.Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(pathlib.Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit (set CUDA_HOME)")


def _target(name: str) -> pathlib.Path:
    flags = BASE_FLAGS + EXTRA_FLAGS.get(name, [])
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes() + " ".join(flags).encode())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build_all() -> float:
    """Compile every source that has no up-to-date library; return the
    seconds spent.  Raises with nvcc's output when a build fails."""
    with _lock:
        names = sorted(p.stem for p in CSRC.glob("*.cu"))
        todo = [n for n in names if not _target(n).exists()]
        t0 = time.perf_counter()
        if todo:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            nvcc = _nvcc()
            procs = {}
            for n in todo:
                tmp = _target(n).with_suffix(f".{os.getpid()}.tmp")
                cmd = [nvcc, *BASE_FLAGS, *EXTRA_FLAGS.get(n, []), "-o", str(tmp), str(CSRC / f"{n}.cu")]
                procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                             text=True), tmp)
            failed = []
            for n, (proc, tmp) in procs.items():
                out, _ = proc.communicate()
                build_log[n] = out
                if proc.returncode != 0:
                    failed.append(f"--- {n}.cu (exit {proc.returncode}) ---\n{out}")
                else:
                    tmp.replace(_target(n))
            if failed:
                raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building all sources first
    if needed."""
    lib = _libs.get(name)
    if lib is None:
        build_all()
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(_target(name)))
                _libs[name] = lib
    return lib


def function(lib_name: str, fn_name: str, argtypes) -> ctypes._CFuncPtr:
    """A C entry point of ``csrc/<lib_name>.cu`` with its argument types set
    (pointers and the stream as ``c_void_p``) and an int return."""
    fn = getattr(library(lib_name), fn_name)
    if fn.argtypes is None:
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return fn


def check(status: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")
