"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``repro_torch/csrc/<name>.cu`` exposes a plain C interface and is
compiled on first use into its own shared library under
``build/repro_torch_kernels/`` at the checkout's root. A library's file
name carries a hash of its sources and of the compiler flags, so an
edited source is rebuilt and an unchanged one is loaded as it is. Nothing
here runs at import time: the CPU tests import every module on a machine
with no ``nvcc``.
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
from typing import Dict, Iterable, List, Optional, Sequence

__all__ = ["KERNELS", "build", "build_dir", "load", "nvcc_path"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
KERNELS = ("sextans_spmm", "sextans_spmv")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, then the toolkit's
    default place, then ``PATH``."""
    cands = [os.path.join(os.environ[v], "bin", "nvcc")
             for v in ("CUDA_HOME", "CUDA_PATH") if os.environ.get(v)]
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _library_path(name: str) -> Path:
    h = hashlib.sha256()
    h.update((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile every named kernel that is not built yet, one ``nvcc``
    process per source, all started together. Returns, per name, the
    library path, whether it was compiled now, the seconds it took and
    the compiler's resource report (``ptxas -v``). Raises if a build
    fails."""
    names = list(KERNELS if names is None else names)
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    report: Dict[str, dict] = {}
    jobs: List[tuple] = []
    t0 = time.perf_counter()
    for name in names:
        src = CSRC / f"{name}.cu"
        if not src.is_file():
            raise FileNotFoundError(f"no CUDA source for kernel {name!r}: {src}")
        lib = _library_path(name)
        if lib.is_file():
            report[name] = dict(path=str(lib), compiled=False, seconds=0.0,
                                log="")
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, lib, tmp, proc))
    failed = []
    for name, lib, tmp, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, lib)
        report[name] = dict(path=str(lib), compiled=True,
                            seconds=time.perf_counter() - t0, log=log)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return report


def load(name: str, functions: Dict[str, Sequence]) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (built on first use), with
    ``functions`` mapping each C entry it exports to its argument types.
    Every entry returns an ``int`` status."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = build([name])[name]["path"]
            lib = ctypes.CDLL(path)
            for fn, argtypes in functions.items():
                f = getattr(lib, fn)
                f.argtypes = list(argtypes)
                f.restype = ctypes.c_int
            _LIBS[name] = lib
        return lib
