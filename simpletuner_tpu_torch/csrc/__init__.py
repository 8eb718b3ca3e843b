"""Build and load the hand-written CUDA kernels of the port.

Each ``<name>.cu`` in this directory is compiled by ``nvcc`` for ``sm_90a`` into
a shared library with a plain C interface and loaded with :mod:`ctypes`.  The
build happens at first use, into ``build/kernels/`` at the root of the
checkout, keyed by a hash of the sources and flags, so an edited kernel is
rebuilt and an unchanged one is reused.  A failed build raises: nothing falls
back to a plain PyTorch path on the card.  Every ``*.cuh`` in the directory
is part of every library's key, so a shared header rebuilds all of them.
The libraries need no ``-lcuda``: the TMA tensor maps are encoded through
the driver entry point that ``cudaGetDriverEntryPoint`` returns
(``hopper.cuh``).

Kernel table (every Pallas kernel of the JAX package, ``pl.pallas_call`` sites
in ``simpletuner_tpu/ops/flash_attention.py``):

====  ==========================================  =======================  ==========================
 #    Pallas kernel                               Hopper port              status
====  ==========================================  =======================  ==========================
 1    ``_fwd_kernel`` :68, call :157              ``csrc/flash_fwd.cu``    ported (CUDA, TMA + wgmma)
 2    ``_bwd_dq_kernel`` :197, call :334          ``csrc/flash_bwd.cu``    ported (CUDA, TMA + wgmma)
 3    ``_bwd_dkv_kernel`` :239, call :369         ``csrc/flash_bwd.cu``    ported (CUDA, TMA + wgmma)
====  ==========================================  =======================  ==========================
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterable

CSRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = CSRC_DIR.parents[1] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
# seconds spent compiling, per kernel source, in this process (0 when reused)
BUILD_SECONDS: Dict[str, float] = {}


def find_nvcc() -> str:
    for candidate in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if candidate and os.path.exists(candidate):
            return candidate
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")


def _sources(name: str):
    main = CSRC_DIR / f"{name}.cu"
    if not main.exists():
        raise FileNotFoundError(main)
    return [main] + sorted(CSRC_DIR.glob("*.cuh"))


def library_path(name: str) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for source in _sources(name):
        digest.update(source.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build_log_path(name: str) -> Path:
    return library_path(name).with_suffix(".log")


def _build(name: str, target: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    start = time.perf_counter()
    result = subprocess.run(cmd, capture_output=True, text=True)
    BUILD_SECONDS[name] = time.perf_counter() - start
    target.with_suffix(".log").write_text(result.stdout + result.stderr)
    if result.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed for {name}.cu (exit {result.returncode}):\n{result.stderr[-4000:]}"
        )
    os.replace(tmp, target)


def build(names: Iterable[str]) -> None:
    """Compile every named library that is not built yet, one ``nvcc`` per
    source, all started together."""
    todo = [name for name in dict.fromkeys(names) if not library_path(name).exists()]
    if todo:
        with ThreadPoolExecutor(len(todo)) as pool:
            list(pool.map(lambda name: _build(name, library_path(name)), todo))


def load(name: str) -> ctypes.CDLL:
    """The shared library built from ``csrc/<name>.cu``, compiled on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            target = library_path(name)
            if not target.exists():
                _build(name, target)
            else:
                BUILD_SECONDS.setdefault(name, 0.0)
            lib = ctypes.CDLL(str(target))
            _LIBS[name] = lib
        return lib

