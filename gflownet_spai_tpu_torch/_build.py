"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into its own shared library, then loaded with ``ctypes``.
The libraries go to ``$GFLOWNET_SPAI_KERNEL_DIR`` when it is set, else to
``build/kernels/`` at the root of a source checkout, else (an installed
package) to ``gflownet_spai_tpu_torch/kernels`` in the user's cache
directory.  The library's file name carries a hash of its source and of
the headers beside it (``csrc/*.cuh``), so an edited source or header is
rebuilt and an unchanged one is reused.  ``build_all``
starts one ``nvcc`` per source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"


def _build_dir() -> Path:
    if os.environ.get("GFLOWNET_SPAI_KERNEL_DIR"):
        return Path(os.environ["GFLOWNET_SPAI_KERNEL_DIR"])
    root = Path(__file__).resolve().parent.parent
    if (root / "pyproject.toml").exists():          # a source checkout
        return root / "build" / "kernels"
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "gflownet_spai_tpu_torch" / "kernels"


BUILD_DIR = _build_dir()
SOURCES = ("bsr", "bsr_bf16", "dia", "dia_rhs", "dia_spmm", "gat_fused", "segment")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME") and
                 os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    text = b"".join(p.read_bytes() for p in [CSRC / f"{name}.cu",
                                             *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(verbose: bool = False) -> float:
    """Compile every source whose library is missing, one ``nvcc`` per
    source, all started together.  Returns the wall seconds spent.
    ``verbose`` adds ``-Xptxas -v`` and prints each compiler's output
    (registers, shared memory and spills per kernel)."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in SOURCES if not library_path(n).exists()]
    if not todo:
        return time.perf_counter() - t0
    nvcc = nvcc_path()
    procs = {}
    for name in todo:
        tmp = library_path(name).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (exit {proc.returncode})\n{log}")
            continue
        if verbose and log.strip():
            print(f"--- nvcc {name}.cu\n{log.strip()}", flush=True)
        os.replace(tmp, library_path(name))   # atomic: concurrent builds agree
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    if name not in _loaded:
        if not library_path(name).exists():
            build_all()
        _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return _loaded[name]


def check(rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
