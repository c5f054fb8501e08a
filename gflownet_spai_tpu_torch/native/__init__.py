"""ctypes binding of the native host library ``native/gfnspai.cpp``
(counterpart of ``gflownet_spai_tpu/native/__init__.py``).

The library makes the host side of setup fast at production matrix sizes:
Matrix Market parsing, ILU(0) values, the RCM ordering and the symbolic
SpGEMM plan.  Every entry point has a numpy counterpart in the module
that calls it (``sparse.io.read_mtx``, ``env.ilu.ilu0``,
``ops.rcm.rcm_permutation``, ``sparse.ops.SpGEMMPlan``), which takes its
own path wherever ``available()`` is false.

``available()`` builds the library at first use: ``g++ -O3 -fPIC
-std=c++17 -shared`` on the checkout's ``native/gfnspai.cpp`` into
``build/native/`` beside the kernels' build directory (``_build.BUILD_DIR``),
under a name that carries a hash of the source and the flags.  The
compiler writes a temporary file that is renamed into place, so processes
that build at once all load a whole library.  An installed package, which
carries no C++ source, takes the numpy paths.
"""

from __future__ import annotations

import ctypes as ct
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from .. import _build

SOURCE = Path(__file__).resolve().parents[2] / "native" / "gfnspai.cpp"
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared"]
BUILD_DIR = _build.BUILD_DIR.parent / "native"

_lib: Optional[ct.CDLL] = None
_build_failed = False

_I64P = ct.POINTER(ct.c_int64)
_F64P = ct.POINTER(ct.c_double)


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libgfnspai-{digest}.so"


def build() -> bool:
    """Compile the library into ``BUILD_DIR`` (needs ``g++``) and load it;
    returns whether it loaded."""
    global _lib, _build_failed
    cxx = shutil.which("g++")
    if not SOURCE.exists() or cxx is None:
        _build_failed = True
        return False
    out = library_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                       check=True, capture_output=True)
    except (subprocess.CalledProcessError, OSError):
        tmp.unlink(missing_ok=True)
        _build_failed = True
        return False
    os.replace(tmp, out)       # atomic: concurrent builds agree
    _lib = None
    return _try_load() is not None


def _try_load() -> Optional[ct.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    if not SOURCE.exists() or not library_path().exists():
        return None
    lib = ct.CDLL(str(library_path()))
    lib.gfn_free.argtypes = [ct.c_void_p]
    lib.gfn_free.restype = None
    lib.gfn_parse_mtx.argtypes = [
        ct.c_char_p, _I64P, _I64P, _I64P,
        ct.POINTER(_I64P), ct.POINTER(_I64P), ct.POINTER(_F64P),
    ]
    lib.gfn_ilu0.argtypes = [ct.c_int64, _I64P, _I64P, _F64P, ct.POINTER(_F64P)]
    lib.gfn_rcm.argtypes = [ct.c_int64, _I64P, _I64P, ct.POINTER(_I64P)]
    lib.gfn_spgemm_plan.argtypes = [
        ct.c_int64, _I64P, _I64P, ct.c_int64, ct.c_int64, _I64P, _I64P,
        _I64P, _I64P,
        ct.POINTER(_I64P), ct.POINTER(_I64P),
        ct.POINTER(_I64P), ct.POINTER(_I64P), ct.POINTER(_I64P),
    ]
    for fn in (lib.gfn_parse_mtx, lib.gfn_ilu0, lib.gfn_rcm, lib.gfn_spgemm_plan):
        fn.restype = ct.c_int
    _lib = lib
    return lib


def available() -> bool:
    """Whether the library is loaded, building it first where it is
    missing (once per process: a failed build is not retried)."""
    if _try_load() is not None:
        return True
    return not _build_failed and build()


def _loaded() -> ct.CDLL:
    if not available():
        raise RuntimeError(f"the native library could not be built from {SOURCE}")
    return _lib


def _take(lib, ptr, n) -> np.ndarray:
    """Copy ``n`` elements out of a malloc'd output and free it."""
    arr = np.ctypeslib.as_array(ptr, shape=(n,)).copy() if n else \
        np.zeros(0, np.float64 if isinstance(ptr, _F64P) else np.int64)
    lib.gfn_free(ptr)
    return arr


def _i64(x) -> np.ndarray:
    return np.ascontiguousarray(x, np.int64)


def parse_mtx(path) -> Tuple[int, int, np.ndarray, np.ndarray, np.ndarray]:
    """(nrows, ncols, rows, cols, vals) of a coordinate Matrix Market file,
    sorted row-major, symmetry expanded; ``ValueError`` on a file the
    parser does not take (array format, complex or hermitian)."""
    lib = _loaded()
    nr, nc, nz = ct.c_int64(), ct.c_int64(), ct.c_int64()
    rp, cp, vp = _I64P(), _I64P(), _F64P()
    rc = lib.gfn_parse_mtx(str(path).encode(), ct.byref(nr), ct.byref(nc),
                           ct.byref(nz), ct.byref(rp), ct.byref(cp), ct.byref(vp))
    if rc != 0:
        raise ValueError(f"gfn_parse_mtx({path}) failed with code {rc}")
    n = nz.value
    return nr.value, nc.value, _take(lib, rp, n), _take(lib, cp, n), _take(lib, vp, n)


def ilu0_values(indptr: np.ndarray, indices: np.ndarray,
                vals: np.ndarray) -> np.ndarray:
    """Combined L\\U values of ILU(0) on a row-sorted CSR pattern (unit
    diagonal of L implied); ``ZeroDivisionError`` on a zero pivot."""
    lib = _loaded()
    ip, ix = _i64(indptr), _i64(indices)
    v = np.ascontiguousarray(vals, np.float64)
    if len(ix) != len(v) or len(ip) < 1 or ip[-1] != len(v):
        raise ValueError("ilu0_values: indptr, indices and vals disagree")
    out = _F64P()
    rc = lib.gfn_ilu0(len(ip) - 1, ip.ctypes.data_as(_I64P), ix.ctypes.data_as(_I64P),
                      v.ctypes.data_as(_F64P), ct.byref(out))
    if rc < 0:
        raise MemoryError("gfn_ilu0: out of memory")
    if rc != 0:
        raise ZeroDivisionError(f"ILU(0) zero pivot at row {rc - 1}")
    return _take(lib, out, len(v))


def rcm(indptr: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Reverse Cuthill-McKee order of a symmetric CSR graph."""
    lib = _loaded()
    ip, ix = _i64(indptr), _i64(indices)
    n = len(ip) - 1
    out = _I64P()
    if lib.gfn_rcm(n, ip.ctypes.data_as(_I64P), ix.ctypes.data_as(_I64P),
                   ct.byref(out)) != 0:
        raise RuntimeError("gfn_rcm failed")
    return _take(lib, out, n)


def spgemm_plan(rows_a: np.ndarray, cols_a: np.ndarray, n_mid: int,
                ncols_b: int, indptr_b: np.ndarray, indices_b: np.ndarray):
    """Symbolic product of a COO A and a CSR B: (out_row, out_col, pair_a,
    pair_b, pair_out), the output pattern row-major and the pairs sorted by
    output slot (in no fixed order within a slot)."""
    lib = _loaded()
    ra, ca, ib, jb = _i64(rows_a), _i64(cols_a), _i64(indptr_b), _i64(indices_b)
    out_nnz, n_pairs = ct.c_int64(), ct.c_int64()
    orow, ocol, pa, pb, po = _I64P(), _I64P(), _I64P(), _I64P(), _I64P()
    if lib.gfn_spgemm_plan(
            len(ra), ra.ctypes.data_as(_I64P), ca.ctypes.data_as(_I64P),
            n_mid, ncols_b, ib.ctypes.data_as(_I64P), jb.ctypes.data_as(_I64P),
            ct.byref(out_nnz), ct.byref(n_pairs), ct.byref(orow), ct.byref(ocol),
            ct.byref(pa), ct.byref(pb), ct.byref(po)) != 0:
        raise RuntimeError("gfn_spgemm_plan failed")
    k, m = out_nnz.value, n_pairs.value
    return (_take(lib, orow, k), _take(lib, ocol, k), _take(lib, pa, m),
            _take(lib, pb, m), _take(lib, po, m))
