"""DIA (diagonal) sparse format and its kernels (counterpart of
``gflownet_spai_tpu/ops/dia.py``, with ``dia_astype`` and bf16 diagonal
storage).  The banded product ``spgemm_dia`` (and its batched form, the DIA
reward env's residual) is plain PyTorch on any device, as the JAX
package's is plain ``jnp``.

Storage is row-scaled: ``data[s, i] = A[i, i + offsets[s]]``, zero where
out of range, padded to ``n_pad`` rows (a multiple of 1024)::

    y[i] = Σ_s data[s, i] · x[i + offsets[s]]

Entry points and the kernels they launch on CUDA tensors:

- ``spmv_dia`` / ``spmv_dia_padded`` (and the unfused affine sweep): K8,
  which on a wide band that stores mostly zeros (``_k8_skips``) reads a
  diagonal only in the row tiles where the matrix's segment flags
  (``_segment_flags``, made with such a DIA) say it holds a word other
  than zero;
- ``spmv_dia_padded_io`` (K10, output in x's padded layout, halo blocks
  zeroed by the same launch) and ``spmv_dia_pingpong`` (K11, into a second
  buffer's interior): one entry of ``csrc/dia_rhs.cu``, a launch of its
  row-tile kernel on one right-hand side;
- ``spmv_dia_power`` (K12) and ``spmv_dia_power_rhs`` (K14, K right-hand
  sides): k fused passes; ``spmv_dia_cheby`` (K13): k Chebyshev steps;
- ``spmm_dia`` (K15, X [n, K]): ``csrc/dia_spmm.cu``; ``spmm_dia_t`` /
  ``spmm_dia_t_padded`` / ``spmm_dia_t_rows`` (K16, X in [K, n] layout, the
  last on an unpadded [K, n_pad] buffer) and ``spmv_dia_power_rhs`` (K14):
  ``csrc/dia_rhs.cu``'s row-tile kernel.

On CPU tensors each computes its plain version (``*_ref``), the JAX
package's jnp fallback.  K12 and K13 have two modes (``csrc/dia.cu``'s
header): fused, where clusters of CTAs stage each window's diagonals once
and run all k passes in shared memory, trading edge rows through
distributed shared memory; and streamed, one launch per pass through
global memory.  ``_fused_plan`` picks the fused launch (cluster size, rows
per CTA, clusters launched) that a cost model fitted on the card times
fastest, and takes it only where a window fits (at most 9 diagonals, reach
below the shared memory) and the model times it below the streamed mode;
the two modes agree bit for bit.  ``_SMEM_BYTES = 0`` forces the streamed
mode (tests, ``chip_smoke.py``).  K14 runs its k passes as k launches of
the row-tile kernel that K16 shares, so every k the selection picks runs
on the card.

Dtypes (one rule for the CPU and the card).  The JAX package's two paths
disagree on bf16: its Pallas kernels cast x to the diagonals' dtype and
accumulate and return in it, while its jnp fallbacks promote.  The port
follows the jnp fallbacks' dtypes and the kernels' purpose:

- diagonals are float32 or bf16 (``dia_astype(d, torch.bfloat16)``: half
  the diagonals' bytes);
- vectors and buffers keep the dtype the caller gives them; only the
  padding helpers that cast in JAX round them to the diagonals' dtype
  (``dia_pad_x``, ``dia_pad_io``, ``dia_pad_xt``), while ``dia_pad_pp``
  and ``dia_pad_pp_rhs`` promote;
- every entry point's output has the dtype promote(diagonals, vectors), the
  jnp fallbacks' dtype, and all buffers of one call share one dtype: a
  bf16 vector given with float32 diagonals is converted to float32 first;
- every product and sum is taken in float32 (bf16 → float32 is exact) and
  each value is rounded once, where it is stored, to the output dtype; K12,
  K13 and K14 round every pass's iterate to the buffers' dtype, as the jnp
  fallbacks' ``cur`` is between passes.  The port does not copy the TPU
  kernels' bf16 accumulation, so its bf16 results lie closer to float64
  than JAX's TPU path does;
- on CUDA tensors the kernels take (diagonals, vectors) of (float32,
  float32), (bf16, float32) or (bf16, bf16); float16, float64, mixed
  buffer dtypes within one call, and bf16 buffers written in place on
  float32 diagonals (their output would be float32) raise ``ValueError``.

The selection functions (``dia_pp_tile``, ``dia_power_ok``,
``dia_power_stream_ok``, ``dia_power_tile``, ``dia_cheby_ok``,
``dia_power_rhs_ok``, ``_spmv_io_tile``, ``_spmm_t_tiles``) are the TPU's
VMEM model, kept verbatim for parity: the fused k they pick sets the
polynomial a preconditioner applies (sweeps and degrees round up to
multiples of k), and they fix the pad widths P and the padded RHS count
K_pad of the buffers.  The CUDA kernels tile as they like and read P and
K_pad from the buffers.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

from .. import _build
from .._device import resolve_device
from ..sparse.convert import coo_sort_dedup
from ..sparse.types import COO, to_numpy

_ALIGN = 1024          # Mosaic vector-load alignment for f32 1-D refs
_MAX_VMEM_BYTES = 15 * 1024 * 1024   # of the 16 MiB/core on v5e
_SMEM_BYTES_MAX = 232448
_SMEM_BYTES = _SMEM_BYTES_MAX   # shared memory K12-K14 may give a block (0: they stream)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@functools.lru_cache(maxsize=256)
def _offsets_tensor(offsets: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    return torch.tensor(offsets, dtype=torch.int32, device=device)


_FLAG_ROWS = 64        # the rows a segment flag covers: K8's row tile (csrc/dia.cu)


def _segment_flags(data: torch.Tensor) -> torch.Tensor:
    """K8's segment flags of the diagonals ``data`` [..., ndiags, n_pad]:
    [..., ceil(n_pad / _FLAG_ROWS), ndiags] uint8, 1 where the segment of a
    diagonal in a tile of ``_FLAG_ROWS`` rows holds a word other than zero
    (NaN counts).  A term of a +0.0 or -0.0 word changes a sum only where
    x is inf or NaN or the sum is -0.0, which K8's skip path handles
    exactly.  Device ops only, no host sync: a CUDA-graph capture may make
    a DIA (the backward's transpose)."""
    n_pad = data.shape[-1]
    tiles = -(-n_pad // _FLAG_ROWS)
    nonzero = data.detach() != 0
    if tiles * _FLAG_ROWS != n_pad:
        nonzero = torch.nn.functional.pad(nonzero, (0, tiles * _FLAG_ROWS - n_pad))
    seg = nonzero.reshape(*data.shape[:-1], tiles, _FLAG_ROWS).any(-1)
    return seg.transpose(-1, -2).to(torch.uint8).contiguous()


def _host_seg_share(data: np.ndarray) -> float:
    """The share of the segments of host diagonals ``data`` [ndiags, n_pad]
    (n_pad a multiple of ``_FLAG_ROWS``) that hold a word other than zero:
    ``_segment_flags``'s mean, reckoned where the data is made."""
    nd, n_pad = data.shape
    if nd == 0:
        return 0.0
    return float((data.reshape(nd, n_pad // _FLAG_ROWS, _FLAG_ROWS) != 0).any(-1).mean())


def _data_version(t: torch.Tensor) -> int | None:
    """The version counter of ``t`` (None for an inference tensor, which
    keeps none)."""
    try:
        return t._version
    except RuntimeError:
        return None


@dataclasses.dataclass(frozen=True, eq=False)
class DIA:
    """Diagonal-format sparse matrix (square).  ``data``: [ndiags, n_pad]."""

    data: torch.Tensor
    offsets: Tuple[int, ...]
    shape: Tuple[int, int]
    nnz: int
    # the share of the 64-row segments of the diagonals that hold an entry,
    # where the maker knows or estimates it (K8's rule, ``_k8_share``)
    seg_share: float | None = dataclasses.field(default=None, repr=False)
    # the offsets as int32 on the data's device, which the kernels read
    offsets_t: torch.Tensor = dataclasses.field(init=False, repr=False)
    # K8's segment flags (``_segment_flags``; None where its rule takes the
    # rows path, which reads none) and the version of ``data`` they were
    # made from (``_flags`` makes them again after an in-place write)
    flags: torch.Tensor | None = dataclasses.field(init=False, repr=False)
    flags_version: int | None = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        # Made with the matrix, one copy per pattern and device, never in a
        # kernel call: a CUDA-graph capture of a call (or of the backward,
        # which builds the transpose) then holds no host-to-device copy.
        dev = self.data.device
        object.__setattr__(self, "offsets_t", _offsets_tensor(self.offsets, dev))
        _offsets_tensor(tuple(-o for o in self.offsets), dev)
        object.__setattr__(self, "flags", _segment_flags(self.data) if _k8_skips(self)
                           else None)
        object.__setattr__(self, "flags_version", _data_version(self.data))

    @property
    def n(self) -> int:
        return self.shape[0]

    @property
    def n_pad(self) -> int:
        return int(self.data.shape[1])

    @property
    def ndiags(self) -> int:
        return len(self.offsets)

    @property
    def reach(self) -> int:
        """The true reach max|offset| (the CUDA kernels' per-pass halo)."""
        return max((abs(o) for o in self.offsets), default=0)

    @property
    def halo(self) -> int:
        # never 0 (a diagonal-only matrix still gets one aligned halo unit)
        return _round_up(max(self.reach, 1), _ALIGN)

    def todense(self) -> torch.Tensor:
        n = self.n
        out = torch.zeros(self.shape, dtype=self.data.dtype, device=self.data.device)
        i = torch.arange(n, device=self.data.device)
        for s, off in enumerate(self.offsets):
            j = i + off
            ok = (j >= 0) & (j < n)
            out[i[ok], j[ok]] += self.data[s, :n][ok]
        return out

    def to(self, device) -> "DIA":
        return dataclasses.replace(self, data=self.data.to(device))


def coo_to_dia(coo: COO, max_diags: int | None = None, device=None) -> DIA:
    """Host-side conversion onto ``device`` (CUDA unless the caller asks
    for another); raises if the matrix has more distinct diagonals than
    ``max_diags``."""
    if coo.shape[0] != coo.shape[1]:
        raise ValueError("DIA requires a square matrix")
    device = resolve_device(device)
    n = coo.shape[0]
    row = to_numpy(coo.row).astype(np.int64)
    col = to_numpy(coo.col).astype(np.int64)
    dat = to_numpy(coo.data)
    offs = np.unique(col - row)
    if max_diags is not None and len(offs) > max_diags:
        raise ValueError(f"{len(offs)} distinct diagonals > max_diags={max_diags}; "
                         "apply RCM reordering or use ELL/BSR")
    n_pad = _round_up(max(n, 1), _ALIGN)
    data = np.zeros((len(offs), n_pad), dat.dtype)
    diag_ids = np.searchsorted(offs, col - row)
    np.add.at(data, (diag_ids, row), dat)   # duplicate entries sum
    return DIA(data=torch.as_tensor(data, device=device),
               offsets=tuple(int(o) for o in offs), shape=tuple(coo.shape),
               nnz=int(len(dat)), seg_share=_host_seg_share(data))


def dia_to_coo(d: DIA) -> COO:
    """The stored nonzeros as a canonical host COO."""
    n = d.n
    data = to_numpy(d.data)
    i = np.arange(n)
    rows, cols, vals = [], [], []
    for s, off in enumerate(d.offsets):
        j = i + off
        m = (j >= 0) & (j < n) & (data[s, :n] != 0)
        rows.append(i[m]); cols.append(j[m]); vals.append(data[s, :n][m])
    return coo_sort_dedup(COO(row=np.concatenate(rows).astype(np.int32),
                              col=np.concatenate(cols).astype(np.int32),
                              data=np.concatenate(vals), shape=d.shape),
                          sum_duplicates=False)


def dia_astype(d: DIA, dtype) -> DIA:
    """The same matrix with its diagonals stored in ``dtype``, rounded to
    nearest even as JAX's ``astype``: ``torch.bfloat16`` halves the
    diagonals' bytes, which every kernel reads; the kernels widen each
    word to float32 where they read it and take every sum in float32."""
    return dataclasses.replace(d, data=d.data.to(dtype))


def dia_transpose(d: DIA) -> DIA:
    """Aᵀ in DIA: ``AT[i, i − off] = A[i − off, i] = data[s, i − off]``, a
    static shift of each diagonal with the negated offset (differentiable)."""
    n, n_pad = d.n, d.n_pad
    idx = torch.arange(n_pad, device=d.data.device)
    rows = []
    for s, off in enumerate(d.offsets):
        valid = (idx - off >= 0) & (idx - off < n)
        rows.append(torch.where(valid, torch.roll(d.data[s], off), 0.0))
    return DIA(data=torch.stack(rows), offsets=tuple(-o for o in d.offsets),
               shape=(d.shape[1], d.shape[0]), nnz=d.nnz, seg_share=d.seg_share)


# ---------------------------------------------------------------------------
# The banded product C = M·A in DIA form (the DIA reward env's residual)
# ---------------------------------------------------------------------------

def spgemm_dia_batch(m_data: torch.Tensor, m_offsets: Tuple[int, ...],
                     a: DIA) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    """Diagonals of C = M·A for M given as ``m_data`` [..., nd_m, n_pad]
    with ``m_offsets`` (any leading batch axes): returns (C's data [...,
    nd_c, n_pad], C's offsets, every sum d₁ + d₂ in ascending order).

    C[i, i + d₁ + d₂] += M[i, i + d₁] · A[i + d₁, i + d₁ + d₂]: each M
    diagonal times a statically shifted A diagonal, added into the output
    diagonals of one M diagonal at a time (each output slot once per M
    diagonal, in M's diagonal order, as the JAX package sums them).
    Entries whose column or row falls outside the matrix are zeroed."""
    n, n_pad = a.n, a.n_pad
    if m_data.shape[-1] != n_pad:
        raise ValueError("operands must share n_pad (repad first)")
    out_offsets = tuple(sorted({d1 + d2 for d1 in m_offsets for d2 in a.offsets}))
    pos = {d: k for k, d in enumerate(out_offsets)}
    # pad by M's reach so every shifted read is an in-bounds static slice
    ha = max((abs(o) for o in m_offsets), default=1)
    a_pad = torch.nn.functional.pad(a.data, (ha, ha))
    dtype = torch.promote_types(m_data.dtype, a.data.dtype)
    out = torch.zeros(m_data.shape[:-2] + (len(out_offsets), n_pad), dtype=dtype,
                      device=m_data.device)
    for s1, d1 in enumerate(m_offsets):
        ks = _offsets_tensor(tuple(pos[d1 + d2] for d2 in a.offsets), out.device)
        shifted = a_pad[:, ha + d1:ha + d1 + n_pad]              # [nd_a, n_pad]
        # ks holds distinct slots: one add per element, in a fixed order
        out.index_add_(-2, ks, m_data[..., s1, None, :].to(dtype) * shifted)
    i = torch.arange(n_pad, device=out.device)
    d3 = _offsets_tensor(out_offsets, out.device)[:, None]
    valid = (i + d3 >= 0) & (i + d3 < n) & (i < n)
    return out.masked_fill_(~valid, 0.0), out_offsets


def spgemm_dia(m: DIA, a: DIA) -> DIA:
    """Banded sparse × sparse product C = M·A entirely in DIA form
    (``spgemm_dia_batch`` on one M); the output offsets are every sum
    d₁ + d₂."""
    if m.shape[1] != a.shape[0]:
        raise ValueError("inner dims mismatch")
    data, offsets = spgemm_dia_batch(m.data, m.offsets, a)
    nnz = sum(max(0, m.n - abs(d3)) for d3 in offsets)
    return DIA(data=data, offsets=offsets, shape=(m.shape[0], a.shape[1]), nnz=nnz)


def frobenius_sq_minus_identity_dia_batch(data: torch.Tensor,
                                          offsets: Tuple[int, ...],
                                          n: int) -> torch.Tensor:
    """‖C − I‖_F² for the DIA diagonals ``data`` [..., ndiags, n_pad] (out
    of range slots zero), per leading index."""
    s2 = torch.sum(data * data, dim=(-2, -1))
    if 0 in offsets:
        s2 = s2 - 2.0 * torch.sum(data[..., offsets.index(0), :n], dim=-1)
    return s2 + n


def frobenius_sq_minus_identity_dia(c: DIA) -> torch.Tensor:
    """‖C − I‖_F² for DIA C (assumes out-of-range slots are zero)."""
    return frobenius_sq_minus_identity_dia_batch(c.data, c.offsets, c.n)


# ---------------------------------------------------------------------------
# Padded layouts and the plain versions
# ---------------------------------------------------------------------------

def _pad_x(d: DIA, x: torch.Tensor) -> torch.Tensor:
    """[..., n] → [..., halo + n_pad + halo] with zeros around x."""
    h = d.halo
    return torch.nn.functional.pad(x, (h, d.n_pad - x.shape[-1] + h))


def dia_pad_x(d: DIA, x: torch.Tensor) -> torch.Tensor:
    """[n] → halo-padded [halo + n_pad + halo] buffer."""
    return _pad_x(d, x.to(d.data.dtype))


def _out_dtype(d: DIA, x: torch.Tensor) -> torch.dtype:
    """An entry point's output dtype: promote(diagonals, vectors)."""
    return torch.promote_types(d.data.dtype, x.dtype)


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The plain versions' working dtype for outputs of ``dtype``:
    float32 for bf16 (every product and sum in float32, as the kernels
    take them), else the dtype itself."""
    return torch.promote_types(dtype, torch.float32)


def _dia_rows(d: DIA, buf: torch.Tensor, start: int, rows: int) -> torch.Tensor:
    """Σ_s data[s, :rows] · buf[..., start + off_s : start + off_s + rows]
    along the last axis (one vector, or K right-hand sides as rows),
    summed in offset order from zero (the jnp fallbacks' order), in the
    working dtype (``_acc_dtype``); the caller rounds at its store."""
    dt = _acc_dtype(torch.promote_types(d.data.dtype, buf.dtype))
    acc = torch.zeros((*buf.shape[:-1], rows), dtype=dt, device=buf.device)
    for s, off in enumerate(d.offsets):
        acc = acc + d.data[s, :rows].to(dt) * buf[..., start + off:start + off + rows].to(dt)
    return acc


def spmv_dia_ref(d: DIA, x: torch.Tensor) -> torch.Tensor:
    """Plain version of K8 (``spmv_dia_jnp``): [n] → [n]."""
    return _dia_rows(d, _pad_x(d, x), d.halo, d.n).to(_out_dtype(d, x))


def spmv_dia_padded_ref(d: DIA, xp: torch.Tensor) -> torch.Tensor:
    """Plain ``spmv_dia_padded``: [P + n_pad + P] → [n_pad]."""
    return _dia_rows(d, xp, (xp.shape[0] - d.n_pad) // 2, d.n_pad).to(_out_dtype(d, xp))


def spmv_dia_padded_io_ref(d: DIA, xq: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """Plain version of K10 (the jnp fallback, dia.py:1038-1044): a new
    buffer in xq's [P + n_pad + P] layout, zero halo blocks, interior
    scale·A·x."""
    p = (xq.shape[0] - d.n_pad) // 2
    out = torch.zeros(xq.shape, dtype=_out_dtype(d, xq), device=xq.device)
    out[p:p + d.n_pad] = _dia_rows(d, xq, p, d.n_pad) * scale
    return out


def spmv_dia_pingpong_ref(d: DIA, xq: torch.Tensor, yq: torch.Tensor,
                          scale: float = 1.0) -> torch.Tensor:
    """Plain version of K11 (dia.py:1260-1265): scale·A·x into yq's
    interior in place (its halo blocks untouched); returns yq."""
    p = (xq.shape[0] - d.n_pad) // 2
    yq[p:p + d.n_pad] = _dia_rows(d, xq, p, d.n_pad) * scale
    return yq


def spmv_dia_power_ref(d: DIA, xq: torch.Tensor, zq: torch.Tensor,
                       scale: float = 1.0, k: int = 2,
                       add: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of K12 (the jnp fallback, dia.py:1796-1811) and, on
    [K, P + n_pad + P] buffers, of K14 (dia.py:1998-2014): k passes
    ``cur ← scale·A·cur [+ add]`` along the last axis, each rounded to the
    buffers' dtype, with rows outside [0, n_pad) zero after the first;
    writes zq's interior in place and returns zq."""
    p = (xq.shape[-1] - d.n_pad) // 2
    h = d.halo
    dt = _out_dtype(d, xq)
    cur = xq[..., p - h:p + d.n_pad + h]
    cadd = None if add is None else add[..., p:p + d.n_pad]
    for _ in range(k):
        acc = _dia_rows(d, cur, h, d.n_pad) * scale
        if cadd is not None:
            acc = acc + cadd.to(acc.dtype)
        cur = torch.nn.functional.pad(acc.to(dt), (h, h))
    zq[..., p:p + d.n_pad] = cur[..., h:h + d.n_pad]
    return zq


spmv_dia_power_rhs_ref = spmv_dia_power_ref      # K14's plain version


def spmm_dia_ref(d: DIA, x: torch.Tensor) -> torch.Tensor:
    """Plain version of K15 (``spmm_dia_jnp``, dia.py:483): Y = A·X for
    X [n, K] → [n, K]."""
    h, n = d.halo, d.n
    out = _out_dtype(d, x)
    dt = _acc_dtype(out)
    xp = torch.nn.functional.pad(x, (0, 0, h, d.n_pad - n + h))
    acc = torch.zeros((n, x.shape[1]), dtype=dt, device=x.device)
    for s, off in enumerate(d.offsets):
        acc = acc + d.data[s, :n, None].to(dt) * xp[h + off:h + off + n].to(dt)
    return acc.to(out)


def spmm_dia_t_ref(d: DIA, xt: torch.Tensor) -> torch.Tensor:
    """Plain transposed-RHS SpMM (``spmm_dia_t_jnp``, dia.py:599):
    Yt[k, i] = Σ_s data[s, i]·Xt[k, i + off_s] for Xt [K, n] → [K, n]."""
    return _dia_rows(d, _pad_x(d, xt), d.halo, d.n).to(_out_dtype(d, xt))


def spmm_dia_t_padded_ref(d: DIA, xtp: torch.Tensor) -> torch.Tensor:
    """Plain version of K16 (``spmm_dia_t_padded``'s jnp branch,
    dia.py:759-765): [K_pad, h + n_pad + h] → [K_pad, n_pad]."""
    return _dia_rows(d, xtp, d.halo, d.n_pad).to(_out_dtype(d, xtp))


def spmv_dia_cheby_ref(d: DIA, zq: torch.Tensor, ddq: torch.Tensor,
                       rq: torch.Tensor, z_dead: torch.Tensor,
                       dd_dead: torch.Tensor, coeffs, k: int):
    """Plain version of K13 (dia.py:1751-1766): per pass
    ``dd ← a·dd + b·(r − A·z); z ← z + dd``, dd and z each rounded to the
    buffers' dtype where they are stored; writes the interiors of
    ``z_dead`` / ``dd_dead`` in place and returns them."""
    del k
    p = (zq.shape[0] - d.n_pad) // 2
    h = d.halo
    out = _out_dtype(d, zq)
    dt = _acc_dtype(out)
    z = zq[p - h:p + d.n_pad + h]
    dd = ddq[p:p + d.n_pad]
    r = rq[p:p + d.n_pad]
    for (a, b) in coeffs:
        t = _dia_rows(d, z, h, d.n_pad)
        dd = (a * dd.to(dt) + b * (r.to(dt) - t)).to(out)
        z = torch.nn.functional.pad((z[h:h + d.n_pad].to(dt) + dd.to(dt)).to(out), (h, h))
    z_dead[p:p + d.n_pad] = z[h:h + d.n_pad]
    dd_dead[p:p + d.n_pad] = dd
    return z_dead, dd_dead


# ---------------------------------------------------------------------------
# The TPU's VMEM model (selection functions, verbatim for parity)
# ---------------------------------------------------------------------------

def dia_pp_tile(d: DIA) -> int:
    """Lane tile P for the ping-pong kernels: a multiple of ``_ALIGN`` ≥
    halo dividing n_pad, the largest VMEM-feasible one ≤ 64·ALIGN.
    Returns 0 when none exists."""
    budget = _MAX_VMEM_BYTES // 4
    best = 0
    tr = _round_up(max(d.halo, _ALIGN), _ALIGN)
    while tr <= min(d.n_pad, 64 * _ALIGN):
        if d.n_pad % tr == 0:
            resident = (d.n_pad + 2 * tr) + (3 * d.ndiags + 4) * tr <= budget
            streamed = 2 * (tr + 2 * d.halo) + (3 * d.ndiags + 8) * tr <= budget
            if resident or streamed:
                best = tr
            else:
                break
        tr += _ALIGN
    return best


def dia_pad_pp(d: DIA, x: torch.Tensor, tr: int | None = None) -> torch.Tensor:
    """[n] → [P + n_pad + P] ping-pong buffer, P = ``dia_pp_tile(d)`` (the
    halo width when no tile exists), or ``tr`` when given."""
    if tr is None:
        tr = dia_pp_tile(d) or d.halo
    dt = torch.promote_types(d.data.dtype, x.dtype)
    return torch.nn.functional.pad(x.to(dt), (tr, d.n_pad - x.shape[0] + tr))


def dia_power_data(d: DIA, k: int = 2, tr: int | None = None) -> torch.Tensor:
    """Per-tile widened data windows [grid, ndiags, tr + 2(k−1)h] (zeros
    beyond the edges), as the TPU kernels' block mapping needs them.  Kept
    for parity of the entry points' signatures: the CUDA kernels and the
    plain versions read ``d.data`` directly."""
    h = d.halo
    if tr is None:
        tr = dia_pp_tile(d)
    if not tr:
        return d.data.new_zeros((0, d.ndiags, 0))
    m = (k - 1) * h
    padded = torch.nn.functional.pad(d.data, (m, m))   # row r at index r + m
    return torch.stack([padded[:, j * tr:j * tr + tr + 2 * m]
                        for j in range(d.n_pad // tr)])


def dia_power_ok(d: DIA, k: int = 2, tr: int | None = None) -> bool:
    """Whether the resident fused k-step TPU kernel fits at tile ``tr``."""
    if tr is None:
        tr = dia_pp_tile(d)
    if not tr or tr < k * d.halo or k < 2:
        return False
    budget = _MAX_VMEM_BYTES // 4
    rows8 = _round_up(d.ndiags, 8)
    win_d = tr + 2 * (k - 1) * d.halo
    need = ((d.n_pad + 2 * tr)
            + (2 * rows8 + 2 * d.ndiags + 8) * win_d
            + 2 * k * d.halo)
    return need <= budget


def dia_power_stream_ok(d: DIA, k: int = 2, tr: int | None = None) -> bool:
    """Whether the streamed fused k-step TPU kernel fits at tile ``tr``."""
    if tr is None:
        tr = dia_pp_tile(d)
    if not tr or tr < k * d.halo or k < 2:
        return False
    budget = _MAX_VMEM_BYTES // 4
    rows8 = _round_up(d.ndiags, 8)
    win_d = tr + 2 * (k - 1) * d.halo
    win_x = tr + 2 * k * d.halo
    need = (4 * win_x + (2 * rows8 + 2 * d.ndiags + 6) * win_d + 2 * tr)
    return need <= budget


def dia_power_tile(d: DIA, k: int = 2) -> int:
    """Largest ping-pong tile P feasible for the fused k-step TPU kernel at
    this k (resident or streamed); 0 when none."""
    if k < 2:
        return 0
    best = 0
    tr = _round_up(max(k * d.halo, _ALIGN), _ALIGN)
    while tr <= min(d.n_pad, 64 * _ALIGN):
        if d.n_pad % tr == 0:
            if dia_power_ok(d, k, tr) or dia_power_stream_ok(d, k, tr):
                best = tr
            else:
                break          # need is monotone increasing in tr
        tr += _ALIGN
    return best


def dia_cheby_ok(d: DIA, k: int) -> bool:
    """VMEM feasibility of the fused Chebyshev TPU kernel."""
    tr = dia_pp_tile(d)
    if not tr or tr < k * d.halo or k < 2:
        return False
    budget = _MAX_VMEM_BYTES // 4
    rows8 = _round_up(d.ndiags, 8)
    win_d = tr + 2 * (k - 1) * d.halo
    need = ((d.n_pad + 2 * tr)
            + (2 * rows8 + 2 * d.ndiags + 6) * win_d
            + 4 * win_d
            + 4 * tr)
    return need <= budget


def _spmv_io_tile(d: DIA) -> int:
    """Pad width P of the padded-IO layout: a multiple of ``_ALIGN``
    dividing n_pad with P ≥ halo, from near 16·ALIGN up; 0 when none."""
    lo = max(d.halo, min(16 * _ALIGN, d.n_pad))
    tr = _round_up(lo, _ALIGN)
    while tr <= d.n_pad and d.n_pad % tr:
        tr += _ALIGN
    return tr if tr <= d.n_pad else 0


def _spmv_io_fits(d: DIA) -> Tuple[bool, bool]:
    """Whether the TPU's resident / streamed padded-IO kernel fits (the
    CUDA kernel has one mode; kept for parity of the selection)."""
    tr = _spmv_io_tile(d)
    if not tr:
        return False, False
    budget = _MAX_VMEM_BYTES // 4
    resident = (d.n_pad + 2 * tr) + (3 * d.ndiags + 4) * tr <= budget
    streamed = 2 * (tr + 2 * d.halo) + (3 * d.ndiags + 8) * tr <= budget
    return resident, streamed


def _pp_resident_ok(d: DIA, tr: int) -> bool:
    """Whether the TPU's resident ping-pong kernel fits at tile ``tr``
    (kept for parity of the selection, as ``_spmv_io_fits``)."""
    budget = _MAX_VMEM_BYTES // 4
    return (d.n_pad + 2 * tr) + (3 * d.ndiags + 4) * tr <= budget


def dia_pad_io(d: DIA, x: torch.Tensor) -> torch.Tensor:
    """[n] → [P + n_pad + P] buffer of the padded-IO chain, P =
    ``_spmv_io_tile(d)`` (the halo width when no tile exists)."""
    tr = _spmv_io_tile(d) or d.halo
    return torch.nn.functional.pad(x.to(d.data.dtype), (tr, d.n_pad - x.shape[0] + tr))


def _spmm_t_need(d: DIA, kb: int, tr: int) -> int:
    """VMEM words of the TPU's transposed SpMM at (kb, tr)."""
    return 3 * kb * (tr + 2 * d.halo) + 5 * kb * tr + 4 * d.ndiags * tr


def _spmm_t_tiles(d: DIA, kp: int) -> Tuple[int, int]:
    """(kb, tr) of the TPU's transposed SpMM: the least modeled HBM
    traffic under the VMEM budget.  kb fixes K_pad, the row count of the
    multi-RHS buffers (``dia_pad_xt``, ``cg_multi``)."""
    budget = _MAX_VMEM_BYTES // 4
    best = (min(kp, 8), _ALIGN)
    best_cost = None
    for kb in (8, 16, 32, 64, 128):
        if kb > max(kp, 8):
            break
        for tr in range(_ALIGN, d.n_pad + 1, _ALIGN):
            if d.n_pad % tr or _spmm_t_need(d, kb, tr) > budget:
                continue
            grid_k = -(-max(kp, kb) // kb)
            cost = (max(kp, kb) * (2 * d.halo + 2 * tr) // tr
                    + grid_k * d.ndiags)
            if best_cost is None or cost < best_cost:
                best, best_cost = (kb, tr), cost
    return best


def _spmm_t_fits(d: DIA, kp: int) -> bool:
    kb, tr = _spmm_t_tiles(d, kp)
    return _spmm_t_need(d, kb, tr) <= _MAX_VMEM_BYTES // 4


def _pad_xt(d: DIA, xt: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``dia_pad_xt``'s buffer in ``dtype``."""
    kb, _ = _spmm_t_tiles(d, max(8, _round_up(xt.shape[0], 8)))
    kp = _round_up(xt.shape[0], kb)
    h = d.halo
    return torch.nn.functional.pad(xt.to(dtype),
                                   (h, d.n_pad - xt.shape[1] + h, 0, kp - xt.shape[0]))


def dia_pad_xt(d: DIA, xt: torch.Tensor) -> torch.Tensor:
    """[K, n] → [K_pad, h + n_pad + h] buffer of the transposed SpMM in the
    diagonals' dtype (as JAX's), K_pad a multiple of ``_spmm_t_tiles``' kb
    (zero rows and halos)."""
    return _pad_xt(d, xt, d.data.dtype)


def dia_pad_pp_rhs(d: DIA, x: torch.Tensor, tr: int | None = None) -> torch.Tensor:
    """[K, n] → [K, P + n_pad + P] ping-pong buffers (promoted dtype, zero
    halo blocks), P = ``tr`` or ``dia_pp_tile(d)`` or the halo."""
    if tr is None:
        tr = dia_pp_tile(d) or d.halo
    dt = torch.promote_types(d.data.dtype, x.dtype)
    return torch.nn.functional.pad(x.to(dt), (tr, d.n_pad - x.shape[1] + tr))


def dia_power_rhs_ok(d: DIA, k: int, n_rhs: int, tr: int | None = None) -> bool:
    """Whether the TPU's resident multi-RHS fused kernel fits: x, z and the
    output scale by K, the data windows do not.  It decides the fused k
    of ``jacobi_multirhs``."""
    if tr is None:
        tr = dia_pp_tile(d)
    if not tr or tr < k * d.halo or k < 2:
        return False
    budget = _MAX_VMEM_BYTES // 4
    rows8 = _round_up(d.ndiags, 8)
    win_d = tr + 2 * (k - 1) * d.halo
    need = (n_rhs * (d.n_pad + 2 * tr)
            + (2 * rows8 + 2 * d.ndiags + 8) * win_d
            + n_rhs * (2 * tr + tr + 2 * k * d.halo))
    return need <= budget


# ---------------------------------------------------------------------------
# The CUDA entry points
# ---------------------------------------------------------------------------

_I64, _PTR, _INT = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "dia_spmv": [_PTR, _I64, _PTR, _INT, _PTR, _INT, _PTR, _I64, _I64, _PTR, _I64, _INT,
                 _PTR, _INT, _PTR],
    "dia_power": [_PTR, _I64, _PTR, _INT, _INT, _PTR, _PTR, _PTR, _I64, _INT,
                  ctypes.c_float, _INT, _INT, _INT, _PTR, _INT, _PTR],
    "dia_cheby": [_PTR, _I64, _PTR, _INT, _INT, _PTR, _PTR, _PTR, _PTR, _PTR,
                  _I64, _INT, ctypes.POINTER(ctypes.c_float), _INT, _INT, _INT,
                  _PTR, _INT, _PTR],
    "dia_fused_clusters": [_INT, _INT, _INT, _INT, _I64, ctypes.POINTER(_INT)],
    "dia_spmv_pp": [_PTR, _I64, _PTR, _INT, _PTR, _PTR, _I64, ctypes.c_float, _INT,
                    _INT, _PTR],
    "dia_power_rhs": [_PTR, _I64, _PTR, _INT, _PTR, _PTR, _PTR, _I64, _INT, _INT,
                      ctypes.c_float, _PTR, _INT, _PTR],
    "dia_spmm": [_PTR, _I64, _PTR, _INT, _PTR, _I64, _INT, _PTR, _INT, _INT, _PTR],
    "dia_spmm_t": [_PTR, _I64, _PTR, _INT, _PTR, _I64, _I64, _I64, _INT, _PTR, _INT, _PTR],
}
_LIBRARY = {"dia_spmm": "dia_spmm", "dia_spmm_t": "dia_rhs",
            "dia_power_rhs": "dia_rhs", "dia_spmv_pp": "dia_rhs"}   # else csrc/dia.cu
_SPMM_MAX_DIAGS = 1024  # K15 stages a block's diagonal words in shared memory
# The kernels' (diagonals, vectors) dtypes: the `types` code of the C entry
# points, and each instance's name in the wrappers' `type_launches`
_TYPES = {(torch.float32, torch.float32): 0, (torch.bfloat16, torch.float32): 1,
          (torch.bfloat16, torch.bfloat16): 2}
_TYPE_NAMES = ("float32", "bf16 diagonals, float32 vectors", "bf16")
_ELEMS = ((4, 4), (2, 4), (2, 2))   # element bytes (diagonals, vectors) by code


@functools.lru_cache(maxsize=None)
def _lib_fn(name: str):
    fn = getattr(_build.load(_LIBRARY.get(name, "dia")), name)
    fn.argtypes, fn.restype = _ARGTYPES[name], ctypes.c_int
    return fn


def _kernel_types(d: DIA, what: str, *bufs: torch.Tensor) -> int:
    """The ``types`` code of a kernel call: the diagonals float32 or bf16,
    every vector of the call of one dtype, float32, or bf16 with bf16
    diagonals; anything else raises."""
    vec = sorted({str(b.dtype) for b in bufs})
    code = _TYPES.get((d.data.dtype, bufs[0].dtype)) if len(vec) == 1 else None
    if code is None:
        raise ValueError(f"{what}: diagonals {d.data.dtype} with vectors {', '.join(vec)}: "
                         "the kernels take float32 or bfloat16 diagonals with float32 "
                         "vectors, or bfloat16 diagonals with bfloat16 vectors, every "
                         "vector of a call of one dtype")
    return code


def _check_cuda(d: DIA, what: str, *bufs: torch.Tensor) -> int:
    """The kernels take contiguous tensors on the diagonals' CUDA device of
    the dtypes ``_kernel_types`` allows.  Returns the ``types`` code."""
    for t in (d.data, *bufs):
        if t.device != d.data.device or t.device.type != "cuda":
            raise ValueError(f"{what}: every tensor must lie on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{what}: expected contiguous tensors, got {tuple(t.shape)} "
                             f"with strides {t.stride()}")
    code = _kernel_types(d, what, *bufs)
    if d.data.dim() != 2 or d.data.shape[0] != d.ndiags:
        raise ValueError(f"{what}: data {tuple(d.data.shape)} does not fit "
                         f"{d.ndiags} offsets")
    return code


def _promoted(d: DIA, x: torch.Tensor) -> torch.Tensor:
    """A vector in the dtype of the output, promote(diagonals, vector): a
    bf16 one given with float32 diagonals becomes float32."""
    return x.to(_out_dtype(d, x)) if x.dtype == torch.bfloat16 else x


def _count(fn, code: int) -> None:
    """One launch of ``fn``'s kernel, and of its ``code`` instance."""
    fn.launches += 1
    fn.type_launches[_TYPE_NAMES[code]] += 1


def _check_pp(d: DIA, what: str, *bufs: torch.Tensor, ndim: int = 1) -> int:
    """The ping-pong pad width P of same-layout buffers (P ≥ halo): [P +
    n_pad + P], or [K, P + n_pad + P] with ``ndim`` 2."""
    shape = bufs[0].shape
    p = (shape[-1] - d.n_pad) // 2
    if any(b.dim() != ndim or b.shape != shape for b in bufs) \
            or shape[-1] != d.n_pad + 2 * p or p < d.halo:
        raise ValueError(f"{what}: buffers must be {'[K, ' if ndim == 2 else '['}P + "
                         f"n_pad + P] with P >= halo ({d.halo}); got "
                         f"{[tuple(b.shape) for b in bufs]}")
    return p


# --- K12 / K13: fused or streamed (``csrc/dia.cu``'s header) ---------------

_FUSED_POWER, _FUSED_AFFINE, _FUSED_CHEBY = 0, 1, 2   # K12, K12 with add, K13
_FUSED_MAX_DIAGS = 9                 # wider matrices stream
_FUSED_CLUSTERS = (16, 8, 4, 2, 1)   # CTAs per cluster tried (16 is non-portable)
# Clusters an H100 SXM (132 SMs) holds at once by cluster size, one
# 1024-thread CTA per SM (cudaOccupancyMaxActiveClusters on the card): the
# rule's view where no card is asked (CPU tensors, tests); on the card
# `_card_active` asks.
_H100_ACTIVE = ((16, 7), (8, 15), (4, 30), (2, 66), (1, 132))
# The rule's cost model (µs, bytes), fitted on an H100 80GB HBM3 at 700 W
# to both modes' times over the fused launches `_fused_candidates` yields
# on float32.  The fused mode's staging bytes scale with the element sizes
# (its shared-memory words of a row update do not); a streamed pass costs
# as much on bf16 as on float32 words (measured there: 7.8-9.3 µs per pass
# of poisson1024's Jacobi M for all three instances, its loads and not its
# bytes bound it); a pass whose words exceed the L2 runs at the HBM rate
# (fitted on poisson2048's Jacobi M and a 9-point matrix of a 2048² grid,
# where the L2 rate had the rule stream float32 26% slower than fused).
# `chip_smoke.py` holds its picks to the faster mode
_STREAM_BYTES_PER_US = 3.16e6   # a streamed pass whose words fit in the L2
_STREAM_HBM_BYTES_PER_US = 2.7e6   # ... and one whose words do not
_L2_BYTES = 50e6                # an H100's L2
_STREAM_FIRST = 0.66            # the first pass's extra, in passes
_PASS_US = 1.9                  # least time of one streamed pass (a launch)
_HBM_BYTES_PER_US = 3.0e6       # the fused mode's staging, all SMs together
_SM_BYTES_PER_US = 2.5e4        # ... and one SM's
_LOAD_US = 0.5                  # latency of one staging round
_FUSED_US = 3.0                 # fixed cost of one fused launch
_BARRIER_US = 1.0               # per pass of a cluster of C > 1: the neighbours' rows
_WORD_US = 3.0e-5               # one shared-memory word of a row update, per CTA


@dataclasses.dataclass(frozen=True)
class FusedPlan:
    """One fused launch of K12 / K13: ``windows`` windows of ``cluster``
    CTAs owning ``rows`` rows each, walked by at most ``clusters`` clusters
    at once, ``smem`` bytes of shared memory per CTA, and the modeled times
    (µs) of both modes."""

    cluster: int
    rows: int
    clusters: int
    windows: int
    smem: int
    fused_us: float
    streamed_us: float


def _fused_align(elems) -> int:
    """Elements of one 16-byte staging copy of the narrower type: Rh, Hk,
    S and P are multiples of it (4 on float32, 8 where a type is bf16)."""
    return 16 // min(elems)


def _fused_geometry(kind: int, ndiags: int, k: int, reach: int, n_pad: int,
                    cluster: int, rows: int, elems=(4, 4)):
    """(output rows per window, windows, shared bytes per CTA) of a fused
    launch on (diagonal, vector) elements of ``elems`` bytes, as
    ``fused_launch`` in ``csrc/dia.cu`` computes them; None where the
    kernel cannot take it."""
    ed, ev = elems
    al = _fused_align(elems)
    rh, hk = _round_up(reach, al), _round_up((k - 1) * reach, al)
    out = cluster * rows - 2 * hk
    if not 2 <= k <= 32 or not 1 <= ndiags <= _FUSED_MAX_DIAGS or rows <= 0 or rows % al \
            or out <= 0 or (cluster > 1 and rows < rh):
        return None
    wb = rows + 2 * rh
    smem = 32 + ev * (3 * wb + kind * rows) + ed * ndiags * rows
    return out, -(-n_pad // out), smem


def _streamed_us(kind: int, ndiags: int, k: int, n_pad: int) -> float:
    """The cost model's streamed mode: k passes, each moving the diagonals
    and the words per row the pass reads from and writes to HBM (c for K12
    with add; r, dd for K13, partly from L2), at least ``_PASS_US`` each,
    and the first pass's extra reads; 4-byte words whatever the instance,
    at the L2 or the HBM rate by whether they fit in the L2."""
    nbytes = 4 * n_pad * (ndiags + (1.0, 2.0, 4.5)[kind])
    bytes_us = nbytes / (_STREAM_BYTES_PER_US if nbytes <= _L2_BYTES
                         else _STREAM_HBM_BYTES_PER_US)
    return k * max(bytes_us, _PASS_US) + _STREAM_FIRST * bytes_us


def _fused_us(kind: int, ndiags: int, k: int, reach: int, cluster: int, rows: int,
              windows: int, clusters: int, elems=(4, 4)) -> float:
    """The cost model's fused mode.  Per round of windows every launched CTA
    stages its rows (diagonals, aux, x and its halo) at its share of the
    HBM rate, at most one SM's rate, then runs the window's k passes: the
    row updates' shared-memory words (2·ndiags + 2 for K12, + 1 with c;
    2·ndiags + 5 for K13) or, in a cluster, at least the wait for the
    neighbours' rows."""
    ed, ev = elems
    launched = min(windows, clusters)
    rounds = -(-windows // launched)
    load = (rows * (ed * ndiags + ev * (kind + 1))
            + 2 * ev * _round_up(reach, _fused_align(elems))) \
        / min(_SM_BYTES_PER_US, _HBM_BYTES_PER_US / (launched * cluster)) + _LOAD_US
    update = 2 * ndiags + (2, 3, 5)[kind]
    passes = k * max(rows * update * _WORD_US, _BARRIER_US if cluster > 1 else 0.0)
    return _FUSED_US + rounds * (load + passes)


def _fused_candidates(kind: int, ndiags: int, k: int, reach: int, n_pad: int,
                      active, smem_bytes: int, elems=(4, 4)):
    """The fused launches `_fused_plan` weighs: for each cluster size C, the
    most rows per CTA that fit (S, a multiple of 32; the window C·S yields
    C·S − 2·(k−1)·R output rows, so wide reaches and large k need long
    windows), and as many windows as whole rounds of co-resident clusters
    hold, each as short as that allows."""
    if not 1 <= ndiags <= _FUSED_MAX_DIAGS:
        return
    ed, ev = elems
    al = _fused_align(elems)
    streamed = _streamed_us(kind, ndiags, k, n_pad)
    rh, hk = _round_up(reach, al), _round_up((k - 1) * reach, al)
    # 32 + ev·(3·(S + 2Rh) + kind·S) + ed·ndiags·S bytes
    most = (smem_bytes - 32 - 6 * ev * rh) // (ev * (3 + kind) + ed * ndiags) // 32 * 32
    for cluster, clusters in active:
        geom = _fused_geometry(kind, ndiags, k, reach, n_pad, cluster, most, elems) \
            if clusters > 0 else None
        if geom is None:
            continue
        rounds = -(-geom[1] // clusters)
        per_window = -(-n_pad // (rounds * clusters))
        rows = max(_round_up(-(-(per_window + 2 * hk) // cluster), 32),
                   _round_up(rh, 32) if cluster > 1 else 32)
        for r in dict.fromkeys((most, min(rows, most))):
            _, windows, smem = _fused_geometry(kind, ndiags, k, reach, n_pad, cluster, r,
                                               elems)
            yield FusedPlan(cluster=cluster, rows=r, clusters=clusters, windows=windows,
                            smem=smem,
                            fused_us=_fused_us(kind, ndiags, k, reach, cluster, r,
                                               windows, clusters, elems),
                            streamed_us=streamed)


@functools.lru_cache(maxsize=4096)
def _fused_plan(kind: int, ndiags: int, k: int, reach: int, n_pad: int,
                active=_H100_ACTIVE, smem_bytes: int = _SMEM_BYTES, elems=(4, 4)):
    """The selection between K12's / K13's two modes: the fused launch of
    ``_fused_candidates`` the cost model times fastest, or None (the
    streamed mode).  It depends on the kind, ndiags (at most 9 fuse), k,
    the reach R, n_pad and the element bytes of (diagonals, vectors), and
    on the card through ``active`` ((cluster size, co-resident clusters)
    pairs) and ``smem_bytes`` (one CTA's shared memory; 0 forces the
    streamed mode).  A shape goes to the fused mode only where a window
    fits and the model times it below the streamed mode."""
    if k < 2:
        return None
    best = min(_fused_candidates(kind, ndiags, k, reach, n_pad, active, smem_bytes, elems),
               key=lambda c: c.fused_us, default=None)
    return best if best is not None and best.fused_us < best.streamed_us else None


@functools.lru_cache(maxsize=256)
def _card_active(kind: int, ndiags: int, device: torch.device, types: int = 0):
    """``_fused_plan``'s ``active`` for this card: cudaOccupancyMaxActiveClusters
    of the kernel that would run (its kind, ndiags and ``types``), at each
    cluster size, at the most shared memory a CTA may take (none for more
    than 9 diagonals)."""
    if not 1 <= ndiags <= _FUSED_MAX_DIAGS:
        return ()
    fn = _lib_fn("dia_fused_clusters")
    out = []
    with torch.cuda.device(device):
        for cluster in _FUSED_CLUSTERS:
            n = ctypes.c_int(0)
            _build.check(fn(kind, ndiags, types, cluster, _SMEM_BYTES_MAX, ctypes.byref(n)),
                         "dia_fused_clusters")
            out.append((cluster, n.value))
    return tuple(out)


def _fused_for(kind: int, d: DIA, k: int, p: int, staged, types: int = 0) \
        -> "FusedPlan | None":
    """This call's fused plan, or None (streamed): the 16-byte staging copies
    need P a multiple of ``_fused_align`` and the staged buffers 16-byte
    aligned."""
    elems = _ELEMS[types]
    if k < 2 or _SMEM_BYTES <= 0 or p % _fused_align(elems) \
            or any(t.data_ptr() % 16 for t in (d.data, *staged)):
        return None
    return _fused_plan(kind, d.ndiags, k, d.reach, d.n_pad,
                       _card_active(kind, d.ndiags, d.data.device, types), _SMEM_BYTES,
                       elems)


def _plan_args(plan) -> Tuple[int, int, int]:
    """(cluster, rows, clusters) of the C entry; rows 0 streams."""
    return (plan.cluster, plan.rows, plan.clusters) if plan else (0, 0, 0)


def _scratch(like: torch.Tensor, n_pad: int, rows: int, k: int):
    """The streamed mode's [n_pad] ping-pong buffer (None when unused)."""
    return torch.empty((n_pad,), dtype=like.dtype, device=like.device) \
        if rows == 0 and k > 1 else None


def _flags(d: DIA) -> torch.Tensor:
    """``d.flags``, made on the device where ``d`` was made without them
    (K8's rule took the rows path) or ``d.data`` was written in place since
    they were made (its version counter moved; an inference tensor keeps
    none, so its flags are made at every call).  Flags made while a CUDA
    graph is captured hold their values only in its replays, so they are
    not kept on ``d``."""
    version = _data_version(d.data)
    if d.flags is not None and version is not None and version == d.flags_version:
        return d.flags
    flags = _segment_flags(d.data)
    if not (d.data.is_cuda and torch.cuda.is_current_stream_capturing()):
        object.__setattr__(d, "flags", flags)
        object.__setattr__(d, "flags_version", version)
    return flags


def _check_flags(d: DIA, flags: torch.Tensor, what: str) -> None:
    """K8 reads [ceil(n_pad / _FLAG_ROWS), ndiags] contiguous uint8 flags,
    one per tile of ``_FLAG_ROWS`` rows (the kernel refuses another tile
    height); ``_segment_flags`` makes them on the diagonals' device."""
    shape = (-(-d.data.shape[1] // _FLAG_ROWS), len(d.offsets))
    if flags.shape != shape or flags.dtype != torch.uint8 or not flags.is_contiguous():
        raise ValueError(f"{what}: segment flags {flags.dtype} {tuple(flags.shape)}; the "
                         f"kernel reads contiguous uint8 {shape}")


# (n0, s): K8 takes its skip path on ndiags diagonals where fewer than
# s·(1 − n0 / ndiags) of the segments hold an entry (fitted on an H100 by
# examples/k8_paths_torch.py; PERF.md)
_K8_SKIP_RULE = (6, 0.32)


def _k8_share(d: DIA) -> float:
    """The share of ``d``'s segments that hold an entry, from host fields:
    ``d.seg_share`` where its maker gave it, else nnz / (ndiags·n), the
    least it can be (a share of single words scattered over many segments
    is far larger)."""
    if d.seg_share is not None:
        return d.seg_share
    return d.nnz / max(d.ndiags * d.n, 1)


def _k8_skips(d: DIA) -> bool:
    """Whether K8 takes its skip path (``csrc/dia.cu``'s header) on ``d``,
    from host fields (no sync, also inside a capture): a band whose
    segments mostly hold only zeros.  A dense band reads every word at the
    bandwidth on the rows path, with no scan of x first, and a narrow one
    (at most n0 diagonals) reads too few words a row there for the skip
    path's scan and lists to pay."""
    n0, below = _K8_SKIP_RULE
    return d.ndiags > n0 and _k8_share(d) < below * (1 - n0 / d.ndiags)


def _k8(d: DIA, x: torch.Tensor, base: int, lo: int, hi: int, rows: int,
        code: int) -> torch.Tensor:
    """Launch K8: y[i] = Σ_s data[s, i]·x[base + i + off_s] for i < rows,
    reading x[base + j] only for lo ≤ j < hi (zero elsewhere); on the skip
    path the diagonals only in the segments ``d.flags`` sets.  y has x's
    dtype."""
    skip = _k8_skips(d) and hi > lo
    flags = nonfinite = None
    if skip:
        flags = _flags(d)
        _check_flags(d, flags, "spmv_dia")
        nonfinite = torch.empty((-(-(hi - lo) // 32),), dtype=torch.uint8, device=x.device)
    y = torch.empty((rows,), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _build.check(_lib_fn("dia_spmv")(
        d.data.data_ptr(), d.n_pad, d.offsets_t.data_ptr(), d.ndiags,
        None if flags is None else flags.data_ptr(), _FLAG_ROWS,
        x.data_ptr() + x.element_size() * base, lo, hi, y.data_ptr(), rows, int(skip),
        None if nonfinite is None else nonfinite.data_ptr(), code, stream), "spmv_dia")
    _count(spmv_dia, code)
    spmv_dia.path_launches["skip" if skip else "rows"] += 1
    return y


def _spmv_fwd(d: DIA, x: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":
        return spmv_dia_ref(d, x)
    x = _promoted(d, x)
    code = _check_cuda(d, "spmv_dia", x)
    if x.dim() != 1 or x.shape[0] != d.n:
        raise ValueError(f"spmv_dia: x {tuple(x.shape)} for n = {d.n}")
    return _k8(d, x, 0, 0, d.n, d.n, code)


def spmv_dia_padded(d: DIA, xp: torch.Tensor) -> torch.Tensor:
    """SpMV on an already-padded [P + n_pad + P] x buffer (P ≥ halo, the
    halo width for ``dia_pad_x``); returns [n_pad] in promote(diagonals,
    x).  K8 on CUDA tensors."""
    if xp.device.type == "cpu":
        return spmv_dia_padded_ref(d, xp)
    xp = _promoted(d, xp)
    code = _check_cuda(d, "spmv_dia_padded", xp)
    p = _check_pp(d, "spmv_dia_padded", xp)
    return _k8(d, xp, p, -p, d.n_pad + p, d.n_pad, code)


class _SpmvDia(torch.autograd.Function):
    """K8 forward; backward (``_spmv_bwd``, dia.py:1837-1849) is K8 on Aᵀ
    for x and an elementwise product for the diagonals (both in the
    cotangent's dtype; autograd casts the diagonals' gradient to theirs)."""

    @staticmethod
    def forward(ctx, data, x, d):
        ctx.d = d
        ctx.save_for_backward(x)
        return _spmv_fwd(d, x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        d = ctx.d
        g = g.contiguous()
        dx = spmv_dia(dia_transpose(d), g) if ctx.needs_input_grad[1] else None
        ddata = None
        if ctx.needs_input_grad[0]:
            h, n = d.halo, d.n
            xp = _pad_x(d, x)
            ddata = torch.stack([
                torch.nn.functional.pad(g[:n] * xp[h + off:h + off + n],
                                        (0, d.n_pad - n))
                for off in d.offsets])
        return ddata, dx, None


def spmv_dia(d: DIA, x: torch.Tensor) -> torch.Tensor:
    """y = A·x for DIA A ([n] → [n], dtype promote(diagonals, x)),
    differentiable in x and the diagonals.  K8 (``csrc/dia.cu``) on CUDA
    tensors, ``spmv_dia_ref`` on CPU tensors."""
    return _SpmvDia.apply(d.data, x, d)


def spmv_dia_power(d: DIA, datak: torch.Tensor, xq: torch.Tensor,
                   zq: torch.Tensor, scale: float = 1.0, k: int = 2,
                   add: torch.Tensor | None = None) -> torch.Tensor:
    """z = scaleᵏ·Aᵏ·x, or with ``add`` (same layout) k affine passes
    ``cur ← scale·A·cur + add`` (k weighted-Jacobi sweeps when A is the
    iteration matrix): one read of the diagonals for k applies.  Buffers
    are [P + n_pad + P] (``dia_pad_pp``) with zero halo blocks; P comes
    from their shape; each pass is rounded to their dtype.  Writes zq's
    interior in place (zq must not be xq) and returns zq.  K12
    (``csrc/dia.cu``) on CUDA tensors, ``spmv_dia_power_ref`` on CPU
    tensors; ``datak`` is not read."""
    del datak
    if xq.device.type == "cpu":
        return spmv_dia_power_ref(d, xq, zq, scale=scale, k=k, add=add)
    bufs = (xq, zq) if add is None else (xq, zq, add)
    code = _check_cuda(d, "spmv_dia_power", *bufs)
    p = _check_pp(d, "spmv_dia_power", *bufs)
    if zq.data_ptr() == xq.data_ptr() or k < 1:
        raise ValueError("spmv_dia_power: zq must be another buffer than xq, k >= 1")
    plan = _fused_for(_FUSED_POWER if add is None else _FUSED_AFFINE, d, k, p,
                      (xq,) if add is None else (xq, add), code)
    tmp = _scratch(xq, d.n_pad, plan.rows if plan else 0, k)
    stream = torch.cuda.current_stream(xq.device).cuda_stream
    _build.check(_lib_fn("dia_power")(
        d.data.data_ptr(), d.n_pad, d.offsets_t.data_ptr(), d.ndiags, d.reach,
        xq.data_ptr(), None if add is None else add.data_ptr(), zq.data_ptr(),
        p, k, float(scale), *_plan_args(plan), None if tmp is None else tmp.data_ptr(),
        code, stream), "spmv_dia_power")
    _count(spmv_dia_power, code)
    spmv_dia_power.mode_launches["fused" if plan else "streamed"] += 1
    return zq


def spmv_dia_cheby(d: DIA, datak: torch.Tensor, zq: torch.Tensor,
                   ddq: torch.Tensor, rq: torch.Tensor, z_dead: torch.Tensor,
                   dd_dead: torch.Tensor, coeffs, k: int):
    """Fused k Chebyshev semi-iteration steps with static per-pass
    ``(aₚ, bₚ)``: ``dd ← aₚ·dd + bₚ·(r − A·z); z ← z + dd``, dd and z
    rounded to the buffers' dtype at every pass.  All buffers in the
    ``dia_pad_pp`` layout; writes ``(z_out, dd_out)`` into the interiors of
    ``z_dead`` / ``dd_dead`` and returns them.  K13 (``csrc/dia.cu``) on
    CUDA tensors, ``spmv_dia_cheby_ref`` on CPU tensors; ``datak`` is not
    read."""
    del datak
    coeffs = tuple(coeffs)
    if zq.device.type == "cpu":
        return spmv_dia_cheby_ref(d, zq, ddq, rq, z_dead, dd_dead, coeffs, k)
    bufs = (zq, ddq, rq, z_dead, dd_dead)
    code = _check_cuda(d, "spmv_dia_cheby", *bufs)
    p = _check_pp(d, "spmv_dia_cheby", *bufs)
    k = len(coeffs)
    if not 1 <= k <= 32 or len({z_dead.data_ptr(), dd_dead.data_ptr(),
                                zq.data_ptr(), ddq.data_ptr()}) != 4:
        raise ValueError("spmv_dia_cheby: 1..32 coefficient pairs, and outputs "
                         "in buffers other than the inputs")
    plan = _fused_for(_FUSED_CHEBY, d, k, p, (zq, ddq, rq), code)
    tmp = _scratch(zq, d.n_pad, plan.rows if plan else 0, k)
    cf = (ctypes.c_float * (2 * k))(*(float(v) for ab in coeffs for v in ab))
    stream = torch.cuda.current_stream(zq.device).cuda_stream
    _build.check(_lib_fn("dia_cheby")(
        d.data.data_ptr(), d.n_pad, d.offsets_t.data_ptr(), d.ndiags, d.reach,
        zq.data_ptr(), ddq.data_ptr(), rq.data_ptr(), z_dead.data_ptr(),
        dd_dead.data_ptr(), p, k, cf, *_plan_args(plan),
        None if tmp is None else tmp.data_ptr(), code, stream), "spmv_dia_cheby")
    _count(spmv_dia_cheby, code)
    spmv_dia_cheby.mode_launches["fused" if plan else "streamed"] += 1
    return z_dead, dd_dead


def _spmv_pp(d: DIA, xq: torch.Tensor, yq: torch.Tensor, scale: float,
             zero_halo: bool, what: str) -> int:
    """Launch ``dia_spmv_pp`` (K10 with ``zero_halo``, else K11: one
    launch of ``csrc/dia_rhs.cu``'s row-tile kernel on one right-hand side:
    its 16-byte instance where the buffers and the diagonals lie on 16-byte
    boundaries, n_pad and P are multiples of 4 float32 or 8 bf16 vector
    elements and its blocks fill the card, else one row a thread, with the
    same sums); returns the ``types`` code."""
    code = _check_cuda(d, what, xq, yq)
    p = _check_pp(d, what, xq, yq)
    if yq.data_ptr() == xq.data_ptr():
        raise ValueError(f"{what}: the output must be another buffer than xq")
    stream = torch.cuda.current_stream(xq.device).cuda_stream
    _build.check(_lib_fn("dia_spmv_pp")(
        d.data.data_ptr(), d.n_pad, d.offsets_t.data_ptr(), d.ndiags, xq.data_ptr(),
        yq.data_ptr(), p, float(scale), int(zero_halo), code, stream), what)
    return code


def spmv_dia_padded_io(d: DIA, xq: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """y = scale·A·x on a ``dia_pad_io`` buffer, returned as a new buffer
    in the same [P + n_pad + P] layout (dtype promote(diagonals, x)) with
    its halo blocks zero, so chained applies never repack.  K10
    (``csrc/dia_rhs.cu``, whose launch writes the halo blocks too) on CUDA
    tensors, ``spmv_dia_padded_io_ref`` on CPU tensors."""
    if xq.device.type == "cpu":
        return spmv_dia_padded_io_ref(d, xq, scale)
    xq = _promoted(d, xq)
    yq = torch.empty_like(xq)
    _count(spmv_dia_padded_io, _spmv_pp(d, xq, yq, scale, True, "spmv_dia_padded_io"))
    return yq


def spmv_dia_pingpong(d: DIA, xq: torch.Tensor, yq: torch.Tensor,
                      scale: float = 1.0) -> torch.Tensor:
    """y = scale·A·x written into ``yq``'s interior in place, both buffers
    in the ``dia_pad_pp`` layout with zero halo blocks, which are never
    written; returns yq.  Chained callers swap the two buffers::

        y = spmv_dia_pingpong(d, x, y); x, y = y, x

    K11 (``csrc/dia_rhs.cu``) on CUDA tensors, ``spmv_dia_pingpong_ref`` on
    CPU tensors."""
    if xq.device.type == "cpu":
        return spmv_dia_pingpong_ref(d, xq, yq, scale)
    _count(spmv_dia_pingpong, _spmv_pp(d, xq, yq, scale, False, "spmv_dia_pingpong"))
    return yq


def spmv_dia_power_rhs(d: DIA, datak, xq: torch.Tensor, zq: torch.Tensor,
                       scale: float = 1.0, k: int = 2,
                       add: torch.Tensor | None = None) -> torch.Tensor:
    """Multi-RHS ``spmv_dia_power``: Z = scaleᵏ·Aᵏ·X for the K rows of X in
    the ``dia_pad_pp_rhs`` layout [K, P + n_pad + P], or k affine passes
    with ``add`` (per-RHS constants, same layout), each pass rounded to the
    buffers' dtype.  Writes zq's interior in place (zq must not be xq) and
    returns zq.  K14 (``csrc/dia_rhs.cu``) on CUDA tensors, any k ≥ 1,
    ``spmv_dia_power_rhs_ref`` on CPU tensors; ``datak`` is not read."""
    del datak
    if xq.device.type == "cpu":
        return spmv_dia_power_rhs_ref(d, xq, zq, scale=scale, k=k, add=add)
    bufs = (xq, zq) if add is None else (xq, zq, add)
    code = _check_cuda(d, "spmv_dia_power_rhs", *bufs)
    p = _check_pp(d, "spmv_dia_power_rhs", *bufs, ndim=2)
    if zq.data_ptr() == xq.data_ptr() or k < 1:
        raise ValueError("spmv_dia_power_rhs: zq must be another buffer than xq, k >= 1")
    n_rhs = xq.shape[0]
    # k passes of the row-tile kernel, through a scratch buffer when k > 1
    tmp = torch.empty((n_rhs, d.n_pad), dtype=xq.dtype, device=xq.device) \
        if k > 1 else None
    stream = torch.cuda.current_stream(xq.device).cuda_stream
    _build.check(_lib_fn("dia_power_rhs")(
        d.data.data_ptr(), d.n_pad, d.offsets_t.data_ptr(), d.ndiags,
        xq.data_ptr(), None if add is None else add.data_ptr(), zq.data_ptr(), p,
        n_rhs, k, float(scale), None if tmp is None else tmp.data_ptr(), code, stream),
        "spmv_dia_power_rhs")
    _count(spmv_dia_power_rhs, code)
    return zq


def spmm_dia(d: DIA, x: torch.Tensor) -> torch.Tensor:
    """Y = A·X for dense X [n, K] (any K) → [n, K], dtype promote(diagonals,
    X).  K15 (``csrc/dia_spmm.cu``) on CUDA tensors, ``spmm_dia_ref`` on
    CPU tensors.  The kernel moves X and Y four columns at a time (16
    bytes of float32, 8 of bf16) when K is a multiple of 4 and X and Y are
    aligned to that, else word by word."""
    if x.device.type == "cpu":
        return spmm_dia_ref(d, x)
    x = _promoted(d, x)
    code = _check_cuda(d, "spmm_dia", x)
    if x.dim() != 2 or x.shape[0] != d.n or d.ndiags > _SPMM_MAX_DIAGS:
        raise ValueError(f"spmm_dia: X {tuple(x.shape)} for n = {d.n}, and at most "
                         f"{_SPMM_MAX_DIAGS} diagonals ({d.ndiags})")
    y = torch.empty_like(x)
    K = x.shape[1]
    quad = 4 * x.element_size()
    vec = K % 4 == 0 and x.data_ptr() % quad == 0 and y.data_ptr() % quad == 0
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _build.check(_lib_fn("dia_spmm")(
        d.data.data_ptr(), d.n_pad, d.offsets_t.data_ptr(), d.ndiags, x.data_ptr(),
        d.n, K, y.data_ptr(), int(vec), code, stream), "spmm_dia")
    _count(spmm_dia, code)
    return y


def spmm_dia_t_padded(d: DIA, xtp: torch.Tensor) -> torch.Tensor:
    """Transposed-RHS SpMM on a ``dia_pad_xt`` buffer [K_pad, h + n_pad +
    h] (any K_pad): Yt[k, i] = Σ_s data[s, i]·Xt[k, i + off_s] → [K_pad,
    n_pad], dtype promote(diagonals, Xt).  K16 (``csrc/dia_rhs.cu``) on
    CUDA tensors, ``spmm_dia_t_padded_ref`` on CPU tensors."""
    if xtp.device.type == "cpu":
        return spmm_dia_t_padded_ref(d, xtp)
    xtp = _promoted(d, xtp)
    if xtp.dim() != 2 or xtp.shape[1] != d.n_pad + 2 * d.halo:
        raise ValueError(f"spmm_dia_t_padded: buffer {tuple(xtp.shape)} is not "
                         f"[K_pad, {d.halo} + {d.n_pad} + {d.halo}]")
    return _k16(d, xtp, d.halo, "spmm_dia_t_padded")


def _k16(d: DIA, xt: torch.Tensor, h: int, what: str) -> torch.Tensor:
    """K16 on a [K, h + n_pad + h] buffer (h = 0: unpadded), read as zero
    outside it; counted on ``spmm_dia_t_padded``."""
    code = _check_cuda(d, what, xt)
    if xt.shape[0] < 1:
        raise ValueError(f"{what}: at least one right-hand side")
    yt = torch.empty((xt.shape[0], d.n_pad), dtype=xt.dtype, device=xt.device)
    stream = torch.cuda.current_stream(xt.device).cuda_stream
    _build.check(_lib_fn("dia_spmm_t")(
        d.data.data_ptr(), d.n_pad, d.offsets_t.data_ptr(), d.ndiags,
        xt.data_ptr() + xt.element_size() * h, xt.shape[1], -h, d.n_pad + h, xt.shape[0],
        yt.data_ptr(), code, stream), what)
    _count(spmm_dia_t_padded, code)
    return yt


def spmm_dia_t_rows(d: DIA, xt: torch.Tensor) -> torch.Tensor:
    """K16 on an unpadded [K, n_pad] buffer, read as zero outside [0,
    n_pad): the values of ``spmm_dia_t_padded`` on the buffer padded with
    zero halos, without the padded copy → [K, n_pad], dtype
    promote(diagonals, Xt).  Its launches count on
    ``spmm_dia_t_padded``."""
    if xt.device.type == "cpu":
        return spmm_dia_t_padded_ref(d, torch.nn.functional.pad(xt, (d.halo, d.halo)))
    xt = _promoted(d, xt)
    if xt.dim() != 2 or xt.shape[1] != d.n_pad:
        raise ValueError(f"spmm_dia_t_rows: buffer {tuple(xt.shape)} is not [K, {d.n_pad}]")
    return _k16(d, xt, 0, "spmm_dia_t_rows")


def spmm_dia_t(d: DIA, xt: torch.Tensor) -> torch.Tensor:
    """Yt = (A·X)ᵀ for the right-hand sides in [K, n] layout → [K, n],
    dtype promote(diagonals, Xt): K16 on a buffer of ``dia_pad_xt``'s
    layout in that dtype (``dia_pad_xt`` itself rounds to the diagonals'
    dtype, as JAX's does) on CUDA tensors, ``spmm_dia_t_ref`` on CPU
    tensors."""
    if xt.device.type == "cpu":
        return spmm_dia_t_ref(d, xt)
    return spmm_dia_t_padded(d, _pad_xt(d, xt, _out_dtype(d, xt)))[:xt.shape[0], :d.n]


def _launch_counters(fn, modes: bool = False) -> None:
    fn.launches = 0
    fn.type_launches = dict.fromkeys(_TYPE_NAMES, 0)   # by (diagonals, vectors) dtypes
    if modes:
        fn.mode_launches = {"fused": 0, "streamed": 0}    # K12's / K13's by mode


for _fn in (spmv_dia, spmv_dia_padded_io, spmv_dia_pingpong, spmv_dia_power_rhs, spmm_dia,
            spmm_dia_t_padded):
    _launch_counters(_fn)
for _fn in (spmv_dia_power, spmv_dia_cheby):
    _launch_counters(_fn, modes=True)
spmv_dia.path_launches = {"rows": 0, "skip": 0}    # K8's by path (``_k8_skips``)
