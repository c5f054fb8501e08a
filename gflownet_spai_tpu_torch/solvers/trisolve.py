"""Level-scheduled sparse triangular solves (counterpart of
``gflownet_spai_tpu/solvers/trisolve.py``).

A host-side topological analysis groups rows into dependency levels; each
level then solves in one gather · ``index_add_`` · scatter step on the
device.  Per factor the form is picked as in JAX: bidiagonal factors run
as a first-order linear recurrence (``ops.scan.linear_scan``, O(log n)
passes); up to 64 levels run the per-level ("unrolled") schedule; more
run the uniformly padded ("looped") schedule, one step shape per level.
"""

from __future__ import annotations

from functools import partial
from typing import List, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..ops.scan import linear_scan
from ..sparse.convert import coo_to_scipy
from ..sparse.types import COO
from .linop import LinOp

_UNROLL_MAX_LEVELS = 64


class TriSolvePlan:
    """Host-built schedule for ``L x = b`` (lower=True) or ``U x = b``;
    the level arrays live on ``device``."""

    def __init__(self, t: COO, lower: bool = True, unit_diagonal: bool = False,
                 device=None):
        device = resolve_device(device)
        T = coo_to_scipy(t).tocsr()
        n = T.shape[0]
        indptr, indices, data = T.indptr, T.indices, T.data
        self.n, self.lower, self.unit, self.device = n, lower, unit_diagonal, device

        order = range(n) if lower else range(n - 1, -1, -1)
        level = np.zeros(n, np.int64)
        for i in order:
            deps = indices[indptr[i]:indptr[i + 1]]
            deps = deps[deps < i] if lower else deps[deps > i]
            if len(deps):
                level[i] = level[deps].max() + 1
        self.num_levels = int(level.max()) + 1 if n else 0

        diag = np.ones(n, data.dtype)
        if not unit_diagonal:
            for i in range(n):
                row = slice(indptr[i], indptr[i + 1])
                dpos = np.nonzero(indices[row] == i)[0]
                if len(dpos) == 0 or data[row][dpos[0]] == 0.0:
                    raise ZeroDivisionError(f"zero diagonal at row {i}")
                diag[i] = data[row][dpos[0]]

        # host copies: (rows, entry row-in-level, entry col, entry value, diag)
        self._host: List[Tuple[np.ndarray, ...]] = []
        for lev in range(self.num_levels):
            rows = np.nonzero(level == lev)[0]
            ent_r, ent_c, ent_v = [], [], []
            for k, i in enumerate(rows):
                row = slice(indptr[i], indptr[i + 1])
                cols, vals = indices[row], data[row]
                off = (cols < i) if lower else (cols > i)
                ent_r.extend([k] * off.sum())
                ent_c.extend(cols[off])
                ent_v.extend(vals[off])
            self._host.append((rows.astype(np.int64), np.asarray(ent_r, np.int64),
                               np.asarray(ent_c, np.int64),
                               np.asarray(ent_v, data.dtype), diag[rows]))
        as_t = lambda a: torch.as_tensor(a, device=device)
        self.levels = [tuple(as_t(a) for a in lev) for lev in self._host]
        self.dtype = data.dtype

    def bidiagonal(self):
        """(sub_or_sup, diag) tensors when every row's off-diagonal
        dependency set is exactly {i−1} (lower) / {i+1} (upper) or empty —
        the linear-recurrence path (None otherwise)."""
        sub = np.zeros(self.n, self.dtype)
        diag = np.ones(self.n, self.dtype)
        for rows, er, ec, ev, dg in self._host:
            diag[rows] = dg
            if len(er) == 0:
                continue
            if len(np.unique(er)) != len(er):       # >1 dep on some row
                return None
            if not np.array_equal(ec, rows[er] + (-1 if self.lower else 1)):
                return None
            sub[rows[er]] = ev
        as_t = lambda a: torch.as_tensor(a, device=self.device)
        return as_t(sub), as_t(diag)

    def padded(self):
        """Uniform [num_levels, W]-padded level tensors for the looped
        solve (padding rows scatter to slot n, padding entries to row W)."""
        n, L = self.n, len(self._host)
        wr = max([len(h[0]) for h in self._host] + [1])
        we = max([len(h[1]) for h in self._host] + [1])
        rows = np.full((L, wr), n, np.int64)
        er = np.full((L, we), wr, np.int64)
        ec = np.zeros((L, we), np.int64)
        ev = np.zeros((L, we), self.dtype)
        dg = np.ones((L, wr), self.dtype)
        for i, (r, e_r, e_c, e_v, d) in enumerate(self._host):
            rows[i, :len(r)] = r
            dg[i, :len(r)] = d
            er[i, :len(e_r)] = e_r
            ec[i, :len(e_c)] = e_c
            ev[i, :len(e_v)] = e_v
        as_t = lambda a: torch.as_tensor(a, device=self.device)
        return tuple(as_t(a) for a in (rows, er, ec, ev, dg))

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        return _levels_solve(self.levels, b)


def _levels_solve(levels, b: torch.Tensor) -> torch.Tensor:
    """The per-level schedule, computed in the promoted dtype of the
    factor and b, stored in b's dtype (as JAX's scatter into ``x`` does)."""
    x = torch.zeros_like(b)
    for rows, er, ec, ev, dg in levels:
        prod = ev * x[ec]
        acc = prod.new_zeros((rows.shape[0],)).index_add_(0, er, prod)
        x[rows] = ((b[rows] - acc) / dg.to(b.dtype)).to(b.dtype)
    return x


def _looped_levels_solve(padded, b: torch.Tensor) -> torch.Tensor:
    """The padded schedule in b's dtype: one step shape for every level
    (slot n absorbs padding rows, segment W padding entries)."""
    rows_a, er_a, ec_a, ev_a, dg_a = padded
    n, wr = b.shape[0], rows_a.shape[1]
    x = b.new_zeros((n + 1,))
    bp = torch.nn.functional.pad(b, (0, 1))
    for rows, er, ec, ev, dg in zip(rows_a, er_a, ec_a, ev_a, dg_a):
        prod = ev.to(b.dtype) * x[ec]
        acc = prod.new_zeros((wr + 1,)).index_add_(0, er, prod)[:wr]
        x[rows] = (bp[rows] - acc) / dg.to(b.dtype)
    return x[:n]


def _bidiag_solve(data, b: torch.Tensor, *, lower: bool) -> torch.Tensor:
    """x_i = (b_i − sub_i·x_{i∓1})/diag_i: the recurrence
    h_t = a_t·h_{t−1} + c_t with a = −sub/diag, c = b/diag (upper solves
    run on the reversed arrays)."""
    sub, diag = data
    s, d, bb = sub.to(b.dtype), diag.to(b.dtype), b
    if not lower:
        s, d, bb = s.flip(0), d.flip(0), b.flip(0)
    a = -s / d
    a[0] = 0.0
    x = linear_scan(a, bb / d)
    return x if lower else x.flip(0)


def _tri_apply_fns(plan: TriSolvePlan):
    """(fn, data) of one triangular solve: bidiagonal recurrence →
    per-level schedule → padded schedule."""
    bi = plan.bidiagonal()
    if bi is not None:
        return partial(_bidiag_solve, lower=plan.lower), bi
    if plan.num_levels <= _UNROLL_MAX_LEVELS:
        return _levels_solve, plan.levels
    return _looped_levels_solve, plan.padded()


def _ilu_two_solve_apply(data, x, *, fl, fu):
    dl, du = data
    return fu(du, fl(dl, x))


def sparse_ilu_solve_op(L: COO, U: COO, max_levels: int | None = None,
                        device=None):
    """x ↦ U⁻¹ L⁻¹ x with sparse triangular solves, as a LinOp; each
    factor takes its best form.  ``max_levels``: return None past that
    level count (the dense-fallback callers' cap)."""
    pl_ = TriSolvePlan(L, lower=True, device=device)
    pu = TriSolvePlan(U, lower=False, device=device)
    if max_levels is not None and max(pl_.num_levels, pu.num_levels) > max_levels:
        return None
    fl, dl = _tri_apply_fns(pl_)
    fu, du = _tri_apply_fns(pu)
    return LinOp(data=(dl, du), fn=partial(_ilu_two_solve_apply, fl=fl, fu=fu),
                 info={"levels": (pl_.num_levels, pu.num_levels)})
