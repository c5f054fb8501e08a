"""Compare the multi-right-hand-side DIA kernels (K14, K16) of several
checkouts of the port on one card: device time and output bits on every
K14 and K16 case of `chip_smoke.py`'s `[dia-multi]`, and the ms per sweep
and per iteration of its `[multirhs]` solvers.

    python examples/k14_k16_compare_torch.py TREE [TREE ...]

Each TREE is the root of a checkout (for another commit: `git archive`
into a directory that `.gitignore` lists).  The trees run one at a time,
each in a process of its own, in the order given and then in reverse (A,
B, B, A for two), so that every tree is timed on either side of the
others.  Cases, at `[dia-multi]`'s seeds and shapes:

- K16 on poisson1024 at `cg_multi`'s A (K_pad 16) in the three (diagonal,
  vector) instances (float32; bf16 diagonals with float32 vectors; bf16
  with bf16), through `spmm_dia_t_padded` and `spmm_dia_t` (and, where
  the tree has it, `spmm_dia_t_rows` on the unpadded rows, whose hash must
  be the padded entry's), on its Jacobi M (1 diagonal) and at K 256;
- K14 on poisson1024's Jacobi matrix, 16 right-hand sides, k 1, affine,
  in the three instances; at k 8 on poisson512 with 2 right-hand sides
  and on poisson128 with 16, in the mode the tree picks and, on a tree
  that still has a tiled mode (`_rhs_tile_rows`), in the tiled and the
  streamed mode forced.

A line per tree and case gives the graph-replay time over cold copies of
the inputs (as `chip_smoke.py`'s `_timed`), a hash of the output (equal
between trees whose kernels give the same bits) and whether a second
launch gave the same bits.  Then `jacobi_multirhs` (100 sweeps) and
`cg_multi` (plain and with the Jacobi M, rtol 1e-5) on poisson1024 with 16
right-hand sides: sweeps or iterations, the host clock's ms per sweep or
iteration over three runs (the first cold), and the device ms per sweep or
iteration of a fourth run under `torch.profiler` (all kernels, and K14's /
K16's).  Needs a CUDA card and `nvcc`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

from k8_compare_torch import COLD_BYTES, _bits, _digest, _graph_ms  # noqa: E402

POISSON, MULTI_K, SPMM_K = 1024, 16, 256
RUNS = 3                    # host-clock runs of each solver (the first cold)
K14_NAMES = ("dia_spmv_rhs_kernel", "dia_power_rhs_kernel", "dia_rhs_kernel")
K16_NAMES = ("dia_spmm_t_kernel", "dia_rhs_kernel")


@contextlib.contextmanager
def _mode(dia, tiled):
    """K14's k > 1 mode forced on a tree that has two: tiled (where a tile
    fits) or streamed; None leaves the tree's own."""
    saved = dia._SMEM_BYTES, getattr(dia, "_K14_TILED", None)
    if tiled is False:
        dia._SMEM_BYTES = 0
    elif tiled and saved[1] is not None:
        dia._K14_TILED = True
    try:
        yield
    finally:
        dia._SMEM_BYTES = saved[0]
        if saved[1] is not None:
            dia._K14_TILED = saved[1]


def run_tree(tree: str) -> None:
    """Build one tree's DIA kernels and time its K14 and K16 on every case."""
    sys.path.insert(0, str(Path(tree).resolve()))
    import numpy as np
    import torch

    from gflownet_spai_tpu_torch import _build
    from gflownet_spai_tpu_torch.ops import dia
    from gflownet_spai_tpu_torch.solvers import cg_multi, jacobi_multirhs
    from gflownet_spai_tpu_torch.solvers.stationary import jacobi_iteration_matrix
    from gflownet_spai_tpu_torch.sparse import gallery

    _build.SOURCES = tuple(s for s in ("dia", "dia_rhs", "dia_spmm")
                           if (_build.CSRC / f"{s}.cu").exists())
    _build.build_all()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4048)
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev)
    bf16 = torch.bfloat16

    def case(label, call, inputs, nbytes):
        """``call(*inputs)`` timed over cold copies of ``inputs`` (DIAs
        copied with their data; an output buffer among them is written in
        place, so no allocation is timed); prints the time and the output's
        hash."""
        y = call(*inputs)
        same = torch.equal(_bits(call(*inputs)), _bits(y))
        n_copies = min(16, max(2, -(-COLD_BYTES // nbytes)))
        copies = [inputs] + [tuple(dataclasses.replace(t, data=t.data.clone())
                                   if isinstance(t, dia.DIA) else t.clone() for t in inputs)
                             for _ in range(1, n_copies)]
        it = itertools.cycle([lambda c=c: call(*c) for c in copies])
        ms = _graph_ms(lambda: next(it)())
        print(f"[compare] {tree} {label}: {ms:.5f} ms (graph replay over {n_copies} "
              f"copies), output sha256 {_digest(y)}, a second launch "
              f"{'the same bits' if same else 'OTHER BITS'}", flush=True)
        return y

    d = dia.coo_to_dia(gallery.poisson2d(POISSON, dtype=np.float32), device=dev)
    n, h = d.n, d.halo
    insts = lambda dd: (("float32", dd, torch.float32),
                        ("bf16 diagonals, float32 vectors", dia.dia_astype(dd, bf16),
                         torch.float32), ("bf16", dia.dia_astype(dd, bf16), bf16))
    # K16: cg_multi's A and Jacobi M at K_pad 16, K 256
    xt16 = rnd(MULTI_K, n)
    diag = d.data[d.offsets.index(0)]
    mj = dia.DIA(data=torch.where(diag != 0, 1.0 / diag, 0.0)[None].contiguous(),
                 offsets=(0,), shape=d.shape, nnz=n)
    for mname, mat, kcount, only32 in (("A", d, MULTI_K, False), ("Jacobi M", mj, MULTI_K, True),
                                       ("A", d, SPMM_K, True)):
        xt = xt16 if kcount == MULTI_K else rnd(SPMM_K, n)
        for inst, dd, vt in insts(mat)[:1 if only32 else 3]:
            xtp = dia.dia_pad_xt(d, xt).to(vt)          # cg_multi's K_pad, d's halo
            xtp = torch.nn.functional.pad(xtp[:, h:h + d.n_pad], (dd.halo, dd.halo))
            nb = dd.data.numel() * dd.data.element_size() + 2 * xtp.shape[0] * d.n_pad \
                * xtp.element_size()
            label = f"K16 {mname} {inst}, K_pad {xtp.shape[0]}"
            y = case(f"{label}, spmm_dia_t_padded", dia.spmm_dia_t_padded, (dd, xtp), nb)
            if hasattr(dia, "spmm_dia_t_rows"):
                rows = xtp[:, dd.halo:dd.halo + d.n_pad].contiguous()
                yr = case(f"{label}, spmm_dia_t_rows", dia.spmm_dia_t_rows, (dd, rows), nb)
                print(f"[compare] {tree} {label}: spmm_dia_t_rows "
                      f"{'equals' if torch.equal(_bits(yr), _bits(y)) else 'DIFFERS FROM'} "
                      "spmm_dia_t_padded bit for bit", flush=True)
            if kcount == MULTI_K:
                case(f"{label}, spmm_dia_t", dia.spmm_dia_t, (dd, xt.to(vt)), nb)
            del xtp
    del xt16
    # K14: k 1 at poisson1024, k 8 at poisson512 / 2 and poisson128 / 16
    for side, n_rhs, k in ((POISSON, MULTI_K, 1), (POISSON // 2, 2, 8),
                           (POISSON // 8, MULTI_K, 8)):
        dd = d if side == POISSON else dia.coo_to_dia(
            gallery.poisson2d(side, dtype=np.float32), device=dev)
        m = jacobi_iteration_matrix(dd)
        p = dia.dia_pp_tile(m) or m.halo
        xq = dia.dia_pad_pp_rhs(m, rnd(n_rhs, m.n), tr=p)
        cq = dia.dia_pad_pp_rhs(m, rnd(n_rhs, m.n), tr=p)
        for inst, mm, vt in insts(m)[:3 if side != POISSON // 8 else 1]:
            xv, cv = xq.to(vt), cq.to(vt)
            nb = mm.data.numel() * mm.data.element_size() + 3 * n_rhs * m.n_pad \
                * xv.element_size()
            call = lambda mm_, x_, c_, z_: dia.spmv_dia_power_rhs(mm_, None, x_, z_, k=k,
                                                                   add=c_)
            label = f"K14 poisson{side} {inst}, {n_rhs} right-hand sides, k {k}, affine"
            two = k > 1 and hasattr(dia, "_rhs_tile_rows")
            for mode in ((None, True, False) if two else (None,)):
                with _mode(dia, mode):
                    tag = {None: "the tree's mode", True: "tiled", False: "streamed"}[mode]
                    case(f"{label}, {tag}", call, (mm, xv, cv, torch.zeros_like(xv)), nb)
    # the solvers
    B = torch.randn((MULTI_K, n), generator=torch.Generator(device=dev).manual_seed(77),
                    device=dev)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for label, fn, names in (
            ("jacobi_multirhs", lambda: jacobi_multirhs(d, B, iters=100), K14_NAMES),
            ("cg_multi", lambda: cg_multi(d, B, maxiter=4000, rtol=1e-5), K16_NAMES),
            ("cg_multi, Jacobi M", lambda: cg_multi(d, B, m=mj, maxiter=4000, rtol=1e-5),
             K16_NAMES)):
        walls = []
        for _ in range(RUNS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        steps = res.iterations if label == "jacobi_multirhs" else int(res.iterations.max())
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        kern = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        dev_ms = sum(us for _, us in kern) / 1e3 / steps
        own_ms = sum(us for nm, us in kern if any(k in nm for k in names)) / 1e3 / steps
        its = "" if label == "jacobi_multirhs" else \
            f" (iterations {int(res.iterations.min())}-{steps})"
        unit = "sweep" if label == "jacobi_multirhs" else "iteration"
        print(f"[compare] {tree} {label}: {steps} {unit}s{its}; host clock ms/{unit} "
              f"{' '.join(f'{1e3 * w / steps:.4f}' for w in walls)}; device (profiler) "
              f"{dev_ms:.4f} ms/{unit}, K{'14' if names is K14_NAMES else '16'}'s kernels "
              f"{own_ms:.4f}", flush=True)


def main(trees: list[str]) -> int:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    for tree in trees + trees[::-1]:
        rc = subprocess.run([sys.executable, __file__, "--one", tree]).returncode
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        run_tree(sys.argv[2])
    elif len(sys.argv) >= 2:
        sys.exit(main(sys.argv[1:]))
    else:
        sys.exit(__doc__)
