"""Time the DIA SpMV (K8) on both of its paths across matrices, to fit the
rule that picks one (`ops/dia.py` `_k8_skips`, `_K8_SKIP_RULE`).

    python examples/k8_paths_torch.py

K8's rows path reads every stored word; its skip path reads the diagonals
only in the 64-row segments that hold a word other than zero, after a scan
of x.  With `_K8_SKIP_RULE` = (n0, s), the rule takes the skip path on a
band of ndiags diagonals where less than s·(1 − n0 / ndiags) of the
segments hold an entry (`_k8_share`: host fields, so no sync).  Cases: the
gallery matrices of `chip_smoke.py`'s paths (poisson1024 and
orsirr_like150 in three instances, orsirr_like150's Jacobi matrix and
Galerkin levels, fully stored bands of 16 to 64 diagonals), and a sweep of
random DIAs of 5 to 230 diagonals whose segments hold entries in 2% to
100% of them, in two patterns: "tiles" (whole 64-row segments filled) and
"scattered" (single words: one entry flags a whole segment).  A line per
case gives the share of entries among the words, the share of segments
holding one (the rule's), the graph-replay time of each path over cold
copies (two rounds, in turn), the host time of an eager call on each path,
whether both paths give the same bits, and the rule's pick; then, for each
family of the sweep, the share of segments where the paths cross, and the
worst loss of the rule's pick over all cases.  Needs a CUDA card and
`nvcc`.
"""

from __future__ import annotations

import dataclasses
import itertools
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from k8_compare_torch import COLD_BYTES, _bits, _graph_ms  # noqa: E402

HOST_CALLS = 200            # eager calls timed on the host clock per path
SHARES = (0.02, 0.05, 0.1, 0.2, 0.3, 0.4, 0.5, 0.7, 1.0)     # "tiles" sweep
WORD_SHARES = (0.002, 0.005, 0.01, 0.03)                       # "scattered" sweep
FAMILIES = ((5, 1 << 20), (9, 1 << 20), (12, 1 << 19), (16, 1 << 18), (24, 1 << 18),
            (32, 1 << 18), (230, 22_500), (230, 1 << 17))
SCATTERED_FROM = 16         # the "scattered" sweep runs on families this wide


def _forced(dia, skip: bool) -> None:
    dia._K8_SKIP_RULE = (0, float("inf")) if skip else (0, 0.0)


def _random_dia(dia, nd: int, n: int, share: float, pattern: str, seed: int):
    """A DIA of ``nd`` diagonals (offsets spread over the band as the
    gallery's are: a few near the centre, the rest far) whose in-range
    words are entries with probability ``share``, by segment or by word."""
    import numpy as np
    import torch

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    near = min(nd, 5)
    far = rng.choice(np.setdiff1d(np.arange(-(n // 2), n // 2), np.arange(-2, 3)),
                     nd - near, replace=False) if nd > near else np.array([], int)
    offsets = tuple(sorted([*range(-(near // 2), near - near // 2)] + far.tolist()))
    if nd == 5:
        offsets = (-1024, -1, 0, 1, 1024)
    n_pad = -(-n // 1024) * 1024
    gen = torch.Generator(device=dev).manual_seed(seed)
    data = torch.randn((nd, n_pad), generator=gen, device=dev)
    if pattern == "tiles":
        keep = torch.rand((nd, -(-n_pad // 64)), generator=gen, device=dev) < share
        keep = keep.repeat_interleave(64, dim=1)[:, :n_pad]
    else:
        keep = torch.rand((nd, n_pad), generator=gen, device=dev) < share
    i = torch.arange(n_pad, device=dev)
    off = torch.tensor(offsets, device=dev)[:, None]
    keep &= (i < n) & (i + off >= 0) & (i + off < n)
    data = torch.where(keep, data, torch.zeros((), device=dev))
    share = float(dia._segment_flags(data).float().mean())    # as coo_to_dia reckons it
    return dia.DIA(data=data, offsets=offsets, shape=(n, n), nnz=int(keep.sum()),
                   seg_share=share)


def _host_us(dia, d, x) -> float:
    import torch

    dia.spmv_dia(d, x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HOST_CALLS):
        dia.spmv_dia(d, x)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / HOST_CALLS


def _case(dia, name: str, d, x, rule: tuple) -> dict:
    """Both paths on one case; ``rule`` is the shipped ``_K8_SKIP_RULE``."""
    import torch

    nbytes = d.data.numel() * d.data.element_size() + 2 * x.numel() * x.element_size()
    n_copies = min(16, max(2, -(-COLD_BYTES // nbytes)))
    copies = [(d, x)] + [(dataclasses.replace(d, data=d.data.clone()), x.clone())
                         for _ in range(1, n_copies)]
    for c, _ in copies:                  # the skip path's flags, made before any capture
        dia._flags(c)
    ms = {False: [], True: []}
    for order in ((False, True), (True, False)):
        for skip in order:
            _forced(dia, skip)
            it = itertools.cycle([lambda c=c: dia.spmv_dia(*c) for c in copies])
            ms[skip].append(_graph_ms(lambda: next(it)()))
    ys, host = {}, {}
    for skip in (False, True):
        _forced(dia, skip)
        ys[skip] = dia.spmv_dia(d, x)
        host[skip] = _host_us(dia, d, x)
    torch.cuda.synchronize()
    dia._K8_SKIP_RULE = rule
    entries = d.nnz / (d.ndiags * d.n)
    share = dia._k8_share(d)
    pick = dia._k8_skips(d)
    rows, skip = min(ms[False]), min(ms[True])
    loss = (skip if pick else rows) / min(rows, skip)
    same = torch.equal(_bits(ys[False]), _bits(ys[True]))
    print(f"[paths] {name} ({d.ndiags} diagonals, n {d.n}): entries {100 * entries:.2f}% "
          f"of the words, {100 * share:.2f}% of the segments; rows "
          f"{' '.join(f'{v:.5f}' for v in ms[False])} ms, skip {' '.join(f'{v:.5f}' for v in ms[True])} ms (skip / rows "
          f"{skip / rows:.3f}); host per eager call rows {host[False]:.1f} us, skip "
          f"{host[True]:.1f} us; same bits {same}; the rule picks "
          f"{'skip' if pick else 'rows'} ({loss:.3f}x the faster)", flush=True)
    return dict(share=share, ratio=skip / rows, loss=loss, same=same, ndiags=d.ndiags)


def main() -> int:
    import numpy as np
    import torch

    from gflownet_spai_tpu_torch import _build
    from gflownet_spai_tpu_torch.ops import dia
    from gflownet_spai_tpu_torch.solvers.multigrid import galerkin_coarse_dia
    from gflownet_spai_tpu_torch.solvers.stationary import jacobi_iteration_matrix
    from gflownet_spai_tpu_torch.sparse import gallery

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    _build.SOURCES = ("dia",)
    _build.build_all()
    rule = dia._K8_SKIP_RULE
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    bf16 = torch.bfloat16
    out = []

    def coo_dia(a):
        return dia.coo_to_dia(a.with_data(a.data.astype(np.float32)), device=dev)

    pois = coo_dia(gallery.poisson2d(1024, dtype=np.float32))
    ors = coo_dia(gallery.get("orsirr_like150"))
    c1 = galerkin_coarse_dia(ors)
    named = [("poisson1024", pois), ("orsirr_like150", ors),
             ("orsirr_like150 Jacobi matrix", jacobi_iteration_matrix(ors)),
             ("orsirr_like150 Galerkin level 1", c1),
             ("orsirr_like150 Galerkin level 2", galerkin_coarse_dia(c1))]
    for nd, n in ((16, 1 << 18), (32, 1 << 18), (64, 1 << 16)):
        named.append((f"full band {nd}", _random_dia(dia, nd, n, 1.0, "tiles", nd)))
    for name, d in named:
        x = torch.randn(d.n, generator=gen, device=dev)
        out.append(_case(dia, f"{name}, float32", d, x, rule))
        if name in ("poisson1024", "orsirr_like150"):
            db = dia.dia_astype(d, bf16)
            out.append(_case(dia, f"{name}, bf16 diagonals, float32 x", db, x, rule))
            out.append(_case(dia, f"{name}, bf16", db, x.to(bf16), rule))
    for nd, n in FAMILIES:
        for pattern, shares in (("tiles", SHARES), ("scattered", WORD_SHARES)):
            if pattern == "scattered" and nd < SCATTERED_FROM:
                continue
            fam = []
            for k, share in enumerate(shares):
                d = _random_dia(dia, nd, n, share, pattern, 100 * nd + k)
                x = torch.randn(d.n, generator=gen, device=dev)
                fam.append(_case(dia, f"{pattern} {share:g}", d, x, rule))
                del d
            out.extend(fam)
            cross = next(((a, b) for a, b in zip(fam, fam[1:])
                          if a["ratio"] < 1 <= b["ratio"]), None)
            if cross is None:
                where = ("skip faster at every share" if fam[-1]["ratio"] < 1
                         else "rows faster at every share")
            else:
                a, b = cross        # linear in log(skip / rows) between the two shares
                t = -np.log(a["ratio"]) / (np.log(b["ratio"]) - np.log(a["ratio"]))
                where = f"{100 * (a['share'] + t * (b['share'] - a['share'])):.1f}% of the segments"
            print(f"[paths] crossover, {pattern}, {nd} diagonals, n {n}: {where}", flush=True)
    worst = max(out, key=lambda r: r["loss"])
    print(f"[paths] the rule (skip below {rule[1]:g}·(1 − {rule[0]}/ndiags) of the "
          f"segments) over {len(out)} cases: worst pick {worst['loss']:.3f}x the faster path "
          f"({worst['ndiags']} diagonals, {100 * worst['share']:.2f}% of the segments); same "
          f"bits on every case: "
          f"{all(r['same'] for r in out)}", flush=True)
    return 0 if all(r["same"] for r in out) else 1


if __name__ == "__main__":
    sys.exit(main())
