"""Compare the padded-IO and ping-pong DIA SpMVs (K10, K11) of several
checkouts of the port on one card: device time and output bits.

    python examples/k10_k11_compare_torch.py TREE [TREE ...]

Each TREE is the root of a checkout (for another commit: `git archive`
into a directory that `.gitignore` lists).  The trees run one at a time,
each in a process of its own, in the order given and then in reverse (A,
B, B, A for two), so that every tree is timed on either side of the
others.  Cases, at `chip_smoke.py`'s `[dia-multi]` seed and scale (0.2):

- K10 (`spmv_dia_padded_io`, P 16,384) and K11 (`spmv_dia_pingpong`, P
  65,536) on poisson1024 in the three (diagonal, vector) instances:
  float32; bf16 diagonals with float32 vectors; bf16 with bf16;
- both on orsirr_like150 (230 diagonals at odd offsets, P 1,024) in the
  three instances;
- both on poisson1024 in float32 with x one element past a 16-byte
  boundary (the row-tile kernel's scalar instance; its output must have
  the aligned case's hash).

A line per tree and case gives the graph-replay time over cold copies of
the inputs (as `chip_smoke.py`'s `_timed`), a hash of the output buffer
(equal between trees whose kernels give the same bits; K11's output is
its buffer of zeros with the interior written) and whether a second launch
gave the same bits.  Each tree first prints the ptxas registers and spills
of the kernels it builds for K10 and K11.  Needs a CUDA card and `nvcc`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import itertools
import re
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

from k8_compare_torch import COLD_BYTES, _bits, _digest, _graph_ms  # noqa: E402

POISSON, MATRIX, SCALE = 1024, "orsirr_like150", 0.2
KERNELS = ("dia_spmv_pp_kernel", "dia_rhs_kernel")   # K10 / K11's kernel before and after


def _ptxas(tree, log):
    """The ptxas lines (registers, spills) of K10 / K11's kernels."""
    lines = [ln.strip() for ln in log.splitlines()]
    for i, line in enumerate(lines):
        if "Compiling entry" in line and any(k in line for k in KERNELS):
            name = re.search(r"'(\S+)'", line)
            print(f"[compare] {tree} ptxas {name.group(1) if name else line}: "
                  f"{lines[i + 2]}; {lines[i + 3]}", flush=True)


def run_tree(tree: str) -> None:
    """Build one tree's DIA kernels and time its K10 and K11 on every case."""
    sys.path.insert(0, str(Path(tree).resolve()))
    import numpy as np
    import torch

    from gflownet_spai_tpu_torch import _build
    from gflownet_spai_tpu_torch.ops import dia
    from gflownet_spai_tpu_torch.sparse import gallery

    _build.SOURCES = tuple(s for s in ("dia", "dia_rhs")
                           if (_build.CSRC / f"{s}.cu").exists())
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        _build.build_all(verbose=True)
    _ptxas(tree, log.getvalue())
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4048)
    bf16 = torch.bfloat16

    def shifted(t):
        """``t``'s values one element past a 16-byte boundary."""
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        out = buf[1:]
        out.copy_(t)
        return out

    def case(label, call, inputs, nbytes, copy=lambda t: t.clone()):
        """``call(*inputs)`` timed over cold copies of ``inputs`` (DIAs
        copied with their data, tensors by ``copy``); prints the time and
        the output's hash."""
        y = call(*inputs).clone()
        same = torch.equal(_bits(call(*inputs)), _bits(y))
        n_copies = min(16, max(2, -(-COLD_BYTES // nbytes)))
        copies = [inputs] + [tuple(dataclasses.replace(t, data=t.data.clone())
                                   if isinstance(t, dia.DIA) else copy(t) for t in inputs)
                             for _ in range(1, n_copies)]
        it = itertools.cycle([lambda c=c: call(*c) for c in copies])
        ms = _graph_ms(lambda: next(it)())
        print(f"[compare] {tree} {label}: {ms:.5f} ms (graph replay over {n_copies} "
              f"copies), output sha256 {_digest(y)}, a second launch "
              f"{'the same bits' if same else 'OTHER BITS'}", flush=True)

    k10 = lambda dd, xq: dia.spmv_dia_padded_io(dd, xq, scale=SCALE)
    k11 = lambda dd, xq, yq: dia.spmv_dia_pingpong(dd, xq, yq, scale=SCALE)
    for name in (f"poisson{POISSON}", MATRIX):
        a = gallery.poisson2d(POISSON, dtype=np.float32) if name != MATRIX \
            else gallery.get(MATRIX)
        d = dia.coo_to_dia(a.with_data(a.data.astype(np.float32)), device=dev)
        x = torch.randn(d.n, generator=gen, device=dev)
        db = dia.dia_astype(d, bf16)
        for inst, dd, vt in (("float32", d, torch.float32),
                             ("bf16 diagonals, float32 vectors", db, torch.float32),
                             ("bf16", db, bf16)):
            for key, xq in (("K10", dia.dia_pad_io(d, x)), ("K11", dia.dia_pad_pp(d, x))):
                xq = xq.to(vt)
                p = (xq.shape[0] - d.n_pad) // 2
                nb = dd.data.numel() * dd.data.element_size() + xq.element_size() * (
                    d.n + (xq.shape[0] if key == "K10" else d.n))
                label = f"{key} {name} {inst}, P {p}, {d.ndiags} diagonals"
                cases = [("", lambda t: t.clone())]
                if name != MATRIX and inst == "float32":
                    cases.append((", x off its 16-byte alignment (scalar instance)", shifted))
                for tag, copy in cases:
                    xin = copy(xq)
                    if key == "K10":
                        case(label + tag, k10, (dd, xin), nb, copy)
                    else:
                        case(label + tag, k11, (dd, xin, torch.zeros_like(xq)), nb, copy)


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
