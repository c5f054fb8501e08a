"""Compare the float32 block-ELL SpMM (K17) of several checkouts of the port
on one card: device time and output bits on `chip_smoke.py`'s `[bell]`
cases (the same seeded matrices and X), and the registers and spills that
`ptxas` reports for the bm = 128 instances.

    python examples/k17_compare_torch.py TREE [TREE ...]

Each TREE is the root of a checkout (for another commit: `git archive`
into a directory that `.gitignore` lists).  The trees run one at a time,
each in a process of its own, in the order given and then in reverse
(A, B, B, A for two), so that every tree is timed on either side of the
others; a line per tree and case gives the graph-replay time over cold
copies and a hash of the output, which are equal between trees whose
kernels give the same bits.  Needs a CUDA card and `nvcc`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import io
import subprocess
import sys
from pathlib import Path

CASES = ((4096, (8, 128)), (4096, (32, 128)), (4096, (128, 128)), (65536, (8, 128)),
         (65536, (128, 128)))
K = 256


def run_tree(tree: str) -> None:
    """Build one tree's `bsr` library and time its float32 K17."""
    sys.path.insert(0, str(Path(tree).resolve()))
    import numpy as np
    import torch

    import chip_smoke as cs
    from gflownet_spai_tpu_torch import _build
    from gflownet_spai_tpu_torch.ops import bsr

    _build.SOURCES = ("bsr",)
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        _build.build_all(verbose=True)
    lines = log.getvalue().splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry" in line and "Li128" in line:
            print(f"[compare] {tree} ptxas {line.split('kernelI')[1][:14]}: "
                  f"{lines[i + 2].strip()}; {lines[i + 3].strip()}", flush=True)
    dev = torch.device("cuda")
    rng = np.random.default_rng(17)
    gen = torch.Generator(device=dev).manual_seed(17)
    mats = []
    for m, bs in CASES:
        brow, bcol, blocks = cs._bell_blocks(m, m, bs, rng)
        mats.append(cs._bell_direct(m, m, brow, bcol, blocks).to(dev))
    xs = [torch.randn((m, K), generator=gen, device=dev) for m, _ in CASES]
    for (m, bs), a, x in zip(CASES, mats, xs):
        y = bsr.spmm_bell(a, x)
        digest = hashlib.sha256(y.cpu().numpy().tobytes()).hexdigest()[:16]
        copies = [(a, x)] + [(dataclasses.replace(a, data=a.data.clone()), x.clone())
                             for _ in range(1, 4 if m > 4096 else 16)]
        ms = cs.graph_ms(cs._cycle([lambda c=c: bsr.spmm_bell(*c) for c in copies]), 10)
        print(f"[compare] {tree} {m}², blocks {bs}: float32 K17 {ms:.5f} ms, output "
              f"sha256 {digest}", flush=True)


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
