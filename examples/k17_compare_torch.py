"""Compare the block-ELL SpMM (K17) of several checkouts of the port on one
card: device time and output bits of its float32 and its bf16 × bf16
(tensor-core) instances on `chip_smoke.py`'s `[bell]` cases (the same
seeded matrices and X; bf16 blocks and X are the float32 ones rounded),
and the registers and spills that `ptxas` reports for the float32
kernel's bm = 128 instances and every tensor-core instance.

    python examples/k17_compare_torch.py TREE [TREE ...]

Each TREE is the root of a checkout (for another commit: `git archive`
into a directory that `.gitignore` lists).  The trees run one at a time,
each in a process of its own, in the order given and then in reverse
(A, B, B, A for two), so that every tree is timed on either side of the
others; a line per tree, case and instance gives the graph-replay time
over cold copies and a hash of the output, which are equal between trees
whose kernels give the same bits.  Needs a CUDA card and `nvcc`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import io
import re
import subprocess
import sys
from pathlib import Path

CASES = ((4096, (8, 128)), (4096, (32, 128)), (4096, (128, 128)), (65536, (8, 128)),
         (65536, (128, 128)))
K = 256


def _ptxas(lines: list[str]) -> None:
    """Each kernel's registers, shared memory and spills as ptxas gives them."""
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if not m or not ("bell_spmm_bf16" in m.group(1) or "Li128" in m.group(1)):
            continue
        name = re.sub(r"^.*?(bell_spmm\w*?kernel)I", r"\1<", m.group(1))
        print(f"[compare] ptxas {name}: {lines[i + 2].strip()}; {lines[i + 3].strip()}",
              flush=True)


def run_tree(tree: str) -> None:
    """Build one tree's `bsr` and `bsr_bf16` libraries and time its K17."""
    sys.path.insert(0, str(Path(tree).resolve()))
    import numpy as np
    import torch

    import chip_smoke as cs
    from gflownet_spai_tpu_torch import _build
    from gflownet_spai_tpu_torch.ops import bsr

    _build.SOURCES = ("bsr", "bsr_bf16")
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        _build.build_all(verbose=True)
    print(f"[compare] {tree}", flush=True)
    _ptxas(log.getvalue().splitlines())
    dev = torch.device("cuda")
    rng = np.random.default_rng(17)
    gen = torch.Generator(device=dev).manual_seed(17)
    mats = []
    for m, bs in CASES:
        brow, bcol, blocks = cs._bell_blocks(m, m, bs, rng)
        mats.append(cs._bell_direct(m, m, brow, bcol, blocks).to(dev))
    xs = [torch.randn((m, K), generator=gen, device=dev) for m, _ in CASES]
    for (m, bs), a32, x32 in zip(CASES, mats, xs):
        for name, dt in (("float32", torch.float32), ("bf16 x bf16", torch.bfloat16)):
            a = dataclasses.replace(a32, data=a32.data.to(dt))
            x = x32.to(dt)
            y = bsr.spmm_bell(a, x)
            digest = hashlib.sha256(y.view(torch.int16 if dt == torch.bfloat16 else dt)
                                    .cpu().numpy().tobytes()).hexdigest()[:16]
            copies = [(a, x)] + [(dataclasses.replace(a, data=a.data.clone()), x.clone())
                                 for _ in range(1, 4 if m > 4096 else 16)]
            ms = cs.graph_ms(cs._cycle([lambda c=c: bsr.spmm_bell(*c) for c in copies]), 10)
            print(f"[compare] {tree} {m}², blocks {bs}: {name} K17 {ms:.5f} ms, output "
                  f"sha256 {digest}", flush=True)
            del copies


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
