"""Profile the multi-right-hand-side DIA kernels (K14 one pass, K16) of one
checkout at `cg_multi`'s shape, where no Nsight tool runs: event-timed
variants that move one factor each, the achieved DRAM rate, and the
compiler's registers (occupancy).

    python examples/k14_k16_profile_torch.py [TREE]

TREE (default: this checkout) is the root of a checkout of the port.  At
poisson1024 (5 diagonals, n_pad 1,048,576) it times, as CUDA-graph replays
over cold copies (`k8_compare_torch._graph_ms`):

- K16 on `cg_multi`'s A (K_pad 16) and Jacobi M (1 diagonal), in the
  three (diagonal, vector) instances, and at K_pad 8, 32 and 256;
- K14 at k 1, affine, 16 right-hand sides, in the three instances, and at
  8 right-hand sides;
- a yardstick of the DRAM rate: one PyTorch elementwise kernel that reads
  and writes as many bytes as K16 (`torch.add` of two float32 vectors
  into a third);

and prints for each the bytes it must move, its bound at 3.35 TB/s, the
achieved rate (bytes / time), the time per right-hand side, and the device
time `torch.profiler` reports for the kernel.  The sectors per request are
reckoned from the access pattern (printed beside).  `nvcc -Xptxas -v`
gives each kernel's registers; the resident warps per SM follow from them
and the block size.  Needs a CUDA card and `nvcc`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import itertools
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

from k8_compare_torch import COLD_BYTES, _graph_ms  # noqa: E402

POISSON = 1024
HBM = 3.35e12
KERNELS = ("dia_spmv_rhs_kernel", "dia_spmm_t_kernel", "dia_rhs_kernel")


def _ptxas(tree: str) -> None:
    """Registers and spills of the K14 / K16 kernels, from ``-Xptxas -v``."""
    from gflownet_spai_tpu_torch import _build

    _build.SOURCES = tuple(s for s in ("dia", "dia_spmm", "dia_rhs")
                           if (_build.CSRC / f"{s}.cu").exists())
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        _build.build_all(verbose=True)
    lines = log.getvalue().splitlines()
    for i, line in enumerate(lines):
        kern = next((k for k in KERNELS if k in line), None)
        if "Compiling entry" in line and kern:
            inst = line.split(kern)[1][:40]
            print(f"[profile] {tree} ptxas {kern}{inst}: {lines[i + 2].strip()}; "
                  f"{lines[i + 3].strip()}", flush=True)


def _profiled_ms(fn) -> tuple[float, str]:
    """Device ms of one call of ``fn`` by ``torch.profiler`` (the mean over
    10 calls) and the name of its longest kernel."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
    kern = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kern:
        return float("nan"), "no device events"
    top = max(kern, key=lambda k: k[1])[0]
    return sum(us for _, us in kern) / 1e4, top[:60]


def run(tree: str) -> None:
    sys.path.insert(0, str(Path(tree).resolve()))
    import numpy as np
    import torch

    from gflownet_spai_tpu_torch.ops import dia
    from gflownet_spai_tpu_torch.solvers.stationary import jacobi_iteration_matrix
    from gflownet_spai_tpu_torch.sparse import gallery

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    _ptxas(tree)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(16)
    bf16 = torch.bfloat16
    d = dia.coo_to_dia(gallery.poisson2d(POISSON, dtype=np.float32), device=dev)
    n, n_pad = d.n, d.n_pad
    diag = d.data[d.offsets.index(0)]
    mj = dia.DIA(data=torch.where(diag != 0, 1.0 / diag, 0.0)[None].contiguous(),
                 offsets=(0,), shape=d.shape, nnz=n)
    m = jacobi_iteration_matrix(d)

    def report(label, copies, nbytes, n_rhs):
        it = itertools.cycle(copies)
        ms = _graph_ms(lambda: next(it)())
        warm = _graph_ms(copies[0])
        prof_ms, top = _profiled_ms(copies[0])
        print(f"[profile] {tree} {label}: {ms:.5f} ms cold (graph replay over {len(copies)} "
              f"copies), {warm:.5f} warm; {nbytes / 1e6:.1f} MB, bound "
              f"{1e3 * nbytes / HBM:.6f} ms, achieved {nbytes / ms / 1e9:.3f} TB/s "
              f"({100 * nbytes / ms / 1e9 / 3.35:.1f}% of 3.35), {ms / n_rhs * 1e3:.3f} us "
              f"per right-hand side; profiler {prof_ms:.5f} ms ({top})", flush=True)

    def n_copies(nbytes):
        return min(16, max(2, -(-COLD_BYTES // nbytes)))

    # K16: cg_multi's A and M at K_pad 16, the instances, and K_pad 8, 32, 256
    for mat, mname in ((d, "A"), (mj, "Jacobi M")):
        for inst, dd, vt in (("float32", mat, torch.float32),
                             ("bf16 diagonals, float32 vectors", dia.dia_astype(mat, bf16),
                              torch.float32),
                             ("bf16", dia.dia_astype(mat, bf16), bf16)):
            for kp in ((8, 16, 32, 256) if mname == "A" and inst == "float32" else (16,)):
                xtp = torch.zeros((kp, dd.halo + n_pad + dd.halo), device=dev, dtype=vt)
                xtp[:, dd.halo:dd.halo + n] = torch.randn((kp, n), generator=gen,
                                                          device=dev).to(vt)
                nbytes = dd.data.numel() * dd.data.element_size() \
                    + 2 * kp * n_pad * xtp.element_size()
                copies = [(dd, xtp)] + [(dataclasses.replace(dd, data=dd.data.clone()),
                                         xtp.clone()) for _ in range(1, n_copies(nbytes))]
                fns = [lambda c=c: dia.spmm_dia_t_padded(*c) for c in copies]
                report(f"K16 {mname} ({dd.ndiags} diagonals) {inst}, K_pad {kp}",
                       fns, nbytes, kp)
                del xtp, copies, fns
    # K14 at k 1, affine: 16 and 8 right-hand sides
    p = dia.dia_pp_tile(m) or m.halo
    for inst, mm, vt in (("float32", m, torch.float32),
                         ("bf16 diagonals, float32 vectors", dia.dia_astype(m, bf16),
                          torch.float32),
                         ("bf16", dia.dia_astype(m, bf16), bf16)):
        for k_rhs in ((16, 8) if inst == "float32" else (16,)):
            xq = dia.dia_pad_pp_rhs(mm, torch.randn((k_rhs, n), generator=gen, device=dev),
                                    tr=p).to(vt)
            cq = dia.dia_pad_pp_rhs(mm, torch.randn((k_rhs, n), generator=gen, device=dev),
                                    tr=p).to(vt)
            nbytes = mm.data.numel() * mm.data.element_size() \
                + 3 * k_rhs * n_pad * xq.element_size()
            copies = [(mm, xq, torch.zeros_like(xq), cq)] + [
                (dataclasses.replace(mm, data=mm.data.clone()), xq.clone(),
                 torch.zeros_like(xq), cq.clone()) for _ in range(1, n_copies(nbytes))]
            fns = [lambda c=c: dia.spmv_dia_power_rhs(c[0], None, c[1], c[2], k=1, add=c[3])
                   for c in copies]
            report(f"K14 k 1 affine {inst}, {k_rhs} right-hand sides", fns, nbytes, k_rhs)
            del xq, cq, copies, fns
    # the DRAM yardstick: read two float32 vectors, write one, as K16's bytes
    words = (d.data.numel() + 2 * 16 * n_pad) // 3
    vecs = [(torch.randn(words, device=dev), torch.randn(words, device=dev),
             torch.empty(words, device=dev)) for _ in range(4)]
    fns = [lambda v=v: torch.add(v[0], v[1], out=v[2]) for v in vecs]
    report("yardstick torch.add (2 reads, 1 write)", fns, 12 * words, 16)
    print(f"[profile] {tree} sectors per request, reckoned: a warp's load of 32 "
          "consecutive float32 words is 4 sectors (5 when it starts off a 32-byte "
          "boundary, as at offsets +-1); of 32 bf16 words 2 (3); a warp's 16-byte "
          "vector load is 16 sectors (32 at +-1, two aligned loads)", flush=True)


if __name__ == "__main__":
    run(sys.argv[1] if len(sys.argv) > 1 else str(Path(__file__).resolve().parent.parent))
