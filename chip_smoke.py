"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):

1. card      — requires CUDA; prints the device, its count and
               ``nvidia-smi``'s name and power limit; TF32 off.
2. build     — compiles every kernel of the port from
               ``gflownet_spai_tpu_torch/csrc`` with nvcc (one process per
               source, all at once), then the native host library
               (``native/gfnspai.cpp``, g++) into ``build/native/``; fails
               if the library does not load.
3. setup     — ``setup(TrainConfig(matrix="orsirr_like150", env_format="coo"))``
               on the card (ILU(0) seed, hidden 4, heads 4), its host part
               through the native library.
4. kernels   — K1 (fused GATv2 tile forward) at every bucket of that
               graph, both GAT layers, and K3 (windowed row gather) in one
               call for every bucket and in one call per bucket, against
               their plain PyTorch versions on the same CUDA tensors; K1
               must give the same bits on a second launch.  Kernel and
               library times are CUDA-graph replays of one L2-warm copy of
               the inputs (device time, no host dispatch), printed beside
               the eager calls' time, the bytes/ops bound and the launch
               floor (a one-element add_ replayed the same way); K1 also
               at each lane plan of GAT_PLANS.
5. backward  — K2 (the fused tile backward) and K4 (the windowed
               scatter-add) the same way; K2's four outputs and K4 must give
               the same bits on a second launch, K4 the bits of its plain
               version on the CPU except on hub rows (more than 32 slots).
6. gradients — a fixed random cotangent on the 156,975 logits: the
               forward parameters' gradient through the tiled graph
               (K1-K4) against the per-edge scatter path on the card.
7. slice     — launch counters to 0, ``sample(..., batch_size=256)`` for a
               few batches, counters read: every kernel of the path ran.
               Checks finite rewards and log-probs, terminal-ended
               trajectories, rewards against a float64 scipy reference, and
               the kernel-path logits against the per-edge scatter path.
8. breakdown — host-clock times of the forward, the rollout and the reward.
9. train     — launch counters to 0, ``train(cfg)`` at the training slice's
               configuration (SubTB, linear backward, t_cap 4096, replay),
               counters read: K1 8, K2 8, K3 1, K4 1 per step.  Checks a
               finite loss every epoch, moved forward parameters and the
               metrics stream; prints ms per step, peak memory, a
               synchronised breakdown of one step and a ``torch.profiler``
               summary of three (device busy share, top operators).
10. restore  — ``python -m gflownet_spai_tpu_torch.sample --run-dir`` (in
               process) restores the checkpoint: the epoch comes back and
               the rewards are finite.
11. dia      — K8 (DIA SpMV), K12 (fused k-step SpMV) and K13 (fused
               Chebyshev steps) against their plain versions at the
               validation path's shapes: K8 on poisson1024 and on the
               orsirr_like150 DIA (230 diagonals); K12 on poisson1024's
               Jacobi iteration matrix at k = 8 and k = 2 with and without
               the affine term, on poisson2048's Jacobi 16 sweeps (k = 8 at
               reach 2048) and on poisson128's Jacobi 4 (k = 2, where the
               selection streams) and 16 sweeps (k = 8); K13 on
               poisson1024 at k = 2 with Chebyshev coefficients from the
               estimated spectrum, and at the Chebyshev V-cycle's coarser
               levels (k 4 on poisson512, k 8 on poisson256).  Each shape
               runs in both modes, fused (clusters stage a window once and
               run the k passes in shared memory) and streamed (one launch
               per pass): the two must agree bit for bit, and the mode the
               selection picks must not be more than 3% slower than the
               other (where it is, both modes are timed again, A B B A,
               and the check fails only if the second reading agrees).  Kernel (CUDA-graph replays cycling through input
               copies larger than L2 together, and one L2-warm copy),
               eager, plain, bound and (K8) torch.sparse CSR times.  K8
               reads a diagonal only in the 64-row tiles its segment flags
               set (its skip path, from 16 diagonals; a narrow band takes
               its rows path): each K8 case prints the flagged share of
               the stored words, the flags' build time, two bounds, the
               flagged segments with x, y and the flags (the record's)
               and every stored word (the TPU kernels' work), and both
               paths' times ([K8-paths]: the same bits, and the rule's
               path not more than 3% slower, with a second A B B A reading
               as above); K8 on orsirr_like150 with
               inf and NaN in x gives NaN and inf in the plain version's
               rows, in each instance.  The
               poisson1024 cases of K8 (and orsirr_like150's), K12 and K13
               at k 2 then run on the same inputs through the bf16
               (``dia_astype``) diagonals, with float32 and with bf16
               vectors (``_check``): the same bits on a second launch, the
               plain version's bits on bf16 vectors (on float32 vectors
               within the tolerance above, the error printed in ulps),
               within max(2e-2, k·2⁻⁸) of the largest magnitude of the
               float32 kernel on the unrounded matrix, fused equal to
               streamed; timed beside the float32 kernel, library
               torch.sparse CSR of the bf16-rounded values (bf16 on bf16
               vectors, float32 on float32 ones).  K12's rule is also held
               on both instances at k 8 on a 9-point damped-Jacobi matrix
               of a 2048 x 2048 grid and on a short irregular band.
12. validate — launch counters to 0, then the orsirr_like150 harness from
               the training run's checkpoint: restore, sample 256, the best
               sampled M, GMRES(20) (x0 = 0, b = ones, rtol 1e-5, maxiter
               10,260) with none / ILU(0) / sampled SPAI / classic SPAI /
               Jacobi 16 sweeps / Chebyshev degree 16 / a 3-level V-cycle;
               per row iterations, cold and steady wall, true residual and
               kernel launches.
13. poisson  — launch counters to 0, CG on poisson1024 (the BASELINE
               config-2 class at a grid whose padded size lets the kernels
               fuse) with none / Jacobi 16 / Chebyshev 16 to rtol 1e-5;
               each row's residual history held against float64 scipy CG
               with the same operators in float64 (the first iteration at
               rtol 1e-1 and 1e-2 within 3%; the ladder down to 1e-5
               printed), the polynomial operators against their float64
               versions on two vectors, K12's and K13's launches by mode,
               and the polynomial rows' iteration counts again with the
               streamed mode forced (they must be equal).
14. dia-multi — the row-tile kernel's ptxas registers and spills per
               instance (fails on spills); K10 (padded-IO SpMV) and K11
               (ping-pong SpMV), both on that kernel, as chains of 8 calls
               at scale 0.2 (halo blocks checked), then in each instance
               one K10 call into an allocator block that held NaN (its halo
               blocks must be zero) and one K11 call into a buffer of NaN
               (its halo blocks must stay NaN), K15 and K16 (the
               SpMMs) at 256 right-hand sides (K15 also held at K 7, its
               word-by-word path, and 16, and timed on orsirr_like150's
               230 diagonals at K 64; K16 at cg_multi's K_pad 16 on A and
               on the Jacobi M, and at 256, each through its unpadded entry
               (cg_multi's) and its padded one, timed apart, the same
               bits), K14 (multi-RHS fused k-step, k passes) at k = 1 with
               16 right-hand sides and at k = 8 on poisson512 with 2 and
               poisson128 with 16, all on
               poisson1024 unless named, against their plain versions;
               times as [dia], library calls torch.sparse CSR A@x / A@X
               and (K14 at k = 1) addmm.  Each kernel's first case (and
               K15 at K 16 and 7, K16's padded entry, held) then runs on
               bf16 diagonals as in [dia].
15. multirhs — launch counters to 0, poisson1024 with 16 seeded
               right-hand sides: ``cg_multi`` (K16) plain and with a
               one-diagonal Jacobi M, every column against single-RHS
               ``cg`` (the same first iteration at rtol 1e-1 and 1e-2, within
               5% at 1e-5); ``jacobi_multirhs`` (100 sweeps, k = 1: K14)
               against 16 single ``jacobi`` runs; host ms and device ms
               (torch.profiler, one more solve) per iteration or sweep.
16. vcycle   — poisson1024 CG (b = ones, rtol 1e-5) with none, a 6-level
               Jacobi V-cycle, a 3-level Chebyshev V-cycle and its W-cycle,
               each against the same operator in float64 on the CPU (the
               first iteration at rtol 1e-1 and 1e-2 within 3%); BiCGStab on
               orsirr_like150 in float64 against scipy's iteration count
               within 10%, and in float32 (printed).
17. validate-cli — ``python -m gflownet_spai_tpu_torch.validate`` on
               bcsstk03_like (with ``--vcycle 2``) in a subprocess on the
               card: every row in validation.json, the vcycle row
               converged; the CLI's verdict printed.
18. segment  — K5 (segment softmax) forward and backward, K6 (segment sum)
               and K7 (node -> slot broadcast) against their plain
               versions at orsirr_like150's uniform tile layout, at every
               width the generic GAT layer gives them (K5 at 4 and 1 heads,
               K6 and K7 at 16, 4 and 1 features); K5 forward and backward
               must give the same bits on a second launch; times as [dia],
               library calls torch.sparse.softmax and its backward on the
               real slots as a hybrid COO tensor (K5, eager), index_add_
               (K6) and index_select (K7); K5's backward also as the K6 +
               K7 chain it replaced; per width the kernel's share of its
               bound and its time over the launch floor; K5 and K6 at every
               slot-lane count their rules can pick ([K5-plans],
               [K5b-plans], [K6-plans]); then the layout with each tile's
               slots permuted and padding ids -1 and TN + 5: K5 forward
               and backward and K6 against their plain versions, K7
               exactly.
19. gat-generic — launch counters to 0, a two-layer generic GATv2 stack
               (edge_dim 2, the forward policy's widths) forward and the
               gradient of sum(c * out) on orsirr_like150's tile graph,
               counters read (K3-K7 and K5's backward each launched, as
               often as GEN_CALLS says); output and gradients
               against the per-edge path on the card and in float64 on the
               CPU; ms per forward and per forward + backward; a
               ``torch.profiler`` reading of forward + backward passes
               (device busy, idle share, the device operations with the
               most time).
20. bell     — launch counters to 0, ``spmm_bell`` at docs/BENCH.md's
               block-ELL configuration (4096^2, 2% of the (8,128) blocks,
               K = 256), at blockshapes (32,128) and (128,128), and on
               65,536^2 matrices of the same density at (8,128) and
               (128,128) (JAX's streamed regime), ``spmv_bell`` once, and
               the 4096^2 (8,128) matrix again with its slots shuffled and
               3 explicit zero blocks added per row (correctness only), in
               each of K17's three instances (float32; bf16 blocks with
               bf16 X, the tensor-core kernel; bf16 blocks with float32
               X), counters read per instance; each against
               ``spmm_bell_ref`` (bf16 outputs within one bf16 ulp plus
               the float32 sums' slack) and scipy float64 of the stored
               values, a second launch's bits, and the bf16-block float32-X
               instance against the float32 one on the widened blocks, bit
               for bit; times as [dia], the library call torch.sparse CSR
               of the stored values in X's dtype @ X (at 4096^2 also the
               dense bf16 torch.matmul, printed); per case the real against
               stored block slots, kernel / library, the X bytes staged
               from L2 and each instance against the float32 one; for the
               tensor-core kernel its ptxas registers and spills and its
               shape per bm, each case's column tile and chunk-list build
               ms, and the (8,128) cases against their L2 floor (X's bytes
               staged from L2 over an L2 read yardstick, the row sums of
               a 32 MB bf16 buffer that stays in L2).
21. train-default — ``python -m gflownet_spai_tpu_torch.train --epochs 20``
               with every other argument at its default, in a subprocess on
               the card: exit 0, the DIA env on LF10_like (the checkpoint's
               enumeration stamp), a finite loss every epoch; then the
               validate CLI from its checkpoint: every row in
               validation.json.
22. dia-env  — the DIA reward env at scale: convdiff100000's ILU(0) seed
               through ``env_format="auto"`` (the DIA env, the tiled graph);
               256 sampled rewards against float64 scipy ‖M·A − I‖_F of
               the same keep masks and against the pair env, the same bits
               on a second call; reward ms per call of 16 and 256 against
               the pair env on the same actions (eager and graph replays);
               train steps as phase 9's recipe with K1-K4 counted from 0
               (2 per bucket, 2 per bucket, 1, 1 a step), ms/step, peak
               memory, the idle share under torch.profiler.
23. rowblock — the rowblock env at config 4 (orsirr_like150's SPAI seed,
               identity baseline, window order, t_cap 0): the plan's host
               build seconds; 256 sampled rewards against float64 scipy;
               the residuals of every plan variant (cm / mc layout, none /
               gram, float32 / bf16 storage, sorted order) against float64
               at the JAX oracles' tolerances, the same bits on a second
               call; reward ms against the pair env; train steps as in
               [dia-env].
24. dia-bf16 — the bf16-diagonal path (its kernels were held and timed in
               [dia] and [dia-multi]), launch counters to 0: the ops
               entry points on dia_astype(poisson1024, bf16),
               CG on poisson1024 with its Jacobi-16 and Chebyshev-16
               preconditioners (iterations and true residual beside
               [poisson]'s float32 rows; finite, not required to converge;
               each apply's device time against float32's) and
               jacobi_multirhs (16 systems, 100 sweeps); counters read:
               every bf16 instance launched.
25. native   — the host library against its numpy paths on
               orsirr_like150 and orsirr_like300: parsing a file
               ``write_mtx`` wrote, ILU(0) (values within 1e-12), RCM and
               the seed · A SpGEMM plan, each the same result; phase 3's
               whole setup on each path; seconds of each path, the g++
               build's seconds and the host's CPU model.
26. env-single — the single-sample reward API on the card, on the coo env
               of phase 3 and config 4's rowblock env ([rowblock]): for 8
               trajectories ``reward_from_actions`` against
               ``batched_rewards`` row by row within 1e-6 relative; µs per
               single-sample call.
27. grid     — the grid GFlowNet (``examples/grid_gfn_torch.py``: the
               grid env, ``scan_rollout``, TB, Adam 5e-3) for 300 steps of
               64 on the card: ms per step, the loss falling and more than
               35% of 512 samples in the high-reward bands.
28. profiling — ``utils.profiler_trace`` around two train steps of phase 9
               (the trace must name a ``gat_tile_fused`` kernel),
               ``utils.log_memory_usage`` (the card's MiB), and
               ``utils.timed`` on K8 at poisson1024 beside [dia]'s reading.
29. launchers — ``examples/chebyshev_cg_torch.py`` at its defaults
               (Poisson-1M) in a subprocess on the card: exit 0, every row
               converged, each row's iterations and wall seconds, and K8,
               K12 and K13 launched where the row reaches them.
30. parallel — the multi-device layer on a one-rank NCCL world (TCP store
               on 127.0.0.1; backend, NCCL version, an all_reduce probe),
               each multi-device call below with the launch counters
               K1-K4, K8, K12 set to 0 just before it and read just after
               (before its reference call), each kernel of its path > 0:
               on poisson1024
               ``halo_spmv`` and ``spmv_allgather`` against ``spmv_dia``,
               ``halo_spmv_power`` k 4 against four ``spmv_dia`` calls,
               ``distributed_jacobi`` against ``jacobi``, distributed CG /
               GMRES(30) at the single-device iteration counts (true
               residuals, ms per apply / iteration beside the single-device
               call's); ``sharded_policy_pooled`` on orsirr_like150's uniform
               tile layout against ``forward_policy_pooled``, values and
               gradients; ``train`` with the sharded sampler at phase 9's
               configuration (finite, moved, ms/step beside phase 9's) and
               ``make_dp_train_step`` on the 1×1 mesh against ``loss_fn``
               on the same noise; then ``bench_scaling.run([1], 262144)``
               (K8) and ``__graft_entry_torch__.entry()``; with two or more
               cards, the rank check ``gflownet_spai_tpu_torch.parallel.check``
               (``halo_spmv`` and a dp step) on min(count, 4) NCCL ranks
               started by torchrun.

Each phase prints its seconds.  The line before the last is the ``kernels``
JSON object; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import io
import itertools
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

import gflownet_spai_tpu_torch as port
from gflownet_spai_tpu_torch import _build, native
from gflownet_spai_tpu_torch.env import spai
from gflownet_spai_tpu_torch.gfn import gflownet as gfn
from gflownet_spai_tpu_torch.gfn.loss import log_reward, subtb_loss
from gflownet_spai_tpu_torch.gfn.replay import replay_sample
from gflownet_spai_tpu_torch.gfn.rollout import gumbel_topk_rollout, trajectory_logprobs
from gflownet_spai_tpu_torch.models import gat
from gflownet_spai_tpu_torch.models import policies as pol
from gflownet_spai_tpu_torch.ops import bsr, dia
from gflownet_spai_tpu_torch.ops import gat_fused as gf
from gflownet_spai_tpu_torch.ops import segment as seg
from gflownet_spai_tpu_torch.sample.__main__ import main as sample_main
from gflownet_spai_tpu_torch.train import TrainConfig, setup, train
from gflownet_spai_tpu_torch.train.loop import (apply_updates, make_train_step,
                                                tree_leaves, tree_replace)

MATRIX = "orsirr_like150"
BATCH = 256
BATCHES = 4                 # sampled batches on the main path (first is warm-up)
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
F32_OPS_PER_S = 67e12       # H100 SXM f32 outside the tensor cores
TC_OPS_PER_S = 989e12       # H100 SXM dense bf16 on the tensor cores
# K1 against its plain version: the online softmax rescales its sums and
# divides once per node, the plain version divides per slot and sums by
# matmuls; float32 rounding only, the same bits on every launch (at most
# 8.4% of a 1e-5 tolerance on this path, measured on an H100)
K1_TOL = dict(rtol=4e-6, atol=4e-6)
# K2: its per-tile outputs (dw_e, datt and the uniform layer's dxs, dxd) are
# float32 sums over every real slot of a bucket (up to ~96,000 terms of
# mixed sign), reduced in another order than the plain version's.  Both
# are held against the plain version in float64: K2 may be at most 2x as
# far from it as the plain float32 version is, plus 1e-5 of the output's
# largest magnitude (at least 1), for the one-tile bucket, where the plain
# version's own error is tiny.  K2's sums run in a fixed order, so its
# rounding does not change between launches
K2_FACTOR, K2_FLOOR = 2.0, 1e-5
EPS32 = float(torch.finfo(torch.float32).eps)
BF16 = torch.bfloat16
# K4 sums each row of at most 32 slots in slot order, as index_add_ on the
# CPU does: the same bits as the plain version there; a hub row (more
# slots) is summed by a warp in another fixed order, within rtol·|exact| +
# eps_sums·eps32·Σ|g| of float64 (a tree of depth d is within d·eps32/2·Σ|g|)
K4_TOL = dict(rtol=0.0, eps_sums=1.0)
# gradients, tiled (K1-K4) vs per-edge path: the repo's bound (rtol 5e-4,
# atol 5e-5) times the parameter group's largest gradient, because a
# layer's w_dst / w_edge / att gradients cancel to ~1e-9 of its w_src one
GRAD_RTOL, GRAD_ATOL = 5e-4, 5e-5
# the training slice: the repo's at-scale recipe (docs/BENCH.md round 4)
# without the spai seed and the sharded sampler
TRAIN = dict(matrix=MATRIX, env_format="coo", loss="subtb", backward="linear",
             t_cap=4096, terminal_bias=8.0, batch_size=16, lr=2e-3,
             plateau_patience=0, replay_size=32, replay_samples=4,
             replay_prioritized=1.0, alpha_fixed=0.98,
             reward_baseline="identity", log_every=1)
EPOCHS = 12
LOGIT_TOL = dict(rtol=2e-4, atol=2e-5)   # tiled vs per-edge GAT (repo's own bound)
REWARD_RTOL = 1e-4          # f32 device reward vs float64 host reward


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` back-to-back eager calls
    (CUDA events, after one warm-up call).  Where a call's device work is
    shorter than its host dispatch, this is the dispatch rate."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int, replays: int = 5) -> float:
    """Mean device milliseconds of one call of ``fn``: ``reps`` calls are
    captured into one CUDA graph, whose replays are timed with CUDA events,
    so host dispatch is not in the time."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def bound_ms(nbytes: float, ops: float, rate: float = F32_OPS_PER_S) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / rate
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def phase_card():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    print(f"[card] {name} x{count}; torch {torch.__version__} cuda {torch.version.cuda}")
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip()
          else f"nvidia-smi unavailable (exit {smi.returncode})", flush=True)
    return name, count


BUILD_LOG = []              # the build's compiler output (ptxas -v), for [bell]
NATIVE_BUILD_S = []         # the native host library's g++ seconds, for [native]


def phase_build():
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        secs = _build.build_all(verbose=True)
    print(log.getvalue(), end="", flush=True)
    BUILD_LOG.extend(log.getvalue().splitlines())
    for name in _build.SOURCES:
        _build.load(name)
    print(f"[build] {len(_build.SOURCES)} kernel sources in {secs:.2f} s", flush=True)
    t0 = time.perf_counter()
    if not (native.build() and native.available()):
        fail(f"the native host library did not build from {native.SOURCE} (g++)")
    NATIVE_BUILD_S.append(time.perf_counter() - t0)
    print(f"[build] native host library: g++ {' '.join(native.CXX_FLAGS)} in "
          f"{NATIVE_BUILD_S[0]:.2f} s -> {native.library_path().name}", flush=True)


def _k1_case(bk, layer, gen, dev):
    """Inputs K1 sees at this bucket: layer 1 uniform (H·D = 16), layer 2
    per-slot/per-node rows (H = 1, D = 4); edge scalars are the graph's."""
    tb = bk.tiles
    H, D = (4, 4) if layer == 1 else (1, 4)
    HD = H * D
    r = lambda *s: torch.randn(s, generator=gen, device=dev)
    T, S, TN = tb.tiles, tb.slots, tb.tile_nodes
    xs = r(1, HD) if layer == 1 else r(T * S, HD)
    xd = r(1, HD) if layer == 1 else r(T * TN, HD)
    args = (bk.attr_t.reshape(-1), xs, xd, r(HD), r(H, D))
    # bytes the function needs: every local_dst; attr and (layer 2) the xs
    # rows of real slots only; the xd rows of nodes that have slots; w_e,
    # att; the whole output
    real, nodes = _tile_counts(tb, dev)
    xs_rows = 1 if layer == 1 else real
    xd_rows = 1 if layer == 1 else nodes
    nbytes = 4 * (T * S + real + (xs_rows + xd_rows + 2) * HD + T * TN * HD)
    return tb, args, nbytes, real * (8 * HD + 5 * H)


def launch_floor(reps: int = 20) -> float:
    """Device ms of a one-element in-place ``add_``, timed as the kernels
    are (``graph_ms``, the same calls per graph and replays): the least
    one launch takes in a replayed graph on this card."""
    one = torch.zeros(1, device="cuda")
    return graph_ms(lambda: one.add_(1.0), reps)


# K1 / K2 lane plans timed beside the wrapper's pick: (channel lanes per
# head, slot lanes per node).  The rule (``gf._lane_plan``) takes P 1 at
# D 4, and Q from the bucket's mean run (two or three slots a lane) unless
# the bucket's lanes would pass 16 warps per SM
GAT_PLANS = ((1, 1), (1, 2), (1, 4), (1, 8), (2, 1))


@contextlib.contextmanager
def _gat_plan(lanes, slots):
    saved = gf._lane_plan
    gf._lane_plan = lambda H, D, run=1.0, cap=None: (
        lanes, slots, 1 << (H * lanes * slots - 1).bit_length())
    try:
        yield
    finally:
        gf._lane_plan = saved


def _plan_times(key, tb, args, call, check):
    """``call`` timed at every plan of GAT_PLANS that fits a warp (outputs
    held by ``check`` first), printed on one line beside the rule's pick
    for K1's / K2's inputs ``args``."""
    H, D = args[4].shape
    pick = gf._check_cuda_args("plan", tb, *args[:5])[:2]
    times = []
    for plan in GAT_PLANS:
        if H * plan[0] * plan[1] > 32:
            continue
        with _gat_plan(*plan):
            check(call())
            times.append("P{}Q{} ".format(*plan) + f"{graph_ms(call, 20):.5f}")
    print(f"[{key}-plans] T={tb.tiles} S={tb.slots} H={H} D={D} mean run "
          f"{gf._mean_run(tb):.2f}: " + ", ".join(times)
          + " ms (the rule picks P{}Q{})".format(*pick), flush=True)


def phase_kernels(graph, dev):
    """K1 and K3 against their plain versions at the slice's shapes."""
    gen = torch.Generator(device=dev).manual_seed(1234)
    k1 = dict(err=0.0, ms=0.0, eager=0.0, plain=0.0, bytes=0.0, ops=0.0)
    floor = launch_floor()
    print(f"[kernels] launch floor (graph replay of a one-element add_): "
          f"{floor:.5f} ms", flush=True)
    for bk in graph.gat_buckets:
        tb = bk.tiles
        for layer in (1, 2):
            tiles, args, nbytes, ops = _k1_case(bk, layer, gen, dev)
            got = gf.gat_tile_fused(tiles, *args)
            again = gf.gat_tile_fused(tiles, *args)
            want = gf.gat_tile_fused_ref(tiles, *args)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            if not torch.allclose(got, want, **K1_TOL):
                fail(f"K1 disagrees with its plain version at bucket "
                     f"T={tb.tiles} S={tb.slots} layer {layer}: max abs err {err}")
            if not torch.equal(got, again):
                fail(f"K1 gave other bits on a second launch at bucket "
                     f"T={tb.tiles} S={tb.slots} layer {layer}")

            def k1_check(out, want=want, tb=tb, layer=layer):
                if not torch.allclose(out, want, **K1_TOL):
                    fail(f"K1 at a timed lane plan disagrees with its plain "
                         f"version at bucket T={tb.tiles} S={tb.slots} layer {layer}")

            _plan_times("K1", tiles, args, lambda: gf.gat_tile_fused(tiles, *args),
                        k1_check)
            ms = graph_ms(lambda: gf.gat_tile_fused(tiles, *args), 20)
            eager = cuda_ms(lambda: gf.gat_tile_fused(tiles, *args), 20)
            plain = cuda_ms(lambda: gf.gat_tile_fused_ref(tiles, *args), 3)
            b, _ = bound_ms(nbytes, ops)
            share = float(((got - want).abs()
                           / (K1_TOL["atol"] + K1_TOL["rtol"] * want.abs())).max())
            print(f"[K1] T={tb.tiles} S={tb.slots} layer {layer}: max abs err "
                  f"{err:.3e} (rel {err / max(float(want.abs().max()), 1e-30):.3e}, "
                  f"{100 * share:.1f}% of the tolerance), equal bits on a second "
                  f"launch; kernel {ms:.5f} ms (graph "
                  f"replay, one L2-warm copy of the inputs; eager calls "
                  f"{eager:.5f} ms), plain {plain:.4f} ms, bound {b:.6f} ms, "
                  f"launch floor {floor:.5f} ms", flush=True)
            k1["err"] = max(k1["err"], err)
            k1["ms"] += ms
            k1["eager"] += eager
            k1["plain"] += plain
            k1["bytes"] += nbytes
            k1["ops"] += ops
    return k1, _phase_k3(graph, gen, dev, floor)


def _row_calls(graph):
    """The K3 / K4 calls timed: one single-layout call per bucket (as the
    path made them until it took one call for every bucket), then the
    path's call over every bucket."""
    plans = tuple(bk.srcwin for bk in graph.gat_buckets)
    calls = [(f"bucket T={bk.tiles.tiles} S={bk.tiles.slots} win={bk.srcwin.win}", (i,))
             for i, bk in enumerate(graph.gat_buckets)]
    return plans, calls + [(f"all {len(plans)} buckets", tuple(range(len(plans))))]


def _phase_k3(graph, gen, dev, floor):
    """K3 at the slice's shapes (layer-2 source rows [2n, 4]): each call of
    ``_row_calls`` exact against its plain version, timed beside one
    ``index_select`` over the same effective rows, the bound and the launch
    floor; returns the all-bucket call's record."""
    n, D = graph.tiles.num_nodes, 4
    vals = torch.randn((n, D), generator=gen, device=dev)
    ext = torch.cat([vals, vals.new_zeros(1, D)])
    plans, calls = _row_calls(graph)
    singles = dict(ms=0.0, eager=0.0)
    for label, pick in calls:
        ps = tuple(plans[i] for i in pick)
        got = seg.gather_rows_buckets(ps, vals)
        want = seg.gather_rows_buckets_ref(ps, vals)
        rows = seg.row_plan(ps, n).rows.long()
        lib = torch.index_select(ext, 0, rows)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            fail(f"K3 disagrees with its plain version at {label}")
        if not torch.equal(lib, torch.cat(want)):
            fail("the index_select yardstick does not compute K3's function")
        rec = dict(err=0.0, lib=graph_ms(lambda: torch.index_select(ext, 0, rows), 50),
                   ms=graph_ms(lambda: seg.gather_rows_buckets(ps, vals), 50),
                   eager=cuda_ms(lambda: seg.gather_rows_buckets(ps, vals), 50),
                   plain=cuda_ms(lambda: seg.gather_rows_buckets_ref(ps, vals), 10))
        # bytes the function needs: one source-row index per slot, each
        # distinct source row once, the whole output
        slots = rows.numel()
        distinct = int(torch.unique(rows[rows < n]).numel())
        rec["bytes"] = 4 * (slots + distinct * D + slots * D)
        b, _ = bound_ms(rec["bytes"], 0)
        print(f"[K3] {label}: {slots} slots, distinct rows {distinct}: exact; "
              f"kernel {rec['ms']:.5f} ms (graph replay; eager calls "
              f"{rec['eager']:.5f} ms), plain {rec['plain']:.4f} ms, index_select "
              f"{rec['lib']:.5f} ms (graph replay), bound {b:.6f} ms, launch floor "
              f"{floor:.5f} ms", flush=True)
        if len(pick) == 1:
            singles = {k: singles[k] + rec[k] for k in singles}
    print(f"[K3] one call per bucket, summed: kernel {singles['ms']:.5f} ms, eager "
          f"{singles['eager']:.5f} ms; one call for every bucket: kernel "
          f"{rec['ms']:.5f} ms, eager {rec['eager']:.5f} ms", flush=True)
    return rec


def _host_reward(seed, a, keep_row, alpha, base_res, base_flops):
    """Reward of one keep mask in float64 with scipy (independent of the
    device pair plan)."""
    import scipy.sparse as sp

    n = a.shape[0]
    m = sp.csr_matrix((seed.data.astype(np.float64) * keep_row,
                       (seed.row, seed.col)), shape=seed.shape)
    am = sp.csr_matrix((a.data.astype(np.float64), (a.row, a.col)), shape=a.shape)
    c = (m @ am - sp.eye(n, format="csr")).tocoo()
    res = float(np.sqrt(np.sum(c.data * c.data)))
    comp = 2.0 * keep_row.sum() * n / base_flops
    return 1000.0 * (alpha * (1 - res / base_res) + (1 - alpha) * (1 - comp))


def phase_slice(a, seed, env, graph, mcfg, params, dev):
    A = mcfg.num_actions
    gen = torch.Generator(device=dev).manual_seed(7)
    gf.gat_tile_fused.launches = 0
    seg.gather_rows_windows.launches = 0
    torch.cuda.reset_peak_memory_stats()
    times, outs = [], []
    for _ in range(BATCHES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = gfn.sample(params, env, graph, mcfg, gen, BATCH)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        outs.append(out)
    launches = {"K1": gf.gat_tile_fused.launches, "K3": seg.gather_rows_windows.launches}
    peak = torch.cuda.max_memory_allocated()
    n_b = len(graph.gat_buckets)
    if launches != {"K1": 2 * n_b * BATCHES, "K3": BATCHES}:
        fail(f"launch counts {launches} on {BATCHES} batches over {n_b} buckets: "
             "the main path did not run K1 once per bucket and layer and K3 once "
             "per forward")
    for out in outs:
        r, lp = out.rewards, out.rollout.fwd_logprobs
        if r.shape != (BATCH,) or not torch.isfinite(r).all() \
                or not torch.isfinite(lp).all():
            fail("non-finite or misshapen rewards / log-probs")
        lengths = out.rollout.lengths
        last = out.rollout.actions.gather(1, (lengths - 1)[:, None])[:, 0]
        if not bool((last == A - 1).all()) or bool((lengths > A).any()):
            fail("a trajectory does not end in the terminal action")
    out = outs[-1]
    # rewards of two trajectories against a float64 host reference
    acts = out.rollout.actions[:2].cpu().numpy()
    alpha = float(out.alpha)
    for b in range(2):
        keep = np.ones(seed.nnz)
        keep[acts[b][(acts[b] >= 0) & (acts[b] < seed.nnz)]] = 0.0
        want = _host_reward(seed, a, keep, alpha, float(env.baseline_residual),
                            env.baseline_flops)
        got = float(out.rewards[b])
        if abs(got - want) > REWARD_RTOL * max(abs(want), 1.0):
            fail(f"reward {got} vs float64 host reference {want}")
    # kernel-path logits against the per-edge scatter path on the card
    dense = pol.graph_from_seed(seed, device=dev)
    want = pol.forward_policy_logits(params.forward, dense, A, mcfg.hidden_dim,
                                     mcfg.heads)
    logit_err = float((out.logits - want).abs().max())
    if not torch.allclose(out.logits, want, **LOGIT_TOL):
        fail(f"kernel-path logits vs the scatter path: max abs err {logit_err}")
    lens = torch.cat([o.rollout.lengths for o in outs]).float()
    rew = torch.cat([o.rewards for o in outs])
    steady = times[1:]
    print(f"[slice] {MATRIX}: actions {A}, nodes {graph.tiles.num_nodes}, tiles "
          f"{graph.tiles.tiles}, buckets (tiles, S, win) "
          f"{[(b.tiles.tiles, b.tiles.slots, b.srcwin.win) for b in graph.gat_buckets]}",
          flush=True)
    print(f"[slice] batch {BATCH}: ms/batch {np.mean(steady):.3f} "
          f"(batches {', '.join(f'{t:.3f}' for t in times)}; first is warm-up); "
          f"reward mean {float(rew.mean()):.4f} max {float(rew.max()):.4f}; "
          f"mean length {float(lens.mean()):.1f}; peak memory "
          f"{peak / 2**20:.1f} MiB; launches {launches}; logits vs scatter "
          f"path max abs err {logit_err:.3e}", flush=True)
    return launches


def phase_breakdown(env, graph, mcfg, params, dev, reps=5):
    """Host-clock milliseconds of the three stages of ``sample``."""
    gen = torch.Generator(device=dev).manual_seed(11)
    A = mcfg.num_actions

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            res = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps, res

    fwd_ms, logits = timed(lambda: pol.forward_policy_logits(
        params.forward, graph, A, mcfg.hidden_dim, mcfg.heads))
    roll_ms, roll = timed(lambda: gumbel_topk_rollout(
        logits.expand(BATCH, A), gen, A - 1))
    alpha = pol.forward_policy_alpha(params.forward)
    rew_ms, _ = timed(lambda: spai.batched_rewards(env, roll.actions, alpha))
    print(f"[breakdown] per batch of {BATCH}: policy forward {fwd_ms:.3f} ms, "
          f"rollout (noise + sort over [{BATCH}, {A}]) {roll_ms:.3f} ms, "
          f"reward (pair plan, {env.plan.npairs} pairs) {rew_ms:.3f} ms",
          flush=True)


def _tile_counts(tb, dev):
    """Real (non-padding) slots and nodes that have slots, of one bucket."""
    T, TN = tb.tiles, tb.tile_nodes
    ld = tb.local_dst.long()
    is_real = ld < TN
    nodes = torch.unique((ld + torch.arange(T, device=dev)[:, None] * TN)[is_real])
    return int(is_real.sum()), int(nodes.numel())


def _k2_check(got, want, want64, where):
    """K2's outputs against the plain version in float64 (``K2_FACTOR``,
    ``K2_FLOOR``); returns (max abs err against the float32 plain version,
    the largest share of the tolerance used)."""
    worst = case_err = 0.0
    for name, a, b, b64 in zip(("xs", "xd", "w_e", "att"), got, want, want64):
        scale = max(float(b64.abs().max()), 1.0)
        err64 = float((a.double() - b64).abs().max())
        plain64 = float((b.double() - b64).abs().max())
        tol = K2_FACTOR * plain64 + K2_FLOOR * scale
        if a.shape != b.shape or err64 > tol:
            fail(f"K2 d{name} at {where}: {err64:.3e} from the float64 plain "
                 f"version, the float32 plain version {plain64:.3e}")
        case_err = max(case_err, float((a - b).abs().max()))
        worst = max(worst, err64 / tol)
    return case_err, worst


def phase_kernels_bwd(graph, dev):
    """K2 and K4 against their plain versions at the slice's shapes."""
    gen = torch.Generator(device=dev).manual_seed(4321)
    k2 = dict(err=0.0, ms=0.0, eager=0.0, plain=0.0, bytes=0.0, ops=0.0)
    floor = launch_floor()
    print(f"[backward] launch floor (graph replay of a one-element add_): "
          f"{floor:.5f} ms", flush=True)
    for bk in graph.gat_buckets:
        tb = bk.tiles
        T, S, TN = tb.tiles, tb.slots, tb.tile_nodes
        real, nodes = _tile_counts(tb, dev)
        for layer in (1, 2):
            tiles, args, _, _ = _k1_case(bk, layer, gen, dev)
            H, D = args[4].shape
            HD = H * D
            g = torch.randn((T * TN, HD), generator=gen, device=dev)
            got = gf.gat_tile_fused_bwd(tiles, *args, g)
            again = gf.gat_tile_fused_bwd(tiles, *args, g)
            want = gf.gat_tile_fused_bwd_ref(tiles, *args, g)
            want64 = gf.gat_tile_fused_bwd_ref(tiles, *(x.double() for x in args),
                                               g.double())
            torch.cuda.synchronize()
            where = f"bucket T={T} S={S} layer {layer}"
            case_err, worst = _k2_check(got, want, want64, where)
            if not all(torch.equal(x, y) for x, y in zip(got, again)):
                fail(f"K2 gave other bits on a second launch at {where}")
            _plan_times("K2", tiles, args, lambda: gf.gat_tile_fused_bwd(tiles, *args, g),
                        lambda out, want=want, want64=want64, where=where:
                        _k2_check(out, want, want64, where + " (a timed lane plan)"))
            k2["err"] = max(k2["err"], case_err)
            ms = graph_ms(lambda: gf.gat_tile_fused_bwd(tiles, *args, g), 20)
            eager = cuda_ms(lambda: gf.gat_tile_fused_bwd(tiles, *args, g), 20)
            plain = cuda_ms(lambda: gf.gat_tile_fused_bwd_ref(tiles, *args, g), 3)
            # bytes the function needs: K1's inputs (local_dst, attr and
            # layer-2 xs rows of real slots, xd rows of nodes with slots,
            # w_e, att), g rows of nodes with slots, every output once
            xs_rows = 1 if layer == 1 else real
            xd_rows = 1 if layer == 1 else nodes
            out_rows = (1 if layer == 1 else T * S) + (1 if layer == 1 else T * TN) + 2
            nbytes = 4 * (T * S + real + (xs_rows + xd_rows + 2 + nodes + out_rows) * HD)
            ops = real * (18 * HD + 10 * H)
            b, _ = bound_ms(nbytes, ops)
            print(f"[K2] T={T} S={S} layer {layer}: max abs err vs plain "
                  f"{case_err:.3e}; vs float64, {100 * worst:.1f}% of the "
                  f"tolerance; equal bits on a second launch; kernel {ms:.5f} ms "
                  f"(graph replay, one L2-warm copy of the inputs; eager calls "
                  f"{eager:.5f} ms), plain {plain:.4f} ms, bound {b:.6f} ms, "
                  f"launch floor {floor:.5f} ms", flush=True)
            k2["ms"] += ms
            k2["eager"] += eager
            k2["plain"] += plain
            k2["bytes"] += nbytes
            k2["ops"] += ops
    return k2, _phase_k4(graph, gen, dev, floor)


def _hold_k4(got, plans, gs, n, where):
    """K4's dv against its plain version computed on the CPU, where
    ``index_add_`` sums each row in slot order: the same bits on every row
    of at most 32 slots, hub rows within ``K4_TOL`` of float64.  Returns
    (max abs err against the plain version, the largest share of the hub
    bound used, hub rows)."""
    host = [p.to("cpu") for p in plans]
    cpu = lambda f: [f(g.cpu()) for g in gs]
    want = seg.scatter_rows_buckets_ref(host, cpu(lambda g: g), n)
    exact = seg.scatter_rows_buckets_ref(host, cpu(torch.Tensor.double), n)
    sums = seg.scatter_rows_buckets_ref(host, cpu(lambda g: g.double().abs()), n)
    hub = torch.zeros(n, dtype=torch.bool)
    hub[seg.row_plan(host, n).hubs.long()] = True
    got = got.cpu()
    if not torch.equal(got[~hub], want[~hub]):
        fail(f"K4 at {where} differs from the bits of its plain version on the CPU")
    err64 = (got[hub].double() - exact[hub]).abs()
    bound = K4_TOL["rtol"] * exact[hub].abs() + K4_TOL["eps_sums"] * EPS32 * sums[hub]
    if not bool((err64 <= bound).all()):
        fail(f"K4 at {where}: a hub row is {float(err64.max()):.3e} from float64")
    share = float((err64 / bound).max()) if bool(hub.any()) else 0.0
    return float((got - want).abs().max()), share, int(hub.sum())


def _phase_k4(graph, gen, dev, floor):
    """K4 at the slice's shapes (cotangents of the layer-2 source rows,
    [T_b·S_b, 4] per bucket, onto [2n, 4]): each call of ``_row_calls``
    held by ``_hold_k4`` and to the same bits on a second launch, timed
    beside one ``index_add_`` over the same effective rows, the bound and
    the launch floor; returns the all-bucket call's record.  Also times the
    adds of the per-bucket partials that autograd made when each bucket
    had its own call."""
    n, D = graph.tiles.num_nodes, 4
    plans, calls = _row_calls(graph)
    gs = [torch.randn((p.lsrc.numel(), D), generator=gen, device=dev) for p in plans]
    singles = dict(ms=0.0, eager=0.0)
    for label, pick in calls:
        ps, g = tuple(plans[i] for i in pick), [gs[i] for i in pick]
        got = seg.scatter_rows_buckets(ps, g, n)
        again = seg.scatter_rows_buckets(ps, g, n)
        rows = seg.row_plan(ps, n).rows.long()
        g_cat = torch.cat(g)
        lib_fn = lambda: torch.zeros((n + 1, D), device=dev).index_add_(0, rows, g_cat)
        lib = lib_fn()[:n]
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            fail(f"K4 gave other bits on a second launch at {label}")
        err, share, hubs = _hold_k4(got, ps, g, n, label)
        exact = seg.scatter_rows_buckets_ref(ps, [x.double() for x in g], n)
        sums = seg.scatter_rows_buckets_ref(ps, [x.double().abs() for x in g], n)
        if not bool(((lib.double() - exact).abs() <= 4 * EPS32 * sums).all()):
            fail("the index_add_ yardstick does not compute K4's function")
        rec = dict(err=err, lib=graph_ms(lib_fn, 50),
                   ms=graph_ms(lambda: seg.scatter_rows_buckets(ps, g, n), 50),
                   eager=cuda_ms(lambda: seg.scatter_rows_buckets(ps, g, n), 50),
                   plain=cuda_ms(lambda: seg.scatter_rows_buckets_ref(ps, g, n), 10))
        # bytes the function needs: one source-row index per slot, the g
        # rows of slots that read a row, the whole output once; one add per
        # word of those g rows
        used = int((rows < n).sum())
        rec["bytes"], rec["ops"] = 4 * (rows.numel() + used * D + n * D), used * D
        b, _ = bound_ms(rec["bytes"], rec["ops"])
        print(f"[K4] {label}: {rows.numel()} slots, {used} read a row, {hubs} hub "
              f"rows: the plain version's bits elsewhere (max abs err {err:.3e}, "
              f"{100 * share:.1f}% of the hub bound), equal bits on a second launch; "
              f"kernel {rec['ms']:.5f} ms (graph replay; eager calls "
              f"{rec['eager']:.5f} ms), plain {rec['plain']:.4f} ms, index_add_ "
              f"{rec['lib']:.5f} ms (graph replay), bound {b:.6f} ms, launch floor "
              f"{floor:.5f} ms", flush=True)
        if len(pick) == 1:
            singles = {k: singles[k] + rec[k] for k in singles}
    parts = [torch.randn((n, D), generator=gen, device=dev) for _ in plans]
    adds = graph_ms(lambda: functools.reduce(torch.add, parts), 50)
    print(f"[K4] one call per bucket, summed: kernel {singles['ms']:.5f} ms, eager "
          f"{singles['eager']:.5f} ms, and autograd's {len(plans) - 1} adds of the "
          f"[{n}, {D}] partials {adds:.5f} ms (graph replay); one call for every "
          f"bucket: kernel {rec['ms']:.5f} ms, eager {rec['eager']:.5f} ms", flush=True)
    return rec


def _forward_grads(params, graph, mcfg, c):
    """Gradient of Σ c·logits in every forward parameter, by path."""
    named = tree_leaves(params.forward)
    leaves = [x.detach().requires_grad_(True) for _, x in named]
    fwd = tree_replace(params.forward, iter(leaves))
    logits = pol.forward_policy_logits(fwd, graph, mcfg.num_actions,
                                       mcfg.hidden_dim, mcfg.heads)
    grads = torch.autograd.grad((logits * c).sum(), leaves, allow_unused=True)
    return {p: torch.zeros_like(x) if g is None else g
            for (p, x), g in zip(named, grads)}


def phase_gradients(seed, graph, mcfg, params, dev):
    """The forward parameters' gradient through the tiled graph (K1-K4)
    against the per-edge scatter path, both on the card."""
    gen = torch.Generator(device=dev).manual_seed(99)
    c = torch.randn(mcfg.num_actions, generator=gen, device=dev)
    k2, k4 = gf.gat_tile_fused_bwd.launches, seg.scatter_rows_windows.launches
    got = _forward_grads(params, graph, mcfg, c)
    n_b = len(graph.gat_buckets)
    if (gf.gat_tile_fused_bwd.launches - k2, seg.scatter_rows_windows.launches - k4) \
            != (2 * n_b, 1):
        fail("the tiled gradient did not run K2 once per bucket and layer and K4 once")
    want = _forward_grads(params, pol.graph_from_seed(seed, device=dev), mcfg, c)
    torch.cuda.synchronize()
    group = lambda p: p.rsplit("/", 1)[0]
    scale = {}
    for p, w in want.items():
        scale[group(p)] = max(scale.get(group(p), 0.0), float(w.abs().max()))
    worst = 0.0
    for p, w in want.items():
        err = float((got[p] - w).abs().max())
        worst = max(worst, err / max(scale[group(p)], 1e-30))
        if not torch.allclose(got[p], w, rtol=GRAD_RTOL,
                              atol=GRAD_ATOL * scale[group(p)]):
            fail(f"gradient of {p}: tiled vs per-edge path max abs err {err} "
                 f"(group scale {scale[group(p)]:.3e})")
    print(f"[gradients] d(sum c*logits)/d(forward params), tiled (K1-K4) vs "
          f"per-edge path: max abs err / group scale {worst:.3e} over "
          f"{len(want)} leaves", flush=True)


COUNTERS = {"K1": gf.gat_tile_fused, "K2": gf.gat_tile_fused_bwd,
            "K3": seg.gather_rows_windows, "K4": seg.scatter_rows_windows}


def phase_train(run_dir: Path, dev):
    """``train(cfg)`` at the training slice's configuration."""
    cfg = TrainConfig(**TRAIN, num_epochs=EPOCHS, out_dir=str(run_dir))
    _, _, env, graph, mcfg, opt, init = setup(cfg)
    n_b = len(graph.gat_buckets)
    for fn in COUNTERS.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    state, history = train(cfg)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in COUNTERS.items()}
    peak = torch.cuda.max_memory_allocated()
    per_step = {"K1": 2 * n_b, "K2": 2 * n_b, "K3": 1, "K4": 1}
    if launches != {k: v * EPOCHS for k, v in per_step.items()}:
        fail(f"launch counts {launches} over {EPOCHS} train steps: expected "
             f"{per_step} per step")
    recs = [json.loads(x) for x in (run_dir / "metrics.jsonl").read_text().splitlines()]
    if [r["epoch"] for r in recs] != list(range(EPOCHS)):
        fail("metrics.jsonl does not hold every epoch")
    if not all(np.isfinite(r["loss"]) and not r["skipped"] for r in recs) \
            or not np.isfinite(history).all():
        fail("a non-finite loss in the training slice")
    moved = [p for (p, a), (_, b) in zip(tree_leaves(state.params.forward),
                                         tree_leaves(init.params.forward))
             if not torch.equal(a, b)]
    for need in ("/gat1/w_src", "/gat2/w_src", "/fc_w", "/fc_b"):
        if need not in moved:
            fail(f"forward parameter {need} did not change in training")
    wall = [r["wall_s"] * 1e3 for r in recs]
    step_ms = float(np.mean(wall[1:]))
    print(f"[train] {EPOCHS} steps of batch {cfg.batch_size} + {cfg.replay_samples} "
          f"replayed, t_cap {mcfg.t_cap}: steady ms/step {step_ms:.3f} (steps "
          f"{', '.join(f'{w:.3f}' for w in wall)}; the first includes warm-up); "
          f"peak memory {peak / 2**20:.1f} MiB; launches {launches}", flush=True)
    for r in recs:
        print(f"[train] epoch {r['epoch']}: loss {r['loss']:.4f} reward mean "
              f"{r['reward_mean']:.4f} max {r['reward_max']:.4f} mean length "
              f"{r['mean_len']:.1f}", flush=True)
    return cfg, env, graph, mcfg, opt, state, launches, step_ms, peak


def phase_step_breakdown(cfg, env, graph, mcfg, opt, state, reps=3):
    """One train step cut into synchronised parts (host clock), mirroring
    ``gfn.loss_fn`` and ``make_train_step`` piece by piece."""
    A, B = mcfg.num_actions, cfg.batch_size
    gen = state.generator
    parts: dict = {}

    def mark(name, t):
        torch.cuda.synchronize()
        now = time.perf_counter()
        parts[name] = parts.get(name, 0.0) + (now - t) * 1e3 / reps
        return now

    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r_actions, _, r_valid = replay_sample(state.replay, gen, cfg.replay_samples,
                                              prioritized=cfg.replay_prioritized)
        leaves = [x.detach().requires_grad_(True) for _, x in tree_leaves(state.params)]
        params = tree_replace(state.params, iter(leaves))
        t = mark("replay draw", t)
        logits = pol.forward_policy_logits(params.forward, graph, A, mcfg.hidden_dim,
                                           mcfg.heads)
        t = mark("sample: policy forward (K1, K3)", t)
        alpha = torch.tensor(mcfg.alpha_fixed, dtype=logits.dtype, device=logits.device)
        roll = gumbel_topk_rollout(logits.expand(B, A), gen, A - 1, t_cap=mcfg.t_cap)
        t = mark("sample: rollout (noise + top-k)", t)
        rewards = spai.batched_rewards(env, roll.actions, alpha)
        t = mark("sample: reward (pair plan)", t)
        r_fwd = trajectory_logprobs(logits, r_actions)
        r_rewards = spai.batched_rewards(env, r_actions, alpha)
        t = mark("loss: replay re-scoring", t)
        actions = torch.cat([roll.actions, r_actions], 0)
        back_lp = gfn.backward_logprobs(params, mcfg, actions)
        t = mark("loss: backward policy (linear scan)", t)
        terminated = torch.cat([torch.any(roll.actions == A - 1, dim=-1),
                                torch.ones_like(r_valid)], 0)
        weights = torch.cat([torch.ones(B, device=logits.device),
                             r_valid.to(logits.dtype)], 0)
        lengths = torch.cat([roll.lengths, (r_actions >= 0).sum(-1)], 0)
        log_r = torch.cat([log_reward(rewards), log_reward(r_rewards)], 0)
        loss = subtb_loss(pol.flow_head_logF(params.flow, actions), log_r,
                          torch.cat([roll.fwd_logprobs, r_fwd], 0), back_lp, lengths,
                          lam=mcfg.subtb_lambda, weights=weights, terminated=terminated)
        t = mark("loss: SubTB", t)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        t = mark("backward() (K2, K4 and the rest)", t)
        with torch.no_grad():
            grads = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)]
            updates, _ = opt.update(grads, state.opt_state, value=loss.detach())
            apply_updates(tree_replace(state.params, (x.detach() for x in leaves)),
                          updates)
        mark("optimizer (Adam)", t)
    total = sum(parts.values())
    print(f"[step] one train step, synchronised parts (mean of {reps}), total "
          f"{total:.3f} ms: " + "; ".join(f"{k} {v:.3f}" for k, v in parts.items()),
          flush=True)
    return parts


def _profiled(fn, steps):
    """``fn`` run ``steps`` times under ``torch.profiler`` after one
    warm-up call: wall ms (host clock, synchronised) and device busy ms per
    call, and the device kernels and the host operators (self CPU) with the
    most ms per call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    cuda = torch.autograd.DeviceType.CUDA
    busy_ms = sum(e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type == cuda) / 1e3 / steps
    ka = prof.key_averages()
    top = lambda rows, key: "; ".join(
        f"{e.key[:56]} {key(e) / 1e3 / steps:.4f}"
        for e in sorted(rows, key=key, reverse=True)[:8])
    return (wall_ms, busy_ms,
            top([e for e in ka if e.device_type == cuda], lambda e: e.device_time_total),
            top([e for e in ka if e.device_type != cuda], lambda e: e.self_cpu_time_total))


def phase_profile(cfg, env, graph, mcfg, opt, state, steps=3):
    """``torch.profiler`` over a few real train steps: the device's busy
    share of the wall time and the operators that take the most host and
    device time."""
    step = make_train_step(cfg, env, graph, mcfg, opt)
    box = [state]

    def run():
        box[0], _ = step(box[0])

    wall_ms, busy_ms, kernels, ops = _profiled(run, steps)
    print(f"[profile] {steps} train steps under torch.profiler: {wall_ms:.3f} "
          f"ms/step wall, device busy {busy_ms:.3f} ms/step (idle share "
          f"{100 * (1 - busy_ms / wall_ms):.1f}%)", flush=True)
    print(f"[profile] kernels with the most device ms/step: {kernels}", flush=True)
    print(f"[profile] operators with the most host (self CPU) ms/step: {ops}", flush=True)


def phase_restore(run_dir: Path):
    """The sample CLI restores the training run's checkpoint."""
    argv = ["--run-dir", str(run_dir), "--matrix", MATRIX, "--env-format", "coo",
            "--loss", TRAIN["loss"], "--backward", TRAIN["backward"],
            "--t-cap", str(TRAIN["t_cap"]), "--replay-size", str(TRAIN["replay_size"]),
            "--alpha-fixed", str(TRAIN["alpha_fixed"]),
            "--plateau-patience", str(TRAIN["plateau_patience"]),
            "--reward-baseline", TRAIN["reward_baseline"], "--num-samples", "256"]
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = sample_main(argv)
    m = re.search(r"restored epoch (\d+)", out.getvalue())
    summary = json.loads((run_dir / "sample_summary.json").read_text())
    if rc != 0 or m is None or int(m.group(1)) != EPOCHS:
        fail(f"the sample CLI did not restore epoch {EPOCHS}: {out.getvalue()[:500]}")
    if summary["samples"] != 256 or not all(
            np.isfinite(summary[k]) for k in ("reward_mean", "reward_max", "mean_len")):
        fail(f"sample CLI summary {summary}")
    print(f"[restore] sample --run-dir: restored epoch {m.group(1)}, 256 samples in "
          f"{time.perf_counter() - t0:.1f} s (setup included): reward mean "
          f"{summary['reward_mean']:.4f} max {summary['reward_max']:.4f}, mean "
          f"length {summary['mean_len']:.1f}", flush=True)


# --- the validation path (K8, K12, K13) --------------------------------------

POISSON = 1024              # poisson1024: n 1,048,576, 5 diagonals, fuses k = 8 / 2
VALIDATE_MAXITER = 10260    # the CLI's (reference GFlowNet100.py:81)
COLD_BYTES = 150_000_000    # input copies a cold-L2 kernel time cycles through (3x L2)
CG_MAXITER = 20000
CG_ITER_TOL = 0.03          # float32 CG vs float64 scipy CG: iterations within 3%
# float32 CG on poisson1024 (κ ≈ 4e5, b = ones) cannot hold its true
# residual below about eps·κ ≈ 0.03-0.15, so past rtol 1e-2 its recursive
# residual runs on rounding and its count drifts from float64's (the
# ladder printed per row shows where); the 3% parity is held down to 1e-2
CG_PARITY_RTOLS = (1e-1, 1e-2)
CG_LADDER = (1e-1, 1e-2, 1e-3, 1e-4, 1e-5)
# K12 / K13: the selection's mode may time this much above the other mode
# before [dia] fails (CUDA-graph replays of one shape moved up to ~2% between runs)
RULE_MARGIN = 0.03
POLY_OP_RTOL = 1e-4         # float32 polynomial operator vs float64, ‖·‖₂ relative
DIA_COUNTERS = {"K8": dia.spmv_dia, "K12": dia.spmv_dia_power, "K13": dia.spmv_dia_cheby}
CLI_ARGS = ["--matrix", "bcsstk03_like", "--epochs", "8", "--batch-size", "4",
            "--maxiter", "500", "--jacobi-poly", "4", "--chebyshev", "4", "--vcycle", "2"]
# bf16 diagonals (dia_astype): [dia] and [dia-multi] run each float32 case's
# inputs through the two bf16-diagonal instances too.  Against the float32
# kernel on the unrounded matrix: max|Δ| at most BF16_ORACLE of the float32
# output's largest magnitude (tests/test_ops.py:786-790's bound for bf16
# diagonals, k = 2), or over k passes k·BF16_PASS: each pass carries the
# diagonals' rounding (2⁻⁹, the same every pass: on the Jacobi M, whose
# entries 1/3 and 1/6 both round up by 0.2%, it adds up to 1.6% over 8
# passes) and, on bf16 vectors, the stored iterate's (2⁻⁹)
BF16_ORACLE = 2e-2
BF16_PASS = 2.0 ** -8
BF16_VECS = (torch.float32, BF16)      # the vectors of the two bf16-diagonal instances
# K12's rule checked on bf16 at two more fusable shapes (k = 8, affine):
# the damped-Jacobi (ω 0.8) iteration matrix of the 9-point Mehrstellen
# Laplacian on a 2048 x 2048 grid, where the model streams float32 and
# fuses bf16, and a short irregular band (4 diagonals, n 20,000)
NINE_POINT = 2048
IRREGULAR_N, IRREGULAR_OFFSETS = 20_000, (-301, -7, 0, 129)


def _ulps(got, want):
    """max|got − want| in units in the last place of want's dtype (8
    significand bits for bf16, 24 for float32) at want's largest
    magnitude."""
    top = want.float().abs().max().clamp_min(torch.finfo(torch.float32).tiny)
    ulp = torch.ldexp(torch.ones_like(top), torch.frexp(top)[1]
                      - (8 if want.dtype == BF16 else 24))
    return float((got.float() - want.float()).abs().max() / ulp)


def _dia_tol(want, k):
    """K8: 1e-5 of the output's largest magnitude (at least 1): float32
    FMAs against separate multiply-adds.  K12/K13 carry k dependent passes:
    k times that."""
    return 1e-5 * k * max(float(want.abs().max()), 1.0)


def _cycle(fns):
    """One call of the next function in ``fns`` per call (round robin)."""
    it = itertools.cycle(fns)
    return lambda: next(it)()


def _copies(nbytes):
    """Input copies a kernel time cycles through (``_timed``)."""
    return min(16, max(2, -(-COLD_BYTES // nbytes)))


def _dia_copy(d):
    return dataclasses.replace(d, data=d.data.clone())


@contextlib.contextmanager
def _streamed():
    """K12 and K13 in their streamed mode whatever the reach (no block's
    shared memory is taken to fit a tile), to time both modes on one
    matrix."""
    saved = dia._SMEM_BYTES
    dia._SMEM_BYTES = 0
    try:
        yield
    finally:
        dia._SMEM_BYTES = saved


def _rule(kind, d, k, types=0):
    """The fused plan the selection takes for K12 / K13 on ``d`` at k on
    this card (aligned buffers) for the instance of ``types``
    (``ops/dia.py`` ``_TYPES``), or None: the streamed mode."""
    return dia._fused_plan(kind, d.ndiags, k, d.reach, d.n_pad,
                           dia._card_active(kind, d.ndiags, d.data.device, types),
                           dia._SMEM_BYTES, dia._ELEMS[types])


def _mode_label(plan):
    return (f"fused (clusters of {plan.cluster} CTAs x {plan.rows} rows, {plan.windows} "
            f"windows on {min(plan.windows, plan.clusters)} clusters)" if plan
            else "streamed (one launch per pass)")


@contextlib.contextmanager
def _forced(plan):
    """K12 and K13 in the fused mode with ``plan``, whatever the rule says."""
    saved = dia._fused_for
    dia._fused_for = lambda *a: plan
    try:
        yield
    finally:
        dia._fused_for = saved


def _both_modes(key, label, kind, d, k, call, want, make, plain, nbytes, ops, types=0,
                f32=None, f32_recs=None):
    """K12 / K13 at one shape in both modes.  ``call()`` returns the
    outputs on fresh output buffers, ``want`` the plain version's; ``make``
    and the rest as ``_timed``; ``types`` the instance (``_rule``).  The
    fused mode (the rule's plan, or where the rule streams the candidate
    the model times fastest) must equal the streamed mode bit for bit;
    both are timed, and the rule's pick must not be slower than the other
    mode by more than ``RULE_MARGIN``.  A bf16-diagonal case gives ``f32``
    (``_check``) and ``f32_recs``, the float32 kernel's records at the same
    shape (rule's mode, streamed), printed beside.  Returns the records of
    the rule's mode and of the streamed mode."""
    plan = _rule(kind, d, k, types)
    fused = plan or min(dia._fused_candidates(
        kind, d.ndiags, k, d.reach, d.n_pad,
        dia._card_active(kind, d.ndiags, d.data.device, types), dia._SMEM_BYTES,
        dia._ELEMS[types]), key=lambda c: c.fused_us, default=None)
    hold = {} if f32 is None else dict(again=call, f32=f32)
    with _streamed():
        got_s = call()
        rec_s = _record(key, f"{label}, {_mode_label(None)}", got_s, want, k, make, plain,
                        nbytes, ops, **hold)
    if fused is None:
        print(f"[{key}] {label}: the rule streams; no fused window fits", flush=True)
        return rec_s, rec_s
    with _forced(fused):
        got_f = call()
        torch.cuda.synchronize()
        if not all(torch.equal(f, s_) for f, s_ in zip(got_f, got_s)):
            fail(f"{key} fused mode differs from the streamed mode ({label})")
        rec_f = _record(key, f"{label}, {_mode_label(fused)}", got_f, want, k, make, plain,
                        nbytes, ops, **hold)
    picked, other = (rec_f, rec_s) if plan else (rec_s, rec_f)
    verdict = "faster" if picked["ms"] <= other["ms"] else \
        f"slower by {100 * (picked['ms'] / other['ms'] - 1):.1f}%"
    print(f"[{key}] {label}: fused equals streamed bit for bit; fused {rec_f['ms']:.5f} "
          f"ms, streamed {rec_s['ms']:.5f} ms (model {fused.fused_us / 1e3:.5f} / "
          f"{fused.streamed_us / 1e3:.5f}); the rule picks the "
          f"{'fused' if plan else 'streamed'} mode: {verdict}", flush=True)
    if f32_recs is not None:
        print(f"[{key}] {label}: the float32 kernel at the same shape {f32_recs[0]['ms']:.5f} "
              f"ms in its rule's mode, streamed {f32_recs[1]['ms']:.5f} ms (this run): bf16 / "
              f"float32 {picked['ms'] / f32_recs[0]['ms']:.3f} in the rules' modes, "
              f"{rec_s['ms'] / f32_recs[1]['ms']:.3f} streamed", flush=True)
        picked["f32_ms"] = f32_recs[0]["ms"]
    if picked["ms"] > (1 + RULE_MARGIN) * other["ms"]:
        fused_mode = functools.partial(_forced, fused)
        pick, oth = (fused_mode, _streamed) if plan else (_streamed, fused_mode)
        ms_p, ms_o = _second_reading([make(i) for i in range(_copies(nbytes))], pick, oth)
        if ms_p > (1 + RULE_MARGIN) * ms_o:
            fail(f"{key} ({label}): the rule's mode is {verdict} than the other, and "
                 f"{_slower(ms_p, ms_o)} in a second reading")
        print(f"[{key}] {label}: the rule's mode held in the second reading", flush=True)
    return picked, rec_s


def _slower(ms_pick, ms_other):
    return "faster" if ms_pick <= ms_other else \
        f"slower by {100 * (ms_pick / ms_other - 1):.1f}%"


def _second_reading(fns, pick, other, reps=20):
    """A rule check's second reading, after its pick lost the first by more
    than ``RULE_MARGIN``: the rule's pick and the other side timed again in
    turns, A B B A (``pick`` and ``other`` give the context that forces
    each side; ``fns`` the calls over the input copies, replayed as
    ``_timed`` does).  Prints both sides' readings and returns their means."""
    ms = {pick: [], other: []}
    for side in (pick, other, other, pick):
        with side():
            ms[side].append(graph_ms(_cycle(fns), reps))
    print(f"[rule-check] second reading, A B B A: the rule's pick "
          f"{ms[pick][0]:.5f}, {ms[pick][1]:.5f} ms; the other {ms[other][0]:.5f}, "
          f"{ms[other][1]:.5f} ms: {_slower(np.mean(ms[pick]), np.mean(ms[other]))}",
          flush=True)
    return float(np.mean(ms[pick])), float(np.mean(ms[other]))


def _mode_counts():
    """K12's and K13's launches by mode."""
    return {f"{key} {mode}": n for key, fn in (("K12", dia.spmv_dia_power),
                                               ("K13", dia.spmv_dia_cheby))
            for mode, n in fn.mode_launches.items()}


def _counts(counters=DIA_COUNTERS):
    return {k: fn.launches for k, fn in counters.items()}


@contextlib.contextmanager
def _uncounted():
    """A check run beside the main path (the streamed-forced re-solve):
    K8's, K12's and K13's launch counts, and K12's and K13's by mode, are
    set back after it, so they count the main path only; the dict it
    yields gets what the check launched."""
    saved = _counts()
    saved_m = {fn: dict(fn.mode_launches) for fn in (dia.spmv_dia_power, dia.spmv_dia_cheby)}
    saved_p = dict(dia.spmv_dia.path_launches)
    moved = {}
    try:
        yield moved
    finally:
        moved.update({k: v - saved[k] for k, v in _counts().items() if v - saved[k]})
        for key, fn in DIA_COUNTERS.items():
            fn.launches = saved[key]
        dia.spmv_dia.path_launches = saved_p
        for fn, modes in saved_m.items():
            moved.update({f"{'K12' if fn is dia.spmv_dia_power else 'K13'} {m}": v - modes[m]
                          for m, v in fn.mode_launches.items() if v - modes[m]})
            fn.mode_launches.update(modes)


def _k8_path_counts():
    """K8's launches by path (``ops/dia.py`` ``_k8_skips``) since the last
    ``_reset``, keyed as the kernels line's entries read them."""
    return {f"K8 {path}": n for path, n in dia.spmv_dia.path_launches.items()}


def _reset(counters=DIA_COUNTERS):
    for fn in counters.values():
        fn.launches = 0
        if hasattr(fn, "path_launches"):
            fn.path_launches = dict.fromkeys(fn.path_launches, 0)


def _bf16_bound(k):
    """A bf16-diagonal result's bound against float32 after k passes (a
    share of the float32 result's largest magnitude)."""
    return max(BF16_ORACLE, k * BF16_PASS)


def _vname(vt):
    return "bf16 vectors" if vt == BF16 else "float32 vectors"


def _types(vt):
    """``ops/dia.py``'s ``_TYPES`` code of bf16 diagonals with vectors ``vt``."""
    return 2 if vt == BF16 else 1


def _bf16_put(out, key, vt, rec, case):
    """File a bf16-diagonal record under ``bf16 <key> <vectors> <case>``;
    the kernel's first case also stands as ``bf16 <key> <vectors>`` (the
    kernels line's entry)."""
    tag = f"bf16 {key} {_vname(vt)}"
    out.setdefault(tag, rec)
    out[f"{tag} {case}"] = rec


def _csr_rounded(d, vt):
    """``_csr`` of a float32 DIA with its values rounded to bf16, held in
    ``vt``: the stored entries of ``dia_astype(d, bf16)`` for the one
    torch.sparse call that computes a bf16-diagonal instance's function on
    ``vt`` vectors (bf16 -> float32 is exact; cuSPARSE takes no CSR bf16 x
    float32)."""
    c = _csr(d)
    return torch.sparse_csr_tensor(c.crow_indices(), c.col_indices(),
                                   c.values().to(BF16).to(vt), c.shape)


def _bf16_lib(lib, want, vt, what="A@x"):
    """The yardstick ``lib()`` (``_csr_rounded`` on ``vt`` vectors) where
    PyTorch takes it on the card and it computes the function within
    ``BF16_ORACLE`` of the plain version ``want``: (True, its name) or
    (False, why not)."""
    name = f"torch.sparse CSR {'bf16' if vt == BF16 else 'float32 (bf16-rounded values)'} " \
        f"{what}"
    try:
        y = lib()
        torch.cuda.synchronize()
    except (RuntimeError, TypeError, NotImplementedError, ValueError) as e:
        return False, f"none: PyTorch refuses {name} on the card ({str(e).splitlines()[0][:140]})"
    dev = float((y.float() - want.float()).abs().max()) / max(float(want.float().abs().max()),
                                                              1e-30)
    return (True, name) if dev <= BF16_ORACLE else \
        (False, f"none: {name} is {dev:.3e} of the largest magnitude off")


def _check(key, label, got, want, k, again=None, f32=None):
    """Hold a DIA kernel's outputs ``got`` against its plain version's
    ``want`` on the same CUDA tensors: bf16 outputs bit for bit, float32
    ones within ``_dia_tol``.  A bf16-diagonal case also gives ``again()``
    (a second launch on fresh outputs: the same bits) and ``f32``, the
    float32 kernel's outputs on the unrounded matrix: within
    ``_bf16_bound(k)`` of their largest magnitude.  Returns (max abs error,
    what was checked)."""
    torch.cuda.synchronize()
    err = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
    if got[0].dtype == BF16:
        tol = 0.0
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            fail(f"{key} disagrees with its plain version ({label}): bf16 outputs differ "
                 f"by up to {max(_ulps(g, w) for g, w in zip(got, want)):.0f} ulps")
    else:
        tol = max(_dia_tol(w, k) for w in want)
    if not err <= tol:
        fail(f"{key} disagrees with its plain version ({label}): max abs err "
             f"{err:.3e} > {tol:.3e}")
    checked = f"max abs err {err:.3e} (tolerance {tol:.3e})"
    if f32 is None:
        return err, checked
    if got[0].dtype != BF16:      # float32 vectors: fused multiply-adds against its mul, add
        checked += (f", {max(_ulps(g, w) for g, w in zip(got, want)):.2f} float32 ulps of the "
                    "largest magnitude")
    again = again()
    torch.cuda.synchronize()
    if not all(torch.equal(g, a) for g, a in zip(got, again)):
        fail(f"{key} ({label}): a second launch gave other bits")
    dev = max(float((g.float() - f).abs().max()) / max(float(f.abs().max()), 1e-30)
              for g, f in zip(got, f32))
    if not dev <= _bf16_bound(k):
        fail(f"{key} ({label}): {dev:.3e} of the float32 kernel's largest magnitude from "
             f"it on the unrounded matrix (bound {_bf16_bound(k):.4f})")
    return err, (f"{checked}; a second launch gives the same bits; {dev:.3e} of the float32 "
                 f"kernel's largest magnitude from it on the unrounded matrix (bound "
                 f"{_bf16_bound(k):.4f})")


def _record(key, label, got, want, k, make, plain, nbytes, ops, make_lib=None,
            lib_name="torch.sparse CSR A@x", reps=20, again=None, f32=None, f32_rec=None,
            lib=None):
    """Check a DIA kernel against its plain version (``_check``) and time
    it (``_timed``).  A bf16-diagonal case gives ``f32_rec``, the float32
    kernel's record at the same shape (printed beside), and ``lib``,
    ``_bf16_lib``'s verdict on the yardstick ``make_lib``."""
    err, checked = _check(key, label, got, want, k, again, f32)
    if lib is not None:
        lib_name = lib[1]
        if not lib[0]:
            print(f"[{key}] {label}: library {lib_name}", flush=True)
            make_lib = None
    rec = _timed(key, label, checked, err, make, plain, nbytes, ops, make_lib, lib_name, reps)
    if f32_rec is not None:
        rec["f32_ms"] = f32_rec["ms"]
        print(f"[{key}] {label}: the float32 kernel at the same shape {f32_rec['ms']:.5f} ms "
              f"(this run): bf16 / float32 {rec['ms'] / f32_rec['ms']:.3f}", flush=True)
    return rec


def _timed(key, label, checked, err, make, plain, nbytes, ops, make_lib=None,
           lib_name="torch.sparse CSR A@x", reps=20, rate=F32_OPS_PER_S):
    """Time a kernel that was held against its plain version (``checked``
    says how).  ``make(i)`` returns a call of the kernel on the i-th copy
    of its inputs (copy 0: the inputs it was checked on).  The kernel time
    cycles through enough copies that a replay reads HBM, not the 50 MB L2
    that holds one copy; the warm time repeats copy 0.  ``rate``: the peak
    operations per second of the bound."""
    n_copies = _copies(nbytes)
    fns = [make(i) for i in range(n_copies)]
    lib_fns = [make_lib(i) for i in range(n_copies)] if make_lib else []
    ms = graph_ms(_cycle(fns), reps)
    warm = graph_ms(fns[0], reps)
    eager = cuda_ms(fns[0], reps)
    plain_ms = cuda_ms(plain, 3)
    lib_ms = graph_ms(_cycle(lib_fns), reps) if lib_fns else None
    b, by = bound_ms(nbytes, ops, rate)
    print(f"[{key}] {label}: {checked}; kernel "
          f"{ms:.5f} ms (graph replay over {n_copies} input copies; one copy, "
          f"L2-warm {warm:.5f} ms; eager calls {eager:.5f} ms), plain "
          f"{plain_ms:.4f} ms, " + (f"{lib_name} {lib_ms:.5f} ms (graph replay, same "
                                    f"copies), " if lib_ms is not None
                                    else "library: none, ")
          + f"bound {b:.6f} ms ({by}; {nbytes / 1e6:.2f} MB, {ops / 1e6:.2f} Mflop)",
          flush=True)
    return dict(err=err, ms=ms, warm=warm, eager=eager, plain=plain_ms, lib=lib_ms,
                bound=(b, by))


def _nine_point(side, dev):
    """The damped-Jacobi (ω 0.8) iteration matrix I − ω·D⁻¹A of the 9-point
    Mehrstellen Laplacian (centre 20, edges −4, corners −1) on a side x
    side grid: 9 diagonals, centre 0.2, edges 0.16, corners 0.04 (each
    rounds up by 0.1% in bf16), zero where the neighbour is off the grid."""
    n = side * side
    n_pad = -(-n // 1024) * 1024
    r, c = (torch.arange(n, device=dev) // side), (torch.arange(n, device=dev) % side)
    offsets, rows = [], []
    for dr in (-1, 0, 1):
        for dc in (-1, 0, 1):
            w = 0.2 if dr == dc == 0 else 0.04 if dr and dc else 0.16
            inside = (r + dr >= 0) & (r + dr < side) & (c + dc >= 0) & (c + dc < side)
            offsets.append(dr * side + dc)
            rows.append(torch.nn.functional.pad(inside.float() * w, (0, n_pad - n)))
    return dia.DIA(data=torch.stack(rows).contiguous(), offsets=tuple(offsets),
                   shape=(n, n), nnz=int(sum(int((row != 0).sum()) for row in rows)))


def _irregular(n, offsets, dev):
    """A band with the given offsets and values uniform in [0, 1/len(offsets))
    (numpy, seed 5; row sums below 1), zero past row n."""
    n_pad = -(-n // 1024) * 1024
    data = np.random.default_rng(5).uniform(0.0, 1.0 / len(offsets),
                                            (len(offsets), n_pad)).astype(np.float32)
    data[:, n:] = 0.0
    return dia.DIA(data=torch.as_tensor(data, device=dev), offsets=offsets, shape=(n, n),
                   nnz=len(offsets) * n)


def _k8_segments(d, name=None):
    """The diagonal words in the 64-row segments K8's flags set (the ragged
    last tile's rows only); with ``name``, print their share of the stored
    words and the flags' build time (device, graph replay)."""
    rows, flags = dia._FLAG_ROWS, dia._flags(d)
    per_tile = torch.clamp(d.n_pad - rows * torch.arange(flags.shape[0], device=flags.device),
                           max=rows)
    words = int((flags.to(torch.int64) * per_tile[:, None]).sum())
    if name is not None:
        build = graph_ms(lambda: dia._segment_flags(d.data), 10)
        print(f"[K8] {name}: the flags set {int(flags.sum())} of {flags.numel()} "
              f"segments of {rows} rows, {words} of {d.ndiags * d.n_pad} stored words "
              f"({100 * words / (d.ndiags * d.n_pad):.2f}%); the flags ({flags.numel()} "
              f"bytes) are built in {build:.5f} ms (device, graph replay)", flush=True)
    return words


def _k8_stored_bound(rec, d, ed, ev, label):
    """Print K8's second bound, every stored word with x and y once (the
    work of the TPU kernels, which read every word), beside the record's."""
    b, by = bound_ms(ed * d.ndiags * d.n_pad + 2 * ev * d.n, 2 * d.ndiags * d.n_pad)
    print(f"[K8] {label}: bounds: flagged segments, x, y and flags {rec['bound'][0]:.6f} ms "
          f"({rec['bound'][1]}); every stored word, x and y {b:.6f} ms ({by}); kernel "
          f"{rec['ms'] / rec['bound'][0]:.1f}x and {rec['ms'] / b:.2f}x", flush=True)


@contextlib.contextmanager
def _k8_path(skip):
    """K8 on its skip path (or its rows path) whatever the rule says."""
    saved = dia._K8_SKIP_RULE
    dia._K8_SKIP_RULE = (0, float("inf")) if skip else (0, 0.0)
    try:
        yield
    finally:
        dia._K8_SKIP_RULE = saved


def _k8_paths(label, d, x):
    """K8's two paths on one case: the same bits, NaN included, and each
    timed as ``_timed`` does (graph replays over cold copies); fails if
    the rule's path (``ops/dia.py`` ``_k8_skips``) is more than
    ``RULE_MARGIN`` slower than the other."""
    ys, ms = {}, {}
    n_copies = _copies(d.data.numel() * d.data.element_size() + 2 * x.numel() * x.element_size())
    copies = [(d, x)] + [(_dia_copy(d), x.clone()) for _ in range(1, n_copies)]
    for c, _ in copies:       # flags for the forced skip path, made before any capture
        dia._flags(c)
    for skip in (False, True):
        with _k8_path(skip):
            ys[skip] = dia.spmv_dia(d, x)
            ms[skip] = graph_ms(_cycle([lambda c=c: dia.spmv_dia(*c) for c in copies]), 20)
    torch.cuda.synchronize()
    view = torch.int16 if x.element_size() == 2 else torch.int32
    if not torch.equal(ys[False].view(view), ys[True].view(view)):
        fail(f"K8's skip path differs from its rows path ({label})")
    pick = dia._k8_skips(d)
    verdict = "faster" if ms[pick] <= ms[not pick] else \
        f"slower by {100 * (ms[pick] / ms[not pick] - 1):.1f}%"
    n0, below = dia._K8_SKIP_RULE
    print(f"[K8-paths] {label}: skip path equals rows path bit for bit; rows {ms[False]:.5f} "
          f"ms, skip {ms[True]:.5f} ms; the rule ({d.ndiags} diagonals, "
          f"{100 * dia._k8_share(d):.2f}% of the segments holding an entry; skip below "
          f"{below:g}·(1 − {n0}/ndiags)) picks {'skip' if pick else 'rows'}: {verdict}",
          flush=True)
    if ms[pick] > (1 + RULE_MARGIN) * ms[not pick]:
        fns = [lambda c=c: dia.spmv_dia(*c) for c in copies]
        ms_p, ms_o = _second_reading(fns, functools.partial(_k8_path, pick),
                                     functools.partial(_k8_path, not pick))
        if ms_p > (1 + RULE_MARGIN) * ms_o:
            fail(f"K8 ({label}): the rule's path is {verdict} than the other, and "
                 f"{_slower(ms_p, ms_o)} in a second reading")
        print(f"[K8-paths] {label}: the rule's path held in the second reading",
              flush=True)


def _k8_nonfinite(d, rnd):
    """K8 with inf at 4 and NaN at 4 entries of x, in each instance, on the
    rule's path: NaN and inf in the same rows as the plain version (stored
    zeros of skipped segments reach most of them: fma(+0.0, inf) is NaN),
    the rest within the record's tolerance (bf16 vectors: its bits)."""
    x = rnd(d.n)
    idx = torch.randperm(d.n, generator=torch.Generator().manual_seed(5))[:8].to(x.device)
    x[idx[:4]], x[idx[4:]] = float("inf"), float("nan")
    for dd, xv, what in ((d, x, "float32"), (dia.dia_astype(d, BF16), x, "bf16 diagonals, "
                                             "float32 vectors"),
                         (dia.dia_astype(d, BF16), x.to(BF16), "bf16")):
        got, want = dia.spmv_dia(dd, xv), dia.spmv_dia_ref(dd, xv)
        torch.cuda.synchronize()
        nan, inf = want.isnan(), want.isinf()
        if not (torch.equal(got.isnan(), nan) and torch.equal(got.isinf(), inf)):
            fail(f"K8 with inf and NaN in x ({what}): NaN in {int(got.isnan().sum())} rows, "
                 f"inf in {int(got.isinf().sum())}; the plain version {int(nan.sum())}, "
                 f"{int(inf.sum())}")
        fin = want.isfinite()
        err, checked = _check("K8", f"{MATRIX} with inf and NaN in x, {what}", [got[fin]],
                              [want[fin]], 1)
        print(f"[K8] {MATRIX} ({what}) with inf at 4 and NaN at 4 entries of x: NaN in the "
              f"plain version's {int(nan.sum())} rows, inf in its {int(inf.sum())}; the "
              f"other rows {checked}", flush=True)


def phase_dia(dev):
    """K8, K12 and K13 against their plain versions at the validation
    path's shapes; on poisson1024 (and K8 on orsirr_like150), with the same
    inputs, their two bf16-diagonal instances, and K12's on bf16 at two
    more shapes (``NINE_POINT``, ``IRREGULAR_N``)."""
    from gflownet_spai_tpu_torch.solvers import vcycle_op
    from gflownet_spai_tpu_torch.solvers.stationary import (
        _pick_power_config, chebyshev_coeffs, estimate_lmax, jacobi_iteration_matrix)
    from gflownet_spai_tpu_torch.sparse import gallery
    gen = torch.Generator(device=dev).manual_seed(2024)
    rnd = lambda n: torch.randn(n, generator=gen, device=dev)
    pois = gallery.poisson2d(POISSON, dtype=np.float32)
    d = dia.coo_to_dia(pois, device=dev)
    ors = gallery.get(MATRIX)
    ors = ors.with_data(ors.data.astype(np.float32))
    dors = dia.coo_to_dia(ors, device=dev)
    out = {}
    record = _record

    # K8: y = A·x; bound: the flagged segments' words, x, y and the flags once
    for name, dd, coo in ((f"poisson{POISSON}", d, pois), (MATRIX, dors, ors)):
        x = rnd(dd.n)
        csr = torch.sparse_coo_tensor(
            torch.as_tensor(np.stack([coo.row, coo.col]).astype(np.int64), device=dev),
            torch.as_tensor(coo.data, device=dev), coo.shape).coalesce().to_sparse_csr()
        lib_y = csr @ x
        want = dia.spmv_dia_ref(dd, x)
        if not float((lib_y - want).abs().max()) <= _dia_tol(want, 1):
            fail("the torch.sparse yardstick does not compute K8's function")
        words = _k8_segments(dd, name)
        flag_bytes = dia._flags(dd).numel() if dia._k8_skips(dd) else 0   # the rows path reads none
        nbytes = 4 * (words + 2 * dd.n) + flag_bytes

        def make(i, dd=dd, x=x):
            di, xi = (dd, x) if i == 0 else (_dia_copy(dd), x.clone())
            return lambda: dia.spmv_dia(di, xi)

        def make_lib(i, csr=csr, x=x):
            ci, xi = (csr, x) if i == 0 else (csr.clone(), x.clone())
            return lambda: ci @ xi

        r = record("K8", f"{name} ({dd.ndiags} diagonals, n_pad {dd.n_pad}, halo "
                   f"{dd.halo}, nnz {coo.nnz})", [dia.spmv_dia(dd, x)], [want], 1,
                   make, lambda: dia.spmv_dia_ref(dd, x),
                   nbytes, 2 * words, make_lib=make_lib)
        _k8_stored_bound(r, dd, 4, 4, name)
        _k8_paths(f"{name}, float32", dd, x)
        out.setdefault("K8", r)           # the poisson case stands for K8
        out[f"K8 {name}"] = r
        db, f32 = dia.dia_astype(dd, BF16), [dia.spmv_dia(dd, x)]
        for vt in BF16_VECS:
            xb, cb = x.to(vt), _csr_rounded(dd, vt)
            wb = dia.spmv_dia_ref(db, xb)
            rb = record(
                "K8 bf16", f"{name} ({dd.ndiags} bf16 diagonals), {_vname(vt)}",
                [dia.spmv_dia(db, xb)], [wb], 1, lambda i, db=db, xb=xb: make(i, db, xb),
                lambda db=db, xb=xb: dia.spmv_dia_ref(db, xb),
                2 * _k8_segments(db) + 2 * xb.element_size() * dd.n + flag_bytes,
                2 * words, make_lib=lambda i, cb=cb, xb=xb: make_lib(i, cb, xb),
                again=lambda db=db, xb=xb: [dia.spmv_dia(db, xb)], f32=f32, f32_rec=r,
                lib=_bf16_lib(lambda: cb @ xb, wb, vt))
            _k8_stored_bound(rb, dd, 2, xb.element_size(), f"{name} {_vname(vt)}")
            _k8_paths(f"{name}, bf16 diagonals, {_vname(vt)}", db, xb)
            _bf16_put(out, "K8", vt, rb, name)
    _k8_nonfinite(dors, rnd)

    def k12(mm, name, k, tr, affine, bf16=None, what="Jacobi M"):
        """K12 on ``mm`` (an iteration matrix) at the selection's k, in both
        modes (``_both_modes``); where ``bf16`` names the case, then on
        ``dia_astype(mm, bf16)`` with the same x and c in both vector
        dtypes."""
        xq = dia.dia_pad_pp(mm, rnd(mm.n), tr=tr)
        add = dia.dia_pad_pp(mm, rnd(mm.n), tr=tr) if affine else None
        zref = torch.zeros_like(xq)
        want = dia.spmv_dia_power_ref(mm, xq, zref, k=k, add=add)

        def make(i, mm=mm, xq=xq, add=add):
            mi, xi, zi = (mm, xq, torch.zeros_like(xq)) if i == 0 else \
                (_dia_copy(mm), xq.clone(), torch.zeros_like(xq))
            ci = add if i == 0 or add is None else add.clone()
            return lambda: dia.spmv_dia_power(mi, None, xi, zi, k=k, add=ci)

        label = f"{name} {what}, k = {k}, P = {tr}, {'affine' if affine else 'plain power'}"
        kind = dia._FUSED_AFFINE if affine else dia._FUSED_POWER
        ops = k * (2 * mm.ndiags + 1 + affine) * mm.n_pad
        recs = _both_modes(
            "K12", label, kind, mm, k,
            lambda: [dia.spmv_dia_power(mm, None, xq, torch.zeros_like(xq), k=k, add=add)],
            [want], make, lambda: dia.spmv_dia_power_ref(mm, xq, zref, k=k, add=add),
            4 * (mm.ndiags * mm.n_pad + (2 + affine) * mm.n_pad), ops)
        if bf16 is None:
            return recs
        mb = dia.dia_astype(mm, BF16)
        f32 = [dia.spmv_dia_power(mm, None, xq, torch.zeros_like(xq), k=k, add=add)]
        for vt in BF16_VECS:
            xb, ab = xq.to(vt), None if add is None else add.to(vt)
            plain = lambda xb=xb, ab=ab: dia.spmv_dia_power_ref(
                mb, xb, torch.zeros_like(xb), k=k, add=ab)
            picked, streamed = _both_modes(
                "K12 bf16", f"{label}, bf16 diagonals, {_vname(vt)}", kind, mb, k,
                lambda xb=xb, ab=ab: [dia.spmv_dia_power(mb, None, xb, torch.zeros_like(xb),
                                                         k=k, add=ab)],
                [plain()], lambda i, xb=xb, ab=ab: make(i, mb, xb, ab), plain,
                2 * mm.ndiags * mm.n_pad + xb.element_size() * (2 + affine) * mm.n_pad, ops,
                types=_types(vt), f32=f32, f32_recs=recs)
            _bf16_put(out, "K12", vt, picked, bf16)
            out[f"bf16 K12 {_vname(vt)} {bf16} streamed"] = streamed
        return recs

    # K12 on the Jacobi iteration matrix at the two fused configurations
    m = jacobi_iteration_matrix(d)
    for sweeps in (16, 4):
        k, tr = _pick_power_config(m, 8, sweeps)
        for affine in (True, False):
            tag = f"K12 k={k} {'affine' if affine else 'power'}"
            picked, streamed = k12(m, f"poisson{POISSON}", k, tr, affine,
                                   bf16=tag[len("K12 "):])
            out[tag], out[tag + " streamed"] = picked, streamed
            out.setdefault("K12", picked)      # the Jacobi-16 row's call stands for K12
    # poisson2048's Jacobi 16 sweeps pick k = 8 at reach 2048 (the TPU's
    # streamed kernel; which side of the rule it lies on is printed)
    t0 = time.perf_counter()
    m2 = jacobi_iteration_matrix(
        dia.coo_to_dia(gallery.poisson2d(2 * POISSON, dtype=np.float32), device=dev))
    k, tr = _pick_power_config(m2, 8, 16)
    print(f"[K12] poisson{2 * POISSON}: Jacobi M built in {time.perf_counter() - t0:.1f} s "
          f"(n {m2.n}, halo {m2.halo}); Jacobi-16 selection k = {k}, P = {tr}; the "
          f"rule's side: {_mode_label(_rule(dia._FUSED_AFFINE, m2, k))}", flush=True)
    if k != 8:
        fail(f"poisson{2 * POISSON} Jacobi-16 should fuse k = 8 (k = {k})")
    out[f"K12 k=8 affine poisson{2 * POISSON}"], _ = k12(m2, f"poisson{2 * POISSON}", k,
                                                          tr, True)
    del m2
    # both sides of the rule on one small grid, poisson128 (n 16,384): its
    # Jacobi-4 sweeps (k = 2) stream, two launches costing less than one
    # fused launch's fixed part; its Jacobi-16 sweeps (k = 8) fuse
    m128 = jacobi_iteration_matrix(
        dia.coo_to_dia(gallery.poisson2d(POISSON // 8, dtype=np.float32), device=dev))
    for sweeps in (4, 16):
        k, tr = _pick_power_config(m128, 8, sweeps)
        out[f"K12 k={k} affine poisson{POISSON // 8}"], _ = k12(
            m128, f"poisson{POISSON // 8}", k, tr, True)
    del m128
    # the Jacobi V-cycle's coarsest level as [vcycle] builds it (poisson1024
    # aggregated five times: n 32,768, reach 32), whose 16 sweeps run as
    # k = 8 calls on every cycle
    vc = vcycle_op(d, **dict(VCYCLE_ROWS)["vcycle(levels=6)"])
    mc, meta = vc.data[-1][1], vc.fn.keywords["metas"][-1]
    if (meta["k"], mc.reach) != (8, POISSON // 32):
        fail(f"the Jacobi V-cycle's coarsest level: k {meta['k']}, reach {mc.reach}")
    out["K12 k=8 affine vcycle coarsest"], _ = k12(
        mc, f"V-cycle coarsest level (n {mc.n}, reach {mc.reach})", meta["k"], meta["tr"],
        True)
    del vc, mc
    # K12's rule on bf16 at two more fusable shapes (float32 beside)
    nine = _nine_point(NINE_POINT, dev)
    k12(nine, f"{NINE_POINT} x {NINE_POINT} grid", 8, dia.dia_pp_tile(nine) or nine.halo, True,
        bf16="k=8 affine nine-point", what="9-point damped-Jacobi M")
    del nine
    irr = _irregular(IRREGULAR_N, IRREGULAR_OFFSETS, dev)
    k12(irr, f"irregular band n {IRREGULAR_N}", 8, dia.dia_pp_tile(irr) or irr.halo, True,
        bf16="k=8 affine irregular", what=f"offsets {IRREGULAR_OFFSETS}")
    del irr

    def k13(dd, name, coeffs, bf16=False):
        """K13 on ``dd`` with the coefficient pairs ``coeffs`` (k of them),
        in both modes; with ``bf16``, then on ``dia_astype(dd, bf16)`` with
        the same buffers in both vector dtypes."""
        k = len(coeffs)
        q = lambda: dia.dia_pad_pp(dd, rnd(dd.n))
        zq, ddq, rq = q(), q(), q()
        zero = lambda zq=zq: [torch.zeros_like(zq) for _ in range(2)]
        want = list(dia.spmv_dia_cheby_ref(dd, zq, ddq, rq, *zero(), coeffs, k))

        def make(i, dd=dd, ins=(zq, ddq, rq)):
            di, ins = (dd, ins) if i == 0 else \
                (_dia_copy(dd), tuple(t.clone() for t in ins))
            outs = zero(ins[0])
            return lambda: dia.spmv_dia_cheby(di, None, *ins, *outs, coeffs, k)

        label = f"{name}, k = {k}, (a, b) = " \
            f"{[(round(a, 5), round(b, 5)) for a, b in coeffs]}"
        ops = k * (2 * dd.ndiags + 5) * dd.n_pad
        recs = _both_modes(
            "K13", label, dia._FUSED_CHEBY, dd, k,
            lambda: list(dia.spmv_dia_cheby(dd, None, zq, ddq, rq, *zero(), coeffs, k)),
            want, make, lambda: dia.spmv_dia_cheby_ref(dd, zq, ddq, rq, *zero(), coeffs, k),
            4 * (dd.ndiags * dd.n_pad + 5 * dd.n_pad), ops)
        if not bf16:
            return recs
        db = dia.dia_astype(dd, BF16)
        f32 = list(dia.spmv_dia_cheby(dd, None, zq, ddq, rq, *zero(), coeffs, k))
        for vt in BF16_VECS:
            ins = tuple(t.to(vt) for t in (zq, ddq, rq))
            plain = lambda ins=ins: dia.spmv_dia_cheby_ref(db, *ins, *zero(ins[0]), coeffs, k)
            picked, streamed = _both_modes(
                "K13 bf16", f"{label}, bf16 diagonals, {_vname(vt)}", dia._FUSED_CHEBY, db,
                k, lambda ins=ins: list(dia.spmv_dia_cheby(db, None, *ins, *zero(ins[0]),
                                                           coeffs, k)),
                list(plain()), lambda i, ins=ins: make(i, db, ins), plain,
                2 * dd.ndiags * dd.n_pad + 5 * ins[0].element_size() * dd.n_pad, ops,
                types=_types(vt), f32=f32, f32_recs=recs)
            _bf16_put(out, "K13", vt, picked, f"k={k}")
            out[f"bf16 K13 {_vname(vt)} k={k} streamed"] = streamed
        return recs

    # K13 at k = 2 with the Chebyshev coefficients of the estimated spectrum
    # (the [poisson] row's second fused call), then at the Chebyshev
    # V-cycle's coarser levels: k 4 (degree 8 on [lmax/4, lmax]) on
    # poisson512 and k 8 (the coarsest level's degree 32 on [lmax/30,
    # lmax]) on poisson256
    lmax = 1.05 * float(estimate_lmax(d, iters=30))
    out["K13"], out["K13 streamed"] = k13(d, f"poisson{POISSON} lmax {lmax:.4f}",
                                          chebyshev_coeffs(lmax / 30, lmax, 16)[2:4], True)
    for n, k, ratio, degree in ((POISSON // 2, 4, 4.0, 8), (POISSON // 4, 8, 30.0, 32)):
        dl = dia.coo_to_dia(gallery.poisson2d(n, dtype=np.float32), device=dev)
        lm = 1.05 * float(estimate_lmax(dl, iters=20))
        out[f"K13 k={k} poisson{n}"], _ = k13(dl, f"poisson{n} lmax {lm:.4f}",
                                             chebyshev_coeffs(lm / ratio, lm, degree)[:k])
    return out


def _row_print(tag, name, rec):
    print(f"[{tag}] {name:13s} iterations {rec['iterations']:6d}  cold "
          f"{rec['cold_s']:.3f} s  steady {rec['steady_s']:.3f} s  "
          f"({1e3 * rec['steady_s'] / max(rec['iterations'], 1):.4f} ms/iteration)  "
          f"true residual {rec['true_residual']:.3e}  launches {rec['launches']}"
          + (f" (by mode {rec['modes']})" if rec.get("modes") else "")
          + (f"  {rec['note']}" if rec.get("note") else ""), flush=True)


def phase_validate(run_dir: Path, dev):
    """The orsirr_like150 harness from the training run's checkpoint."""
    from gflownet_spai_tpu_torch.env import ilu as ilu_mod
    from gflownet_spai_tpu_torch.solvers import (chebyshev_op, estimate_lmax,
                                                 ilu_solve_op, jacobi_sweeps_op,
                                                 solve_with_gmres, spai_op, vcycle_op)
    from gflownet_spai_tpu_torch.solvers.spai_classic import spai_classic
    from gflownet_spai_tpu_torch.solvers.validate import (best_sampled_matrix,
                                                          true_residual)
    from gflownet_spai_tpu_torch.train import restore_checkpoint
    from gflownet_spai_tpu_torch.train.enums import reconcile

    cfg = TrainConfig(**TRAIN, num_epochs=EPOCHS, out_dir=str(run_dir))
    a, _, env, graph, mcfg, _, template = setup(cfg)
    restored = restore_checkpoint(str(run_dir), template)
    if restored is None or restored.epoch != EPOCHS:
        fail("the validate phase could not restore the training checkpoint")
    state, _ = reconcile(str(run_dir), env, restored, backward=cfg.backward)
    with torch.no_grad():
        out = gfn.sample(state.params, env, graph, mcfg,
                         torch.Generator(device=dev).manual_seed(123), 256)
    m_best = best_sampled_matrix(env, out.rollout.actions, out.rewards)
    kept = int((m_best.data.abs() > 0).sum())
    ad = a.to(dev)
    b = torch.ones((a.shape[0],), dtype=ad.data.dtype, device=dev)
    print(f"[validate] {MATRIX} from the epoch-{EPOCHS} checkpoint: best of 256 "
          f"samples keeps {kept}/{env.num_edges} seed entries (reward "
          f"{float(out.rewards.max()):.4f}); GMRES(20), x0 = 0, b = ones, rtol 1e-5, "
          f"maxiter {VALIDATE_MAXITER}", flush=True)

    L, U = ilu_mod.ilu0(a)

    def cheby():
        dd = dia.coo_to_dia(a, device=dev)
        lmax = 1.05 * float(estimate_lmax(dd, iters=30))
        return chebyshev_op(dd, lmax=lmax, lmin=lmax / 30, degree=16)

    rows = (("none", lambda: None),
            ("ilu", lambda: ilu_solve_op(L, U, device=dev)),
            ("sampled_spai", lambda: spai_op(m_best)),
            ("classic_spai", lambda: spai_op(spai_classic(a, k=1, dtype=a.data.dtype,
                                                          device=dev).to(dev))),
            ("jacobi_poly", lambda: jacobi_sweeps_op(dia.coo_to_dia(a, device=dev),
                                                     sweeps=16)),
            ("chebyshev", cheby),
            ("vcycle", lambda: vcycle_op(dia.coo_to_dia(a, device=dev), levels=3)))
    _reset()
    report, total = {}, {k: 0 for k in DIA_COUNTERS}
    for name, make in rows:
        before = _counts()
        op = make()
        walls = []
        for _ in range(2):
            x, res, iters, secs = solve_with_gmres(ad, b, op, maxiter=VALIDATE_MAXITER,
                                                   restart=20, rtol=1e-5)
            walls.append(secs)
        launches = {k: v - before[k] for k, v in _counts().items()}
        rec = dict(iterations=iters, cold_s=walls[0], steady_s=walls[1],
                   true_residual=true_residual(ad, b, x), launches=launches,
                   note=", ".join(f"{k} {v}" for k, v in (op.info if op else {}).items()
                                  if k in ("k", "sweeps", "degree", "levels")))
        if not (iters >= 1 and np.isfinite(rec["true_residual"])):
            fail(f"validate row {name}: {rec}")
        report[name] = rec
        _row_print("validate", name, rec)
    total = _counts()
    if total["K8"] == 0:
        fail("the validation harness did not launch K8")
    total.update(_k8_path_counts())
    print(f"[validate] kernel launches over the seven rows: {total} (orsirr_like150's "
          f"DIA has 230 diagonals: the fused selection picks k = 1 on the fine level)",
          flush=True)
    return report, total


def _cg_ref(apply_a, apply_m, n, maxiter, dev):
    """float64 scipy CG (x0 = 0, b = ones, rtol 1e-5) with LinearOperators
    whose applies run in float64 on the card: (iterations, info, the
    relative true residual ‖b − A·x_k‖/‖b‖ after each iteration)."""
    import inspect

    import scipy.sparse.linalg as spla

    to_dev = lambda v: torch.from_numpy(np.ascontiguousarray(v, np.float64).ravel()).to(dev)
    lin = lambda f: spla.LinearOperator((n, n), matvec=lambda v: f(to_dev(v)).cpu().numpy(),
                                        dtype=np.float64)
    hist = []

    def callback(xk):
        r = 1.0 - apply_a(to_dev(xk))
        hist.append(float(torch.linalg.vector_norm(r)) / np.sqrt(n))

    tol_kw = "rtol" if "rtol" in inspect.signature(spla.cg).parameters else "tol"
    _, info = spla.cg(lin(apply_a), np.ones(n), x0=np.zeros(n), maxiter=maxiter,
                      M=None if apply_m is None else lin(apply_m), callback=callback,
                      **{tol_kw: 1e-5})
    return len(hist), info, np.asarray(hist)


def _crossings(rel_hist):
    """The first iteration whose relative residual is ≤ each rtol of the
    ladder (None where it never is)."""
    out = {}
    for t in CG_LADDER:
        hit = np.nonzero(rel_hist <= t)[0]
        out[t] = int(hit[0]) + 1 if len(hit) else None
    return out


def phase_poisson(dev):
    """CG on poisson1024 with none / Jacobi 16 / Chebyshev 16 on the fused
    kernels, each held against float64 scipy CG with the same operator:
    the first iteration at each rtol of ``CG_PARITY_RTOLS`` within
    ``CG_ITER_TOL``, and the polynomial operators on two vectors."""
    from gflownet_spai_tpu_torch.solvers import (cg, chebyshev_coeffs, chebyshev_op,
                                                 estimate_lmax, jacobi_sweeps_op)
    from gflownet_spai_tpu_torch.sparse import gallery

    a = gallery.poisson2d(POISSON, dtype=np.float32)
    d = dia.coo_to_dia(a, device=dev)
    n = d.n
    a64 = torch.sparse_coo_tensor(
        torch.as_tensor(np.stack([a.row, a.col]).astype(np.int64), device=dev),
        torch.as_tensor(a.data.astype(np.float64), device=dev),
        a.shape).coalesce().to_sparse_csr()
    A64 = lambda v: a64 @ v
    b = torch.ones(n, device=dev)
    _reset()
    t_ops = time.perf_counter()
    lmax = 1.05 * float(estimate_lmax(d, iters=30))
    ops = {"none": None, "jacobi_poly": jacobi_sweeps_op(d, sweeps=16),
           "chebyshev": chebyshev_op(d, lmax=lmax, lmin=lmax / 30, degree=16)}
    t_ops = time.perf_counter() - t_ops
    jac, che = ops["jacobi_poly"].info, ops["chebyshev"].info
    print(f"[poisson] poisson{POISSON}: n {n}, nnz {a.nnz}, {d.ndiags} diagonals, halo "
          f"{d.halo}; selection: Jacobi k = {jac['k']}, P = {jac['tile']}, "
          f"{jac['sweeps']} sweeps; Chebyshev k = {che['k']}, P = {che['tile']}, "
          f"degree {che['degree']}, lmax {lmax:.5f}, lmin {lmax / 30:.5f} "
          f"(operators built in {t_ops:.2f} s)", flush=True)

    def jacobi64(r):
        x = torch.zeros_like(r)
        for _ in range(jac["sweeps"]):
            x = x + jac["omega"] / 4.0 * (r - A64(x))
        return x

    coeffs = chebyshev_coeffs(che["lmin"], che["lmax"], che["degree"])

    def cheby64(r):
        z, dd = torch.zeros_like(r), torch.zeros_like(r)
        for ca, cb in coeffs:
            dd = ca * dd + cb * (r - A64(z))
            z = z + dd
        return z

    refs = {"none": None, "jacobi_poly": jacobi64, "chebyshev": cheby64}
    gen = torch.Generator(device=dev).manual_seed(5)
    for name in ("jacobi_poly", "chebyshev"):
        for _ in range(2):
            v = torch.randn(n, generator=gen, device=dev)
            got, want = ops[name](v).double(), refs[name](v.double())
            rel = float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want))
            if not rel <= POLY_OP_RTOL:
                fail(f"[poisson] {name} operator vs float64: relative error {rel:.3e}")
        print(f"[poisson] {name} operator (float32, kernels) vs float64 on two random "
              f"vectors: relative 2-norm error {rel:.3e} (tolerance {POLY_OP_RTOL})",
              flush=True)
    # the device time of one preconditioner apply (CUDA-graph replays of one
    # vector, L2-warm), in the rule's modes and with the streamed mode
    # forced: the K12 / K13 part of an iteration without the host clock's
    # spread.  Not the path: its launches are not counted
    v = torch.randn(n, generator=gen, device=dev)
    with _uncounted():
        for name in ("jacobi_poly", "chebyshev"):
            rule_ms = graph_ms(lambda: ops[name](v), 10)
            with _streamed():
                forced_ms = graph_ms(lambda: ops[name](v), 10)
            print(f"[poisson] {name} apply, device time: {rule_ms:.5f} ms in the rule's "
                  f"modes, {forced_ms:.5f} ms with K12 / K13 forced into the streamed mode",
                  flush=True)
    report = {}
    for name, op in ops.items():
        before, before_m = _counts(), _mode_counts()
        walls = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = cg(d, b, m_op=op, maxiter=CG_MAXITER, rtol=1e-5)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        x = res.x
        true_res = float(torch.linalg.vector_norm(b.double() - A64(x.double()))
                         / torch.linalg.vector_norm(b.double()))
        launches = {k: v - before[k] for k, v in _counts().items()}
        modes = {k: v - before_m[k] for k, v in _mode_counts().items() if v - before_m[k]}
        if op is not None:
            # the streamed mode gives the same iterates: K12 and K13 sum alike
            # in both modes, bit for bit.  A check, not the path: its
            # launches are printed and left out of the counts
            with _uncounted() as forced, _streamed():
                its_s = cg(d, b, m_op=op, maxiter=CG_MAXITER, rtol=1e-5).iterations
            if its_s != res.iterations:
                fail(f"[poisson] {name}: {res.iterations} iterations, {its_s} with K12 / "
                     f"K13 forced into the streamed mode")
            print(f"[poisson] {name} with K12 / K13 forced into the streamed mode: "
                  f"{its_s} iterations, as the rule's modes give; launches {forced} "
                  f"(not counted)", flush=True)
        t0 = time.perf_counter()
        ref_it, info, ref_hist = _cg_ref(A64, refs[name], n, CG_MAXITER, dev)
        ref_s = time.perf_counter() - t0
        got_x = _crossings(res.residuals.cpu().numpy() / np.sqrt(n))
        ref_x = _crossings(ref_hist)
        ladder = ", ".join(f"{t:g}: {got_x[t]} vs {ref_x[t]}" for t in CG_LADDER)
        rec = dict(iterations=res.iterations, cold_s=walls[0], steady_s=walls[1],
                   true_residual=true_res, launches=launches, modes=modes,
                   note=f"float64 scipy CG {ref_it} iterations (info {info}, "
                        f"{ref_s:.1f} s); first iteration at rtol (float32 vs "
                        f"float64) {ladder}")
        _row_print("poisson", name, rec)
        bad = [t for t in CG_PARITY_RTOLS if got_x[t] is None or ref_x[t] is None
               or abs(got_x[t] - ref_x[t]) > max(2, CG_ITER_TOL * ref_x[t])]
        if not res.converged or info != 0 or bad:
            fail(f"[poisson] {name}: converged {res.converged}, scipy info {info}; "
                 f"float32 vs float64 CG iterations at rtol {bad} differ by more "
                 f"than {CG_ITER_TOL:.0%}: {ladder}")
        report[name] = rec
    total = _counts()
    if min(total.values()) == 0:
        fail(f"[poisson] a kernel of the path did not launch: {total}")
    total.update(_k8_path_counts())
    print(f"[poisson] kernel launches over the three rows (two solves each, plus "
          f"estimate_lmax; the streamed-forced re-solves not counted): {total}",
          flush=True)
    return report, total


# --- the solver library (K10, K11, K14, K15, K16) ------------------------------

MULTI_K = 16                # right-hand sides of the [multirhs] phase
SPMM_K = 256                # the wide-K SpMM configuration (docs/BENCH.md:97-104)
SPMM_K_MANY = 64            # K15 on orsirr_like150's 230 diagonals
CHAIN = 8                   # K10 / K11: chained calls at scale 0.2
MULTI_ITER_TOL = 0.05       # cg_multi vs single cg per column at rtol 1e-5
BICGSTAB_ITER_TOL = 0.10    # port BiCGStab (float64) vs scipy's iteration count
# float32 BiCGStab on orsirr_like150 vs scipy's count: the float32 count
# moves with the SpMV's summation order (the COO entry orders below show
# by how much), so it is held to a wider bound, on the one SpMV whose
# order is fixed (K8)
BICGSTAB32_ITER_TOL = 0.20
BICGSTAB32_ORDERS = 8       # COO entry orders shown for the float32 spread
MULTI_COUNTERS = {"K10": dia.spmv_dia_padded_io, "K11": dia.spmv_dia_pingpong,
                  "K14": dia.spmv_dia_power_rhs, "K15": dia.spmm_dia,
                  "K16": dia.spmm_dia_t_padded}


def _jacobi_m(d):
    """The one-diagonal DIA Jacobi preconditioner diag(A)⁻¹ of ``cg_multi``."""
    diag = d.data[d.offsets.index(0)]
    return dia.DIA(data=torch.where(diag != 0, 1.0 / diag, 0.0)[None].contiguous(),
                   offsets=(0,), shape=d.shape, nnz=d.n)


def _csr(d):
    """The stored entries of a DIA as a torch.sparse CSR matrix on its
    device (the library yardstick; timed only)."""
    i = torch.arange(d.n, device=d.data.device)
    rows, cols, vals = [], [], []
    for s, off in enumerate(d.offsets):
        ok = (i + off >= 0) & (i + off < d.n)
        rows.append(i[ok]); cols.append(i[ok] + off); vals.append(d.data[s, :d.n][ok])
    return torch.sparse_coo_tensor(torch.stack([torch.cat(rows), torch.cat(cols)]),
                                   torch.cat(vals), d.shape).coalesce().to_sparse_csr()


def _rhs_ptxas():
    """The row-tile kernel's (K10, K11, K14, K16) registers and spills per
    instance, from this run's ptxas -v; fails on spills."""
    found = 0
    # (S1_ in the mangled name repeats the first template type, bf16)
    for m, spills, regs in _ptxas_entries(r"dia_rhs_kernelILb(\d)ELb(\d)ELi(\d+)ELi(\d+)E"
                                          r"(f|13__nv_bfloat16)(f|13__nv_bfloat16|S1_)E"):
        vec, power, rows, groups = map(int, m.groups()[:4])
        td, tv = ("float32" if t == "f" else "bf16" for t in m.groups()[4:])
        what = (f"{'16-byte' if vec else 'scalar'}, {rows} rows x {groups} right-hand sides "
                f"a thread, {'K14 / K10 / K11' if power else 'K16'}, diagonals {td}, "
                f"vectors {tv}")
        found += 1
        print(f"[dia-multi] ptxas dia_rhs_kernel, {what}: {spills}; {regs}", flush=True)
        if "0 bytes spill stores, 0 bytes spill loads" not in spills:
            fail(f"[dia-multi] the row-tile kernel spills ({what})")
    if not found:
        print("[dia-multi] ptxas: dia_rhs was not built in this run (a kept library)",
              flush=True)


def _pp_halo_check(key, dd, xq):
    """K10 into an allocator block that was filled with NaN before it was
    freed (the block its previous call was handed, so a halo row the launch
    skipped would show: its halo blocks must be zero), or K11 into a buffer
    of NaN (its halo blocks must stay NaN); the interior against the plain
    version (``_check``).  Made after the chain's counts were read."""
    p = (xq.shape[0] - dd.n_pad) // 2
    if key == "K10":
        y = dia.spmv_dia_padded_io(dd, xq, scale=0.2)
        ptr = y.data_ptr()
        y.fill_(float("nan"))
        del y
        y = dia.spmv_dia_padded_io(dd, xq, scale=0.2)
        torch.cuda.synchronize()
        if y.data_ptr() != ptr:
            fail("K10's NaN check: the allocator handed K10 another block")
        ok = not (y[:p].any() or y[p + dd.n_pad:].any())      # NaN counts as nonzero
        want = dia.spmv_dia_padded_io_ref(dd, xq, 0.2)
    else:
        y = torch.full_like(xq, float("nan"))
        dia.spmv_dia_pingpong(dd, xq, y, scale=0.2)
        torch.cuda.synchronize()
        ok = bool(torch.isnan(y[:p]).all() and torch.isnan(y[p + dd.n_pad:]).all())
        want = dia.spmv_dia_pingpong_ref(dd, xq, torch.full_like(xq, float("nan")), 0.2)
    label = f"{dd.data.dtype} diagonals, {_vname(xq.dtype)}"
    if not ok:
        fail(f"{key} ({label}): a halo block " + ("is not zero over a NaN block" if key == "K10"
                                                  else "was written"))
    _, checked = _check(key, f"halo check, {label}", [y[p:p + dd.n_pad]],
                        [want[p:p + dd.n_pad]], 1)
    print(f"[{key}] {label}: " + ("halo blocks zero over an allocator block that held NaN"
                                  if key == "K10" else "halo blocks of a NaN buffer untouched")
          + f"; interior {checked}", flush=True)


def phase_dia_multi(dev):
    """K10, K11, K14, K15 and K16 against their plain versions on the card
    at poisson1024 (K14 also at poisson512 with 2 right-hand sides and at
    poisson128 with 16, where the selection fuses k = 8; K16 also on the
    Jacobi M and at K = 256).  K10 and K11 are driven as chains of 8 calls
    at scale 0.2, their launch counts read around the chain.  Each kernel's
    first case (and K15 at K 16 and 7, K14 at k 8 on poisson512) then runs
    its two bf16-diagonal instances on the same inputs."""
    from gflownet_spai_tpu_torch.solvers.stationary import (_multirhs_config,
                                                            jacobi_iteration_matrix)
    from gflownet_spai_tpu_torch.sparse import gallery

    _rhs_ptxas()
    gen = torch.Generator(device=dev).manual_seed(4048)
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev)
    d = dia.coo_to_dia(gallery.poisson2d(POISSON, dtype=np.float32), device=dev)
    n, nd = d.n, d.ndiags
    csr = _csr(d)
    out, launches = {}, {}
    name = f"poisson{POISSON}"
    db = dia.dia_astype(d, BF16)

    def chain(key, dd, q):
        """K10 / K11 on ``dd``: 8 calls at scale 0.2 from buffer q (K11 swaps
        two buffers); checks the halo blocks."""
        if key == "K10":
            for _ in range(CHAIN):
                q = dia.spmv_dia_padded_io(dd, q, scale=0.2)
            bufs = [q]
        else:
            bufs = [q.clone(), torch.zeros_like(q)]
            for _ in range(CHAIN):
                dia.spmv_dia_pingpong(dd, bufs[0], bufs[1], scale=0.2)
                bufs.reverse()
        pp = (q.shape[0] - dd.n_pad) // 2
        if any(b[:pp].any() or b[pp + dd.n_pad:].any() for b in bufs):
            fail(f"{key} chain on {dd.data.dtype} diagonals: a halo block is not zero")
        return bufs[:1]

    def chain_ref(key, dd, q):
        if key == "K10":
            for _ in range(CHAIN):
                q = dia.spmv_dia_padded_io_ref(dd, q, 0.2)
            return [q]
        bufs = [q.clone(), torch.zeros_like(q)]
        for _ in range(CHAIN):
            dia.spmv_dia_pingpong_ref(dd, bufs[0], bufs[1], 0.2)
            bufs.reverse()
        return bufs[:1]

    def chain_bf16(key, xq0, make, f32, f32_rec):
        """K10 / K11's bf16-diagonal instances: the chain from ``xq0`` in
        each vector dtype, one call timed (``make(i, dd, xq)``)."""
        p = (xq0.shape[0] - d.n_pad) // 2
        for vt in BF16_VECS:
            xq = xq0.to(vt)
            xin, cb = xq[p:p + n], _csr_rounded(d, vt)
            one = (lambda xq=xq: dia.spmv_dia_padded_io_ref(db, xq, 0.2)) if key == "K10" \
                else (lambda xq=xq: dia.spmv_dia_pingpong_ref(db, xq, torch.zeros_like(xq), 0.2))

            def make_lib(i, cb=cb, xin=xin):
                ci, xi = (cb, xin) if i == 0 else (cb.clone(), xin.clone())
                return lambda: ci @ xi

            ev = xq.element_size()
            _bf16_put(out, key, vt, _record(
                f"{key} bf16", f"{name}, P {p}, chain of {CHAIN} calls at scale 0.2, bf16 "
                f"diagonals, {_vname(vt)}", chain(key, db, xq), chain_ref(key, db, xq), CHAIN,
                lambda i, xq=xq: make(i, db, xq), one,
                2 * nd * d.n_pad + ev * (n + (xq.shape[0] if key == "K10" else n)),
                (2 * nd + 1) * d.n_pad, make_lib=make_lib,
                again=lambda xq=xq: chain(key, db, xq), f32=f32, f32_rec=f32_rec,
                lib=_bf16_lib(lambda: cb @ xin, dia.spmv_dia_ref(db, xin), vt)), "chain")
            _pp_halo_check(key, db, xq)

    # K10: the padded-IO chain (a new buffer per call, halo blocks zeroed)
    x = rnd(n)
    xq0 = dia.dia_pad_io(d, x)
    p = (xq0.shape[0] - d.n_pad) // 2
    _reset(MULTI_COUNTERS)
    yq = xq0
    for _ in range(CHAIN):
        yq = dia.spmv_dia_padded_io(d, yq, scale=0.2)
    torch.cuda.synchronize()
    launches["K10"] = dia.spmv_dia_padded_io.launches
    want = xq0
    for _ in range(CHAIN):
        want = dia.spmv_dia_padded_io_ref(d, want, 0.2)
    if launches["K10"] != CHAIN or yq[:p].any() or yq[p + d.n_pad:].any():
        fail(f"K10 chain: {launches['K10']} launches, or a halo block not zero")
    _pp_halo_check("K10", d, xq0)
    xin = xq0[p:p + n]

    def make10(i, dd=d, xq=xq0):
        di, xi = (dd, xq) if i == 0 else (_dia_copy(dd), xq.clone())
        return lambda: dia.spmv_dia_padded_io(di, xi, scale=0.2)

    def make_lib1(i):
        ci, xi = (csr, xin) if i == 0 else (csr.clone(), xin.clone())
        return lambda: ci @ xi

    out["K10"] = _record(
        "K10", f"{name}, P {p}, chain of {CHAIN} calls at scale 0.2 (halo blocks zero)",
        [yq], [want], CHAIN, make10, lambda: dia.spmv_dia_padded_io_ref(d, xq0, 0.2),
        4 * (nd * d.n_pad + n + xq0.shape[0]), (2 * nd + 1) * d.n_pad,
        make_lib=make_lib1)
    chain_bf16("K10", xq0, make10, [yq], out["K10"])

    # K11: the ping-pong chain (two fixed buffers, swapped each call)
    xq0 = dia.dia_pad_pp(d, x)
    p = (xq0.shape[0] - d.n_pad) // 2
    bufs = [xq0.clone(), torch.zeros_like(xq0)]
    for _ in range(CHAIN):
        dia.spmv_dia_pingpong(d, bufs[0], bufs[1], scale=0.2)
        bufs.reverse()
    torch.cuda.synchronize()
    launches["K11"] = dia.spmv_dia_pingpong.launches
    ref = [xq0.clone(), torch.zeros_like(xq0)]
    for _ in range(CHAIN):
        dia.spmv_dia_pingpong_ref(d, ref[0], ref[1], 0.2)
        ref.reverse()
    if launches["K11"] != CHAIN or any(b[:p].any() or b[p + d.n_pad:].any() for b in bufs):
        fail(f"K11 chain: {launches['K11']} launches, or a halo block written")
    _pp_halo_check("K11", d, xq0)
    yq0 = torch.zeros_like(xq0)

    def make11(i, dd=d, xq=xq0):
        yi = torch.zeros_like(xq)
        di, xi = (dd, xq) if i == 0 else (_dia_copy(dd), xq.clone())
        return lambda: dia.spmv_dia_pingpong(di, xi, yi, scale=0.2)

    out["K11"] = _record(
        "K11", f"{name}, P {p}, chain of {CHAIN} calls at scale 0.2 (halo blocks never "
        "written)", [bufs[0]], [ref[0]], CHAIN, make11,
        lambda: dia.spmv_dia_pingpong_ref(d, xq0, yq0, 0.2),
        4 * (nd * d.n_pad + 2 * n), (2 * nd + 1) * d.n_pad, make_lib=make_lib1)
    chain_bf16("K11", xq0, make11, [bufs[0]], out["K11"])
    del bufs, ref, want, yq

    # K15: Y = A·X, X [n, 256] (1.07 GB)
    X = rnd(n, SPMM_K)
    y = dia.spmm_dia(d, X)
    launches["K15"] = dia.spmm_dia.launches
    want = dia.spmm_dia_ref(d, X)
    lib = csr @ X
    if not float((lib - want).abs().max()) <= _dia_tol(want, 1):
        fail("the torch.sparse yardstick does not compute K15's function")
    del lib

    def make15(i, dd=d, X=X):
        di, xi = (dd, X) if i == 0 else (_dia_copy(dd), X.clone())
        return lambda: dia.spmm_dia(di, xi)

    def make_lib15(i, c=csr, X=X):
        ci, xi = (c, X) if i == 0 else (c.clone(), X.clone())
        return lambda: ci @ xi

    out["K15"] = _record(
        "K15", f"{name}, X [{n}, {SPMM_K}]", [y], [want], 1, make15,
        lambda: dia.spmm_dia_ref(d, X), 4 * (nd * d.n_pad + 2 * n * SPMM_K),
        2 * nd * n * SPMM_K, make_lib=make_lib15, lib_name="torch.sparse CSR A@X", reps=5)
    del want
    for vt in BF16_VECS:
        Xb, cb = X.to(vt), _csr_rounded(d, vt)
        wb = dia.spmm_dia_ref(db, Xb)
        _bf16_put(out, "K15", vt, _record(
            "K15 bf16", f"{name}, X [{n}, {SPMM_K}], bf16 diagonals, {_vname(vt)}",
            [dia.spmm_dia(db, Xb)], [wb], 1, lambda i, Xb=Xb: make15(i, db, Xb),
            lambda Xb=Xb: dia.spmm_dia_ref(db, Xb),
            2 * nd * d.n_pad + 2 * Xb.element_size() * n * SPMM_K, 2 * nd * n * SPMM_K,
            make_lib=lambda i, cb=cb, Xb=Xb: make_lib15(i, cb, Xb), reps=5,
            again=lambda Xb=Xb: [dia.spmm_dia(db, Xb)], f32=[y], f32_rec=out["K15"],
            lib=_bf16_lib(lambda: cb @ Xb, wb, vt, "A@X")), f"K={SPMM_K}")
        del Xb, wb, cb
    del X, y
    # K15 at K 7 (the word-by-word path) and 16 (held, and their bf16
    # instances), and on the 230 diagonals of orsirr_like150 at K 64 (held
    # and timed)
    for k in (7, 16):
        Xk = rnd(n, k)
        yk, wk = dia.spmm_dia(d, Xk), dia.spmm_dia_ref(d, Xk)
        torch.cuda.synchronize()
        err = float((yk - wk).abs().max())
        if not err <= _dia_tol(wk, 1):
            fail(f"K15 at {name}, K {k}: max abs err {err:.3e} > {_dia_tol(wk, 1):.3e}")
        print(f"[K15] {name}, X [{n}, {k}]: max abs err {err:.3e}", flush=True)
        out[f"K15 K={k}"] = dict(err=err)
        for vt in BF16_VECS:
            Xb = Xk.to(vt)
            label = f"{name}, X [{n}, {k}], bf16 diagonals, {_vname(vt)}"
            err, checked = _check("K15 bf16", label, [dia.spmm_dia(db, Xb)],
                                  [dia.spmm_dia_ref(db, Xb)], 1,
                                  lambda Xb=Xb: [dia.spmm_dia(db, Xb)], [yk])
            print(f"[K15 bf16] {label}: {checked}", flush=True)
            out[f"bf16 K15 {_vname(vt)} K={k}"] = dict(err=err)
    a150 = gallery.get(MATRIX)
    d150 = dia.coo_to_dia(a150.with_data(a150.data.astype(np.float32)), device=dev)
    csr150 = _csr(d150)
    X150 = rnd(d150.n, SPMM_K_MANY)
    y150, want150 = dia.spmm_dia(d150, X150), dia.spmm_dia_ref(d150, X150)

    def make15b(i):
        di, xi = (d150, X150) if i == 0 else (_dia_copy(d150), X150.clone())
        return lambda: dia.spmm_dia(di, xi)

    def make_lib15b(i):
        ci, xi = (csr150, X150) if i == 0 else (csr150.clone(), X150.clone())
        return lambda: ci @ xi

    out["K15 orsirr"] = _record(
        "K15", f"{MATRIX} ({d150.ndiags} diagonals), X [{d150.n}, {SPMM_K_MANY}]",
        [y150], [want150], 1, make15b, lambda: dia.spmm_dia_ref(d150, X150),
        4 * (d150.ndiags * d150.n_pad + 2 * d150.n * SPMM_K_MANY),
        2 * d150.ndiags * d150.n * SPMM_K_MANY, make_lib=make_lib15b,
        lib_name="torch.sparse CSR A@X")
    del X150, y150, want150, csr150

    def k16(key, dd, label, xtp, reps=20, bf16=False):
        """K16 at the shape its path gives it: the unpadded entry
        (``spmm_dia_t_rows``, cg_multi's apply) on the [K_pad, n_pad]
        interior of the [K_pad, h + n_pad + h] buffer ``xtp``, filed as
        ``out[key]``, then the padded entry (``spmm_dia_t_padded``) on
        ``xtp`` itself as ``out[key + " padded"]``, the same bits.  The
        library yardstick is CSR A@X on a contiguous [n, K_pad] copy of X.
        With ``bf16``, both entries then on ``dia_astype(dd, bf16)`` with X
        in both vector dtypes."""
        h, kp = dd.halo, xtp.shape[0]
        pad = lambda t: torch.nn.functional.pad(t, (h, h))
        xr = xtp[:, h:h + dd.n_pad].contiguous()
        yt = dia.spmm_dia_t_rows(dd, xr)
        want = dia.spmm_dia_t_padded_ref(dd, xtp)
        if not torch.equal(dia.spmm_dia_t_padded(dd, xtp), yt):
            fail(f"K16 ({label}): spmm_dia_t_rows differs from spmm_dia_t_padded")
        mcsr = _csr(dd)
        x_nk = xtp[:, h:h + n].t().contiguous()
        if not float((mcsr @ x_nk - want[:, :n].t()).abs().max()) <= _dia_tol(want, 1):
            fail("the torch.sparse yardstick does not compute K16's function")

        def make(i, dd=dd, x=xr, entry=dia.spmm_dia_t_rows):
            di, xi = (dd, x) if i == 0 else (_dia_copy(dd), x.clone())
            return lambda: entry(di, xi)

        def make_lib(i, mcsr=mcsr, x_nk=x_nk):
            ci, xi = (mcsr, x_nk) if i == 0 else (mcsr.clone(), x_nk.clone())
            return lambda: ci @ xi

        lib_name = "torch.sparse CSR A@X (X [n, K_pad] contiguous)"
        entries = ((f"Xt [{kp}, {dd.n_pad}] unpadded, spmm_dia_t_rows", "",
                    dia.spmm_dia_t_rows, lambda x: x[:, h:h + dd.n_pad].contiguous(),
                    lambda x: dia.spmm_dia_t_padded_ref(dd, pad(x))),
                   (f"Xt [{kp}, {h} + {dd.n_pad} + {h}], spmm_dia_t_padded", " padded",
                    dia.spmm_dia_t_padded, lambda x: x,
                    lambda x: dia.spmm_dia_t_padded_ref(dd, x)))
        # every word of A once, X's K_pad rows of n_pad once, Y once
        nbytes = 4 * (dd.ndiags * dd.n_pad + 2 * kp * dd.n_pad)
        ops = 2 * dd.ndiags * dd.n_pad * kp
        for shape, tag, entry, arg, plain in entries:
            x = arg(xtp)
            out[key + tag] = _record(
                "K16", f"{label}, {dd.ndiags} diagonals, {shape}",
                [entry(dd, x)], [want], 1, lambda i, x=x, entry=entry: make(i, dd, x, entry),
                lambda x=x, plain=plain: plain(x), nbytes, ops, make_lib=make_lib,
                lib_name=lib_name, reps=reps)
        if not bf16:
            return
        mb = dia.dia_astype(dd, BF16)
        for vt in BF16_VECS:
            xb, cb = xtp.to(vt), _csr_rounded(dd, vt)
            wb = dia.spmm_dia_t_padded_ref(mb, xb)
            if not torch.equal(dia.spmm_dia_t_rows(mb, xb[:, h:h + dd.n_pad].contiguous()),
                               dia.spmm_dia_t_padded(mb, xb)):
                fail(f"K16 bf16 ({label}, {_vname(vt)}): spmm_dia_t_rows differs from "
                     "spmm_dia_t_padded")
            x_b = xb[:, h:h + n].t().contiguous()
            lib_b = _bf16_lib(lambda: cb @ x_b, wb[:, :n].t(), vt,
                              "A@X (X [n, K_pad] contiguous)")
            plain_b = ((lambda x: dia.spmm_dia_t_padded_ref(mb, pad(x))),
                       (lambda x: dia.spmm_dia_t_padded_ref(mb, x)))
            for (shape, tag, entry, arg, _), plain in zip(entries, plain_b):
                x = arg(xb)
                # the first (the unpadded entry) stands as the kernels line's
                _bf16_put(out, "K16", vt, _record(
                    "K16 bf16", f"{label}, {dd.ndiags} bf16 diagonals, {shape}, {_vname(vt)}",
                    [entry(mb, x)], [wb], 1, lambda i, x=x, entry=entry: make(i, mb, x, entry),
                    lambda x=x, plain=plain: plain(x),
                    2 * dd.ndiags * dd.n_pad + 2 * xb.element_size() * kp * dd.n_pad, ops,
                    reps=reps, make_lib=lambda i, cb=cb, x_b=x_b: make_lib(i, cb, x_b),
                    again=lambda x=x, entry=entry: [entry(mb, x)], f32=[yt],
                    f32_rec=out[key + tag], lib=lib_b), "cg_multi A" + tag)

    # K16 at cg_multi's shapes (its main path): A at K = 16 (dia_pad_xt's
    # K_pad), and the one-diagonal Jacobi M on the same [K_pad, n_pad] rows;
    # then the wide K = 256 case
    xtp = dia.dia_pad_xt(d, rnd(MULTI_K, n))
    k16("K16", d, f"{name} (cg_multi's A)", xtp, bf16=True)
    mj = _jacobi_m(d)
    h = d.halo
    k16("K16 M", mj, f"{name} Jacobi M (cg_multi's M)", torch.nn.functional.pad(
        xtp[:, h:h + d.n_pad], (mj.halo, mj.halo)))
    del xtp, mj
    k16("K16 K=256", d, name, dia.dia_pad_xt(d, rnd(SPMM_K, n)), reps=5)

    def k14(dd, label, n_rhs, k, tr, lib=False, bf16=None):
        """K14 on ``dd``'s Jacobi M; where ``bf16`` names the case, then on
        its bf16 copy with the same X and C in both vector dtypes."""
        m = jacobi_iteration_matrix(dd)
        xq = dia.dia_pad_pp_rhs(m, rnd(n_rhs, m.n), tr=tr)
        cq = dia.dia_pad_pp_rhs(m, rnd(n_rhs, m.n), tr=tr)
        zq = torch.zeros_like(xq)
        got = dia.spmv_dia_power_rhs(m, None, xq, zq, k=k, add=cq)
        want = dia.spmv_dia_power_rhs_ref(m, xq, torch.zeros_like(xq), k=k, add=cq)
        mode = "one pass" if k == 1 else f"{k} passes"

        def make(i, m=m, xq=xq, cq=cq):
            zq = torch.zeros_like(xq)
            if i == 0:
                return lambda: dia.spmv_dia_power_rhs(m, None, xq, zq, k=k, add=cq)
            mi, xi, zi, ci = _dia_copy(m), xq.clone(), zq.clone(), cq.clone()
            return lambda: dia.spmv_dia_power_rhs(mi, None, xi, zi, k=k, add=ci)

        q = (xq.shape[1] - m.n_pad) // 2
        nk = lambda t: t[:, q:q + m.n].t().contiguous()
        make_lib = None
        if lib:                      # k = 1: C + M·X in one call (addmm)
            mcsr, x_nk, c_nk = _csr(m), nk(xq), nk(cq)
            if not float((torch.addmm(c_nk, mcsr, x_nk).t()
                          - want[:, q:q + m.n]).abs().max()) <= _dia_tol(want, 1):
                fail("the addmm yardstick does not compute K14's function at k = 1")

            def make_lib(i, mcsr=mcsr, x_nk=x_nk, c_nk=c_nk):
                ci, xi, bi = (mcsr, x_nk, c_nk) if i == 0 else \
                    (mcsr.clone(), x_nk.clone(), c_nk.clone())
                return lambda: torch.addmm(bi, ci, xi)

        shape = f"{n_rhs} right-hand sides, k = {k}, P = {tr}, affine"
        ops = k * n_rhs * (2 * m.ndiags + 2) * m.n_pad
        rec = _record(
            "K14", f"{label} Jacobi M, {shape}, {mode}", [got], [want], k, make,
            lambda: dia.spmv_dia_power_rhs_ref(m, xq, torch.zeros_like(xq), k=k, add=cq),
            4 * (m.ndiags * m.n_pad + 3 * n_rhs * m.n_pad), ops, make_lib=make_lib,
            lib_name="torch.addmm(C, CSR M, X)")
        if bf16 is None:
            return rec
        mb = dia.dia_astype(m, BF16)
        for vt in BF16_VECS:
            xb, cb = xq.to(vt), cq.to(vt)
            call = lambda xb=xb, cb=cb: [dia.spmv_dia_power_rhs(
                mb, None, xb, torch.zeros_like(xb), k=k, add=cb)]
            plain = lambda xb=xb, cb=cb: dia.spmv_dia_power_rhs_ref(
                mb, xb, torch.zeros_like(xb), k=k, add=cb)
            label_b = f"{label} bf16 Jacobi M, {shape}, {_vname(vt)}, {mode}"
            got_b = call()
            lib_b, make_lib_b = None, None
            if lib:
                mc, x_nk, c_nk = _csr_rounded(m, vt), nk(xb), nk(cb)
                lib_b = _bf16_lib(lambda: torch.addmm(c_nk, mc, x_nk).t(),
                                  plain()[:, q:q + m.n], vt, "M in torch.addmm(C, M, X)")

                def make_lib_b(i, mc=mc, x_nk=x_nk, c_nk=c_nk):
                    return make_lib(i, mc, x_nk, c_nk)

            _bf16_put(out, "K14", vt, _record(
                "K14 bf16", label_b, got_b, [plain()], k, lambda i, xb=xb, cb=cb: make(
                    i, mb, xb, cb), plain,
                2 * m.ndiags * m.n_pad + 3 * xb.element_size() * n_rhs * m.n_pad, ops,
                make_lib=make_lib_b, again=call, f32=[got], f32_rec=rec, lib=lib_b), bf16)
        return rec

    m = jacobi_iteration_matrix(d)
    k, trk = _multirhs_config(m, 8, 100, MULTI_K)
    if k != 1:
        fail(f"jacobi_multirhs on {name} with {MULTI_K} right-hand sides should fuse "
             f"k = 1, not {k}")
    out["K14"] = k14(d, name, MULTI_K, 1, trk or dia.dia_pp_tile(m) or m.halo, lib=True,
                     bf16="k=1")
    del m
    # K14 at k 8, where the TPU's selection fuses k = 8 (copied: k is part of
    # the operator): poisson512 with 2 right-hand sides (also in both bf16
    # instances) and poisson128 with 16
    for side, n_rhs, key, bf16 in ((POISSON // 2, 2, "K14 k=8", True),
                                   (POISSON // 8, MULTI_K, "K14 k=8 small", False)):
        dd = dia.coo_to_dia(gallery.poisson2d(side, dtype=np.float32), device=dev)
        k, trk = _multirhs_config(jacobi_iteration_matrix(dd), 8, 16, n_rhs)
        if k != 8:
            fail(f"jacobi_multirhs on poisson{side} with {n_rhs} right-hand sides should "
                 f"fuse k = 8, not {k}")
        out[key] = k14(dd, f"poisson{side}", n_rhs, 8, trk, bf16="k=8" if bf16 else None)
    return out, launches


def _crossing(hist, bnorm, rtol):
    """The first iteration whose residual is ≤ rtol·‖b‖ (None if none)."""
    hit = np.nonzero(hist <= rtol * bnorm)[0]
    return int(hit[0]) + 1 if len(hit) else None


def _solver_device_ms(solve, steps):
    """Device ms per iteration (or sweep) of one more ``solve()`` under
    ``torch.profiler``, all kernels; its launches are left out of the
    counts."""
    saved = _counts(MULTI_COUNTERS)
    _, busy_ms, _, _ = _profiled(solve, 1)
    for key, fn in MULTI_COUNTERS.items():
        fn.launches = saved[key]
    return busy_ms / steps


def phase_multirhs(dev):
    """poisson1024 with 16 seeded right-hand sides, rtol 1e-5: ``cg_multi``
    (K16) plain and with a one-diagonal Jacobi M, each column against the
    port's single-RHS ``cg``; ``jacobi_multirhs`` (100 sweeps, k = 1: K14)
    against 16 single ``jacobi`` runs at the same k."""
    from gflownet_spai_tpu_torch.solvers import cg, cg_multi, jacobi, jacobi_multirhs
    from gflownet_spai_tpu_torch.sparse import gallery

    d = dia.coo_to_dia(gallery.poisson2d(POISSON, dtype=np.float32), device=dev)
    n = d.n
    B = torch.randn((MULTI_K, n), generator=torch.Generator(device=dev).manual_seed(77),
                    device=dev)
    bnorm = torch.linalg.vector_norm(B, dim=1).cpu().numpy()
    M = _jacobi_m(d)
    _reset(MULTI_COUNTERS)
    total = {}
    for label, m in (("cg_multi", None), ("cg_multi, Jacobi M", M)):
        before = _counts(MULTI_COUNTERS)
        walls = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = cg_multi(d, B, m=m, maxiter=CG_MAXITER, rtol=1e-5)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        launches = {k: v - before[k] for k, v in _counts(MULTI_COUNTERS).items() if v - before[k]}
        its = res.iterations.cpu().numpy()
        hist = res.residuals.cpu().numpy()
        dev_ms = _solver_device_ms(lambda m=m: cg_multi(d, B, m=m, maxiter=CG_MAXITER,
                                                        rtol=1e-5), int(its.max()))
        if not bool(res.converged.all()):
            fail(f"[multirhs] {label}: not every system converged ({its})")
        t0 = time.perf_counter()
        singles = [cg(d, B[i], m_op=m, maxiter=CG_MAXITER, rtol=1e-5) for i in range(MULTI_K)]
        torch.cuda.synchronize()
        single_s = time.perf_counter() - t0
        bad = []
        for i, sres in enumerate(singles):
            shist = sres.residuals.cpu().numpy()
            for t in (1e-1, 1e-2):
                if _crossing(hist[:, i], bnorm[i], t) != _crossing(shist, bnorm[i], t):
                    bad.append((i, t, _crossing(hist[:, i], bnorm[i], t),
                                _crossing(shist, bnorm[i], t)))
            if abs(int(its[i]) - sres.iterations) > MULTI_ITER_TOL * sres.iterations:
                bad.append((i, 1e-5, int(its[i]), sres.iterations))
        print(f"[multirhs] {label}: {MULTI_K} systems of poisson{POISSON}, iterations "
              f"{its.min()}-{its.max()} (single cg {min(s.iterations for s in singles)}-"
              f"{max(s.iterations for s in singles)}); wall cold {walls[0]:.3f} s, steady "
              f"{walls[1]:.3f} s per solve of all {MULTI_K} ({1e3 * walls[1] / its.max():.4f} "
              f"ms/iteration; device {dev_ms:.4f} ms/iteration under torch.profiler), "
              f"single cg {single_s:.3f} s for the {MULTI_K} columns; launches over both "
              f"solves {launches}", flush=True)
        if bad:
            fail(f"[multirhs] {label} vs single cg (system, rtol, multi, single): {bad}")
        total[label] = launches
    before = _counts(MULTI_COUNTERS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    jm = jacobi_multirhs(d, B, iters=100)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v - before[k] for k, v in _counts(MULTI_COUNTERS).items() if v - before[k]}
    dev_ms = _solver_device_ms(lambda: jacobi_multirhs(d, B, iters=100), jm.iterations)
    t0 = time.perf_counter()
    singles = [jacobi(d, B[i], iters=100, fuse_k=1) for i in range(MULTI_K)]
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t0
    got = jm.residual.cpu().numpy()
    want = np.array([float(s.residual) for s in singles])
    rel = float(np.max(np.abs(got - want) / want))
    print(f"[multirhs] jacobi_multirhs: {MULTI_K} systems, {jm.iterations} sweeps (k = "
          f"1): {1e3 * wall:.3f} ms ({1e3 * wall / jm.iterations:.4f} ms/sweep for all "
          f"{MULTI_K}; device {dev_ms:.4f} ms/sweep under torch.profiler), {MULTI_K} single "
          f"jacobi {1e3 * single_s:.3f} ms; residuals vs the single runs: max relative "
          f"difference {rel:.3e}; launches {launches}", flush=True)
    if jm.iterations != 100 or singles[0].iterations != 100 or launches.get("K14") != 100 \
            or not rel <= 1e-4:
        fail(f"[multirhs] jacobi_multirhs: {jm.iterations} sweeps, launches {launches}, "
             f"residuals off by {rel:.3e}")
    total["jacobi_multirhs"] = launches
    return total


VCYCLE_ROWS = (("none", None),
               ("vcycle(levels=6)", dict(levels=6, pre=2, post=2, coarse_sweeps=16)),
               ("vcycle-cheb(levels=3)", dict(levels=3, smoother="chebyshev")),
               ("wcycle-cheb(levels=3)", dict(levels=3, smoother="chebyshev", gamma=2)))


def phase_vcycle(dev):
    """poisson1024 CG (b = ones, rtol 1e-5) with the V-cycle rows of
    ``examples/chebyshev_cg.py:59-70``, each held against the same operator
    in float64 on the CPU (its CG to rtol 1e-2: the first iteration at rtol
    1e-1 and 1e-2 within ``CG_ITER_TOL``); BiCGStab on orsirr_like150
    against scipy's iteration count."""
    import inspect

    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    from gflownet_spai_tpu_torch.solvers import bicgstab, cg, vcycle_op
    from gflownet_spai_tpu_torch.sparse import gallery

    a = gallery.poisson2d(POISSON, dtype=np.float32)
    d = dia.coo_to_dia(a, device=dev)
    d64 = dia.coo_to_dia(gallery.poisson2d(POISSON), device="cpu")
    n = d.n
    b = torch.ones(n, device=dev)
    _reset()
    report = {}
    for name, kw in VCYCLE_ROWS:
        t0 = time.perf_counter()
        op = vcycle_op(d, **kw) if kw else None
        setup_s = time.perf_counter() - t0
        before, before_m = _counts(), _mode_counts()
        walls = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = cg(d, b, m_op=op, maxiter=CG_MAXITER, rtol=1e-5)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        launches = {k: (v - before[k]) // 2 for k, v in _counts().items()}
        modes = {k: (v - before_m[k]) // 2 for k, v in _mode_counts().items()
                 if v - before_m[k]}
        true_res = float(torch.linalg.vector_norm(b - dia.spmv_dia(d, res.x))
                         / torch.linalg.vector_norm(b))
        got_x = {t: _crossing(res.residuals.cpu().numpy(), np.sqrt(n), t)
                 for t in CG_LADDER}
        note = f"set-up {setup_s:.2f} s" + (f", k per level {op.info['k']}" if op else "")
        if kw:
            t0 = time.perf_counter()
            ref = cg(d64, torch.ones(n, dtype=torch.float64), m_op=vcycle_op(d64, **kw),
                     maxiter=CG_MAXITER, rtol=1e-2)
            ref_x = {t: _crossing(ref.residuals.numpy(), np.sqrt(n), t) for t in (1e-1, 1e-2)}
            note += (f"; float64 CPU reference {time.perf_counter() - t0:.1f} s: first "
                     f"iteration at rtol 1e-1 {got_x[1e-1]} vs {ref_x[1e-1]}, 1e-2 "
                     f"{got_x[1e-2]} vs {ref_x[1e-2]}")
            bad = [t for t in (1e-1, 1e-2) if got_x[t] is None or ref_x[t] is None
                   or abs(got_x[t] - ref_x[t]) > max(2, CG_ITER_TOL * ref_x[t])]
        else:
            bad = []
        rec = dict(iterations=res.iterations, cold_s=walls[0], steady_s=walls[1],
                   true_residual=true_res, launches=launches, modes=modes, note=note)
        _row_print("vcycle", name, rec)
        if not res.converged or bad:
            fail(f"[vcycle] {name}: converged {res.converged}; float32 vs float64 "
                 f"iterations at rtol {bad} differ by more than {CG_ITER_TOL:.0%}")
        report[name] = rec
    total = _counts()
    if total["K8"] == 0 or total["K12"] + total["K13"] == 0:
        fail(f"[vcycle] the V-cycles did not run K8 and the fused kernels: {total}")
    total.update(_k8_path_counts())

    ors = gallery.get(MATRIX)
    A = sp.csr_matrix((ors.data, (ors.row, ors.col)), shape=ors.shape)
    count = [0]
    tol_kw = "rtol" if "rtol" in inspect.signature(spla.bicgstab).parameters else "tol"
    _, info = spla.bicgstab(A, np.ones(ors.shape[0]), maxiter=CG_MAXITER,
                            callback=lambda _: count.__setitem__(0, count[0] + 1),
                            **{tol_kw: 1e-5})
    bnorm = float(np.sqrt(ors.shape[0]))

    def run(label, a_dev, dtype):
        bb = torch.ones(ors.shape[0], dtype=dtype, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = bicgstab(a_dev, bb, maxiter=CG_MAXITER, rtol=1e-5)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        # stopped on its recursive residual, not on a breakdown
        reached = bool(res.residuals[res.iterations - 1] <= 1e-5 * bnorm)
        print(f"[vcycle] bicgstab {MATRIX} ({label}, b = ones, rtol 1e-5): "
              f"{res.iterations} iterations (scipy float64: {count[0]}, info {info}), "
              f"recursive residual reached rtol {reached}, true residual reached "
              f"{res.converged}, {wall:.3f} s ({1e3 * wall / max(res.iterations, 1):.4f} "
              f"ms/iteration)", flush=True)
        return res.iterations, reached

    def off(its, tol):
        return abs(its - count[0]) > tol * count[0]

    its, _ = run("float64, COO", ors.to(dev), torch.float64)
    if off(its, BICGSTAB_ITER_TOL):
        fail(f"[vcycle] float64 bicgstab {its} iterations vs scipy's {count[0]}")
    # float32: the count depends on the SpMV's summation order.  The DIA
    # SpMV (K8, each row summed by one thread in a fixed order) runs the same every time
    # and is held; the COO SpMV's index_add_ adds in a run-dependent order,
    # shown over seeded orders of its entries
    a32 = ors.with_data(ors.data.astype(np.float32))
    its, reached = run("float32, DIA (K8)", dia.coo_to_dia(a32, device=dev), torch.float32)
    if not reached or off(its, BICGSTAB32_ITER_TOL):
        fail(f"[vcycle] float32 bicgstab on the DIA SpMV: {its} iterations vs scipy's "
             f"{count[0]} (bound {BICGSTAB32_ITER_TOL:.0%}), reached rtol {reached}")
    rng = np.random.default_rng(5)
    spread = []
    for i in range(BICGSTAB32_ORDERS):
        p = np.arange(a32.nnz) if i == 0 else rng.permutation(a32.nnz)
        spread.append(run(f"float32, COO, entry order {i}",
                          type(a32)(row=a32.row[p], col=a32.col[p], data=a32.data[p],
                                    shape=a32.shape).to(dev), torch.float32))
    print(f"[vcycle] float32 bicgstab over {BICGSTAB32_ORDERS} COO entry orders "
          f"(iterations, reached rtol): {spread}", flush=True)
    print(f"[vcycle] kernel launches over the rows (two solves each, plus set-up): "
          f"{total}", flush=True)
    return report, total


def phase_validate_cli():
    """The port's validate CLI on bcsstk03_like in a subprocess on the card."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_validate_") as tmp:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "gflownet_spai_tpu_torch.validate", *CLI_ARGS,
             "--out-dir", tmp], capture_output=True, text=True, timeout=900,
            cwd=str(Path(__file__).resolve().parent))
        secs = time.perf_counter() - t0
        path = Path(tmp) / "validation.json"
        if proc.returncode not in (0, 1) or not path.exists():
            fail(f"the validate CLI exited {proc.returncode}: "
                 f"{(proc.stdout + proc.stderr)[-2000:]}")
        report = json.loads(path.read_text())
    rows = ("none", "ilu", "sampled_spai", "classic_spai", "jacobi_poly", "chebyshev",
            "vcycle")
    for row in rows:
        if row not in report or report[row]["iterations"] < 1 \
                or not np.isfinite(report[row]["true_residual"]):
            fail(f"validation.json lacks a finite row {row}: {report.get(row)}")
    vc = report["vcycle"]
    if not (vc["iterations"] < 500 and vc["true_residual"] <= 100 * 1e-5):
        fail(f"the CLI's vcycle row did not converge: {vc}")
    verdict = [ln for ln in proc.stdout.splitlines() if ln.startswith("sampled SPAI")]
    print(f"[validate-cli] python -m gflownet_spai_tpu_torch.validate "
          f"{' '.join(CLI_ARGS)}: exit {proc.returncode} in {secs:.1f} s (process "
          f"start and setup included); " + "; ".join(
              f"{r} {report[r]['iterations']} it" for r in rows)
          + f"; verdict: {verdict[-1] if verdict else '?'}", flush=True)


# ---------------------------------------------------------------------------
# [segment], [gat-generic], [bell]: the generic GATv2 tile layer (K5-K7) and
# the block-ELL SpMM (K17)
# ---------------------------------------------------------------------------

# K6 and K17 sum in another order than their plain versions: rtol 1e-5 and,
# per element, 4·eps32 times the sum of the magnitudes of its terms; K5
# divides by a sum of positive terms whose rounding grows with the run:
# rtol 1e-5 + 4·eps32·(run length), atol 1e-6; K5's backward
# y ⊙ (g − Σ_run y·g) carries K6's bound through the product with y: atol
# 1e-6, rtol 1e-5 and 4·eps32·|y|·Σ_run|y·g|.  K7 moves values: exact.
SEG_RTOL, SEG_EPS_SUMS = 1e-5, 4.0
# the generic stack's gradients against the per-edge path and float64: the
# repo's bound for tiled vs per-edge GAT gradients (tests/test_segment.py
# :116-121, rtol 5e-3, atol 5e-4) times the layer's largest gradient
GEN_GRAD_RTOL, GEN_GRAD_ATOL = 5e-3, 5e-4
GEN_HEADS, GEN_HIDDEN, GEN_EDGE_DIM = 4, 4, 2   # the forward policy's widths
# calls of each segment kernel in one forward + backward of the generic
# stack, by feature width (layer 1: heads 4 x 4 on the uniform x; layer 2:
# heads 1 x 4 through K3 and K7; "K5b" is K5's backward kernel)
GEN_CALLS = {"K5": {4: 1, 1: 1}, "K5b": {4: 1, 1: 1}, "K6": {16: 1, 4: 2},
             "K7": {16: 1, 4: 2}}
GEN_PROFILED = 5            # forward + backward passes under torch.profiler
SEG_COUNTERS = {"K3": seg.gather_rows_windows, "K4": seg.scatter_rows_windows,
                "K5": seg.segment_softmax_tiles_mh, "K6": seg.segment_sum_tiles,
                "K7": seg.segment_broadcast_tiles, "K5b": seg.segment_softmax_tiles_bwd}
BELL_K = 256                # docs/BENCH.md:108-125
BELL_DENSITY = 0.02         # of the blocks
BELL_CASES = ((4096, (8, 128)), (4096, (32, 128)), (4096, (128, 128)), (65536, (8, 128)),
              (65536, (128, 128)))
BELL_SCIPY_ROWS = 512       # rows of a 65,536 case held against scipy float64
BELL_ZERO_SLOTS = 3         # explicit zero blocks added per row of the irregular BELL
# K17's instances by their name in spmm_bell.type_launches: (blocks, X)
# dtypes, and the peak rate of their operations (CUDA cores; bf16 x bf16 on
# the tensor cores)
BELL_TYPES = {"float32": (torch.float32, torch.float32, F32_OPS_PER_S),
              "bf16 blocks, bf16 X": (BF16, BF16, TC_OPS_PER_S),
              "bf16 blocks, float32 X": (BF16, torch.float32, F32_OPS_PER_S)}


def _elementwise(got, want, bound, what):
    err = (got - want).abs()
    worst = float((err / torch.clamp_min(bound, 1e-30)).max())
    if not worst <= 1.0:
        fail(f"{what}: max abs err {float(err.max()):.3e}, {worst:.2f} of the "
             f"elementwise bound")
    return float(err.max()), f"max abs err {float(err.max()):.3e} ({100 * worst:.1f}% " \
        f"of the elementwise bound)"


def _plans(values, rule_name, patch, fns, check):
    """A kernel at every lane count ``values`` its rule (``rule_name`` in
    ``seg``) can pick, outputs held by ``check`` first, timed as ``_timed``
    times it (graph replays cycling through ``fns``, one per input copy).
    ``patch(v)`` is the rule that forces v.  Returns the times."""
    rule = getattr(seg, rule_name)
    times = []
    for v in values:
        setattr(seg, rule_name, patch(v))
        try:
            check(fns[0]())
            times.append(f"{v} {graph_ms(_cycle(fns), 20):.5f}")
        finally:
            setattr(seg, rule_name, rule)
    return ", ".join(times)


def _k6_plans(tiles, width, xs, check):
    """K6 at slot lanes R 1, 2, 4 and 8 beside the rule's pick."""
    q = width // 4 if width % 4 == 0 else width
    run = seg._mean_run(tiles)
    times = _plans((1, 2, 4, 8), "_sum_lanes",
                   lambda R: lambda q, mean_run: (min(seg._pow2(q), 32 // R), R),
                   [functools.partial(seg.segment_sum_tiles, tiles, x) for x in xs], check)
    print(f"[K6-plans] D {width}, mean run {run:.2f}: R " + times
          + f" ms (the rule picks R{seg._sum_lanes(q, run)[1]})", flush=True)


def _k5_plans(key, width, fns, check, tiles):
    """K5 forward or backward at slot lanes L 1, 2, 4 and 8 beside the
    rule's pick."""
    run = seg._mean_run(tiles)
    times = _plans((1, 2, 4, 8), "_slot_lanes", lambda L: lambda mean_run: L, fns, check)
    print(f"[{key}-plans] H {width}, mean run {run:.2f}: L " + times
          + f" ms (the rule picks L{seg._slot_lanes(run)})", flush=True)


def _k5b_bound(tiles, y, g, want):
    return 1e-6 + SEG_RTOL * want.abs() + SEG_EPS_SUMS * EPS32 * y.abs() \
        * seg._run_sums_ref(tiles, (y * g).abs())


def _k5_chain(tiles, y, g):
    """K5's backward as the JAX VJP composes it (and the port did before its
    backward kernel): multiply, transpose, K6, K7, transpose back,
    subtract, multiply."""
    T, H, S = y.shape
    yg = (y * g).permute(0, 2, 1).contiguous()
    per_node = seg.segment_sum_tiles(tiles, yg).reshape(T, tiles.tile_nodes, H)
    return y * (g - seg.segment_broadcast_tiles(tiles, per_node).permute(0, 2, 1))


class _SparseSoftmax:
    """The library yardstick of K5 and its backward: ``torch.sparse.softmax``
    over dim 1 of a coalesced hybrid COO tensor [T·TN, T·S, H] whose entries
    are the real slots, (t·TN + node, t·S + slot), and
    ``aten._sparse_softmax_backward_data`` on the same pattern; built
    outside the timed calls."""

    def __init__(self, tiles, H):
        T, S, TN = tiles.tiles, tiles.slots, tiles.tile_nodes
        lid = tiles.local_dst
        t, slot = torch.nonzero((lid >= 0) & (lid < TN), as_tuple=True)
        self.cols = t * S + slot
        self.idx = torch.stack([t * TN + lid[t, slot].long(), self.cols])
        self.shape, self.T, self.S, self.H = (T * TN, T * S, H), T, S, H

    def sparse(self, x):
        """[T, H, S] → the hybrid COO tensor of its real slots."""
        vals = x.permute(0, 2, 1).reshape(-1, self.H)[self.cols]
        return torch.sparse_coo_tensor(self.idx, vals, self.shape,
                                       check_invariants=False).coalesce()

    @staticmethod
    def softmax(sp):
        return torch.sparse.softmax(sp, 1)

    @staticmethod
    def backward(g_sp, y_sp, x_sp):
        return torch.ops.aten._sparse_softmax_backward_data(g_sp, y_sp, 1, x_sp)

    def dense(self, out):
        """A result back to [T, H, S] (0 off the pattern)."""
        out = out.coalesce()
        flat = out.values().new_zeros((self.T * self.S, self.H))
        flat[out.indices()[1]] = out.values()
        return flat.reshape(self.T, self.S, self.H).permute(0, 2, 1)

    @staticmethod
    def name(key):
        return "torch.sparse.softmax" if key == "K5" else "aten._sparse_softmax_backward_data"


def _shuffled(tiles, gen):
    """The layout with each tile's slots permuted and every third padding
    slot marked -1, every third TN + 5 (as the card tests' shuffled
    layouts): no node's slots form a run."""
    T, S, TN = tiles.tiles, tiles.slots, tiles.tile_nodes
    keys = torch.rand((T, S), generator=gen, device=tiles.local_dst.device)
    lid = torch.gather(tiles.local_dst, 1, torch.argsort(keys, dim=1))
    pad = lid == TN
    k = pad.long().cumsum(1)
    lid = torch.where(pad & (k % 3 == 1), -1, torch.where(pad & (k % 3 == 2), TN + 5, lid))
    shuf = dataclasses.replace(tiles, local_dst=lid.to(torch.int32).contiguous())
    if seg.layout_runs(shuf)[1] is None:
        fail("[segment] the shuffled layout's slots form runs")
    return shuf


def _segment_shuffled(tiles, gen, dev):
    """K5 forward and backward and K6 against their plain versions on the
    shuffled layout, K7 exactly; K5's times there beside the uniform
    layout's."""
    shuf = _shuffled(tiles, gen)
    T, S, TN = shuf.tiles, shuf.slots, shuf.tile_nodes
    r = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    errs, times = {}, []
    for H in (4, 1):
        xs = [r(T, H, S) * 3 for _ in range(_copies(4 * 2 * T * H * S))]
        gs = [r(T, H, S) for _ in xs]
        want = seg.segment_softmax_tiles_ref(shuf, xs[0])
        ys = [seg.segment_softmax_tiles_mh(shuf, x) for x in xs]
        bound = 1e-6 + (SEG_RTOL + SEG_EPS_SUMS * EPS32 * seg._run_sums_ref(
            shuf, torch.ones_like(want))) * want.abs()
        errs[f"K5 H {H}"] = _elementwise(ys[0], want, bound, f"K5 on the shuffled layout, "
                                         f"H {H}")[0]
        want_b = seg.segment_softmax_tiles_bwd_ref(shuf, ys[0], gs[0])
        got_b = seg.segment_softmax_tiles_bwd(shuf, ys[0], gs[0])
        errs[f"K5b H {H}"] = _elementwise(got_b, want_b, _k5b_bound(shuf, ys[0], gs[0], want_b),
                                          f"K5 backward on the shuffled layout, H {H}")[0]
        fwd = [functools.partial(seg.segment_softmax_tiles_mh, shuf, x) for x in xs]
        bwd = [functools.partial(seg.segment_softmax_tiles_bwd, shuf, y, g)
               for y, g in zip(ys, gs)]
        times.append(f"H {H} forward {graph_ms(_cycle(fwd), 20):.5f}, backward "
                     f"{graph_ms(_cycle(bwd), 20):.5f}")
    for D in (16, 4, 1):
        vals, nodes = r(T, S, D), r(T, TN, D)
        want = seg.segment_sum_tiles_ref(shuf, vals)
        bound = SEG_RTOL * want.abs() + SEG_EPS_SUMS * EPS32 * seg.segment_sum_tiles_ref(
            shuf, vals.abs())
        errs[f"K6 D {D}"] = _elementwise(seg.segment_sum_tiles(shuf, vals), want, bound,
                                         f"K6 on the shuffled layout, D {D}")[0]
        if not torch.equal(seg.segment_broadcast_tiles(shuf, nodes),
                           seg.segment_broadcast_tiles_ref(shuf, nodes)):
            fail(f"K7 on the shuffled layout, D {D}, disagrees with its plain version")
    print(f"[segment] shuffled layout (each tile's slots permuted, padding ids -1 and "
          f"TN + 5; slot order through layout_runs): max abs err "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + "; K7 exact; K5 graph replays " + "; ".join(times) + " ms", flush=True)
    return max(v for k, v in errs.items() if k.startswith("K5 ")), \
        max(v for k, v in errs.items() if k.startswith("K5b"))


def phase_segment(graph, dev):
    """K5 forward and backward, K6 and K7 against their plain versions at
    orsirr_like150's uniform tile layout, at every width the generic stack
    gives them, and on that layout shuffled."""
    tiles = graph.tiles
    T, S, TN = tiles.tiles, tiles.slots, tiles.tile_nodes
    gen = torch.Generator(device=dev).manual_seed(77)
    real, nodes = _tile_counts(tiles, dev)
    rows = seg._slot_rows(tiles)
    ones = torch.ones((T, S, 1), device=dev)
    run_len = seg.segment_broadcast_tiles_ref(
        tiles, seg.segment_sum_tiles_ref(tiles, ones).reshape(T, TN, 1))   # [T, S, 1]
    floor = launch_floor()
    print(f"[segment] {MATRIX} uniform layout: T {T}, S {S}, TN {TN}, {real} real "
          f"slots of {T * S}, {nodes} nodes with slots, longest run "
          f"{int(run_len.max())}; launch floor {floor:.5f} ms", flush=True)
    out, chains = {}, {}
    cases = [("K5", 4), ("K5", 1), ("K5b", 4), ("K5b", 1), ("K6", 16), ("K6", 4), ("K6", 1),
             ("K7", 16), ("K7", 4), ("K7", 1)]
    for key, width in cases:
        r = lambda *shape: torch.randn(shape, generator=gen, device=dev)
        make_lib, lib_name, lib_check = None, None, None
        if key in ("K5", "K5b"):
            sps = _SparseSoftmax(tiles, width)
            label = f"H {width}, [{T}, {width}, {S}]"
        if key == "K5":
            # the layout enters as its run starts [T, TN + 1]; each real slot's
            # score is read once (padding is written, never read) and every
            # output written once
            nbytes, ops = 4 * (T * (TN + 1) + real * width + T * width * S), 5 * real * width
            xs = [r(T, width, S) * 3 for _ in range(_copies(nbytes))]
            call = lambda x: seg.segment_softmax_tiles_mh(tiles, x)
            plain = lambda x: seg.segment_softmax_tiles_ref(tiles, x)
            want = plain(xs[0])
            bound = 1e-6 + (SEG_RTOL + SEG_EPS_SUMS * EPS32 * run_len.permute(0, 2, 1)) \
                * want.abs()
            inputs = [(x,) for x in xs]
            lib_in = [sps.sparse(x) for x in xs]
            lib = lambda i: sps.softmax(lib_in[i])
        elif key == "K5b":
            # the real slots' y and g read once, every output written once
            nbytes, ops = 4 * (T * (TN + 1) + 2 * real * width + T * width * S), \
                4 * real * width
            xs = [r(T, width, S) * 3 for _ in range(_copies(nbytes))]
            ys = [seg.segment_softmax_tiles_ref(tiles, x).contiguous() for x in xs]
            gs = [r(T, width, S) for _ in xs]
            inputs = list(zip(ys, gs))
            plain = lambda y, g: seg.segment_softmax_tiles_bwd_ref(tiles, y, g)
            want = plain(*inputs[0])
            bound = _k5b_bound(tiles, ys[0], gs[0], want)
            # the parent's path: K6 and K7 with the heads as the feature axis
            got = _k5_chain(tiles, *inputs[0])
            _elementwise(got, want, bound, f"K5's backward as a K6 and a K7, H {width}")
            chain_fns = [functools.partial(_k5_chain, tiles, y, g) for y, g in inputs]
            chains[width] = dict(ms=graph_ms(_cycle(chain_fns), 20),
                                 eager=cuda_ms(chain_fns[0], 20))
            print(f"[K5b] H {width}: K5's backward as a K6 and a K7 (multiply, transpose, "
                  f"K6, K7, transpose back, subtract, multiply): {chains[width]['ms']:.5f} "
                  f"ms (graph replay over {len(chain_fns)} input copies; eager "
                  f"{chains[width]['eager']:.5f} ms)", flush=True)
            call = lambda y, g: seg.segment_softmax_tiles_bwd(tiles, y, g)
            lib_in = [(sps.sparse(g), sps.sparse(y), sps.sparse(x))
                      for x, (y, g) in zip(xs, inputs)]
            lib = lambda i: sps.backward(*lib_in[i])
        elif key == "K6":
            nbytes = 4 * (T * (TN + 1) + real * width + T * TN * width)
            xs = [r(T, S, width) for _ in range(16)]
            inputs = [(x,) for x in xs]
            call = lambda x: seg.segment_sum_tiles(tiles, x)
            plain = lambda x: seg.segment_sum_tiles_ref(tiles, x)
            want = plain(xs[0])
            bound = SEG_RTOL * want.abs() + SEG_EPS_SUMS * EPS32 * plain(xs[0].abs())
            # the layout enters as its run starts [T, TN + 1], derived once
            ops = real * width
            lib = lambda i: torch.zeros((T * (TN + 1), width), device=dev).index_add_(
                0, rows, xs[i].reshape(-1, width))
            lib_check = lambda o: o.reshape(T, TN + 1, width)[:, :TN].reshape(-1, width)
            lib_name = "index_add_"
            label = f"D {width}, [{T}, {S}, {width}] -> [{T}, {TN}, {width}]"
        else:
            xs = [r(T, TN, width) for _ in range(16)]
            inputs = [(x,) for x in xs]
            call = lambda x: seg.segment_broadcast_tiles(tiles, x)
            plain = lambda x: seg.segment_broadcast_tiles_ref(tiles, x)
            want = plain(xs[0])
            bound = None
            nbytes, ops = 4 * (T * S + nodes * width + T * S * width), 0
            # the same function as one indexing call on the nodes' rows with a
            # zero row per tile appended (built outside the timed call)
            exts = [torch.cat([x, x.new_zeros((T, 1, width))], 1).reshape(-1, width)
                    for x in xs]
            lib = lambda i: torch.index_select(exts[i], 0, rows)
            lib_check = lambda o: o.reshape(T, S, width)
            lib_name = "index_select"
            label = f"D {width}, [{T}, {TN}, {width}] -> [{T}, {S}, {width}]"
        got = call(*inputs[0])
        torch.cuda.synchronize()
        if bound is None:
            err = float((got - want).abs().max())
            if not torch.equal(got, want):
                fail(f"K7 at D {width} disagrees with its plain version: {err:.3e}")
            checked = "exact"
            if not torch.equal(lib_check(lib(0)), want):
                fail("the index_select yardstick does not compute K7's function")
        else:
            err, checked = _elementwise(got, want, bound, f"{key} at width {width}")
            if key not in ("K5", "K5b"):
                _elementwise(lib_check(lib(0)), want, bound, f"the {lib_name} yardstick")
        if key in ("K5", "K5b"):
            if not torch.equal(call(*inputs[0]), got):
                fail(f"{key} at H {width}: a second launch gives other bits")
            checked += "; a second launch gives the same bits"
        else:
            make_lib = lambda i: (lambda: lib(i))
        rec = out[(key, width)] = _timed(key, label, checked, err,
                                         lambda i: (lambda: call(*inputs[i])),
                                         lambda: plain(*inputs[0]), nbytes, ops, make_lib,
                                         lib_name, reps=20)
        if key in ("K5", "K5b"):
            # the sparse COO calls are timed eagerly (they may synchronise with
            # the host), and only where they compute the kernel's function
            lib_err = (sps.dense(lib(0)) - want).abs()
            if bool((lib_err <= bound).all()):
                lib_fns = [functools.partial(lib, i) for i in range(len(inputs))]
                rec["lib"] = cuda_ms(_cycle(lib_fns), 10)
                print(f"[{key}] H {width}: {sps.name(key)} {rec['lib']:.5f} ms (eager calls, "
                      f"CUDA events, the same copies; the sparse inputs built outside the "
                      f"timed call; max abs err {float(lib_err.max()):.3e})", flush=True)
            else:
                print(f"[{key}] H {width}: {sps.name(key)} disagrees with the plain version "
                      f"beyond the kernel's bound (max abs err {float(lib_err.max()):.3e}):"
                      f" no library time", flush=True)
            _k5_plans(key, width, [functools.partial(call, *a) for a in inputs],
                      lambda o, want=want, bound=bound: _elementwise(
                          o, want, bound, f"{key} at H {width}, forced lanes"), tiles)
        if key == "K5b":
            print(f"[K5b] H {width}: the kernel {rec['ms']:.5f} ms against the K6 + K7 "
                  f"chain's {chains[width]['ms']:.5f} ms", flush=True)
        print(f"[{key}] {label.split(',')[0]}: {100 * rec['bound'][0] / rec['ms']:.1f}% "
              f"of its bound, {rec['ms'] / floor:.2f}x the launch floor {floor:.5f} ms",
              flush=True)
        if key == "K6":
            _k6_plans(tiles, width, xs, lambda got, want=want, bound=bound: _elementwise(
                got, want, bound, f"K6 at width {width}, forced plan"))
    # per kernel: the sums over one forward + backward of the generic stack
    total = {}
    for key, calls in GEN_CALLS.items():
        recs = [(out[(key, w)], c) for w, c in calls.items()]
        lib = [r["lib"] for r, _ in recs]
        total[key] = dict(
            err=max(r["err"] for r, _ in recs),
            **{f: sum(r[f] * c for r, c in recs) for f in ("ms", "eager", "plain")},
            lib=None if None in lib else sum(r["lib"] * c for r, c in recs),
            bound=(sum(r["bound"][0] * c for r, c in recs), recs[0][0]["bound"][1]))
    chain = sum(c["ms"] for c in chains.values())
    print(f"[segment] K5's backward per forward + backward (H 4 and H 1): "
          f"the kernel {total['K5b']['ms']:.5f} ms, as a K6 and a K7 {chain:.5f} ms "
          f"(graph replays)", flush=True)
    k5, k5b = _segment_shuffled(tiles, gen, dev)
    total["K5"]["err"] = max(total["K5"]["err"], k5)
    total["K5b"]["err"] = max(total["K5b"]["err"], k5b)
    return total


def _edge_attr(seed, n2, dev):
    """[E + n2, 2] edge features [v, |v|], the self-loop rows filled with the
    column means of the real edges (as ``tiled_graph_from_seed`` fills its
    one column)."""
    v = torch.as_tensor(seed.data, dtype=torch.float32, device=dev)
    feats = torch.stack([v, v.abs()], dim=1)
    return torch.cat([feats, feats.mean(0, keepdim=True).expand(n2, 2)])


def _generic_stack(ps, x, graph, attr_t, n2):
    h = torch.relu(gat.gatv2_apply_tiled(ps[0], x, graph.tiles, graph.src_t,
                                         graph.dst_t, attr_t, n2, GEN_HEADS, GEN_HIDDEN,
                                         srcwin=graph.srcwin))
    return gat.gatv2_apply_tiled(ps[1], h, graph.tiles, graph.src_t, graph.dst_t,
                                 attr_t, n2, 1, GEN_HIDDEN, srcwin=graph.srcwin)


def _per_edge_stack(ps, seed_dev, ea, n2):
    x = torch.ones((n2, 1), dtype=ea.dtype, device=ea.device)
    h = torch.relu(gat.gatv2_apply(ps[0], x, seed_dev.row, seed_dev.col, ea, n2,
                                   GEN_HEADS, GEN_HIDDEN))
    return gat.gatv2_apply(ps[1], h, seed_dev.row, seed_dev.col, ea, n2, 1, GEN_HIDDEN)


def _grads(fn, ps, c):
    leaves = [x for p in ps for x in p]
    out = fn(ps)
    return out.detach(), torch.autograd.grad((out * c).sum(), leaves)


def _hold_grads(got, want, what):
    """Each layer's gradients within the repo's bound times its largest."""
    worst = 0.0
    for layer in (slice(0, 6), slice(6, 12)):
        scale = max(float(w.abs().max()) for w in want[layer])
        for a, b in zip(got[layer], want[layer]):
            a, b = a.double().cpu(), b.double().cpu()
            err = float((a - b).abs().max())
            worst = max(worst, err / scale)
            if not torch.allclose(a, b, rtol=GEN_GRAD_RTOL, atol=GEN_GRAD_ATOL * scale):
                fail(f"[gat-generic] gradient vs {what}: max abs err {err:.3e} (layer "
                     f"scale {scale:.3e})")
    return worst


def phase_gat_generic(seed, graph, dev):
    """The two-layer generic GATv2 stack (edge_dim 2) at the forward
    policy's widths on orsirr_like150's tile graph: launch counters to 0,
    a forward and the gradient of sum(c·out), counters read; outputs and
    gradients against the per-edge path on the card and in float64 on the
    CPU."""
    n2 = graph.tiles.num_nodes
    attr = _edge_attr(seed, n2, dev)
    attr_t = seg.to_tiles(graph.tiles, attr)
    gen = torch.Generator().manual_seed(2024)
    ps = [gat.gatv2_init(gen, 1, GEN_HIDDEN, GEN_HEADS, edge_dim=GEN_EDGE_DIM),
          gat.gatv2_init(gen, GEN_HEADS * GEN_HIDDEN, GEN_HIDDEN, 1, edge_dim=GEN_EDGE_DIM)]
    ps = [gat.GATv2Params(*(x.to(dev).requires_grad_(True) for x in p)) for p in ps]
    c = torch.randn((n2, GEN_HIDDEN), generator=gen).to(dev)
    tiled = lambda q: _generic_stack(q, graph.x, graph, attr_t, n2)
    for fn in SEG_COUNTERS.values():
        fn.launches = 0
    out, got = _grads(tiled, ps, c)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in SEG_COUNTERS.items()}
    if min(launches.values()) == 0:
        fail(f"[gat-generic] a kernel of the path did not launch: {launches}")
    expected = {"K3": 1, "K4": 1, **{k: sum(c.values()) for k, c in GEN_CALLS.items()}}
    if launches != expected:
        fail(f"[gat-generic] launches {launches}, expected {expected} (GEN_CALLS)")
    if not (out.shape == (n2, GEN_HIDDEN) and bool(torch.isfinite(out).all())):
        fail("[gat-generic] the stack's output is not finite [n2, hidden]")
    seed_dev = seed.to(dev)
    ea = attr[:seed.nnz]
    want_out, want = _grads(lambda q: _per_edge_stack(q, seed_dev, ea, n2), ps, c)
    if not torch.allclose(out, want_out, **LOGIT_TOL):
        fail(f"[gat-generic] output vs the per-edge path: max abs err "
             f"{float((out - want_out).abs().max()):.3e}")
    worst_edge = _hold_grads(got, want, "the per-edge path")
    ps64 = [gat.GATv2Params(*(x.detach().double().cpu().requires_grad_(True) for x in p))
            for p in ps]
    seed_cpu = seed.to("cpu")
    out64, want64 = _grads(lambda q: _per_edge_stack(q, seed_cpu, ea.double().cpu(), n2),
                           ps64, c.double().cpu())
    err64 = float((out.double().cpu() - out64).abs().max())
    if not torch.allclose(out.double().cpu(), out64, **LOGIT_TOL):
        fail(f"[gat-generic] output vs float64 on the CPU: max abs err {err64:.3e}")
    worst64 = _hold_grads(got, want64, "float64 on the CPU")

    def fwd():
        with torch.no_grad():
            tiled(ps)

    fwd_ms = cuda_ms(fwd, 10)
    step_ms = cuda_ms(lambda: _grads(tiled, ps, c), 10)
    print(f"[gat-generic] {MATRIX}: two GATv2 layers, edge_dim {GEN_EDGE_DIM} ([v, |v|], "
          f"self-loops the column means), heads {GEN_HEADS} x {GEN_HIDDEN} then 1 x "
          f"{GEN_HIDDEN}, on the uniform layout (T {graph.tiles.tiles}, S "
          f"{graph.tiles.slots}): output max abs err vs the per-edge path "
          f"{float((out - want_out).abs().max()):.3e}, vs float64 {err64:.3e}; "
          f"gradients max abs err / layer scale {worst_edge:.3e} and {worst64:.3e}; "
          f"{fwd_ms:.4f} ms per forward, {step_ms:.4f} ms per forward + backward "
          f"(eager, CUDA events); launches in one forward + backward {launches}",
          flush=True)
    wall, busy, kernels, _ = _profiled(lambda: _grads(tiled, ps, c), GEN_PROFILED)
    print(f"[gat-generic] torch.profiler over {GEN_PROFILED} forward + backward: "
          f"{wall:.4f} ms wall, device busy {busy:.4f} ms (idle share "
          f"{100 * (1 - busy / wall):.1f}%) per forward + backward; device "
          f"operations with the most ms per forward + backward: {kernels}", flush=True)
    return launches


def _bell_blocks(m, n, blockshape, rng):
    """BELL_DENSITY of the (bm, bn) blocks of an m x n matrix, chosen by
    ``rng`` and filled with standard normals: (block row, block column,
    blocks), row-major."""
    bm, bn = blockshape
    nbc = n // bn
    total = (m // bm) * nbc
    pick = np.sort(rng.choice(total, size=int(round(BELL_DENSITY * total)), replace=False))
    blocks = rng.standard_normal((len(pick), bm, bn), dtype=np.float32)
    return pick // nbc, pick % nbc, blocks


def _bell_direct(m, n, brow, bcol, blocks):
    """The BELL of row-major sorted blocks, built without CSR (what
    ``csr_to_bell`` gives for the same matrix)."""
    nbr = m // blocks.shape[1]
    per_row = np.bincount(brow, minlength=nbr)
    W = max(1, int(per_row.max()))
    slot = np.arange(len(brow)) - np.repeat(np.cumsum(per_row) - per_row, per_row)
    data = np.zeros((nbr, W) + blocks.shape[1:], np.float32)
    cols = np.zeros((nbr, W), np.int32)
    data[brow, slot] = blocks
    cols[brow, slot] = bcol
    return bsr.BELL(data=data, bcols=cols, shape=(m, n), nnz=int(blocks.size))


def _bell_irregular(a, extra, rng):
    """``a`` with ``extra`` explicit all-zero blocks added to every block
    row (random block columns) and each row's slots shuffled, padding
    included: a BELL ``csr_to_bell`` never gives, for K17's chunk skip."""
    nbr, W = a.bcols.shape
    W2 = W + extra
    data = np.zeros((nbr, W2) + a.data.shape[2:], np.float32)
    cols = rng.integers(0, a.shape[1] // a.data.shape[3], (nbr, W2)).astype(np.int32)
    perm = np.argsort(rng.random((nbr, W2)), axis=1)[:, :W]
    rows = np.arange(nbr)[:, None]
    data[rows, perm] = a.data
    cols[rows, perm] = a.bcols
    return bsr.BELL(data=data, bcols=cols, shape=a.shape, nnz=a.nnz)


def _bell_scipy(a, block_rows):
    """scipy float64 CSR of the first ``block_rows`` block rows of a BELL on
    the card (its stored values, bf16 ones exactly)."""
    import scipy.sparse as sp

    data = a.data[:block_rows].double().cpu().numpy()
    cols = a.bcols[:block_rows].cpu().numpy()
    nbr, W, bm, bn = data.shape
    r, w, i, j = np.nonzero(data)
    return sp.csr_matrix((data[r, w, i, j], (r * bm + i, cols[r, w] * bn + j)),
                         shape=(nbr * bm, a.shape[1]))


def _bell_csr(a):
    """torch.sparse CSR of a BELL on its device (the library yardstick)."""
    nbr, W, bm, bn = a.data.shape
    r, w, i, j = a.data.nonzero(as_tuple=True)
    idx = torch.stack([r * bm + i, a.bcols[r, w].long() * bn + j])
    return torch.sparse_coo_tensor(idx, a.data[r, w, i, j], a.shape,
                                   check_invariants=False).coalesce().to_sparse_csr()


def _bell_tail(a, x, ms):
    """What bounds K17 on the benchmark matrix: its time with only the
    block row of the most real blocks kept (the tensor-core kernel walks a
    row's chunks in one block), and with no real block (the launch, the Y
    writes and, in the CUDA-core kernel, the scan of every padded slot),
    beside the whole."""
    real = a.data.abs().amax(dim=(2, 3)) > 0
    heavy = int(real.sum(dim=1).argmax())
    keep = torch.zeros_like(real[:, 0])
    keep[heavy] = True
    for what, mask in ((f"block row {heavy} alone ({int(real[heavy].sum())} real "
                        f"blocks)", keep), ("no real block", torch.zeros_like(keep))):
        d = a.data * mask[:, None, None, None]
        copies = [(dataclasses.replace(a, data=d.clone()), x.clone()) for _ in range(16)]
        t = graph_ms(_cycle([lambda c=c: bsr.spmm_bell(*c) for c in copies]), 10)
        print(f"[bell] {a.data.dtype} blocks, {x.dtype} X, same W, {what}: kernel {t:.5f} ms "
              f"(the whole matrix {ms:.5f})", flush=True)


def _bf16_ulp(v):
    """One bf16 unit in the last place of each element of ``v`` (0 at 0)."""
    return torch.where(v == 0, torch.zeros_like(v),
                       torch.ldexp(torch.ones_like(v), torch.frexp(v)[1] - 8))


def _bell_bound(want, mag, bf16):
    """K17's elementwise bound against ``want`` (the plain version's output
    or float64 scipy's), ``mag`` = |A|·|X|: the float32 sums' other order,
    SEG_EPS_SUMS·eps32·mag, plus SEG_RTOL·|want| on float32 outputs or one
    bf16 ulp of want on bf16 ones (two float32 sums a few eps32 apart may
    round to neighbouring bf16 values)."""
    return (_bf16_ulp(want) if bf16 else SEG_RTOL * want.abs()) + SEG_EPS_SUMS * EPS32 * mag


def _bell_check(what, y, a, x, block_rows):
    """Hold K17's output ``y`` = A·X against the plain version on the same
    tensors, and against scipy float64 on A's first ``block_rows`` block
    rows (of the values as stored: bf16 blocks and X exactly)."""
    want = bsr.spmm_bell_ref(a, x).float()
    mag = bsr.spmm_bell_ref(dataclasses.replace(a, data=a.data.abs().float()),
                            x.abs().float())
    bf16 = y.dtype == BF16
    err, checked = _elementwise(y.float(), want, _bell_bound(want, mag, bf16), what)
    if bf16:
        checked += (f", {int((y.float() != want).sum())} of {y.numel()} outputs off the "
                    "plain version's bits")
    rows = block_rows * a.data.shape[2]
    ref64 = torch.from_numpy(_bell_scipy(a, block_rows) @ x.double().cpu().numpy())
    bound64 = _bell_bound(ref64, mag[:rows].double().cpu(), bf16)
    worst64 = float(((y[:rows].double().cpu() - ref64).abs()
                     / bound64.clamp_min(1e-30)).max())
    if not worst64 <= 1.0:
        fail(f"[bell] {what} vs scipy float64: {worst64:.2f} of the bound")
    return err, f"{checked}; vs scipy float64 on {rows} rows {100 * worst64:.1f}% of the bound"


def _bell_lib(a, x):
    """The torch.sparse CSR of A's stored values in X's dtype: the one
    PyTorch call (``@ x``) that computes an instance's function (bf16 CSR
    on bf16 X; on float32 X the float32 CSR of the blocks' values, bf16 ones
    widened exactly: cuSPARSE takes no CSR bf16 x float32)."""
    c = _bell_csr(a)
    return torch.sparse_csr_tensor(c.crow_indices(), c.col_indices(),
                                   c.values().to(x.dtype), c.shape)


L2_YARDSTICK_BYTES = 32 << 20   # a buffer that stays in the 50 MB L2


def _l2_rate(dev):
    """An L2 read yardstick: bytes per second of the row sums of a bf16
    buffer of L2_YARDSTICK_BYTES in rows of 4096, replayed back to back
    (graph replay), so every read after the first replay hits L2.  (The
    fastest read of the PyTorch calls tried on the H100: whole sums, float32
    row sums, amax, torch.mv, torch.mm with 8 columns reached 0.8-4.8
    TB/s; it is a floor of the L2's rate, not its peak.)"""
    buf = torch.ones(L2_YARDSTICK_BYTES // 2, device=dev, dtype=BF16).view(-1, 4096)
    ms = graph_ms(lambda: buf.sum(1), 50)
    return L2_YARDSTICK_BYTES / (ms * 1e-3), ms


def _ptxas_entries(pattern):
    """(match, spill line, register line) of each kernel instance whose
    mangled name matches ``pattern`` in this run's ptxas -v output."""
    lines = [ln.strip() for ln in BUILD_LOG]
    for i, line in enumerate(lines):
        m = re.search(pattern, line)
        if m and "Compiling entry" in line:
            yield m, lines[i + 2], lines[i + 3]


def _bell_ptxas():
    """The tensor-core K17's registers and spills per instance (from this
    run's ptxas -v) beside its shape per bm and column tile."""
    found = 0
    for m, spills, regs in _ptxas_entries(
            r"bell_spmm_bf16_kernelILi(\d+)ELi(\d+)ELi(\d+)ELb(\d)E"):
        bm, cw, mt, tma = map(int, m.groups())
        cfg = bsr.kernel_config(bm, 64 * cw * mt)
        found += 1
        print(f"[bell] ptxas bm {bm}, Kc {64 * cw * mt} ({cw} consumer warpgroups x {mt} "
              f"m64 tiles), X {'by TMA' if tma else 'element by element'}: {spills}; "
              f"{regs}; {cfg['threads']} threads, {cfg['stages']} stages, "
              f"{cfg['smem']} B dynamic shared memory, setmaxnreg {cfg['producer_regs']} / "
              f"{cfg['consumer_regs']}", flush=True)
        if "0 bytes spill stores, 0 bytes spill loads" not in spills:
            fail(f"[bell] the tensor-core K17 spills at bm {bm}, Kc {64 * cw * mt}")
    # ptxas's note where it makes a kernel's wgmmas synchronous (it cost the
    # kernel a third of its time at 4096², (8,128))
    serial = [ln for ln in BUILD_LOG if "bell_spmm_bf16_kernel" in ln and "serialized" in ln]
    if serial:
        fail(f"[bell] ptxas serializes the tensor-core K17's wgmmas: {serial[0]}")
    if not found:
        print("[bell] ptxas: bsr_bf16 was not built in this run (a kept library)", flush=True)


def phase_bell(dev):
    """K17 through ``spmm_bell`` at docs/BENCH.md:108-125's configuration
    (4096², 2% of the (8,128) blocks, K = 256), at blockshapes (32,128)
    and (128,128), and on 65,536² matrices of the same density at (8,128)
    and (128,128) (JAX would stream there, ``_resident_bk`` is None), each
    in every instance of ``BELL_TYPES``: against ``spmm_bell_ref`` and
    scipy in float64; ``spmv_bell`` and the irregular BELL once per
    instance at 4096².  Returns the records by (instance, case) and each
    instance's launches on the path."""
    from gflownet_spai_tpu_torch.sparse import coo_to_csr
    from gflownet_spai_tpu_torch.sparse.types import COO

    _bell_ptxas()
    l2_rate, l2_ms = _l2_rate(dev)
    print(f"[bell] L2 read yardstick: row sums (dim 1, rows of 4096) of {L2_YARDSTICK_BYTES >> 20}"
          f" MB bf16 {l2_ms:.5f} ms, {l2_rate / 1e12:.3f} TB/s (graph replay)", flush=True)
    rng = np.random.default_rng(17)
    gen = torch.Generator(device=dev).manual_seed(17)
    cases = []
    for m, bs in BELL_CASES:
        t0 = time.perf_counter()
        brow, bcol, blocks = _bell_blocks(m, m, bs, rng)
        direct = _bell_direct(m, m, brow, bcol, blocks)
        if m <= 4096:
            # the user path: COO -> CSR -> csr_to_bell, equal to the direct build
            bm, bn = bs
            nb, ii, jj = np.nonzero(np.ones_like(blocks, dtype=bool))
            coo = COO(row=(brow[nb] * bm + ii).astype(np.int32),
                      col=(bcol[nb] * bn + jj).astype(np.int32),
                      data=blocks[nb, ii, jj], shape=(m, m))
            host = bsr.csr_to_bell(coo_to_csr(coo), bs)
            if not (np.array_equal(host.data, direct.data)
                    and np.array_equal(host.bcols, direct.bcols)):
                fail(f"[bell] csr_to_bell differs from the direct block build at {m}, {bs}")
        else:
            host = direct
        if not cases:
            first = host
        cases.append((m, bs, host.to(dev), time.perf_counter() - t0))
    # the first case with its slots shuffled and explicit zero blocks added
    irr_host = _bell_irregular(first, BELL_ZERO_SLOTS, rng)
    irr = irr_host.to(dev)
    xs = [torch.randn((m, BELL_K), generator=gen, device=dev) for m, *_ in cases]
    v = torch.randn(cases[0][0], generator=gen, device=dev)
    # every instance's inputs: the float32 matrices and X rounded to bf16
    # where the instance takes bf16
    ins = {name: ([(dataclasses.replace(a, data=a.data.to(bt)), x.to(xt))
                   for (_, _, a, _), x in zip(cases, xs)],
                  dataclasses.replace(irr, data=irr.data.to(bt)), v.to(xt))
           for name, (bt, xt, _) in BELL_TYPES.items()}
    # the path: counters to 0, the user entries once per case and instance,
    # counters read
    counts = bsr.spmm_bell.type_launches
    bsr.spmm_bell.launches = 0
    for name in counts:
        counts[name] = 0
    outs = {}
    for name, (inputs, irr_i, v_i) in ins.items():
        outs[name] = ([bsr.spmm_bell(a, x) for a, x in inputs],
                      bsr.spmm_bell(irr_i, inputs[0][1]), bsr.spmv_bell(inputs[0][0], v_i))
    torch.cuda.synchronize()
    launches = dict(counts)
    want_each = len(cases) + 2
    if bsr.spmm_bell.launches != len(ins) * want_each or \
            any(launches[name] != want_each for name in ins):
        fail(f"[bell] spmm_bell / spmv_bell launched K17 {launches} (total "
             f"{bsr.spmm_bell.launches}), not {want_each} per instance")
    errs = {}
    for name, (inputs, irr_i, v_i) in ins.items():
        ys, y_irr, yv = outs[name]
        a0, x0 = inputs[0]
        nbr0 = a0.data.shape[0]
        err_v, checked_v = _bell_check(f"spmv_bell ({name})", yv[:, None], a0, v_i[:, None],
                                       nbr0)
        err_i, checked_i = _bell_check(f"K17 on the irregular BELL ({name})", y_irr, irr_i, x0,
                                       irr_i.data.shape[0])
        errs[name] = [err_v, err_i]
        print(f"[bell] {name}: spmv_bell at {cases[0][0]}², blocks {cases[0][1]}: "
              f"{checked_v}; the irregular {cases[0][0]}² (slots shuffled, "
              f"{BELL_ZERO_SLOTS} explicit zero blocks per row, W {irr_host.width}): "
              f"{checked_i}", flush=True)
    recs = {}
    for k, (m, bs, a, build_s) in enumerate(cases):
        nbr, W, bm, bn = a.data.shape
        nonzero = a.data.abs().amax(dim=(2, 3)) > 0
        real = int(nonzero.sum())
        ncols = int(torch.unique(a.bcols[nonzero]).numel())
        chunks = int((a.data.reshape(nbr, W, bm, bn // 32, 32).abs().amax(dim=(2, 4)) > 0)
                     .sum())
        block_rows = nbr if m <= 4096 else BELL_SCIPY_ROWS // bm
        regime = bsr._resident_bk(a, BELL_K)
        for name, (bt, xt, rate) in BELL_TYPES.items():
            aa, x = ins[name][0][k]
            y = outs[name][0][k]
            err, checked = _bell_check(f"K17 ({name}) at {m}, {bs}", y, aa, x, block_rows)
            errs[name].append(err)
            if not torch.equal(bsr.spmm_bell(aa, x), y):
                fail(f"[bell] K17 ({name}) at {m}, {bs}: a second launch gave other bits")
            checked += "; a second launch gives the same bits"
            if name == "bf16 blocks, float32 X":
                if not torch.equal(y, bsr.spmm_bell(
                        dataclasses.replace(aa, data=aa.data.float()), x)):
                    fail(f"[bell] K17 ({name}) at {m}, {bs}: not the float32 instance's "
                         "bits on the widened blocks")
                checked += "; the float32 instance's bits on the widened blocks"
            eb, ex, ey = aa.data.element_size(), x.element_size(), y.element_size()
            nbytes = eb * real * bm * bn + 4 * nbr * W + ex * ncols * bn * BELL_K \
                + ey * m * BELL_K
            ops = 2 * real * bm * bn * BELL_K
            copies = [(aa, x)] + [(dataclasses.replace(aa, data=aa.data.clone()), x.clone())
                                  for _ in range(_copies(nbytes) - 1)]
            csrs = [_bell_lib(*c) for c in copies]
            if name == "float32":
                want = bsr.spmm_bell_ref(aa, x)
                mag = bsr.spmm_bell_ref(dataclasses.replace(aa, data=aa.data.abs()), x.abs())
                _elementwise(csrs[0] @ x, want, SEG_RTOL * want.abs() + SEG_EPS_SUMS * EPS32
                             * mag, "the torch.sparse CSR yardstick")
                lib_ok, lib_name = True, "torch.sparse CSR A@X"
            else:
                lib_ok, lib_name = _bf16_lib(lambda: csrs[0] @ x, bsr.spmm_bell_ref(aa, x),
                                             xt, "A@X")
                if not lib_ok:
                    print(f"[bell] {name} at {m}, {bs}: library {lib_name}", flush=True)
            # a library call that runs but is off is timed all the same (printed)
            lib_runs = lib_ok or "refuses" not in lib_name
            label = (f"{name}, {m} x {m}, blocks {bs}, {real} of {(m // bm) * (m // bn)} "
                     f"stored (W {W}), K {BELL_K}, JAX regime "
                     + (f"X-resident (bk {regime})" if regime else "streamed")
                     + f"; set-up {build_s:.1f} s")
            rec = _timed("K17", label, checked, err,
                         lambda i: (lambda: bsr.spmm_bell(*copies[i])),
                         lambda: bsr.spmm_bell_ref(aa, x), nbytes, ops,
                         (lambda i: (lambda: csrs[i] @ copies[i][1])) if lib_runs else None,
                         lib_name, reps=10, rate=rate)
            if not lib_ok:
                rec["lib"] = None
            recs[(name, m, bs)] = rec
            f32 = recs[("float32", m, bs)]["ms"]
            l2 = chunks * 32 * BELL_K * ex
            print(f"[bell] {name}, {m}², blocks {bs}: {real} real of {nbr * W} stored slots "
                  f"({100 * real / (nbr * W):.1f}%); kernel / library "
                  + (f"{rec['ms'] / rec['lib']:.3f}" if rec["lib"] else "none")
                  + f", kernel / bound {rec['ms'] / rec['bound'][0]:.2f}; X rows staged "
                  f"from L2 {l2 / 1e9:.4f} GB ({chunks} nonzero [{bm}, 32] chunks x 32 rows "
                  f"x {BELL_K} columns x {ex} B); the float32 instance {f32:.5f} ms, "
                  f"this / float32 {rec['ms'] / f32:.3f}", flush=True)
            if name == "bf16 blocks, bf16 X":
                lst = graph_ms(lambda: bsr._chunk_list(aa.data), 5)
                kc = bsr._col_tile(nbr, BELL_K, True)
                print(f"[bell] {name}, {m}², blocks {bs}: chunk list build {lst:.5f} ms "
                      f"(graph replay; once per BELL), column tile Kc {kc} ({nbr} block rows "
                      f"x {-(-BELL_K // kc)} tiles)", flush=True)
                if bm == 8:
                    floor = l2 / l2_rate * 1e3
                    print(f"[bell] {name}, {m}², blocks {bs}: L2 floor {floor:.5f} ms "
                          f"({l2 / 1e9:.4f} GB of X / the yardstick's "
                          f"{l2_rate / 1e12:.3f} TB/s), kernel / L2 floor "
                          f"{rec['ms'] / floor:.3f}; the kernel reads X from L2 at "
                          f"{l2 / rec['ms'] / 1e9:.3f} TB/s", flush=True)
            if name == "bf16 blocks, bf16 X" and m <= 4096:
                dense = aa.todense()
                print(f"[bell] {name}, {m}², blocks {bs}: dense bf16 torch.matmul of "
                      f"todense() (cuBLAS) {graph_ms(lambda: dense @ x, 10):.5f} ms (graph "
                      f"replay, L2-warm), not a yardstick of the table", flush=True)
                del dense
            del copies, csrs
            if name in ("float32", "bf16 blocks, bf16 X") and k == 0:
                _bell_tail(aa, x, rec["ms"])
    for name in BELL_TYPES:
        recs[(name, "err")] = max(errs[name])
    return recs, launches


# ---------------------------------------------------------------------------
# [train-default], [dia-env], [rowblock]: the DIA and rowblock reward envs
# ---------------------------------------------------------------------------

DEFAULT_EPOCHS = 20         # the train CLI with every other argument at its default
DIA_MATRIX = "convdiff100000"   # ILU(0) seed: 3 diagonals, 299,998 edges (tiled)
# config 4 (examples/config4_orsirr.py): the SPAI seed, the identity
# baseline, window order; t_cap 0 as the recipe runs it
CONFIG4 = dict(matrix=MATRIX, seed_method="spai", reward_baseline="identity",
               loss="subtb", backward="linear", replay_size=32, replay_samples=4,
               replay_prioritized=1.0, alpha_fixed=0.98, lr=2e-3, plateau_patience=0,
               rowblock_order="window", batch_size=16, log_every=1)
ENV_STEPS = 6               # train steps of [dia-env] and [rowblock] (the first warms up)
ENV_PROFILED = 3            # of them again under torch.profiler
ENV_TIMED = (16, 256)       # reward batches timed against the pair env
# residual norms of the rowblock plans against float64 scipy: the JAX
# oracles' tolerances (tests/test_env.py rowblock against pair 5e-5,
# tests/test_sparse.py gram 2e-3, bf16 storage 2e-2)
RB_RTOL = {("float32", "none"): 5e-5, ("float32", "gram"): 2e-3,
           ("bfloat16", "none"): 2e-2, ("bfloat16", "gram"): 2e-2}
# rewards against float64 (tests/test_env.py rowblock against pair)
RB_REWARD_TOL = dict(rtol=5e-4, atol=5e-3)


def phase_train_default():
    """``python -m gflownet_spai_tpu_torch.train`` with its defaults (the
    DIA env on LF10_like) in a subprocess on the card, then the validate
    CLI from its checkpoint."""
    repo = str(Path(__file__).resolve().parent)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_default_") as tmp:
        run = Path(tmp) / "run"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "gflownet_spai_tpu_torch.train", "--epochs",
             str(DEFAULT_EPOCHS), "--out-dir", str(run)],
            capture_output=True, text=True, timeout=600, cwd=repo)
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            fail(f"the default train CLI exited {proc.returncode}: "
                 f"{(proc.stdout + proc.stderr)[-2000:]}")
        recs = [json.loads(x) for x in (run / "metrics.jsonl").read_text().splitlines()]
        if [r["epoch"] for r in recs] != list(range(DEFAULT_EPOCHS)) \
                or not all(np.isfinite(r["loss"]) for r in recs):
            fail(f"the default train CLI's metrics: {recs[:3]}")
        meta = json.loads((run / "checkpoint" / "enum.json").read_text())
        if "matrix='LF10_like'" not in proc.stdout or meta["order"] != "dia":
            fail(f"the default train CLI did not run the DIA env on LF10_like: {meta}")
        t1 = time.perf_counter()
        val = subprocess.run(
            [sys.executable, "-m", "gflownet_spai_tpu_torch.validate", "--from-checkpoint",
             str(run), "--seed-method", "ilu0", "--loss", "tb", "--backward", "lstm",
             "--replay-size", "0", "--out-dir", str(Path(tmp) / "val")],
            capture_output=True, text=True, timeout=600, cwd=repo)
        vsecs = time.perf_counter() - t1
        path = Path(tmp) / "val" / "validation.json"
        if val.returncode not in (0, 1) or not path.exists():
            fail(f"the validate CLI on the default run exited {val.returncode}: "
                 f"{(val.stdout + val.stderr)[-2000:]}")
        report = json.loads(path.read_text())
    rows = ("none", "ilu", "sampled_spai", "classic_spai")
    for row in rows:
        if row not in report or not np.isfinite(report[row]["true_residual"]):
            fail(f"validation.json of the default run lacks a finite row {row}")
    verdict = [ln for ln in val.stdout.splitlines() if ln.startswith("sampled SPAI")]
    print(f"[train-default] train --epochs {DEFAULT_EPOCHS}: exit 0 in {secs:.1f} s "
          f"(process start included), DIA env (enum order {meta['order']}, "
          f"{meta['num_edges']} edges), loss epoch 0 {recs[0]['loss']:.4f} -> "
          f"{recs[-1]['loss']:.4f}, mean length {recs[-1]['mean_len']:.1f}; validate "
          f"--from-checkpoint: exit {val.returncode} in {vsecs:.1f} s; "
          + "; ".join(f"{r} {report[r]['iterations']} it" for r in rows)
          + f"; verdict: {verdict[-1] if verdict else '?'}", flush=True)


def _host_residuals(edges, a, keep):
    """‖M·A − I‖_F in float64 with scipy, M the edges' values masked by
    each row of ``keep`` (independent of the device plans)."""
    import scipy.sparse as sp

    am = sp.csr_matrix((a.data.astype(np.float64), (a.row, a.col)), shape=a.shape)
    eye = sp.eye(a.shape[0], format="csr")
    vals = edges.data.astype(np.float64)
    out = []
    for k in keep:
        m = sp.csr_matrix((vals * k, (edges.row, edges.col)), shape=a.shape)
        out.append(float(np.sqrt(np.sum((m @ am - eye).data ** 2))))
    return np.array(out)


def _host_rewards(res, keep, env, alpha):
    comp = 2.0 * keep.sum(1) * env.n / env.baseline_flops
    return 1000.0 * (alpha * (1 - res / float(env.baseline_residual))
                     + (1 - alpha) * (1 - comp))


def _sampled(env, graph, mcfg, params, dev, tag):
    """256 sampled trajectories, their rewards and a second call's bits."""
    gen = torch.Generator(device=dev).manual_seed(13)
    with torch.no_grad():
        out = gfn.sample(params, env, graph, mcfg, gen, BATCH)
        again = gfn._batched_rewards(env, out.rollout.actions, out.alpha)
    if not torch.isfinite(out.rewards).all() or out.rewards.shape != (BATCH,):
        fail(f"[{tag}] non-finite or misshapen sampled rewards")
    if not torch.equal(out.rewards, again):
        fail(f"[{tag}] a second reward call gave other bits")
    keep = spai.keep_mask_from_actions(out.rollout.actions, env.num_edges)
    return out, keep


def _reward_times(tag, cases, alpha):
    """Eager (host clock, CUDA events) and device (graph replay) ms of one
    batched reward call per env and batch size, on the same actions."""
    parts = []
    for b in ENV_TIMED:
        for name, env, acts in cases:
            fn = lambda: gfn._batched_rewards(env, acts[:b], alpha)
            parts.append(f"{name} batch {b}: {cuda_ms(fn, 10):.4f} eager, "
                         f"{graph_ms(fn, 5):.4f} device")
    print(f"[{tag}] reward ms per call: " + "; ".join(parts), flush=True)


def _env_steps(tag, cfg, env, graph, mcfg, opt, state):
    """ENV_STEPS train steps with K1-K4 counted from 0, then ENV_PROFILED
    under torch.profiler."""
    n_b = len(graph.gat_buckets)
    step = make_train_step(cfg, env, graph, mcfg, opt)
    for fn in COUNTERS.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    walls, losses = [], []
    for _ in range(ENV_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state)
        losses.append(float(m["loss"]))
        walls.append((time.perf_counter() - t0) * 1e3)
    launches = {k: fn.launches for k, fn in COUNTERS.items()}
    peak = torch.cuda.max_memory_allocated()
    per_step = {"K1": 2 * n_b, "K2": 2 * n_b, "K3": 1, "K4": 1}
    if launches != {k: v * ENV_STEPS for k, v in per_step.items()}:
        fail(f"[{tag}] launch counts {launches} over {ENV_STEPS} train steps: "
             f"expected {per_step} per step")
    if not np.isfinite(losses).all():
        fail(f"[{tag}] a non-finite loss: {losses}")
    box = [state]

    def run():
        box[0], _ = step(box[0])

    wall_ms, busy_ms, kernels, _ = _profiled(run, ENV_PROFILED)
    idle = 100 * (1 - busy_ms / wall_ms)
    print(f"[{tag}] {ENV_STEPS} train steps of batch {cfg.batch_size} + "
          f"{cfg.replay_samples} replayed, t_cap {mcfg.t_cap}: steady ms/step "
          f"{np.mean(walls[1:]):.3f} (steps {', '.join(f'{w:.3f}' for w in walls)}); "
          f"peak memory {peak / 2**20:.1f} MiB; launches {launches} ({n_b} buckets); "
          f"losses {', '.join(f'{x:.4f}' for x in losses)}", flush=True)
    print(f"[{tag}] {ENV_PROFILED} steps under torch.profiler: {wall_ms:.3f} ms/step "
          f"wall, device busy {busy_ms:.3f} ms/step (idle share {idle:.1f}%); "
          f"kernels with the most device ms/step: {kernels}", flush=True)
    return {"step_ms": float(np.mean(walls[1:])), "idle": idle, "launches": launches}


def phase_dia_env(dev):
    """The DIA env at scale: convdiff100000's ILU(0) seed through
    ``env_format="auto"``."""
    from gflownet_spai_tpu_torch.env import spai_dia

    cfg = TrainConfig(**{**TRAIN, "matrix": DIA_MATRIX, "env_format": "auto"})
    t0 = time.perf_counter()
    a, seed, env, graph, mcfg, opt, state = setup(cfg)
    setup_s = time.perf_counter() - t0
    if not isinstance(env, spai_dia.SpaiDiaEnv):
        fail(f"[dia-env] auto did not pick the DIA env for {DIA_MATRIX}")
    if not isinstance(graph, pol.TiledGraphInputs) or not graph.gat_buckets:
        fail("[dia-env] the policy graph is not the tiled layout")
    out, keep = _sampled(env, graph, mcfg, state.params, dev, "dia-env")
    keep_h = keep.cpu().numpy()
    alpha = float(out.alpha)
    t0 = time.perf_counter()
    want = _host_rewards(_host_residuals(spai_dia.edge_coo(env), a, keep_h), keep_h,
                         env, alpha)
    host_s = time.perf_counter() - t0
    got = out.rewards.cpu().numpy()
    err = np.abs(got - want) / np.maximum(np.abs(want), 1.0)
    if not err.max() <= REWARD_RTOL:
        fail(f"[dia-env] rewards against float64 scipy: worst {err.max():.3e} "
             f"> {REWARD_RTOL} relative")
    # the pair env on the same edge set, the actions mapped to its ids
    pair = spai.make_env(seed, original=a, baseline=cfg.reward_baseline, device=dev)
    ec, n = spai_dia.edge_coo(env), a.shape[1]
    k_seed = seed.row.astype(np.int64) * n + seed.col
    order = np.argsort(k_seed)
    lut = np.append(order[np.searchsorted(k_seed[order],
                                          ec.row.astype(np.int64) * n + ec.col)],
                    env.num_edges)
    acts = out.rollout.actions
    lut_t = torch.as_tensor(lut, device=dev)
    p_acts = torch.where(acts >= 0, lut_t[acts.clamp_min(0)], acts)
    p_r = gfn._batched_rewards(pair, p_acts, out.alpha)
    np.testing.assert_allclose(p_r.cpu().numpy(), got, rtol=1e-4, atol=1e-2)
    print(f"[dia-env] {DIA_MATRIX}: n {a.shape[0]}, seed edges {env.num_edges} on "
          f"diagonals {env.seed.offsets}, setup {setup_s:.1f} s on the host; {BATCH} "
          f"sampled rewards against float64 scipy: worst {err.max():.3e} relative "
          f"(host check {host_s:.1f} s), reward mean {got.mean():.4f}, mean length "
          f"{float(out.rollout.lengths.float().mean()):.1f}; the pair env on the same "
          f"actions within 1e-4; a second call gives the same bits", flush=True)
    _reward_times("dia-env", (("DIA", env, acts), ("pair", pair, p_acts)), out.alpha)
    del pair, p_r
    return _env_steps("dia-env", cfg, env, graph, mcfg, opt, state)


def phase_rowblock(dev):
    """The rowblock env at config 4: orsirr_like150's SPAI seed, window
    order; every plan variant's residuals against float64 scipy."""
    from gflownet_spai_tpu_torch.sparse import rowblock as rbm

    cfg = TrainConfig(**CONFIG4, num_epochs=ENV_STEPS)
    t0 = time.perf_counter()
    a, seed, env, graph, mcfg, opt, state = setup(cfg)
    setup_s = time.perf_counter() - t0
    if env.rb is None or env.rb.edge_perm is None:
        fail("[rowblock] config 4 did not build the window-order rowblock env")
    if not isinstance(graph, pol.TiledGraphInputs) or not graph.gat_buckets:
        fail("[rowblock] the policy graph is not the tiled layout")
    perm = env.rb.edge_perm.cpu().numpy()
    inv = np.argsort(perm)
    s_seed = dataclasses.replace(seed, row=seed.row[inv], col=seed.col[inv],
                                 data=seed.data[inv])       # the sorted seed
    t0 = time.perf_counter()
    rbm.build_rowblock_plan(s_seed, a, order="window", device=dev)
    plan_s = time.perf_counter() - t0
    out, keep = _sampled(env, graph, mcfg, state.params, dev, "rowblock")
    keep_h = keep.cpu().numpy()
    alpha = float(out.alpha)
    t0 = time.perf_counter()
    res64 = _host_residuals(seed, a, keep_h)
    host_s = time.perf_counter() - t0
    want = _host_rewards(res64, keep_h, env, alpha)
    got = out.rewards.cpu().numpy()
    if not np.allclose(got, want, **RB_REWARD_TOL):
        fail(f"[rowblock] rewards against float64 scipy: max abs err "
             f"{np.abs(got - want).max():.3e}")
    keep_s = torch.empty_like(keep)
    keep_s[:, env.rb.edge_perm] = keep                       # sorted enumeration
    worst = {}
    for dtype, layout, compress in itertools.product(
            (torch.float32, torch.bfloat16), ("cm", "mc"), ("none", "gram")):
        e = spai.make_env(s_seed, original=a, reward_path="rowblock",
                          baseline="identity", rowblock_dtype=dtype,
                          rowblock_layout=layout, rowblock_compress=compress,
                          rowblock_order="sorted", device=dev)
        r = spai.batched_residual_norms(e, keep_s)
        if r.dtype != torch.float32 or not torch.equal(
                r, spai.batched_residual_norms(e, keep_s)):
            fail(f"[rowblock] {dtype} {layout} {compress}: not float32, or a second "
                 "call gave other bits")
        rel = float(np.max(np.abs(r.cpu().numpy() / res64 - 1)))
        tol = RB_RTOL[(str(dtype).split(".")[-1], compress)]
        if not rel <= tol:
            fail(f"[rowblock] {dtype} {layout} {compress}: residuals {rel:.3e} "
                 f"from float64 > {tol}")
        # the rewards: res / baseline enters times 1000·α
        rw = spai.rewards_from_keep(e, keep_s, out.alpha).cpu().numpy()
        bound = 1000 * alpha * tol * res64 / float(e.baseline_residual) \
            + RB_REWARD_TOL["atol"]
        if not (np.abs(rw - want) <= bound).all():
            fail(f"[rowblock] {dtype} {layout} {compress}: rewards against float64 "
                 f"beyond the residual tolerance carried through the reward")
        # bf16 storage multiplies float32 copies of the rounded operands:
        # its time beside float32 storage's is what that choice costs
        ms = graph_ms(lambda: spai.batched_residual_norms(e, keep_s), 5)
        worst[f"{str(dtype).split('.')[-1]} {layout} {compress}"] = (rel, ms)
        del e
    rb = env.rb
    print(f"[rowblock] config 4 on {MATRIX}: n {a.shape[0]}, seed edges "
          f"{env.num_edges}, setup {setup_s:.1f} s on the host, plan build "
          f"{plan_s:.3f} s (window order: {len(rb.gvals)} buckets, "
          f"{rb.padded_slots} padded slots, {rb.npairs} pairs, "
          f"{rb.n_overflow_slots} overflow slots); {BATCH} sampled rewards "
          f"against float64 scipy: max abs err {np.abs(got - want).max():.3e} "
          f"(host check {host_s:.1f} s), mean length "
          f"{float(out.rollout.lengths.float().mean()):.1f}; residuals (and rewards) "
          f"of every sorted-order plan against float64 (worst relative residual, "
          f"same bits on a second call; device ms per call of {BATCH}): "
          + ", ".join(f"{k} {v:.3e} ({t:.4f} ms)" for k, (v, t) in worst.items()),
          flush=True)
    pair = spai.make_env(s_seed, original=a, baseline="identity", device=dev)
    acts = out.rollout.actions
    lut = torch.as_tensor(np.append(perm, env.num_edges), device=dev)
    p_acts = torch.where(acts >= 0, lut[acts.clamp_min(0)], acts)
    np.testing.assert_allclose(gfn._batched_rewards(pair, p_acts, out.alpha).cpu().numpy(),
                               got, **RB_REWARD_TOL)
    _reward_times("rowblock", (("rowblock", env, acts), ("pair", pair, p_acts)), out.alpha)
    del pair
    return _env_steps("rowblock", cfg, env, graph, mcfg, opt, state), env


# --- bf16 diagonals (dia_astype): the path through the system ----------------

BF16_CG_MAXITER = 5000      # CG with a bf16 preconditioner: convergence is reported
BF16_COUNTERS = {"K8": dia.spmv_dia, "K10": dia.spmv_dia_padded_io,
                 "K11": dia.spmv_dia_pingpong, "K12": dia.spmv_dia_power,
                 "K13": dia.spmv_dia_cheby, "K14": dia.spmv_dia_power_rhs,
                 "K15": dia.spmm_dia, "K16": dia.spmm_dia_t_padded}


def phase_dia_bf16(dev, pois):
    """The bf16-diagonal path with every count from 0: the ops entry points
    on ``dia_astype(poisson1024, bf16)``, then its bf16 copy under
    ``jacobi_sweeps_op``, ``chebyshev_op``, CG and ``jacobi_multirhs``
    (their kernels were held and timed in [dia] and [dia-multi]).
    ``pois`` is [poisson]'s report of the float32 preconditioners' CG."""
    from gflownet_spai_tpu_torch.solvers import (cg, chebyshev_coeffs, chebyshev_op,
                                                 estimate_lmax, jacobi_multirhs,
                                                 jacobi_sweeps_op)
    from gflownet_spai_tpu_torch.solvers.stationary import (_pick_power_config,
                                                            jacobi_iteration_matrix)
    from gflownet_spai_tpu_torch.sparse import gallery

    gen = torch.Generator(device=dev).manual_seed(1616)
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev)
    name = f"poisson{POISSON}"
    d = dia.coo_to_dia(gallery.poisson2d(POISSON, dtype=np.float32), device=dev)
    db = dia.dia_astype(d, BF16)
    n = d.n
    m32 = jacobi_iteration_matrix(d)
    mb = dia.dia_astype(m32, BF16)
    lmax = 1.05 * float(estimate_lmax(d, iters=30))
    coeffs = tuple(chebyshev_coeffs(lmax / 30, lmax, 16)[2:4])

    # the polynomial preconditioners on the bf16 copy of poisson1024 and on
    # poisson1024: one apply's device time each (not the path)
    t0 = time.perf_counter()
    lmax_b = 1.05 * float(estimate_lmax(db, iters=30))
    ops = {"jacobi_poly": (jacobi_sweeps_op(db, sweeps=16), jacobi_sweeps_op(d, sweeps=16)),
           "chebyshev": (chebyshev_op(db, lmax=lmax_b, lmin=lmax_b / 30, degree=16),
                         chebyshev_op(d, lmax=lmax, lmin=lmax / 30, degree=16))}
    print(f"[dia-bf16] {name} bf16: lmax {lmax_b:.5f} (float32 {lmax:.5f}); Jacobi k = "
          f"{ops['jacobi_poly'][0].info['k']}, {ops['jacobi_poly'][0].info['sweeps']} sweeps; "
          f"Chebyshev k = {ops['chebyshev'][0].info['k']}, degree "
          f"{ops['chebyshev'][0].info['degree']} ({time.perf_counter() - t0:.2f} s)",
          flush=True)
    v = rnd(n)
    apply_ms = {nm: (graph_ms(lambda: op_b(v), 10), graph_ms(lambda: op_f(v), 10))
                for nm, (op_b, op_f) in ops.items()}

    # --- the path, every count from 0 -----------------------------------------
    for fn in BF16_COUNTERS.values():
        fn.launches = 0
        fn.type_launches = dict.fromkeys(fn.type_launches, 0)
    # the ops entry points on dia_astype(poisson1024, bf16), both vector dtypes
    x32 = rnd(n)
    for vt in BF16_VECS:
        x = x32.to(vt)
        dia.spmv_dia(db, x)
        yq = dia.dia_pad_io(d, x32).to(vt)
        for _ in range(CHAIN):
            yq = dia.spmv_dia_padded_io(db, yq, scale=0.2)
        bufs = [dia.dia_pad_pp(d, x32).to(vt)]
        bufs.append(torch.zeros_like(bufs[0]))
        for _ in range(CHAIN):
            dia.spmv_dia_pingpong(db, bufs[0], bufs[1], scale=0.2)
            bufs.reverse()
        halo = lambda b: b[:(b.shape[0] - d.n_pad) // 2].any() or \
            b[(b.shape[0] + d.n_pad) // 2:].any()
        if any(halo(b) for b in (yq, *bufs)):
            fail(f"[dia-bf16] a K10 halo block not zero, or a K11 one written "
                 f"({_vname(vt)})")
        xq = dia.dia_pad_pp(m32, x32, tr=_pick_power_config(m32, 8, 16)[1]).to(vt)
        dia.spmv_dia_power(mb, None, xq, torch.zeros_like(xq), k=8, add=xq)
        zq = dia.dia_pad_pp(d, x32).to(vt)
        dia.spmv_dia_cheby(db, None, zq, zq.clone(), zq.clone(), torch.zeros_like(zq),
                           torch.zeros_like(zq), coeffs, 2)
        X = rnd(MULTI_K, n).to(vt)
        xr = dia.dia_pad_pp_rhs(m32, X, tr=dia.dia_pp_tile(m32)).to(vt)
        dia.spmv_dia_power_rhs(mb, None, xr, torch.zeros_like(xr), k=1, add=xr)
        dia.spmm_dia(db, X.t().contiguous())
        dia.spmm_dia_t(db, X)
    # the solvers on the bf16 copy of poisson1024
    coo = gallery.poisson2d(POISSON, dtype=np.float64)
    a64 = torch.sparse_coo_tensor(
        torch.as_tensor(np.stack([coo.row, coo.col]).astype(np.int64), device=dev),
        torch.as_tensor(coo.data, device=dev), coo.shape).coalesce().to_sparse_csr()
    b = torch.ones(n, device=dev)
    for opname, (op_b, op_f) in ops.items():
        w_b, w_f = op_b(v), op_f(v)
        rel = float(torch.linalg.vector_norm(w_b - w_f) / torch.linalg.vector_norm(w_f))
        passes = op_b.info.get("sweeps", op_b.info.get("degree"))
        if not (w_b.dtype == torch.float32 and torch.isfinite(w_b).all()
                and rel <= _bf16_bound(passes)):
            fail(f"[dia-bf16] {opname}: the bf16 apply is {rel:.3e} from the float32 one "
                 f"(bound {_bf16_bound(passes):.4f})")
        ms_b, ms_f = apply_ms[opname]
        res = cg(d, b, m_op=op_b, maxiter=BF16_CG_MAXITER, rtol=1e-5)
        true_res = float(torch.linalg.vector_norm(b.double() - a64 @ res.x.double())
                         / torch.linalg.vector_norm(b.double()))
        if not (torch.isfinite(res.x).all() and np.isfinite(true_res)):
            fail(f"[dia-bf16] CG with the bf16 {opname} preconditioner: a non-finite result")
        f32 = pois[opname]
        print(f"[dia-bf16] {opname}: one apply {ms_b:.5f} ms device (float32 {ms_f:.5f} ms, "
              f"this run; bf16 / float32 {ms_b / ms_f:.3f}), {rel:.3e} from the float32 "
              f"apply (2-norm); CG on {name} (A float32, b = ones, rtol 1e-5, maxiter "
              f"{BF16_CG_MAXITER}): {res.iterations} iterations, converged "
              f"{bool(res.converged)}, true residual {true_res:.3e} (float32 preconditioner: "
              f"{f32['iterations']} iterations, true residual {f32['true_residual']:.3e}, "
              "[poisson])", flush=True)
    B = rnd(MULTI_K, n)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    jm = jacobi_multirhs(db, B, iters=100)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    jf = jacobi_multirhs(d, B, iters=100)
    bn = torch.linalg.vector_norm(B, dim=1)
    rb, rf = jm.residual.float() / bn, jf.residual / bn
    if not (jm.iterations == 100 and torch.isfinite(jm.x).all()
            and torch.isfinite(rb).all()):
        fail(f"[dia-bf16] jacobi_multirhs on bf16: {jm.iterations} sweeps, a non-finite "
             "result")
    print(f"[dia-bf16] jacobi_multirhs on {name} bf16, {MULTI_K} systems, 100 sweeps (k = "
          f"1): {1e3 * wall:.3f} ms; relative residuals {float(rb.min()):.4f}-"
          f"{float(rb.max()):.4f} (float32 run {float(rf.min()):.4f}-{float(rf.max()):.4f})",
          flush=True)
    torch.cuda.synchronize()
    counts = {f"{key} {_vname(vt)}": fn.type_launches[dia._TYPE_NAMES[_types(vt)]]
              for key, fn in BF16_COUNTERS.items() for vt in BF16_VECS}
    print(f"[dia-bf16] launches of the bf16 instances on the path: {counts}", flush=True)
    if min(counts.values()) == 0:
        fail(f"[dia-bf16] a bf16 instance did not launch on the path: {counts}")
    return counts


# ---------------------------------------------------------------------------
# [native], [env-single], [grid], [profiling], [launchers]: the host library,
# the single-sample reward API, the grid env, the profiling helpers and a
# launcher
# ---------------------------------------------------------------------------

NATIVE_MATRICES = ("orsirr_like150", "orsirr_like300")
ILU_TOL = 1e-12             # ILU(0) values, library against the numpy loop
SINGLE_SAMPLES = 8          # trajectories of [env-single]
SINGLE_RTOL = 1e-6          # reward_from_actions against batched_rewards
GRID_STEPS, GRID_BATCH, GRID_MIN_SHARE = 300, 64, 0.35   # tests/test_train.py's recipe
# the kernels each row of examples/chebyshev_cg_torch.py reaches: A through
# K8; Chebyshev applies through K13; the Jacobi V-cycle's sweeps through K12
LAUNCHER_KERNELS = {"none": ("K8",), "chebyshev": ("K8", "K13"), "vcycle": ("K8", "K12"),
                    "vcycle-cheb": ("K8", "K13"), "wcycle-cheb": ("K8", "K13")}


def _cpu_model() -> str:
    """The host CPU as /proc/cpuinfo names it (vendor, family and model
    numbers where the model name reads "unknown")."""
    fields = {}
    for line in Path("/proc/cpuinfo").read_text().splitlines():
        key, _, val = line.partition(":")
        fields.setdefault(key.strip(), val.strip())
    name = fields.get("model name", "unknown")
    if name.lower() in ("", "unknown"):
        name = (f"model name '{name}', vendor {fields.get('vendor_id', '?')}, family "
                f"{fields.get('cpu family', '?')}, model {fields.get('model', '?')}")
    return name


@contextlib.contextmanager
def _numpy_path():
    """Every caller of the native library takes its numpy path."""
    saved = native.available
    native.available = lambda: False
    try:
        yield
    finally:
        native.available = saved


def _both_paths(fn):
    """(library result, seconds, numpy result, seconds) of ``fn()``."""
    t0 = time.perf_counter()
    lib = fn()
    t1 = time.perf_counter()
    with _numpy_path():
        py = fn()
    return lib, t1 - t0, py, time.perf_counter() - t1


def phase_native(dev):
    """Host setup with the native library against its numpy paths, on
    orsirr_like150 and orsirr_like300: parse (a file ``write_mtx`` wrote),
    ILU(0), RCM and the seed · A SpGEMM plan, each the same result; and
    phase 3's whole ``setup`` on orsirr_like150 on each path."""
    from gflownet_spai_tpu_torch.env import ilu
    from gflownet_spai_tpu_torch.ops import rcm
    from gflownet_spai_tpu_torch.sparse import gallery, read_mtx, write_mtx
    from gflownet_spai_tpu_torch.sparse.ops import SpGEMMPlan

    if not native.available():
        fail("[native] the native host library is not available")
    print(f"[native] host CPU {_cpu_model()} ({len(os.sched_getaffinity(0))} cores for this "
          f"process); g++ build {NATIVE_BUILD_S[0]:.2f} s ([build])", flush=True)
    out = {}
    for name in NATIVE_MATRICES:
        a = gallery.get(name)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_native_") as tmp:
            path = Path(tmp) / f"{name}.mtx"
            write_mtx(path, a)
            got, t_lib, want, t_py = _both_paths(lambda: read_mtx(path))
        if not all(np.array_equal(getattr(got, f), getattr(want, f))
                   for f in ("row", "col", "data")):
            fail(f"[native] {name}: the parsed COO differs from the Python parser's")
        secs = {"parse": (t_lib, t_py)}
        (L, U), t_lib, (Lp, Up), t_py = _both_paths(lambda: ilu.ilu0(a))
        err = max(float(np.max(np.abs(x.data - y.data))) for x, y in ((L, Lp), (U, Up)))
        if not (all(np.array_equal(x.row, y.row) and np.array_equal(x.col, y.col)
                    for x, y in ((L, Lp), (U, Up))) and err <= ILU_TOL):
            fail(f"[native] {name}: ILU(0) differs from the numpy loop (max |d| {err:.3e})")
        secs["ilu0"] = (t_lib, t_py)
        perm, t_lib, perm_py, t_py = _both_paths(lambda: rcm.rcm_permutation(a))
        if not np.array_equal(perm, perm_py):
            fail(f"[native] {name}: the RCM order differs from the numpy BFS's")
        secs["rcm"] = (t_lib, t_py)
        seed = ilu.seed_pattern(a)
        plan, t_lib, plan_py, t_py = _both_paths(lambda: SpGEMMPlan(seed, a, device=dev))
        for f in ("out_row", "out_col", "pair_a", "pair_b", "pair_out"):
            if not torch.equal(getattr(plan, f), getattr(plan_py, f)):
                fail(f"[native] {name}: the SpGEMM plan's {f} differs from the numpy plan's")
        secs["spgemm plan"] = (t_lib, t_py)
        if name == MATRIX:      # phase 3's setup, whole, on each path
            _, t_lib, _, t_py = _both_paths(
                lambda: setup(TrainConfig(matrix=MATRIX, env_format="coo")))
            secs["setup (coo env)"] = (t_lib, t_py)
        out[name] = secs
        print(f"[native] {name} (n {a.shape[0]}, nnz {a.nnz}; seed {seed.nnz}, "
              f"{plan.npairs} pairs): library / numpy seconds, the same result: "
              + ", ".join(f"{k} {lib:.4f} / {py:.4f} ({py / lib:.0f}x)"
                          for k, (lib, py) in secs.items())
              + f"; ILU(0) max |d| {err:.1e}", flush=True)
    return out


def phase_env_single(envs, dev):
    """The single-sample reward API on the card: for SINGLE_SAMPLES
    trajectories, ``reward_from_actions`` against ``batched_rewards`` row
    by row on each env, and µs per single-sample call."""
    gen = torch.Generator(device=dev).manual_seed(21)
    for tag, env in envs:
        A = env.num_actions
        logits = torch.randn(SINGLE_SAMPLES, A, generator=gen, device=dev)
        acts = gumbel_topk_rollout(logits, gen, env.terminal_action).actions
        alpha = torch.tensor(0.98, device=dev)
        batched = spai.batched_rewards(env, acts, alpha)
        single = torch.stack([spai.reward_from_actions(env, acts[i], alpha)
                              for i in range(SINGLE_SAMPLES)])
        rel = float(torch.max(torch.abs(single - batched)
                              / torch.clamp_min(torch.abs(batched), 1.0)))
        if not (torch.isfinite(single).all() and rel <= SINGLE_RTOL):
            fail(f"[env-single] {tag}: reward_from_actions is {rel:.3e} from "
                 f"batched_rewards (relative, at most {SINGLE_RTOL})")
        one = cuda_ms(lambda: spai.reward_from_actions(env, acts[0], alpha), 20)
        many = cuda_ms(lambda: spai.batched_rewards(env, acts, alpha), 20)
        lengths = (acts >= 0).sum(1)
        print(f"[env-single] {tag}: {SINGLE_SAMPLES} trajectories (lengths "
              f"{int(lengths.min())}-{int(lengths.max())} of {A} actions): "
              f"reward_from_actions equals batched_rewards row by row within {rel:.2e} "
              f"relative; {1e3 * one:.1f} us per single-sample call (eager, CUDA events), "
              f"{1e3 * many / SINGLE_SAMPLES:.1f} us per sample in one batched call of "
              f"{SINGLE_SAMPLES}", flush=True)


def _example(name):
    """A launcher of ``examples/`` as a module."""
    import importlib.util

    path = Path(__file__).resolve().parent / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_grid(dev):
    """The grid GFlowNet of ``examples/grid_gfn_torch.py`` trained on the
    card (``scan_rollout``, ``env.grid``)."""
    grid = _example("grid_gfn_torch")
    run = functools.partial(grid.train, size=8, hidden=32, batch=GRID_BATCH, max_steps=15,
                            lr=5e-3, device=dev, seed=0)
    run(steps=5)                                                # warm-up
    params, losses, secs = run(steps=GRID_STEPS)
    share = grid.band_share(8, params, 512, seed=99, max_steps=15)
    first, last = np.mean(losses[:30]), np.mean(losses[-30:])
    if not (np.isfinite(losses).all() and last < first and share > GRID_MIN_SHARE):
        fail(f"[grid] the grid GFlowNet did not learn: loss {first:.3f} -> {last:.3f}, "
             f"{share:.1%} in the bands")
    print(f"[grid] 8 x 8 grid, {GRID_STEPS} steps of batch {GRID_BATCH} (15 steps a "
          f"trajectory, Adam 5e-3): {1e3 * secs / GRID_STEPS:.3f} ms per step (host clock, "
          f"synchronised at the end, after 5 warm-up steps); loss {first:.3f} -> {last:.3f} (means of "
          f"the first and last 30); {share:.1%} of 512 samples in the bands "
          f"(> {GRID_MIN_SHARE:.0%})", flush=True)


def phase_profiling(cfg, env, graph, mcfg, opt, state, dk, dev):
    """``utils.profiler_trace`` around two train steps, ``log_memory_usage``
    and ``utils.timed`` on K8 at poisson1024."""
    from gflownet_spai_tpu_torch import utils
    from gflownet_spai_tpu_torch.sparse import gallery

    step = make_train_step(cfg, env, graph, mcfg, opt)
    state, _ = step(state)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as tmp:
        t0 = time.perf_counter()
        with utils.profiler_trace(tmp):
            for _ in range(2):
                state, _ = step(state)
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        path = Path(tmp) / "trace.json"
        size = path.stat().st_size if path.exists() else 0
        names = {e.get("name", "") for e in json.loads(path.read_text())["traceEvents"]} \
            if size else set()
    kernels = sorted(n for n in names if "gat_tile_fused" in n)
    if not kernels:
        fail(f"[profiling] the trace of two train steps names no gat_tile_fused kernel "
             f"({size} bytes)")
    mem = utils.log_memory_usage("profiling")
    if not mem.get("cuda0_allocated_mb", 0) > 0:
        fail(f"[profiling] log_memory_usage read no card memory: {mem}")
    d = dia.coo_to_dia(gallery.poisson2d(POISSON, dtype=np.float32), device=dev)
    x = torch.randn(d.n, generator=torch.Generator(device=dev).manual_seed(3), device=dev)
    t = utils.timed(dia.spmv_dia, d, x)
    warm = dk[f"K8 poisson{POISSON}"]["warm"]
    print(f"[profiling] profiler_trace over 2 train steps: {size / 2**20:.1f} MiB trace in "
          f"{secs:.2f} s, naming {kernels[0][:60]} ({len(kernels)} gat_tile_fused kernel "
          f"names); log_memory_usage: card {mem['cuda0_allocated_mb']:.1f} MiB allocated, "
          f"{mem['cuda0_max_allocated_mb']:.1f} MiB peak, host RSS {mem['rss_mb']:.1f} MiB; "
          f"utils.timed(spmv_dia) on poisson{POISSON}: {1e3 * t:.5f} ms (one L2-warm copy, "
          f"graph replays) beside [dia]'s L2-warm reading {warm:.5f} ms", flush=True)


def phase_launchers():
    """``examples/chebyshev_cg_torch.py`` at its defaults (Poisson-1M) in a
    subprocess on the card: every row converges and reaches its kernels."""
    repo = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(repo / "examples" / "chebyshev_cg_torch.py")],
                          capture_output=True, text=True, timeout=600, cwd=str(repo))
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"[launchers] chebyshev_cg_torch.py exited {proc.returncode}: "
             f"{(proc.stdout + proc.stderr)[-2000:]}")
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    print(f"[launchers] examples/chebyshev_cg_torch.py (Poisson {report['grid']}^2, CG rtol "
          f"1e-5): exit 0 in {secs:.1f} s (process start and set-up included); "
          + "; ".join(f"{r['row']} {r['iterations']} it, {r['wall_s']:.4f} s, "
                      + ", ".join(f"{k} {n}" for k, n in r["launches"].items())
                      for r in report["rows"]), flush=True)
    for r in report["rows"]:
        need = LAUNCHER_KERNELS[r["row"].split("(")[0]]
        if not r["converged"] or any(r["launches"][k] == 0 for k in need):
            fail(f"[launchers] chebyshev_cg_torch.py row {r['row']}: converged "
                 f"{r['converged']}, launches {r['launches']} (needs {need})")


PAR_COUNTERS = {"K1": gf.gat_tile_fused, "K2": gf.gat_tile_fused_bwd,
                "K3": seg.gather_rows_windows, "K4": seg.scatter_rows_windows,
                "K8": dia.spmv_dia, "K12": dia.spmv_dia_power}
PAR_EPOCHS = 6              # [parallel]'s sharded-sampler train steps
PAR_LAUNCHES: dict = {}     # [parallel]: each multi-device call's own launches


def _free_port() -> int:
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def _rel_err(got, want) -> float:
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


def _par_count(label: str, need, fn):
    """One call of the multi-device path with every counter of
    ``PAR_COUNTERS`` set to 0 just before it and read just after, before
    any reference call runs; fails unless each kernel of ``need`` launched
    in that call.  The counts go into ``PAR_LAUNCHES[label]``."""
    for c in PAR_COUNTERS.values():
        c.launches = 0
    out = fn()
    got = {k: c.launches for k, c in PAR_COUNTERS.items()}
    PAR_LAUNCHES[label] = {k: v for k, v in got.items() if v}
    if any(got[k] == 0 for k in need):
        fail(f"[parallel] {label} launched {PAR_LAUNCHES[label]}, needs each of {need}")
    return out


def _par_spmv(mesh, dev):
    """The halo / all-gather SpMVs, the fused k-step halo SpMV and the
    distributed solvers on poisson1024 against their single-device calls."""
    from gflownet_spai_tpu_torch.parallel import (distributed_cg, distributed_gmres,
                                                  distributed_jacobi, halo_spmv,
                                                  halo_spmv_power, partition_dia,
                                                  spmv_allgather)
    from gflownet_spai_tpu_torch.solvers import cg, gmres
    from gflownet_spai_tpu_torch.solvers.stationary import jacobi
    from gflownet_spai_tpu_torch.sparse import gallery

    d = dia.coo_to_dia(gallery.poisson2d(POISSON, dtype=np.float32), device=dev)
    dp = partition_dia(d, 1)
    n = d.n
    gen = torch.Generator(device=dev).manual_seed(17)
    x = torch.randn(dp.n_pad, generator=gen, device=dev)
    x[n:] = 0
    want = dia.spmv_dia(dp, x)[:n]
    for label, fn in (("halo_spmv", lambda: halo_spmv(mesh, dp, x)),
                      ("spmv_allgather", lambda: spmv_allgather(mesh, dp, x))):
        err = _rel_err(_par_count(label, ("K8",), fn)[:n], want)
        if err > 1e-6:
            fail(f"[parallel] {label} against spmv_dia: max rel err {err:.3e}")
        single = lambda: dia.spmv_dia(dp, x)
        ms, ms1 = cuda_ms(fn, 50), cuda_ms(single, 50)
        dev_ms, dev1 = graph_ms(fn, 20), graph_ms(single, 20)
        print(f"[parallel] {label} on poisson{POISSON} (n {n}): max rel err vs spmv_dia "
              f"{err:.3e}; per apply {ms:.5f} ms eager, {dev_ms:.5f} ms device (graph "
              f"replays) vs spmv_dia {ms1:.5f} / {dev1:.5f}", flush=True)
    z = _par_count("halo_spmv_power", ("K12",),
                   lambda: halo_spmv_power(mesh, dp, x, k=4, scale=0.25))
    seq = x[:n]
    for _ in range(4):
        seq = 0.25 * dia.spmv_dia(dp, seq)
    err = _rel_err(z[:n], seq)
    if err > 1e-5:
        fail(f"[parallel] halo_spmv_power k 4 against 4 spmv_dia calls: max rel err {err:.3e}")
    ms = cuda_ms(lambda: halo_spmv_power(mesh, dp, x, k=4, scale=0.25), 20)
    print(f"[parallel] halo_spmv_power k 4 (K12) vs four spmv_dia calls: max rel err "
          f"{err:.3e}; {ms:.5f} ms per call of 4 applies (eager)", flush=True)
    b = torch.ones(n, device=dev)
    xj, rj = _par_count("distributed_jacobi", ("K12",),
                        lambda: distributed_jacobi(mesh, d, b, iters=96, k=4))
    ref = jacobi(d, b, iters=96, fuse_k=4)
    err = _rel_err(xj, ref.x)
    if ref.iterations != 96 or err > 1e-5:
        fail(f"[parallel] distributed_jacobi vs jacobi: {ref.iterations} sweeps, max rel "
             f"err {err:.3e}")
    print(f"[parallel] distributed_jacobi (96 sweeps, k 4 on K12) vs jacobi: max rel err "
          f"{err:.3e}; true residual {float(rj):.6e} vs {float(ref.residual):.6e}",
          flush=True)
    for label, dist_fn, single_fn in (
            ("cg", lambda: distributed_cg(mesh, d, b, maxiter=3000, rtol=1e-5),
             lambda: cg(d, b, maxiter=3000, rtol=1e-5)),
            ("gmres(30)", lambda: distributed_gmres(mesh, d, b, restart=30, maxiter=300,
                                                    rtol=1e-5),
             lambda: gmres(d, b, restart=30, maxiter=300, rtol=1e-5))):
        runs = {"dist": [], "single": []}
        for i, which in enumerate(("dist", "single", "single", "dist")):      # A B B A
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = (_par_count(f"distributed_{label}", ("K8",), dist_fn) if i == 0 else
                   (dist_fn if which == "dist" else single_fn)())
            torch.cuda.synchronize()
            runs[which].append((res, time.perf_counter() - t0))
        got, ref = runs["dist"][0][0], runs["single"][0][0]
        its = {r.iterations for rs in runs.values() for r, _ in rs}
        if its != {ref.iterations}:
            fail(f"[parallel] distributed {label}: iterations {its}, single-device "
                 f"{ref.iterations}")
        per = {k: [1e3 * t / max(r.iterations, 1) for r, t in v] for k, v in runs.items()}
        true = [float(torch.linalg.vector_norm(b - dia.spmv_dia(d, r.x))) for r in (got, ref)]
        print(f"[parallel] distributed {label} on poisson{POISSON} (b = ones, rtol 1e-5): "
              f"{got.iterations} iterations = single-device {ref.iterations}, converged "
              f"{got.converged}; true residual {true[0]:.6e} vs {true[1]:.6e}; ms/iteration "
              f"(host clock, A B B A) {np.mean(per['dist']):.5f} "
              f"({', '.join(f'{v:.5f}' for v in per['dist'])}) vs "
              f"{np.mean(per['single']):.5f} ({', '.join(f'{v:.5f}' for v in per['single'])})",
              flush=True)


def _par_gat(mesh, seed, dev):
    """The tile-sharded GAT on orsirr_like150's uniform tile layout against
    ``forward_policy_pooled``: values and the forward parameters' gradient
    of Σ c·pooled."""
    from gflownet_spai_tpu_torch.parallel.gat import (local_shard, shard_tiled_graph,
                                                      sharded_policy_pooled)

    g = pol.tiled_graph_from_seed(seed, bucket_step=None, device=dev)
    sg, meta = shard_tiled_graph(g, 1)
    local = local_shard(sg, meta, 0)
    params = gfn.init_params(torch.Generator().manual_seed(5), gfn.GFlowNetConfig(
        hidden_dim=4, heads=4, num_actions=seed.nnz + 1), device=dev)
    c = torch.randn(4, generator=torch.Generator(device=dev).manual_seed(7), device=dev)

    def run(fn, label=None):
        named = tree_leaves(params.forward)
        leaves = [x.detach().requires_grad_(True) for _, x in named]
        fwd = tree_replace(params.forward, iter(leaves))
        grad = lambda: torch.autograd.grad((pooled * c).sum(), leaves, allow_unused=True)
        if label is None:
            pooled = fn(fwd)
            grads = grad()
        else:
            pooled = _par_count(label, ("K1", "K3"), lambda: fn(fwd))
            grads = _par_count(label + " backward", ("K2", "K4"), grad)
        return pooled.detach(), {p: torch.zeros_like(x) if gr is None else gr
                                 for (p, x), gr in zip(named, grads)}

    got, g_got = run(lambda f: sharded_policy_pooled(mesh, f, local, meta, 4, 4),
                     "sharded_policy_pooled")
    want, g_want = run(lambda f: pol.forward_policy_pooled(f, g, 4, 4))
    err = _rel_err(got, want)
    if err > 1e-5:
        fail(f"[parallel] sharded_policy_pooled vs forward_policy_pooled: rel err {err:.3e}")
    group = lambda p: p.rsplit("/", 1)[0]
    scale = {}
    for p, w in g_want.items():
        scale[group(p)] = max(scale.get(group(p), 0.0), float(w.abs().max()))
    worst = 0.0
    for p, w in g_want.items():
        e = float((g_got[p] - w).abs().max())
        worst = max(worst, e / max(scale[group(p)], 1e-30))
        if not torch.allclose(g_got[p], w, rtol=GRAD_RTOL, atol=GRAD_ATOL * scale[group(p)]):
            fail(f"[parallel] sharded GAT gradient of {p}: max abs err {e}")
    fwd_ms = cuda_ms(lambda: sharded_policy_pooled(mesh, params.forward, local, meta, 4, 4),
                     10)
    ref_ms = cuda_ms(lambda: pol.forward_policy_pooled(params.forward, g, 4, 4), 10)
    print(f"[parallel] sharded_policy_pooled on {MATRIX}'s uniform tile layout "
          f"({g.tiles.tiles} tiles of {g.tiles.slots} slots): rel err vs "
          f"forward_policy_pooled {err:.3e}, gradients max err / group scale "
          f"{worst:.3e}; forward {fwd_ms:.5f} ms vs {ref_ms:.5f} ms (eager)", flush=True)


def _par_train(run_dir: Path, train_ms: float, dev):
    """``train`` with the sharded sampler at the [train] configuration, and
    the dp step on the 1×1 mesh against ``loss_fn`` on the same noise."""
    from gflownet_spai_tpu_torch.gfn.rollout import gumbel_noise
    from gflownet_spai_tpu_torch.parallel import make_dp_train_step, make_mesh

    cfg = TrainConfig(**TRAIN, sampler="sharded", num_epochs=PAR_EPOCHS,
                      out_dir=str(run_dir))
    _, _, env, graph, mcfg, opt, init = setup(cfg)
    if graph.gat_buckets:
        fail("[parallel] the sharded sampler's setup built gat buckets")
    state, history = _par_count("train(sampler='sharded')", ("K1", "K2", "K3", "K4"),
                                lambda: train(cfg, progress=False))
    torch.cuda.synchronize()
    recs = [json.loads(x) for x in (run_dir / "metrics.jsonl").read_text().splitlines()]
    if len(recs) != PAR_EPOCHS or not np.isfinite(history).all():
        fail(f"[parallel] the sharded-sampler run: {len(recs)} epochs, losses {history}")
    moved = [p for (p, a), (_, b) in zip(tree_leaves(state.params.forward),
                                         tree_leaves(init.params.forward))
             if not torch.equal(a, b)]
    if not {"/gat1/w_src", "/gat2/w_src", "/fc_w"} <= set(moved):
        fail(f"[parallel] the sharded-sampler run moved only {moved}")
    wall = [r["wall_s"] * 1e3 for r in recs]
    print(f"[parallel] train(sampler='sharded') at [train]'s configuration, 1x1 mesh: "
          f"{PAR_EPOCHS} steps, steady ms/step {np.mean(wall[1:]):.3f} vs [train]'s dense "
          f"{train_ms:.3f}; losses {', '.join(f'{h:.4f}' for h in history)}; valid share "
          f"{', '.join(str(r['valid_frac']) for r in recs)}", flush=True)
    mesh = make_mesh(1, 1, dev)
    dcfg = mcfg._replace(t_cap=0)
    step, _ = make_dp_train_step(mesh, env, graph, dcfg, opt, batch_size=4)
    A = dcfg.num_actions
    gumbels = gumbel_noise((4, A), torch.Generator(device=dev).manual_seed(3),
                           torch.float32, dev)
    out = _par_count("make_dp_train_step", ("K1", "K2", "K3", "K4"),
                     lambda: step(init.params, init.opt_state, 0, gumbels=gumbels))
    want, _ = gfn.loss_fn(init.params, env, graph, dcfg,
                          torch.Generator(device=dev).manual_seed(3), 4)
    err = abs(float(out[2]) - float(want)) / max(abs(float(want)), 1e-30)
    if err > 1e-5:
        fail(f"[parallel] make_dp_train_step on 1x1: loss {float(out[2])} vs loss_fn "
             f"{float(want)}")
    print(f"[parallel] make_dp_train_step on the 1x1 mesh: loss {float(out[2]):.6f} = "
          f"loss_fn {float(want):.6f} on the same noise (rel err {err:.3e})", flush=True)


def _par_multi_rank(count: int):
    """The port's rank check (``gflownet_spai_tpu_torch.parallel.check``:
    halo_spmv on poisson1024 split over the ranks against each rank's
    whole-matrix K8, and one dp step) on min(count, 4) NCCL ranks, one card
    each, started by torchrun."""
    n = min(count, 4)
    repo = Path(__file__).resolve().parent
    p = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                        "--nproc-per-node", str(n), "-m",
                        "gflownet_spai_tpu_torch.parallel.check", "--poisson", str(POISSON)],
                       env=dict(os.environ, GFNSPAI_TIMEOUT_S="300"), capture_output=True,
                       text=True, cwd=str(repo), timeout=600)
    if p.returncode != 0:
        fail(f"[parallel] the rank check on {n} NCCL ranks exited {p.returncode}: "
             f"{(p.stdout + p.stderr)[-2000:]}")
    recs = [json.loads(x) for x in p.stdout.splitlines() if x.startswith('{"rank"')]
    if len(recs) != n:
        fail(f"[parallel] the rank check on {n} NCCL ranks printed {len(recs)} records")
    for r in sorted(recs, key=lambda r: r["rank"]):
        print(f"[parallel] {n} NCCL ranks, rank {r['rank']}: halo_spmv on poisson"
              f"{POISSON} max rel err {r['spmv_rel_err']:.3e}, K8 launches "
              f"{r['k8_launches']}, {r['halo_spmv_ms']:.5f} ms per apply; dp step loss "
              f"{r['dp_loss']:.6f}", flush=True)


def phase_parallel(seed, train_ms: float, dev, count: int):
    """The multi-device layer on a one-rank NCCL world: the SpMVs and
    solvers, the sharded GAT, training through the sharded sampler and the
    dp step, the launchers, each call's launches counted on their own
    (``_par_count``); then more NCCL ranks where the host has more cards.
    Returns the launches summed over those calls."""
    import torch.distributed as dist

    from gflownet_spai_tpu_torch import bench_scaling
    from gflownet_spai_tpu_torch.parallel import make_mesh

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0)
    try:
        probe = torch.ones(4, device=dev)
        dist.all_reduce(probe)
        mesh = make_mesh(1, 1, dev)
        print(f"[parallel] process group: backend {dist.get_backend()}, NCCL "
              f"{'.'.join(map(str, torch.cuda.nccl.version()))}, world "
              f"{dist.get_world_size()}; {mesh}; all_reduce probe {probe.tolist()}",
              flush=True)
        PAR_LAUNCHES.clear()
        _par_spmv(mesh, dev)
        _par_gat(mesh, seed, dev)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_parallel_") as tmp:
            _par_train(Path(tmp), train_ms, dev)
        for rec in _par_count("bench_scaling.run", ("K8",),
                              lambda: bench_scaling.run([1], 262144)):
            print(json.dumps(rec), flush=True)
        sys.path.insert(0, str(Path(__file__).resolve().parent))
        import __graft_entry_torch__ as graft

        fn, args = graft.entry()
        loss, rewards = _par_count("__graft_entry_torch__.entry()", (), lambda: fn(*args))
        if not (torch.isfinite(loss) and torch.isfinite(rewards).all()):
            fail("[parallel] __graft_entry_torch__.entry(): a non-finite loss or reward")
        print(f"[parallel] __graft_entry_torch__.entry() on {loss.device}: loss "
              f"{float(loss):.4f}, rewards {rewards.shape[0]}", flush=True)
    finally:
        dist.destroy_process_group()
    launches = {k: sum(v.get(k, 0) for v in PAR_LAUNCHES.values()) for k in PAR_COUNTERS}
    print(f"[parallel] launches, each call counted on its own (counters to 0 just "
          f"before it, read just after): {json.dumps(PAR_LAUNCHES)}; summed {launches}",
          flush=True)
    if count >= 2:
        _par_multi_rank(count)
    else:
        print(f"[parallel] {count} card: this card count allows no multi-rank NCCL run",
              flush=True)
    return launches


def timed(name, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"[time] phase {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def main() -> int:
    t_start = time.perf_counter()
    name, count = phase_card()
    timed("build", phase_build)
    dev = port.resolve_device(None)
    t0 = time.perf_counter()
    a, seed, env, graph, mcfg, _, state = setup(
        TrainConfig(matrix=MATRIX, env_format="coo"))
    params = state.params
    print(f"[setup] {MATRIX}: n {a.shape[0]}, nnz(A) {a.nnz}, seed edges "
          f"{seed.nnz}, pair plan {env.plan.npairs} pairs -> {env.plan.out_nnz} "
          f"outputs, {time.perf_counter() - t0:.1f} s on the host (native host library "
          f"{'loaded' if native.available() else 'missing'})", flush=True)
    if not isinstance(graph, pol.TiledGraphInputs) or not graph.gat_buckets:
        fail("the slice did not build the bucketed tile layout")
    k1, k3 = timed("kernels", phase_kernels, graph, dev)
    k2, k4 = timed("backward", phase_kernels_bwd, graph, dev)
    timed("gradients", phase_gradients, seed, graph, mcfg, params, dev)
    sample_launches = timed("slice", phase_slice, a, seed, env, graph, mcfg, params, dev)
    timed("breakdown", phase_breakdown, env, graph, mcfg, params, dev)
    dk = timed("dia", phase_dia, dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        run_dir = Path(tmp)
        cfg, tenv, tgraph, tmcfg, opt, tstate, launches, step_ms, peak = \
            timed("train", phase_train, run_dir, dev)
        timed("step breakdown", phase_step_breakdown, cfg, tenv, tgraph, tmcfg, opt, tstate)
        timed("profile", phase_profile, cfg, tenv, tgraph, tmcfg, opt, tstate)
        timed("restore", phase_restore, run_dir)
        _, val_launches = timed("validate", phase_validate, run_dir, dev)
    pois_report, pois_launches = timed("poisson", phase_poisson, dev)
    dm, chain_launches = timed("dia-multi", phase_dia_multi, dev)
    multi_launches = timed("multirhs", phase_multirhs, dev)
    _, vc_launches = timed("vcycle", phase_vcycle, dev)
    timed("validate-cli", phase_validate_cli)
    seg_recs = timed("segment", phase_segment, graph, dev)
    gen_launches = timed("gat-generic", phase_gat_generic, seed, graph, dev)
    bell_recs, bell_launches = timed("bell", phase_bell, dev)
    timed("train-default", phase_train_default)
    timed("dia-env", phase_dia_env, dev)
    _, rb_env = timed("rowblock", phase_rowblock, dev)
    bf16_launches = timed("dia-bf16", phase_dia_bf16, dev, pois_report)
    timed("native", phase_native, dev)
    timed("env-single", phase_env_single, (("coo env, " + MATRIX, env),
                                           ("config 4 rowblock env", rb_env)), dev)
    del rb_env
    timed("grid", phase_grid, dev)
    timed("profiling", phase_profiling, cfg, tenv, tgraph, tmcfg, opt, tstate, dk, dev)
    timed("launchers", phase_launchers)
    par_launches = timed("parallel", phase_parallel, seed, step_ms, dev, count)
    bwd_ms = k2["ms"] + k4["ms"]
    print(f"[train] K2 + K4 device time per step (kernel phase, graph replays): "
          f"{k2['ms']:.5f} + {k4['ms']:.5f} ms = {100 * bwd_ms / step_ms:.3f}% of "
          f"the steady {step_ms:.3f} ms step", flush=True)
    bounds = {k: bound_ms(d["bytes"], d.get("ops", 0.0))
              for k, d in (("K1", k1), ("K2", k2), ("K3", k3), ("K4", k4))}
    src = "gflownet_spai_tpu_torch/csrc/"
    rows = [("gat_tile_fused (K1)", "K1", k1, "gat_fused.cu", "gat_fused.py:167", None),
            ("gat_tile_fused_bwd (K2)", "K2", k2, "gat_fused.cu", "gat_fused.py:211", None),
            ("gather_rows_buckets (K3)", "K3", k3, "segment.cu", "segment.py:612",
             k3["lib"]),
            ("scatter_rows_buckets (K4)", "K4", k4, "segment.cu", "segment.py:658",
             k4["lib"])]
    kernels = [
        {"name": nm, "route": "cuda", "source": src + file,
         "replaces": "gflownet_spai_tpu/ops/" + rep, "launches": launches[k],
         "max_abs_err": d["err"], "ms": d["ms"], "plain_ms": d["plain"],
         "bound_ms": bounds[k][0], "bound_by": bounds[k][1], "library_ms": lib}
        for nm, k, d, file, rep, lib in rows]
    # K8 by path (``ops/dia.py`` ``_k8_skips``): the rows path at poisson1024's
    # record, the skip path (its scan and SpMV) at orsirr_like150's
    k8_paths = {k: val_launches[k] + pois_launches[k] + vc_launches[k]
                for k in ("K8 rows", "K8 skip")}
    if min(k8_paths.values()) == 0:
        fail(f"a path of K8 did not launch on the main path: {k8_paths}")
    for nm, k, d in (("spmv_dia (K8, rows path: dia_spmv_kernel)", "K8 rows",
                      dk[f"K8 poisson{POISSON}"]),
                     ("spmv_dia (K8, skip path: dia_x_nonfinite_kernel, dia_spmv_skip_kernel)",
                      "K8 skip", dk[f"K8 {MATRIX}"])):
        kernels.append({"name": nm, "route": "cuda", "source": src + "dia.cu",
                        "replaces": "gflownet_spai_tpu/ops/dia.py:215",
                        "launches": k8_paths[k], "max_abs_err": d["err"], "ms": d["ms"],
                        "plain_ms": d["plain"], "bound_ms": d["bound"][0],
                        "bound_by": d["bound"][1], "library_ms": d["lib"]})
    for nm, k, file, rep in (("spmv_dia_power (K12)", "K12", "dia.cu", "dia.py:1325"),
                             ("spmv_dia_cheby (K13)", "K13", "dia.cu", "dia.py:1606")):
        d = dk[k]
        errs = [v["err"] for key, v in dk.items() if key.split()[0] == k]
        kernels.append({"name": nm, "route": "cuda", "source": src + file,
                        "replaces": "gflownet_spai_tpu/ops/" + rep,
                        "launches": val_launches[k] + pois_launches[k] + vc_launches[k],
                        "max_abs_err": max(errs), "ms": d["ms"], "plain_ms": d["plain"],
                        "bound_ms": d["bound"][0], "bound_by": d["bound"][1],
                        "library_ms": d["lib"]})
    # K10, K11 and K15: the [dia-multi] calls that use them (the chains, one
    # SpMM); K14 and K16: the [multirhs] solvers
    path_launches = {"K10": chain_launches["K10"], "K11": chain_launches["K11"],
                     "K15": chain_launches["K15"],
                     "K14": sum(v.get("K14", 0) for v in multi_launches.values()),
                     "K16": sum(v.get("K16", 0) for v in multi_launches.values())}
    if min(path_launches.values()) == 0:
        fail(f"a kernel of the solver library did not launch on its path: {path_launches}")
    for nm, k, file, rep in (("spmv_dia_padded_io (K10)", "K10", "dia_rhs.cu", "dia.py:856"),
                             ("spmv_dia_pingpong (K11)", "K11", "dia_rhs.cu", "dia.py:1091"),
                             ("spmv_dia_power_rhs (K14)", "K14", "dia_rhs.cu", "dia.py:1889"),
                             ("spmm_dia (K15)", "K15", "dia_spmm.cu", "dia.py:499"),
                             ("spmm_dia_t_padded, spmm_dia_t_rows (K16)", "K16", "dia_rhs.cu",
                              "dia.py:651")):
        d = dm[k]
        errs = [v["err"] for key, v in dm.items() if key.split()[0] == k]
        kernels.append({"name": nm, "route": "cuda", "source": src + file,
                        "replaces": "gflownet_spai_tpu/ops/" + rep,
                        "launches": path_launches[k], "max_abs_err": max(errs),
                        "ms": d["ms"], "plain_ms": d["plain"], "bound_ms": d["bound"][0],
                        "bound_by": d["bound"][1], "library_ms": d["lib"]})
    for nm, k, rep in (("segment_softmax_tiles_mh (K5)", "K5", "segment.py:247"),
                       ("segment_softmax_tiles_bwd (K5 backward)", "K5b", "segment.py:306"),
                       ("segment_sum_tiles (K6)", "K6", "segment.py:361"),
                       ("segment_broadcast_tiles (K7)", "K7", "segment.py:398")):
        d = seg_recs[k]
        kernels.append({"name": nm, "route": "cuda", "source": src + "segment.cu",
                        "replaces": "gflownet_spai_tpu/ops/" + rep,
                        "launches": gen_launches[k], "max_abs_err": d["err"],
                        "ms": d["ms"], "plain_ms": d["plain"], "bound_ms": d["bound"][0],
                        "bound_by": d["bound"][1], "library_ms": d["lib"]})
    # the bf16-diagonal instances: their [dia-bf16] path's launches, the
    # first [dia] / [dia-multi] case's times, the largest error against the
    # plain version over those phases' bf16 cases
    bf16_recs = {key: v for key, v in {**dk, **dm}.items() if key.startswith("bf16 ")}
    for nm, k, file, rep in (("spmv_dia", "K8", "dia.cu", "dia.py:215"),
                             ("spmv_dia_padded_io", "K10", "dia_rhs.cu", "dia.py:856"),
                             ("spmv_dia_pingpong", "K11", "dia_rhs.cu", "dia.py:1091"),
                             ("spmv_dia_power", "K12", "dia.cu", "dia.py:1325"),
                             ("spmv_dia_cheby", "K13", "dia.cu", "dia.py:1606"),
                             ("spmv_dia_power_rhs", "K14", "dia_rhs.cu", "dia.py:1889"),
                             ("spmm_dia", "K15", "dia_spmm.cu", "dia.py:499"),
                             ("spmm_dia_t_padded, spmm_dia_t_rows", "K16", "dia_rhs.cu",
                              "dia.py:651")):
        for vec in ("float32 vectors", "bf16 vectors"):
            tag = f"bf16 {k} {vec}"
            d = bf16_recs[tag]
            kernels.append({"name": f"{nm} ({k}, bf16 diagonals, {vec})", "route": "cuda",
                            "source": src + file,
                            "replaces": "gflownet_spai_tpu/ops/" + rep,
                            "launches": bf16_launches[f"{k} {vec}"],
                            "max_abs_err": max(v["err"] for key, v in bf16_recs.items()
                                               if key.startswith(tag)),
                            "ms": d["ms"], "plain_ms": d["plain"], "bound_ms": d["bound"][0],
                            "bound_by": d["bound"][1], "library_ms": d["lib"]})
    # K17: each instance's launches on the [bell] path, its time at the
    # first case, its largest error over the cases
    for nm, inst, file in (("spmm_bell (K17a, K17b)", "float32", "bsr.cu"),
                           ("spmm_bell (K17, bf16 blocks, bf16 X: wgmma fed by a TMA ring "
                            "over the chunk list)", "bf16 blocks, bf16 X", "bsr_bf16.cu"),
                           ("spmm_bell (K17, bf16 blocks, float32 X)", "bf16 blocks, float32 X",
                            "bsr.cu")):
        d = bell_recs[(inst,) + BELL_CASES[0]]
        kernels.append({"name": nm, "route": "cuda", "source": src + file,
                        "replaces": "gflownet_spai_tpu/ops/bsr.py:104",
                        "launches": bell_launches[inst],
                        "max_abs_err": bell_recs[(inst, "err")], "ms": d["ms"],
                        "plain_ms": d["plain"], "bound_ms": d["bound"][0],
                        "bound_by": d["bound"][1], "library_ms": d["lib"]})
    bell_rec = bell_recs[("float32",) + BELL_CASES[0]]
    n_b = len(graph.gat_buckets)
    print(f"[kernels] K1-K4 launches count the {EPOCHS} train steps (the sampling "
          f"slice counted {sample_launches}). ms, plain_ms, library_ms and "
          f"bound_ms are per policy forward (K1 over its {2 * n_b} launches, "
          f"K3 its one call for the {n_b} buckets) and per policy backward "
          f"(K2 over its {2 * n_b}, K4 its one call). K8, K12 and K13 launches "
          f"count the validate "
          f"phase {val_launches} plus the poisson phase {pois_launches}; their ms "
          f"are one call at poisson1024 (K8: y = A.x; K12: k = 8 affine, the "
          f"Jacobi-16 row's call; K13: k = 2), max_abs_err the largest over the "
          f"dia phase's cases (launches also count the vcycle phase {vc_launches}). "
          f"K10, K11 and K15 launches count their [dia-multi] path calls, K14 and "
          f"K16 the multirhs phase {multi_launches}; their ms are one call at "
          f"poisson1024 (K10, K11 scale 0.2; K14 16 right-hand sides, k = 1, "
          f"affine; K15 256 right-hand sides; K16 cg_multi's A at its K_pad "
          f"for 16 through spmm_dia_t_rows, the unpadded entry cg_multi calls), max_abs_err the largest over the dia-multi cases. K5-K7 "
          f"launches count one forward + backward of the [gat-generic] stack "
          f"(K5b: K5's backward kernel), "
          f"their ms, plain_ms, library_ms and bound_ms the sums over that "
          f"forward + backward's calls {GEN_CALLS} at the [segment] phase's "
          f"widths (K5's library_ms eager sparse COO calls), max_abs_err the "
          f"largest there and (K5, K5b) on the shuffled layout. K17's three "
          f"entries (float32; bf16 blocks with bf16 X, the tensor-core kernel; bf16 "
          f"blocks with float32 X) count their instance's launches on the [bell] path "
          f"({len(BELL_CASES)} spmm_bell calls, one on the irregular BELL, one "
          f"spmv_bell each); their ms are one call at 4096 x 4096, blocks (8, 128), "
          f"K {BELL_K}, max_abs_err the largest over the [bell] cases; the bound "
          f"counts 2-byte words for bf16 operands and prices the bf16 x bf16 "
          f"instance's operations at {TC_OPS_PER_S / 1e12:.0f} TFLOP/s; library_ms "
          f"torch.sparse CSR of the stored values in X's dtype. ms and "
          f"library_ms are CUDA-graph replays (device "
          f"time; the DIA kernels and their library calls cycle through input "
          f"copies larger than L2); plain_ms are eager calls. Eager calls of the "
          f"kernels' wrappers: K1 "
          f"{k1['eager']:.5f} ms, K2 {k2['eager']:.5f} ms, K3 {k3['eager']:.5f} "
          f"ms, K4 {k4['eager']:.5f} ms, K8 {dk['K8']['eager']:.5f} ms, K12 "
          f"{dk['K12']['eager']:.5f} ms, K13 {dk['K13']['eager']:.5f} ms, "
          + ", ".join(f"{k} {dm[k]['eager']:.5f} ms" for k in MULTI_COUNTERS)
          + ", " + ", ".join(f"{k} {seg_recs[k]['eager']:.5f} ms" for k in GEN_CALLS)
          + f", K17 {bell_rec['eager']:.5f} ms. The bf16 entries (bf16 diagonals, "
          f"float32 or bf16 vectors) count the [dia-bf16] path (the ops entry "
          f"points on dia_astype(poisson1024, bf16), then jacobi_sweeps_op, "
          f"chebyshev_op, CG and jacobi_multirhs on it); their ms at the float32 "
          f"entry's [dia] / [dia-multi] case on the same inputs (K12 k = 8 affine "
          f"in the rule's mode), max_abs_err the largest over those phases' bf16 "
          f"cases; bound_ms with 2-byte diagonal words (and vector words on bf16 "
          f"vectors); library_ms torch.sparse CSR with bf16 values on bf16 vectors, "
          f"with the bf16-rounded values in float32 on float32 vectors; training "
          f"peak memory {peak / 2**20:.1f} MiB; total {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
