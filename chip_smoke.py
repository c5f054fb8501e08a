"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):

1. card      — requires CUDA; prints the device, its count and
               ``nvidia-smi``'s name and power limit; TF32 off.
2. build     — compiles every kernel of the sampling path from
               ``gflownet_spai_tpu_torch/csrc`` with nvcc (one process per
               source, all at once).
3. setup     — ``setup(TrainConfig(matrix="orsirr_like150", env_format="coo"))``
               on the card (ILU(0) seed, hidden 4, heads 4).
4. kernels   — K1 (fused GATv2 tile forward) and K3 (windowed row gather)
               at every bucket of that graph, both GAT layers, against
               their plain PyTorch versions on the same CUDA tensors.
               Kernel and library times are CUDA-graph replays (device
               time, no host dispatch), printed beside the eager calls'
               time and the bytes/ops bound.
5. slice     — launch counters to 0, ``sample(..., batch_size=256)`` for a
               few batches, counters read: every kernel of the path ran.
               Checks finite rewards and log-probs, terminal-ended
               trajectories, rewards against a float64 scipy reference, and
               the kernel-path logits against the per-edge scatter path.
6. breakdown — host-clock times of the forward, the rollout and the reward.

The line before the last is the ``kernels`` JSON object; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

import gflownet_spai_tpu_torch as port
from gflownet_spai_tpu_torch import _build
from gflownet_spai_tpu_torch.env import spai
from gflownet_spai_tpu_torch.gfn import gflownet as gfn
from gflownet_spai_tpu_torch.gfn.rollout import gumbel_topk_rollout
from gflownet_spai_tpu_torch.models import policies as pol
from gflownet_spai_tpu_torch.ops import gat_fused as gf
from gflownet_spai_tpu_torch.ops import segment as seg
from gflownet_spai_tpu_torch.train import TrainConfig, setup

MATRIX = "orsirr_like150"
BATCH = 256
BATCHES = 4                 # sampled batches on the main path (first is warm-up)
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
F32_OPS_PER_S = 67e12       # H100 SXM f32 outside the tensor cores
K1_TOL = dict(rtol=1e-5, atol=1e-5)   # shared-memory atomics: run-dependent sum order
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


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
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


def phase_build():
    secs = _build.build_all(verbose=True)
    for name in _build.SOURCES:
        _build.load(name)
    print(f"[build] {len(_build.SOURCES)} kernel sources in {secs:.2f} s", flush=True)


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
    ld = tb.local_dst.long()
    is_real = ld < TN
    real = int(is_real.sum())
    nodes = int(torch.unique((ld + torch.arange(T, device=dev)[:, None] * TN)
                             [is_real]).numel())
    xs_rows = 1 if layer == 1 else real
    xd_rows = 1 if layer == 1 else nodes
    nbytes = 4 * (T * S + real + (xs_rows + xd_rows + 2) * HD + T * TN * HD)
    return tb, args, nbytes, real * (8 * HD + 5 * H)


def phase_kernels(graph, dev):
    """K1 and K3 against their plain versions at the slice's shapes."""
    gen = torch.Generator(device=dev).manual_seed(1234)
    k1 = dict(err=0.0, ms=0.0, eager=0.0, plain=0.0, bytes=0.0, ops=0.0)
    k3 = dict(err=0.0, ms=0.0, eager=0.0, plain=0.0, lib=0.0, bytes=0.0)
    n_nodes = graph.tiles.num_nodes
    for bk in graph.gat_buckets:
        tb = bk.tiles
        for layer in (1, 2):
            tiles, args, nbytes, ops = _k1_case(bk, layer, gen, dev)
            got = gf.gat_tile_fused(tiles, *args)
            want = gf.gat_tile_fused_ref(tiles, *args)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            if not torch.allclose(got, want, **K1_TOL):
                fail(f"K1 disagrees with its plain version at bucket "
                     f"T={tb.tiles} S={tb.slots} layer {layer}: max abs err {err}")
            ms = graph_ms(lambda: gf.gat_tile_fused(tiles, *args), 20)
            eager = cuda_ms(lambda: gf.gat_tile_fused(tiles, *args), 20)
            plain = cuda_ms(lambda: gf.gat_tile_fused_ref(tiles, *args), 3)
            b, _ = bound_ms(nbytes, ops)
            print(f"[K1] T={tb.tiles} S={tb.slots} layer {layer}: max abs err "
                  f"{err:.3e} (rel {err / max(float(want.abs().max()), 1e-30):.3e}); "
                  f"kernel {ms:.5f} ms (graph replay; eager calls {eager:.5f} ms), "
                  f"plain {plain:.4f} ms, bound {b:.6f} ms", flush=True)
            k1["err"] = max(k1["err"], err)
            k1["ms"] += ms
            k1["eager"] += eager
            k1["plain"] += plain
            k1["bytes"] += nbytes
            k1["ops"] += ops
        # K3 at this bucket: layer-2 source rows [2n, 4]
        plan = bk.srcwin
        vals = torch.randn((n_nodes, 4), generator=gen, device=dev)
        got = seg.gather_rows_windows(plan, tb, bk.src_t, vals)
        want = seg.gather_rows_windows_ref(plan, tb, vals)
        # the same function as one PyTorch indexing call (timed only)
        row = _effective_rows(plan, n_nodes).to(dev)
        ext = torch.cat([vals, vals.new_zeros(1, 4)])
        lib = torch.index_select(ext, 0, row)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not torch.equal(got, want):
            fail(f"K3 disagrees with its plain version at bucket T={tb.tiles} "
                 f"S={tb.slots}: max abs err {err}")
        k3["err"] = max(k3["err"], err)
        if not torch.equal(lib, want):
            fail("the index_select yardstick does not compute K3's function")
        ms = graph_ms(lambda: seg.gather_rows_windows(plan, tb, bk.src_t, vals), 50)
        eager = cuda_ms(lambda: seg.gather_rows_windows(plan, tb, bk.src_t, vals), 50)
        plain = cuda_ms(lambda: seg.gather_rows_windows_ref(plan, tb, vals), 10)
        lib_ms = graph_ms(lambda: torch.index_select(ext, 0, row), 50)
        # bytes the function needs: lsrc, blk, the real outliers, each
        # distinct source row once, the whole output
        T, S, D = tb.tiles, tb.slots, vals.shape[1]
        outliers = int((plan.out_slot < T * S).sum())
        rows = int(torch.unique(row[row < n_nodes]).numel())
        nbytes = 4 * (T * S + T + 2 * outliers + rows * D + T * S * D)
        b, _ = bound_ms(nbytes, 0)
        print(f"[K3] T={T} S={S} win={plan.win} outliers={outliers} distinct "
              f"rows={rows}: exact; kernel {ms:.5f} ms (graph replay; eager "
              f"calls {eager:.5f} ms), plain {plain:.4f} ms, index_select "
              f"{lib_ms:.5f} ms (graph replay), bound {b:.6f} ms", flush=True)
        k3["ms"] += ms
        k3["eager"] += eager
        k3["plain"] += plain
        k3["lib"] += lib_ms
        k3["bytes"] += nbytes
    return k1, k3


def _effective_rows(plan, n):
    """Per-slot source row of the window plan (n = the appended zero row)."""
    lsrc = plan.lsrc.long().cpu()
    row = plan.blk.long().cpu()[:, None] * plan.win + lsrc
    ok = (lsrc >= 0) & (lsrc < 2 * plan.win) & (row < n)
    row = torch.where(ok, row, n).reshape(-1)
    slot, src = plan.out_slot.long().cpu(), plan.out_src.long().cpu()
    keep = slot < row.numel()
    row[slot[keep]] = src[keep]
    return row


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
    if launches != {"K1": 2 * n_b * BATCHES, "K3": n_b * BATCHES}:
        fail(f"launch counts {launches} on {BATCHES} batches over {n_b} buckets: "
             "the main path did not run every kernel once per bucket and layer")
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


def main() -> int:
    name, count = phase_card()
    phase_build()
    dev = port.resolve_device(None)
    t0 = time.perf_counter()
    a, seed, env, graph, mcfg, params = setup(
        TrainConfig(matrix=MATRIX, env_format="coo"))
    print(f"[setup] {MATRIX}: n {a.shape[0]}, nnz(A) {a.nnz}, seed edges "
          f"{seed.nnz}, pair plan {env.plan.npairs} pairs -> {env.plan.out_nnz} "
          f"outputs, {time.perf_counter() - t0:.1f} s on the host", flush=True)
    if not isinstance(graph, pol.TiledGraphInputs) or not graph.gat_buckets:
        fail("the slice did not build the bucketed tile layout")
    k1, k3 = phase_kernels(graph, dev)
    launches = phase_slice(a, seed, env, graph, mcfg, params, dev)
    phase_breakdown(env, graph, mcfg, params, dev)
    k1_bound, k1_by = bound_ms(k1["bytes"], k1["ops"])
    k3_bound, k3_by = bound_ms(k3["bytes"], 0)
    kernels = [
        {"name": "gat_tile_fused (K1)", "route": "cuda",
         "source": "gflownet_spai_tpu_torch/csrc/gat_fused.cu",
         "replaces": "gflownet_spai_tpu/ops/gat_fused.py:167",
         "launches": launches["K1"], "max_abs_err": k1["err"],
         "ms": k1["ms"], "plain_ms": k1["plain"], "bound_ms": k1_bound,
         "bound_by": k1_by, "library_ms": None},
        {"name": "gather_rows_windows (K3)", "route": "cuda",
         "source": "gflownet_spai_tpu_torch/csrc/segment.cu",
         "replaces": "gflownet_spai_tpu/ops/segment.py:612",
         "launches": launches["K3"], "max_abs_err": k3["err"],
         "ms": k3["ms"], "plain_ms": k3["plain"], "bound_ms": k3_bound,
         "bound_by": k3_by, "library_ms": k3["lib"]},
    ]
    n_b = len(graph.gat_buckets)
    print(f"[kernels] ms, plain_ms, library_ms and bound_ms are per policy "
          f"forward: K1 summed over its {2 * n_b} launches ({n_b} buckets x 2 "
          f"layers), K3 over its {n_b}. ms and library_ms are CUDA-graph "
          f"replays (device time); plain_ms is eager calls (the plain versions "
          f"sync with the host). Eager calls of the kernels' wrappers: K1 "
          f"{k1['eager']:.5f} ms, K3 {k3['eager']:.5f} ms", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
