"""Post-hoc training reports (counterpart of
``gflownet_spai_tpu/utils/reporting.py``; matplotlib is imported inside the
functions that draw, only when they draw).

The reference renders plotly 3D/2D loss plots with an sklearn regression
trend (GFlowNet100.py:333-484).  Equivalent capability, headless-friendly:
loss/reward curves + per-sample scatter from the training CSVs as PNG
(matplotlib Agg) and a JSON trend summary (least-squares slope — the
reference's acceptance signal was "loss slope negative").
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional

import numpy as np


def trend_summary(values: np.ndarray, decreasing_is_better: bool = True) -> Dict[str, float]:
    """Least-squares linear trend over epochs (replaces the reference's
    sklearn LinearRegression at GFlowNet100.py:416-484)."""
    x = np.arange(len(values), dtype=np.float64)
    y = np.asarray(values, np.float64)
    mask = np.isfinite(y)
    slope, intercept = np.polyfit(x[mask], y[mask], 1)
    return {
        "slope_per_epoch": float(slope),
        "intercept": float(intercept),
        "first_10_mean": float(np.nanmean(y[:10])),
        "last_10_mean": float(np.nanmean(y[-10:])),
        "improving": bool(slope < 0) if decreasing_is_better else bool(slope > 0),
    }


def render_training_report(run_dir: str, out_png: Optional[str] = None) -> Dict:
    """Reads ``training_log.csv`` / ``detailed_training_log.csv`` from a run
    directory, writes ``report.json`` (+ ``report.png`` when matplotlib is
    importable) and returns the summary dict."""
    run = Path(run_dir)
    import csv

    epochs, losses, rewards, num_actions = [], [], [], []
    with open(run / "training_log.csv") as f:
        for row in csv.DictReader(f):
            epochs.append(int(row["epoch"]))
            losses.append(float(row["loss"]))
            rewards.append(float(row["reward"]))
            num_actions.append(int(row["num_actions"]))

    summary = {
        "epochs": len(epochs),
        "loss": trend_summary(np.asarray(losses)),
        "reward": trend_summary(np.asarray(rewards), decreasing_is_better=False),
        "final_mean_actions": float(np.mean(num_actions[-10:])),
    }
    summary.update(_jsonl_summary(run))
    (run / "report.json").write_text(json.dumps(summary, indent=2))

    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return summary

    fig, axes = plt.subplots(1, 3, figsize=(14, 4))
    axes[0].plot(epochs, losses, lw=0.8)
    axes[0].set_yscale("symlog")
    axes[0].set_title("TB loss")
    axes[0].set_xlabel("epoch")
    axes[1].plot(epochs, rewards, lw=0.8, color="tab:green")
    axes[1].set_title("mean reward")
    axes[1].set_xlabel("epoch")
    axes[2].plot(epochs, num_actions, lw=0.8, color="tab:orange")
    axes[2].set_title("trajectory length (max in batch)")
    axes[2].set_xlabel("epoch")
    fig.tight_layout()
    target = out_png or (run / "report.png")
    fig.savefig(target, dpi=120)
    plt.close(fig)
    summary["png"] = str(target)

    ps = render_per_sample_surface(run_dir)
    if ps:
        summary["per_sample_png"] = ps
    return summary


def _jsonl_summary(run: Path) -> Dict:
    """Cap-ladder / validity audit from ``metrics.jsonl``.  Returns {}
    when the stream is missing."""
    f = run / "metrics.jsonl"
    if not f.exists():
        return {}
    valid, wall, caps = [], [], []
    for line in f.read_text().splitlines():
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            continue
        if "valid_frac" in rec:
            valid.append(float(rec["valid_frac"]))
        if rec.get("wall_s"):
            wall.append(float(rec["wall_s"]))
        if "t_cap" in rec:
            caps.append((int(rec["epoch"]), int(rec["t_cap"])))
    out: Dict = {}
    if valid:
        p5, p50, p95 = np.percentile(valid, [5, 50, 95])
        out["valid_frac"] = {
            "p5": float(p5), "p50": float(p50), "p95": float(p95),
            "final_10_mean": float(np.mean(valid[-10:])),
        }
    if wall:
        out["wall_s"] = {"median": float(np.median(wall)),
                         "p95": float(np.percentile(wall, 95)),
                         "total": float(np.sum(wall))}
    if caps:
        events = [{"epoch": caps[0][0], "t_cap": caps[0][1]}]
        for (_, prev), (e, cur) in zip(caps, caps[1:]):
            if cur != prev:
                events.append({"epoch": e, "t_cap": cur})
        out["t_cap_ladder"] = {"events": events, "final": caps[-1][1]}
    return out


def render_per_sample_surface(run_dir: str,
                              out_png: Optional[str] = None) -> Optional[str]:
    """The reference's per-sample view (plotly 3D epoch × sample × loss +
    per-sample 2D traces, GFlowNet100.py:333-484), headless: a 3D surface
    of the per-sample loss plus an epoch × sample reward heatmap from
    ``detailed_training_log.csv``.  Returns the PNG path (None when the
    CSV is missing/empty or matplotlib is unavailable)."""
    import csv

    run = Path(run_dir)
    detail = run / "detailed_training_log.csv"
    if not detail.exists():
        return None
    by_epoch: Dict[int, Dict[int, tuple]] = {}
    with open(detail) as f:
        for row in csv.DictReader(f):
            e = int(row["epoch"])
            s = int(row["sample_number"])
            by_epoch.setdefault(e, {})[s] = (float(row["loss"]),
                                             float(row["reward"]))
    if not by_epoch:
        return None
    epochs = sorted(by_epoch)
    n_samples = max(max(d) for d in by_epoch.values())
    loss = np.full((len(epochs), n_samples), np.nan)
    reward = np.full((len(epochs), n_samples), np.nan)
    for i, e in enumerate(epochs):
        for s, (l, r) in by_epoch[e].items():
            loss[i, s - 1] = l
            reward[i, s - 1] = r

    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from mpl_toolkits.mplot3d import Axes3D  # noqa: F401 (side effect)
    except ImportError:
        return None

    # subsample the epoch axis for plottable surfaces on long runs
    step = max(1, len(epochs) // 400)
    ep = np.asarray(epochs)[::step]
    ls = loss[::step]
    rw = reward[::step]
    E, S = np.meshgrid(ep, np.arange(1, n_samples + 1), indexing="ij")

    fig = plt.figure(figsize=(14, 5))
    ax0 = fig.add_subplot(1, 2, 1, projection="3d")
    ax0.plot_surface(E, S, np.log10(np.maximum(np.abs(ls), 1e-12)),
                     cmap="viridis", linewidth=0, antialiased=False)
    ax0.set_xlabel("epoch")
    ax0.set_ylabel("sample")
    ax0.set_zlabel("log10 |loss|")
    ax0.set_title("per-sample loss surface")
    ax1 = fig.add_subplot(1, 2, 2)
    pc = ax1.pcolormesh(ep, np.arange(1, n_samples + 1), rw.T,
                        shading="nearest", cmap="magma")
    fig.colorbar(pc, ax=ax1, label="reward")
    ax1.set_xlabel("epoch")
    ax1.set_ylabel("sample")
    ax1.set_title("per-sample reward")
    fig.tight_layout()
    target = str(out_png or (run / "per_sample.png"))
    fig.savefig(target, dpi=120)
    plt.close(fig)
    return target
