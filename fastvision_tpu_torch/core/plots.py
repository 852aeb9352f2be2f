"""Training-curve and dataset plots (port of fastvision_tpu/core/plots.py):
metric curves from a `MetricLogger` JSONL file, the anchor k-means scatter,
and mAP curves of an `ops.map.MAPResult`. Each writes a PNG with
matplotlib's headless Agg backend; matplotlib is imported inside the
functions."""
from __future__ import annotations

import json
import os

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_metrics(jsonl_path: str, out_path: str, keys: list[str] | None = None) -> str:
    """One panel per metric (default: every numeric key but step, time and
    epoch) against the step, from a `MetricLogger` JSONL file. -> ``out_path``."""
    rows = []
    with open(jsonl_path) as f:
        for line in f:
            try:
                rows.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    if not rows:
        raise ValueError(f"no records in {jsonl_path}")
    if keys is None:
        keys = sorted({k for r in rows for k, v in r.items()
                       if isinstance(v, (int, float)) and k not in ("step", "time", "epoch")})
    plt = _plt()
    fig, axes = plt.subplots(1, len(keys), figsize=(4 * len(keys), 3), squeeze=False)
    for ax, key in zip(axes[0], keys):
        pts = [(r["step"], r[key]) for r in rows if key in r]
        if pts:
            xs, ys = zip(*pts)
            ax.plot(xs, ys)
        ax.set_title(key)
        ax.set_xlabel("step")
        ax.grid(alpha=0.3)
    fig.tight_layout()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, dpi=100)
    plt.close(fig)
    return out_path


def plot_anchors(wh: np.ndarray, centers: np.ndarray, assign: np.ndarray, out_path: str) -> str:
    """The dataset's (w, h) coloured by cluster, and the anchor centers.
    -> ``out_path``."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(5, 5))
    ax.scatter(wh[:, 0], wh[:, 1], c=assign, s=4, alpha=0.5, cmap="tab10")
    ax.scatter(centers[:, 0], centers[:, 1], c="black", marker="x", s=80)
    ax.set_xlabel("width")
    ax.set_ylabel("height")
    ax.set_title(f"anchor k-means (k={len(centers)})")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, dpi=100)
    plt.close(fig)
    return out_path


def plot_pr_curves(result, out_dir: str, class_names: list[str] | None = None) -> list[str]:
    """mAP against the IoU threshold and AP@0.5 per class of an
    `ops.map.MAPResult`. -> the two PNG paths in ``out_dir``."""
    plt = _plt()
    os.makedirs(out_dir, exist_ok=True)
    paths = []

    fig, ax = plt.subplots(figsize=(5, 3))
    ax.plot(result.iou_thresholds, result.map_per_iou, marker="o")
    ax.set_xlabel("IoU threshold")
    ax.set_ylabel("mAP")
    ax.grid(alpha=0.3)
    p = os.path.join(out_dir, "map_vs_iou.png")
    fig.tight_layout()
    fig.savefig(p, dpi=100)
    plt.close(fig)
    paths.append(p)

    fig, ax = plt.subplots(figsize=(max(4, len(result.classes) * 0.5), 3))
    names = [class_names[int(c)] if class_names else str(int(c)) for c in result.classes]
    ax.bar(names, result.ap_per_class_per_iou[:, 0])
    ax.set_ylabel("AP@0.5")
    ax.tick_params(axis="x", rotation=60)
    p = os.path.join(out_dir, "ap_per_class.png")
    fig.tight_layout()
    fig.savefig(p, dpi=100)
    plt.close(fig)
    paths.append(p)
    return paths
