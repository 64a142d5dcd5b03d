"""Offline analysis of evolution runs (reference: tools/data_analysis.py).

The port of `evosoro_tpu.evo.data_analysis` (numpy, pandas and matplotlib
only): loads the per-generation TSVs that `evo.logging` writes into pandas
frames, merges runs and conditions, and plots fitness time series. Plotting
degrades gracefully when matplotlib is absent.
"""

from __future__ import annotations

import glob
import os

import numpy as np
import pandas as pd

from evosoro_tpu_torch.utils.functional import natural_sort


def get_all_data(exp_dir: str) -> pd.DataFrame:
    """Concatenate every Gen_*.txt stats TSV of one run into a frame
    (reference: data_analysis.py:7-19)."""
    run = pd.DataFrame()
    gen_files = natural_sort(
        glob.glob(os.path.join(exp_dir, "allIndividualsData", "Gen_*.txt"))
    )
    for f in gen_files:
        df = pd.read_csv(f, delimiter="\t\t", engine="python")
        run = pd.concat([run, df], ignore_index=True)
    return run


def combine_experiments(parent_dir: str, condition_names=None) -> pd.DataFrame:
    """Stack runs of multiple conditions, tagging `condition` and `run`
    columns (reference: data_analysis.py:22-33)."""
    frames = []
    conditions = condition_names or sorted(
        d for d in os.listdir(parent_dir)
        if os.path.isdir(os.path.join(parent_dir, d))
    )
    for cond in conditions:
        for i, run_dir in enumerate(
            natural_sort(glob.glob(os.path.join(parent_dir, cond, "*")))
        ):
            if not os.path.isdir(run_dir):
                continue
            df = get_all_data(run_dir)
            if df.empty:
                continue
            df["condition"] = cond
            df["run"] = i
            frames.append(df)
    return pd.concat(frames, ignore_index=True) if frames else pd.DataFrame()


def best_per_generation(df: pd.DataFrame, metric: str = "fitness") -> pd.DataFrame:
    """Best-so-far fitness per generation (the bestOfGen equivalent)."""
    group_cols = [c for c in ("condition", "run") if c in df.columns]
    out = df.groupby(group_cols + ["gen"])[metric].max().reset_index()
    out[metric] = out.groupby(group_cols)[metric].cummax() if group_cols \
        else out[metric].cummax()
    return out


def plot_time_series(df: pd.DataFrame, metric: str = "fitness",
                     save_path: str | None = None):
    """Fitness-vs-generation plot per condition (reference:
    data_analysis.py:36-43, seaborn tsplot → modern lineplot)."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:  # pragma: no cover
        print("matplotlib unavailable; returning data only")
        return best_per_generation(df, metric)

    best = best_per_generation(df, metric)
    fig, ax = plt.subplots(figsize=(7, 4))
    if "condition" in best.columns:
        for cond, grp in best.groupby("condition"):
            series = grp.groupby("gen")[metric]
            mean, std = series.mean(), series.std().fillna(0)
            ax.plot(mean.index, mean.values, label=str(cond))
            ax.fill_between(mean.index, (mean - std).values,
                            (mean + std).values, alpha=0.2)
        ax.legend()
    else:
        series = best.groupby("gen")[metric]
        ax.plot(series.mean().index, series.mean().values)
    ax.set_xlabel("generation")
    ax.set_ylabel(metric)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=120)
    return fig
