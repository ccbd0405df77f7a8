"""Paper-figure plots (matplotlib replaces the MATLAB scripts).

Equivalents of torch/utils/*.m (SURVEY.md §2.2 "MATLAB plotting"):
  plot_epochs    PlotEpochs.m      — train/test loss curves per epoch
  plot_norm_div  PrettyPlotNormDiv.m — ||div(U)|| vs rollout timestep,
                 mean +- spread over samples, per solver

A copy of fluidnet_tpu.utils.plots. matplotlib is imported when a plot is
drawn, so the rest of the port runs without it; a plot without it raises.
"""

import numpy as np


def _mpl():
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("plotting needs matplotlib, which is not "
                          "installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plot_epochs(log_path, out_path, columns=("tr_loss", "te_loss")):
    """Loss-vs-epoch curves from a Logger TSV file."""
    from fluidnet_tpu_torch.utils.logger import read_log
    plt = _mpl()
    names, rows = read_log(log_path)
    rows = np.asarray(rows)
    epoch = rows[:, names.index("epoch")]
    fig, ax = plt.subplots(figsize=(6, 4))
    for col in columns:
        if col in names:
            ax.semilogy(epoch, rows[:, names.index(col)], label=col)
    ax.set_xlabel("epoch")
    ax.set_ylabel("loss")
    ax.legend()
    ax.grid(True, alpha=0.3)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_norm_div(stats_by_name, out_path):
    """||div||-vs-step stability plot; stats_by_name maps label ->
    (n_samples, n_steps) arrays from utils.stats.calc_stats."""
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(6, 4))
    for name, arr in stats_by_name.items():
        arr = np.asarray(arr)
        steps = np.arange(1, arr.shape[1] + 1)
        mean = arr.mean(axis=0)
        lo = np.percentile(arr, 10, axis=0)
        hi = np.percentile(arr, 90, axis=0)
        (line,) = ax.semilogy(steps, mean, label=name)
        ax.fill_between(steps, lo, hi, alpha=0.2, color=line.get_color())
    ax.set_xlabel("timestep")
    ax.set_ylabel(r"$\|\nabla \cdot U\|_2$")
    ax.legend()
    ax.grid(True, alpha=0.3)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_histogram(counts, edges, out_path, title="", logy=True):
    """Dataset value-distribution bar plot (data_binary.lua:532-556's
    gnuplot histograms); feed from FluidDataset.histogram()."""
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(6, 4))
    edges = np.asarray(edges)
    centers = 0.5 * (edges[:-1] + edges[1:])
    ax.bar(centers, np.asarray(counts),
           width=float(edges[1] - edges[0]) * 0.95)
    if logy:
        ax.set_yscale("log")
    ax.set_xlabel("value")
    ax.set_ylabel("count")
    if title:
        ax.set_title(title)
    ax.grid(True, alpha=0.3)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path
