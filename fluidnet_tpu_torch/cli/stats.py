"""Long-horizon divergence stability stats CLI.

Port of fluidnet_tpu.cli.stats, the calcStats path of
fluid_net_train.lua:268-295: restart rollouts from the ground-truth test
frames with the chosen projections and record ||div(U)||_2 per step;
writes a TSV per method and the comparison figure (PrettyPlotNormDiv.m's
plot).

  python -m fluidnet_tpu_torch.cli.stats --dataset gen3d \\
      --model data/models_bundled/m3d_v5_bestRollout \\
      --methods convnet jacobi pcg --n_steps 128 --max_iter 34

It runs on the GPU; `--device cpu` runs on the CPU. The work is split in
two: `compute` (the rollouts and the TSVs, or with --dataset_stats the
dataset's statistics and histograms) and `plot` (the figures, which need
matplotlib). `main` runs both.
"""

import argparse
import json
import os

import numpy as np

from fluidnet_tpu_torch.core.config import ModelConfig
from fluidnet_tpu_torch.core.grids import resolve_device
from fluidnet_tpu_torch.data.dataset import FluidDataset
from fluidnet_tpu_torch.train.train import init_train_state
from fluidnet_tpu_torch.utils.checkpoint import load_checkpoint, load_mconf
from fluidnet_tpu_torch.utils.stats import calc_stats

HIST_FIELDS = ("u_div", "p_div", "density")


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_dir", default="data/datasets")
    ap.add_argument("--dataset", required=True)
    ap.add_argument("--model", default="", help="checkpoint dir (needed for "
                    "the convnet method)")
    ap.add_argument("--methods", nargs="+",
                    default=["convnet", "jacobi", "pcg"])
    ap.add_argument("--n_steps", type=int, default=128)
    ap.add_argument("--n_samples", type=int, default=8)
    ap.add_argument("--max_iter", type=int, default=34,
                    help="matched-cost solver iterations "
                    "(fluid_net_3d_sim.lua:80)")
    ap.add_argument("--pcg_tol", type=float, default=1e-4,
                    help="pcg residual tolerance (pTol, default_conf.lua)")
    ap.add_argument("--polish_iters", type=int, default=0,
                    help="hybrid Jacobi polish sweeps for the convnet "
                    "method (ModelConfig.polish_iters)")
    ap.add_argument("--out_dir", default="data/output/stats")
    ap.add_argument("--dataset_stats", action="store_true",
                    help="instead of rollouts, dump per-field stats + "
                    "histograms of the dataset (data_binary.lua:265-354,"
                    "467-556)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda)")
    return ap.parse_args(argv)


def compute(args):
    """The numbers and files of a stats run, without figures. Rollouts:
    one (n_samples, n_steps) array of ||div||_2 per method, each written
    to out_dir/norm_div_<method>.tsv; returns {method: array}. With
    --dataset_stats: the per-field statistics (printed and written to
    out_dir/dataset_stats.json); returns {field: (counts, edges)}, the
    histograms to plot."""
    ds = FluidDataset(args.data_dir, args.dataset, "te")
    os.makedirs(args.out_dir, exist_ok=True)
    if args.dataset_stats:
        st = ds.field_stats()
        print(json.dumps(st, indent=2))
        with open(os.path.join(args.out_dir, "dataset_stats.json"),
                  "w") as f:
            json.dump(st, f, indent=2)
        return {field: ds.histogram(field) for field in HIST_FIELDS}

    dev = resolve_device(args.device)
    batch = ds.get_batch(list(range(min(args.n_samples, len(ds)))))
    model = None
    if args.model:
        mconf = load_mconf(args.model)
        tstate, mconf, _ = load_checkpoint(
            args.model, init_train_state(0, mconf, dev))
        model = tstate.model
    else:
        mconf = ModelConfig(is_3d=ds.is_3d)

    stats = {}
    for method in args.methods:
        if method == "convnet" and model is None:
            print("skipping convnet (no --model)")
            continue
        mc = mconf.replace(sim_method=method, max_iter=args.max_iter,
                           pcg_tol=args.pcg_tol,
                           polish_iters=(args.polish_iters
                                         if method == "convnet" else 0))
        arr = calc_stats([batch], mc, model if method == "convnet" else None,
                         n_steps=args.n_steps, device=dev)
        stats[method] = arr
        np.savetxt(os.path.join(args.out_dir, f"norm_div_{method}.tsv"),
                   arr, delimiter="\t")
        print(f"{method}: ||div|| mean {arr[:, -1].mean():.4e} at step "
              f"{args.n_steps}")
    return stats


def plot(args, result):
    """The figures of compute's result: the ||div|| comparison, or with
    --dataset_stats one histogram per field. Needs matplotlib (raises
    ImportError without it). Returns the paths written."""
    from fluidnet_tpu_torch.utils.plots import plot_histogram, plot_norm_div
    if args.dataset_stats:
        out = []
        for field, (counts, edges) in result.items():
            out.append(plot_histogram(
                counts, edges, os.path.join(args.out_dir,
                                            f"hist_{field}.png"),
                title=field))
            print("wrote", out[-1])
        return out
    fig = plot_norm_div(result, os.path.join(args.out_dir,
                                             "norm_div_compare.png"))
    print("wrote", fig)
    return [fig]


def main(argv=None):
    args = parse_args(argv)
    return plot(args, compute(args))


if __name__ == "__main__":
    main()
