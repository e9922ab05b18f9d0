"""End-to-end session pipeline: load -> filter units -> fit -> decode -> save.

Equivalent of reference pipeline_sr.py (SLURM-targeted single-
session GPLVM pipeline): Kilosort spike counts per probe, unit filtering by
total spikes / mean rate / presence ratio, region+hemisphere selection,
correlation sorting, PoissonGPLVMJump1D fit + decode, npz + mat export.

Unlike the reference (edit-constants-and-run), this script takes CLI args
and has a ``--synthetic`` mode that exercises the full flow on simulated
data (no lab data needed).

Usage:
  python scripts/pipeline_session.py --synthetic --out-dir /tmp/out
  python scripts/pipeline_session.py --data-dir /path/to/session \
      --probes 0 1 --window-size 0.01 --step-size 0.01
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from poor_man_gplvm_tpu.utils.profiling import enable_compilation_cache

enable_compilation_cache()


def parse_args():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data-dir", default=None)
    p.add_argument("--out-dir", default=None)
    p.add_argument("--probes", type=int, nargs="*", default=[0])
    p.add_argument("--window-size", type=float, default=0.01)
    p.add_argument("--step-size", type=float, default=0.01)
    p.add_argument("--use-units", default="good")
    p.add_argument("--min-total-spikes", type=int, default=500)
    p.add_argument("--min-mean-rate", type=float, default=0.01)
    p.add_argument("--min-presence-ratio", type=float, default=0.50)
    p.add_argument("--n-coarse-bins", type=int, default=100)
    p.add_argument("--n-latent-bin", type=int, default=101)
    p.add_argument("--tuning-lengthscale", type=float, default=1.0)
    p.add_argument("--movement-variance", type=float, default=1.0)
    p.add_argument("--n-iter", type=int, default=2)
    p.add_argument("--n-time-per-chunk", type=int, default=10000)
    p.add_argument("--seed", type=int, default=3)
    p.add_argument("--synthetic", action="store_true",
                   help="run on simulated data (smoke test)")
    p.add_argument("--synthetic-T", type=int, default=2000)
    p.add_argument("--synthetic-N", type=int, default=30)
    p.add_argument("--save-figs", action="store_true")
    return p.parse_args()


def load_session_counts(args):
    """Per-probe Kilosort counts -> filtered, concatenated (N, T) matrix."""
    from poor_man_gplvm_tpu import data as pdata

    mats, times_ref = [], None
    for probe in args.probes:
        ks_dir = os.path.join(args.data_dir, f"probe{probe}")
        counts, time_bins, units = pdata.compute_spike_counts_old(
            ks_dir, window_size=args.window_size, step_size=args.step_size,
            use_units=args.use_units, sigma=0, zscore=False,
        )
        total_spikes = counts.sum(axis=1)
        mean_rate = total_spikes / (
            len(time_bins) * args.window_size if len(time_bins) else 1.0
        )
        presence = pdata.get_presence_ratio(
            counts, time_bins, args.n_coarse_bins
        )
        keep = (
            (total_spikes >= args.min_total_spikes)
            & (mean_rate >= args.min_mean_rate)
            & (presence >= args.min_presence_ratio)
        )
        print(
            f"probe {probe}: {keep.sum()}/{len(keep)} units pass filters"
        )
        mats.append(counts[keep])
        times_ref = time_bins
    counts = np.vstack(mats)
    counts = pdata.sort_units(counts, mode="corr")
    return counts, times_ref


def make_synthetic(args):
    import jax.random as jr

    import poor_man_gplvm_tpu as pmg

    gen = pmg.PoissonGPLVMJump1D(
        args.synthetic_N, n_latent_bin=args.n_latent_bin,
        tuning_lengthscale=5.0, movement_variance=args.movement_variance,
    )
    _, spk = gen.sample(args.synthetic_T, key=jr.PRNGKey(0))
    counts = np.asarray(spk).T  # (N, T) like the loaders
    times = np.arange(counts.shape[1]) * args.step_size
    return counts, times


def main():
    args = parse_args()
    out_dir = args.out_dir or os.path.join(args.data_dir or ".", "gplvm")
    os.makedirs(out_dir, exist_ok=True)
    session_name = (
        os.path.basename(args.data_dir) if args.data_dir else "synthetic"
    )

    import jax.random as jr
    from scipy.io import savemat

    import poor_man_gplvm_tpu as pmg

    if args.synthetic:
        counts, times = make_synthetic(args)
    else:
        counts, times = load_session_counts(args)

    print(f"fitting on counts {counts.shape} (units x time bins)")
    model = pmg.PoissonGPLVMJump1D(
        counts.shape[0], n_latent_bin=args.n_latent_bin,
        movement_variance=args.movement_variance,
        tuning_lengthscale=args.tuning_lengthscale,
    )
    em_res = model.fit_em(
        counts.T, key=jr.PRNGKey(args.seed), n_iter=args.n_iter,
        n_time_per_chunk=args.n_time_per_chunk,
    )
    decode_res = model.decode_latent(counts.T)

    latent_posteriors = np.asarray(decode_res["posterior_latent_marg"])
    jump_prob = np.asarray(decode_res["posterior_dynamics_marg"])[:, 1]
    continuous_prob = np.asarray(decode_res["posterior_dynamics_marg"])[:, 0]
    time_array = np.arange(latent_posteriors.shape[0]) * args.step_size

    if args.save_figs:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig_dir = os.path.join(out_dir, "figures")
        os.makedirs(fig_dir, exist_ok=True)
        for neuron in range(min(10, counts.shape[0])):
            plt.figure()
            plt.plot(np.asarray(model.tuning)[:, neuron])
            plt.xlabel("latent bin")
            plt.ylabel("tuning")
            plt.savefig(
                os.path.join(fig_dir, f"tuning_curve_unit_{neuron}.png")
            )
            plt.close()

    base = os.path.join(out_dir, f"{session_name}_gplvm")
    np.savez_compressed(
        f"{base}_posteriors.npz",
        latent_posteriors=latent_posteriors,
        jump_prob=jump_prob,
        continuous_prob=continuous_prob,
        time_array=time_array,
    )
    np.savez_compressed(
        f"{base}_log_marginals.npz",
        log_marginal_l=np.asarray(
            [float(v) for v in em_res["log_marginal_l"]]
        ),
    )
    savemat(
        f"{base}_posteriors.mat",
        {
            "latent_posteriors": latent_posteriors,
            "jump_prob": jump_prob,
            "continuous_prob": continuous_prob,
            "time_seconds": time_array,
        },
    )
    print(f"saved results to {base}_posteriors.[npz|mat]")
    print(
        "log marginal trajectory:",
        [f"{float(v):.1f}" for v in em_res["log_marginal_l"]],
    )


if __name__ == "__main__":
    main()
