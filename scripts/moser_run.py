"""Moser-session pipeline: Bayes-decoder baseline + GPLVM fit/decode.

Equivalent of reference PMGPLVM_moser_run.py, with its two bugs
fixed: it unpacked 6 of preprocess_moser_data's 7 return values
(reference PMGPLVM_moser_run.py:55 vs root core.py:684) and referenced the
nonexistent model attributes ``tuning_curves``/``latent_bin_centers``
(reference PMGPLVM_moser_run.py:202,246-247).

``--synthetic`` exercises the full flow (baseline decoder + GPLVM) on
simulated data.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from poor_man_gplvm_tpu.utils.profiling import enable_compilation_cache

enable_compilation_cache()


def parse_args():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--mat-path", default=None)
    p.add_argument("--out-dir", default=".")
    p.add_argument("--window-size", type=float, default=0.2)
    p.add_argument("--step-size", type=float, default=0.1)
    p.add_argument("--use-units", default="good")
    p.add_argument("--locations", default="both")
    p.add_argument("--n-pos-bins", type=int, default=50)
    p.add_argument("--n-latent-bin", type=int, default=50)
    p.add_argument("--tuning-lengthscale", type=float, default=2.0)
    p.add_argument("--n-iter", type=int, default=5)
    p.add_argument("--seed", type=int, default=3)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--synthetic-T", type=int, default=2000)
    p.add_argument("--synthetic-N", type=int, default=25)
    return p.parse_args()


def main():
    args = parse_args()
    os.makedirs(args.out_dir, exist_ok=True)

    import jax.random as jr
    from scipy.io import savemat

    import poor_man_gplvm_tpu as pmg
    from poor_man_gplvm_tpu.data import PoissonBayesDecoder

    if args.synthetic:
        gen = pmg.PoissonGPLVMJump1D(
            args.synthetic_N, n_latent_bin=args.n_latent_bin,
            tuning_lengthscale=5.0,
        )
        state_l, spk = gen.sample(args.synthetic_T, key=jr.PRNGKey(0))
        counts = np.asarray(spk).T  # (N, T)
        # treat the latent path as 'position' for the supervised baseline
        pos_1d = np.asarray(state_l[:, 1], dtype=float)
        times = np.arange(counts.shape[1]) * args.step_size
        session = "synthetic"
    else:
        from poor_man_gplvm_tpu.data import preprocess_moser_data

        # NOTE: all SEVEN return values (reference bug fixed)
        counts, mean_rates, times, units, x_w, y_w, z_w = (
            preprocess_moser_data(
                args.mat_path, window_size=args.window_size,
                step_size=args.step_size, use_units=args.use_units,
                locations=args.locations,
            )
        )
        pos_1d = x_w  # decode along the x axis
        session = os.path.splitext(os.path.basename(args.mat_path))[0]

    # --- supervised Poisson naive-Bayes baseline (position decoding) ---
    finite = np.isfinite(pos_1d)
    edges = np.linspace(
        np.nanmin(pos_1d), np.nanmax(pos_1d) + 1e-9, args.n_pos_bins + 1
    )
    pos_bins = np.clip(
        np.digitize(pos_1d, edges) - 1, 0, args.n_pos_bins - 1
    )
    split = int(0.8 * counts.shape[1])
    dec = PoissonBayesDecoder(n_bins=args.n_pos_bins)
    dec.fit(counts[:, :split][:, finite[:split]],
            pos_bins[:split][finite[:split]])
    pred = dec.predict(counts[:, split:])
    # score only bins with valid tracking: digitize(NaN) clips to the max
    # bin, which would mix fake labels into the reported error
    test_finite = finite[split:]
    err = np.nanmedian(
        np.abs(pred[test_finite] - pos_bins[split:][test_finite])
    )
    print(f"Bayes baseline: median |bin error| = {err:.1f} "
          f"({args.n_pos_bins} bins)")

    # --- GPLVM fit + decode ---
    model = pmg.PoissonGPLVMJump1D(
        counts.shape[0], n_latent_bin=args.n_latent_bin,
        tuning_lengthscale=args.tuning_lengthscale,
    )
    em_res = model.fit_em(counts.T, key=jr.PRNGKey(args.seed),
                          n_iter=args.n_iter)
    decode_res = model.decode_latent(counts.T)
    latent_map = np.asarray(decode_res["posterior_latent_marg"]).argmax(axis=1)

    # latent vs position correspondence (up to mirror symmetry)
    rho = np.corrcoef(latent_map[finite], pos_bins[finite])[0, 1]
    print(f"GPLVM MAP-latent vs position correlation: {rho:+.2f}")

    base = os.path.join(args.out_dir, f"{session}_moser_gplvm")
    payload = {
        "latent_posteriors": np.asarray(decode_res["posterior_latent_marg"]),
        "jump_prob": np.asarray(decode_res["posterior_dynamics_marg"])[:, 1],
        "latent_map": latent_map,
        # fixed attribute names (reference referenced nonexistent
        # model.tuning_curves / model.latent_bin_centers)
        "tuning": np.asarray(model.tuning),
        "latent_bin_centers": np.arange(args.n_latent_bin),
        "pos_bins": pos_bins,
        "time_array": times,
        "baseline_median_bin_error": err,
        "log_marginal_l": np.asarray(
            [float(v) for v in em_res["log_marginal_l"]]
        ),
    }
    np.savez_compressed(f"{base}.npz", **payload)
    savemat(f"{base}.mat", payload)
    print(f"saved {base}.[npz|mat]")


if __name__ == "__main__":
    main()
