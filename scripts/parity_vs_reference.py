"""Automated reference-parity harness (BASELINE.json acceptance: the rebuilt
framework must match the reference's `log_marginal_l` to <= 1e-5 relative).

Imports BOTH packages in one CPU process — the actual reference at
/root/reference (with pynapple/jaxopt stubbed, scripts/_reference_stubs.py)
and this repo's `poor_man_gplvm_tpu` — pins identical params + posterior
init, then compares:

* `fit_em` `log_marginal_l` over >= 3 EM iterations for all four model
  classes (reference core.py:668 jump, core.py:335 latent-only)
* `decode_latent` with a shared tuning: `log_marginal_final`, the full
  posterior, one-step predictive marginals, and the transition-posterior
  dict — 12 keys joint (reference decoder.py:360-373), 4 keys latent-only
  (decoder_latentonly.py:242-247)
* naive-Bayes decoding (reference decoder.py:88-149)

for BOTH inference engines ('prob' and 'log').

Run:  python scripts/parity_vs_reference.py [--quick]
Writes PARITY.json at the repo root, exits nonzero on any tolerance breach.
The same checks run in pytest via `tests/test_reference_parity.py`
(marker: reference).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

_SCRIPTS = os.path.dirname(os.path.abspath(__file__))
_REPO = os.path.dirname(_SCRIPTS)
sys.path.insert(0, _SCRIPTS)
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

from _reference_stubs import (  # noqa: E402
    install_reference_stubs,
    reference_available,
)

HAVE_REFERENCE = reference_available()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import warnings  # noqa: E402

# The REFERENCE embeds -1e40 constants (core.py:250/582, decoder.py:240)
# that overflow to -inf with a RuntimeWarning when jax casts them to
# f32.  poor_man_gplvm_tpu uses an f32-representable sentinel and emits
# no such warning (asserted by the verify drive); this filter only
# silences the reference side of the comparison.
warnings.filterwarnings(
    "ignore", message="overflow encountered in cast",
    category=RuntimeWarning,
)
import jax.random as jr  # noqa: E402
import numpy as np  # noqa: E402

TOL_LOG_MARGINAL = 1e-5   # BASELINE.json:5 acceptance
TOL_POSTERIOR = 1e-4      # abs, probabilities in [0, 1]
# posterior after n_iter full EM rounds: the Adam while_loop's stopping
# iteration can differ by one between implementations under float32
# (reference fit_tuning_helper.py:154-164), compounding into the E-step;
# informational with a loose bound — the acceptance metric is log_marginal_l
TOL_FIT_POSTERIOR = 1e-2

# (name, kind, ref class name) — classes share names across packages
MODEL_CASES = [
    ("poisson_jump", "poisson", "PoissonGPLVMJump1D"),
    ("gaussian_jump", "gaussian", "GaussianGPLVMJump1D"),
    ("poisson_latentonly", "poisson", "PoissonGPLVM1D"),
    ("gaussian_latentonly", "gaussian", "GaussianGPLVM1D"),
]

JOINT_TRANSITION_KEYS = [
    "p_joint_full", "p_joint_latent", "p_joint_dynamics",
    "p_transition_full", "p_transition_latent", "p_transition_dynamics",
    "log_joint_full", "log_joint_latent", "log_joint_dynamics",
    "log_transition_full", "log_transition_latent",
    "log_transition_dynamics",
]
LATENT_TRANSITION_KEYS = [
    "p_joint_latent", "p_transition_latent",
    "log_joint_latent", "log_transition_latent",
]


def rel_err(ours, ref):
    ours = np.asarray(ours, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    denom = max(float(np.max(np.abs(ref))), 1e-12)
    return float(np.max(np.abs(ours - ref)) / denom)


def log_rel_err(ours, ref):
    """rel_err over entries whose reference log-prob is non-negligible.

    The log-space transition-posterior keys carry -inf / -1e40 sentinels for
    never-visited transitions (reference decoder.py:240); those entries carry
    no probability mass (exp < 2e-22) and their log values are
    representation-dependent, so parity is asserted on the populated ones
    (the p_* keys cover the full arrays in prob space)."""
    ours = np.asarray(ours, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    mask = np.isfinite(ref) & (ref > -50.0)
    if not mask.any():
        return 0.0
    denom = max(float(np.max(np.abs(ref[mask]))), 1e-12)
    return float(np.max(np.abs(ours[mask] - ref[mask])) / denom)


def abs_err(ours, ref):
    return float(
        np.max(np.abs(np.asarray(ours, np.float64) - np.asarray(ref, np.float64)))
    )


def make_data(kind, T, N, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "poisson":
        return rng.poisson(1.0, size=(T, N)).astype(np.float32)
    return rng.normal(1.0, 1.0, size=(T, N)).astype(np.float32)


def build_models(case_name, ref_cls_name, engine, N, L):
    install_reference_stubs()
    import poor_man_gplvm as ref_pkg
    import poor_man_gplvm_tpu as pmg_pkg

    kwargs = dict(
        n_latent_bin=L, tuning_lengthscale=5.0, movement_variance=1.0,
        rng_init_int=123,
    )
    if "jump" in case_name:
        kwargs.update(p_move_to_jump=0.02, p_jump_to_move=0.05)
    if ref_cls_name.startswith("Gaussian"):
        kwargs["noise_std"] = 0.7

    ref_model = getattr(ref_pkg, ref_cls_name)(N, **kwargs)
    pmg_model = getattr(pmg_pkg, ref_cls_name)(
        N, inference_engine=engine, **kwargs
    )
    # pin identical params (both packages init from rng_init, but parity
    # must not depend on matching jax.random call order)
    pmg_model.params = jnp.asarray(np.asarray(ref_model.params))
    pmg_model.tuning = jnp.asarray(np.asarray(ref_model.tuning))
    return ref_model, pmg_model


def run_case(case_name, kind, ref_cls_name, engine, T=300, N=12, L=25,
             n_iter=3, n_time_per_chunk=97):
    """Fit + decode + NB-decode parity for one model class / engine."""
    ref_model, pmg_model = build_models(case_name, ref_cls_name, engine, N, L)
    y = make_data(kind, T, N)

    # shared posterior init from the reference's own sampler
    log_post_init, _ = ref_model.init_latent_posterior(T, jr.PRNGKey(7))
    # the reference floors -inf at -1e40 (core.py:250), which overflows
    # with a RuntimeWarning on the f64->f32 device cast; clamp to the
    # f32-representable sentinel (both carry zero probability mass)
    log_post_init_np = np.maximum(
        np.asarray(log_post_init, dtype=np.float64), -3.0e38
    ).astype(np.float32)

    errs = {}

    em_ref = ref_model.fit_em(
        y, key=jr.PRNGKey(3), n_iter=n_iter,
        log_posterior_init=jnp.asarray(log_post_init_np),
        n_time_per_chunk=n_time_per_chunk, verboase=False,
    )
    em_pmg = pmg_model.fit_em(
        y, key=jr.PRNGKey(3), n_iter=n_iter,
        log_posterior_init=jnp.asarray(log_post_init_np),
        n_time_per_chunk=n_time_per_chunk, verboase=False,
    )
    errs["fit_log_marginal_l"] = rel_err(
        np.asarray(em_pmg["log_marginal_l"]), np.asarray(em_ref["log_marginal_l"])
    )
    errs["fit_posterior"] = abs_err(em_pmg["posterior"], em_ref["posterior"])

    # decode with the SAME tuning so decode parity is isolated from any
    # M-step drift
    tuning = jnp.asarray(np.asarray(em_ref["tuning"]))
    dec_ref = ref_model.decode_latent(
        y, tuning=tuning, n_time_per_chunk=n_time_per_chunk
    )
    dec_pmg = pmg_model.decode_latent(
        y, tuning=tuning, n_time_per_chunk=n_time_per_chunk
    )
    errs["decode_log_marginal_final"] = rel_err(
        dec_pmg["log_marginal_final"], dec_ref["log_marginal_final"]
    )
    errs["decode_posterior_all"] = abs_err(
        dec_pmg["posterior_all"], dec_ref["posterior_all"]
    )
    errs["decode_one_step_pred"] = rel_err(
        dec_pmg["log_one_step_predictive_marginals_all"],
        dec_ref["log_one_step_predictive_marginals_all"],
    )
    tkeys = (
        JOINT_TRANSITION_KEYS if "jump" in case_name else LATENT_TRANSITION_KEYS
    )
    for k in tkeys:
        fn = abs_err if k.startswith("p_") else log_rel_err
        errs[f"decode_{k}"] = fn(dec_pmg[k], dec_ref[k])

    nb_ref = ref_model.decode_latent_naive_bayes(
        y, tuning=tuning, n_time_per_chunk=n_time_per_chunk
    )
    nb_pmg = pmg_model.decode_latent_naive_bayes(
        y, tuning=tuning, n_time_per_chunk=n_time_per_chunk
    )
    errs["nb_log_marginal_total"] = rel_err(
        nb_pmg["log_marginal_total"], nb_ref["log_marginal_total"]
    )
    errs["nb_posterior_latent"] = abs_err(
        nb_pmg["posterior_latent"], nb_ref["posterior_latent"]
    )
    return errs


def run_gain_case(engine, T=300, N=12, L=25, n_iter=3, n_time_per_chunk=97):
    """Parity for the experimental gain model (VERDICT round-2 missing #2):
    fit_em with per-iteration gain refits + gain-aware naive-Bayes decode
    with gain-refit iterations, vs the actual reference
    (reference experimental/core_exp.py:172-293, :95-126)."""
    install_reference_stubs()
    # the reference experimental dir has no __init__.py — import the module
    from poor_man_gplvm.experimental.core_exp import (
        PoissonGPLVMGain1D_gain as RefGain,
    )
    from poor_man_gplvm_tpu.experimental import (
        PoissonGPLVMGain1D_gain as PmgGain,
    )

    kwargs = dict(
        n_latent_bin=L, tuning_lengthscale=5.0, movement_variance=1.0,
        p_move_to_jump=0.02, p_jump_to_move=0.05, rng_init_int=123,
    )
    ref_model = RefGain(N, **kwargs)
    pmg_model = PmgGain(N, inference_engine=engine, **kwargs)
    pmg_model.params = jnp.asarray(np.asarray(ref_model.params))
    pmg_model.tuning = jnp.asarray(np.asarray(ref_model.tuning))

    y = make_data("poisson", T, N)
    log_post_init, _ = ref_model.init_latent_posterior(T, jr.PRNGKey(7))
    # the reference floors -inf at -1e40 (core.py:250), which overflows
    # with a RuntimeWarning on the f64->f32 device cast; clamp to the
    # f32-representable sentinel (both carry zero probability mass)
    log_post_init_np = np.maximum(
        np.asarray(log_post_init, dtype=np.float64), -3.0e38
    ).astype(np.float32)

    errs = {}
    em_kw = dict(
        key=jr.PRNGKey(3), n_iter=n_iter,
        log_posterior_init=jnp.asarray(log_post_init_np),
        n_time_per_chunk=n_time_per_chunk,
    )
    em_ref = ref_model.fit_em(y, **em_kw)
    em_pmg = pmg_model.fit_em(y, **em_kw)
    errs["fit_log_marginal_l"] = rel_err(
        np.asarray(em_pmg["log_marginal_l"]),
        np.asarray(em_ref["log_marginal_l"]),
    )
    errs["fit_posterior"] = abs_err(em_pmg["posterior"], em_ref["posterior"])
    errs["fit_gain"] = rel_err(
        np.asarray(em_pmg["gain_saved"][-1]), np.asarray(em_ref["gain_saved"][-1])
    )

    # gain-aware NB decode with 2 gain-refit iterations, same tuning, gain
    # starting from ones — isolated from M-step drift
    tuning = jnp.asarray(np.asarray(em_ref["tuning"]))
    nb_kw = dict(tuning=tuning, n_time_per_chunk=n_time_per_chunk,
                 gain=jnp.ones(T), gain_refit_n_iter=2)
    nb_ref = ref_model.decode_latent_naive_bayes(y, **nb_kw)
    nb_pmg = pmg_model.decode_latent_naive_bayes(y, **nb_kw)
    errs["nb_log_marginal_total"] = rel_err(
        nb_pmg["log_marginal"], nb_ref["log_marginal"]
    )
    errs["nb_posterior_latent"] = abs_err(
        np.exp(np.asarray(nb_pmg["log_posterior"])),
        np.exp(np.asarray(nb_ref["log_posterior"])),
    )
    return errs


def run_basis_tuning_case(T=400, N=10, L=25, rank=6):
    """Parity for the legacy basis-weighted tuning path (BASELINE.json
    config 4; reference fit_tuning_with_basis.py:13-96).

    The reference's SOLVER (jaxopt.LBFGS, stubbed here) can't run, so the
    case pins function-level parity on everything up to the solver — the
    (w, b) GLM link, the grouped statistics and the per-neuron objective
    at pinned params must match the actual reference code to float32
    exactness — and self-checks that our optax.lbfgs solve improves the
    objective it just agreed on."""
    install_reference_stubs()
    import poor_man_gplvm.fit_tuning_with_basis as ref_ftb

    # the reference does `import jax.scipy.special as jscipy` then calls
    # `jscipy.special.xlogy` (fit_tuning_with_basis.py:10,87) — valid on
    # its pinned jax 0.4.26, an AttributeError on current jax; point the
    # alias at jax.scipy so the nested `.special` access resolves
    ref_ftb.jscipy = jax.scipy

    from poor_man_gplvm_tpu.ops import fit_tuning_with_basis as pmg_ftb

    rng = np.random.default_rng(0)
    spk = jnp.asarray(rng.poisson(1.0, size=(T, N)).astype(np.float32))
    post = rng.dirichlet(np.ones(L), size=T).astype(np.float32)
    post = jnp.asarray(post)
    basis = jnp.asarray(rng.normal(size=(L, rank)).astype(np.float32))
    w = jnp.asarray((rng.normal(size=(rank, N)) * 0.3).astype(np.float32))
    b = jnp.asarray((rng.normal(size=(N,)) * 0.1).astype(np.float32))
    prior_hyper = 1.0

    errs = {}
    errs["basis_glm_tuning"] = rel_err(
        pmg_ftb.glm_get_tuning((w, b), basis),
        ref_ftb.glm_get_tuning((w, b), basis),
    )
    s_ref, t_ref = ref_ftb.group_spk_occupancy_chunk_neuron(
        spk, post, n_neuron_per_chunk=4
    )
    s_pmg, t_pmg = pmg_ftb.group_spk_occupancy_chunk_neuron(
        spk, post, n_neuron_per_chunk=4
    )
    errs["basis_stats_s_b"] = rel_err(s_pmg, s_ref)
    errs["basis_stats_t_b"] = rel_err(t_pmg, t_ref)
    obj_ref = ref_ftb.get_log_poisson_p_y_joint_params_oneneuron_grouped(
        (w[:, 0], b[0]), s_ref[:, 0], basis, t_ref, prior_hyper
    )
    obj_pmg = pmg_ftb.get_log_poisson_p_y_joint_params_oneneuron_grouped(
        (w[:, 0], b[0]), s_pmg[:, 0], basis, t_pmg, prior_hyper
    )
    errs["basis_objective"] = rel_err(obj_pmg, obj_ref)

    # solver self-check on the agreed objective: final summed loss must
    # improve on the init (jaxopt.LBFGS itself is stubbed, so the
    # reference solver output is unavailable for comparison)
    init_loss = sum(
        float(pmg_ftb.get_log_poisson_p_y_joint_params_oneneuron_grouped(
            (w[:, n], b[n]), s_pmg[:, n], basis, t_pmg, prior_hyper
        ))
        for n in range(N)
    )
    _, _, final_err = pmg_ftb.m_step_get_tuning_all_neuron_grouped(
        (w, b), spk, basis, post, prior_hyper, maxiter=30
    )
    errs["basis_solver_improves"] = (
        0.0 if float(final_err) < -init_loss else float("inf")
    )
    return errs


def check_case_errs(errs):
    """Return list of (key, err, tol) tolerance breaches."""
    bad = []
    for k, v in errs.items():
        if k in ("fit_posterior", "fit_gain"):
            # both inherit per-iteration Adam while_loop stopping jitter
            tol = TOL_FIT_POSTERIOR
        elif "posterior" in k or k.startswith("decode_p_"):
            tol = TOL_POSTERIOR
        else:
            tol = TOL_LOG_MARGINAL
        if not np.isfinite(v) or v > tol:
            bad.append((k, v, tol))
    return bad


def run_all(engines=("prob", "log"), quick=False):
    results = {}
    cases = MODEL_CASES[:1] if quick else MODEL_CASES
    for case_name, kind, ref_cls in cases:
        for engine in engines:
            key = f"{case_name}[{engine}]"
            errs = run_case(case_name, kind, ref_cls, engine)
            results[key] = errs
            worst = max(errs.values())
            bad = check_case_errs(errs)
            status = "OK" if not bad else f"FAIL {bad}"
            print(f"{key:32s} worst={worst:.2e}  {status}", file=sys.stderr)
    if not quick:
        for engine in engines:
            key = f"poisson_gain[{engine}]"
            errs = run_gain_case(engine)
            results[key] = errs
            worst = max(errs.values())
            bad = check_case_errs(errs)
            status = "OK" if not bad else f"FAIL {bad}"
            print(f"{key:32s} worst={worst:.2e}  {status}", file=sys.stderr)
        key = "fit_tuning_with_basis"
        errs = run_basis_tuning_case()
        results[key] = errs
        worst = max(errs.values())
        bad = check_case_errs(errs)
        status = "OK" if not bad else f"FAIL {bad}"
        print(f"{key:32s} worst={worst:.2e}  {status}", file=sys.stderr)
    return results


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="flagship class only")
    args = ap.parse_args()

    if not HAVE_REFERENCE:
        print("reference not found at /root/reference; nothing to compare",
              file=sys.stderr)
        sys.exit(2)

    results = run_all(quick=args.quick)
    n_bad = sum(len(check_case_errs(e)) for e in results.values())
    summary = {
        # the FULL tolerance scheme (VERDICT r3 next #8): every error in
        # `cases` is judged against exactly one of these three bars —
        # see check_case_errs for the key -> tolerance mapping
        "tol_log_marginal": TOL_LOG_MARGINAL,
        "tol_posterior": TOL_POSTERIOR,
        "tol_fit_posterior": TOL_FIT_POSTERIOR,
        "tol_scheme": {
            "fit_posterior|fit_gain": TOL_FIT_POSTERIOR,
            "*posterior*|decode_p_*": TOL_POSTERIOR,
            "everything_else(log-marginal rel)": TOL_LOG_MARGINAL,
        },
        "n_breaches": n_bad,
        "worst_fit_log_marginal_rel": max(
            e["fit_log_marginal_l"] for e in results.values()
            if "fit_log_marginal_l" in e  # basis case is function-level
        ),
        "cases": results,
    }
    out = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "PARITY.json")
    with open(out, "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps({
        "parity_ok": n_bad == 0,
        "worst_fit_log_marginal_rel": summary["worst_fit_log_marginal_rel"],
        "n_cases": len(results),
    }))
    sys.exit(0 if n_bad == 0 else 1)


if __name__ == "__main__":
    main()
