"""Model selection: hyperparameter grids, multi-chain fitting, evaluation.

Equivalent of the reference selection subsystem
(reference: poor_man_gplvm/model_selection_helper.py).  API and metric
definitions match; the per-(config x chain) fan-out can additionally run as
one SPMD program over a device mesh (see poor_man_gplvm_tpu.parallel.sweep).
"""

from __future__ import annotations

import itertools
from functools import partial

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pandas as pd

from poor_man_gplvm_tpu.models.jump1d import (
    GaussianGPLVMJump1D,
    PoissonGPLVMJump1D,
)
from poor_man_gplvm_tpu.models.latent1d import GaussianGPLVM1D, PoissonGPLVM1D

__all__ = [
    "model_class_dict",
    "default_fit_kwargs",
    "generate_hyperparam_grid",
    "fit_model_one_config",
    "evaluate_model_one_config",
    "model_selection_one_split",
    "get_downsampled_lml",
    "get_jump_consensus",
    "get_jump_consensus_shuffle",
    "get_lml_test_history",
]

model_class_dict = {
    "poisson": PoissonGPLVMJump1D,
    "gaussian": GaussianGPLVMJump1D,
    "poisson_latentonly": PoissonGPLVM1D,
    "gaussian_latentonly": GaussianGPLVM1D,
}

default_fit_kwargs = {
    "n_iter": 20,
    "log_posterior_init": None,
    # None = HBM-driven auto chunking (single chunk when it fits); the
    # reference pins 10000 (model_selection_helper.py:16) but chunking is
    # exact so only memory/latency differ
    "n_time_per_chunk": None,
    "dt": 1.0,
    "likelihood_scale": 1.0,
    "save_every": None,
    "posterior_init_kwargs": {"random_scale": 0.1},
}


def generate_hyperparam_grid(hyperparam_ranges):
    """Dict of lists -> list of all combinations + DataFrame
    (reference model_selection_helper.py:18-33)."""
    keys = list(hyperparam_ranges.keys())
    combos = itertools.product(*[hyperparam_ranges[k] for k in keys])
    hyper_grid_l = [dict(zip(keys, combo)) for combo in combos]
    hyper_grid_df = pd.DataFrame(hyper_grid_l)
    return hyper_grid_l, hyper_grid_df


def fit_model_one_config(
    config, y_train, key=None, fit_kwargs=default_fit_kwargs,
    model_class_str="poisson", n_repeat=1,
):
    """Fit ``n_repeat`` chains of one configuration
    (reference model_selection_helper.py:35-60)."""
    key = jr.PRNGKey(0) if key is None else key
    if model_class_str not in model_class_dict:
        raise ValueError(f"Invalid model class: {model_class_str}")
    model_class = model_class_dict[model_class_str]
    key_l = key if isinstance(key, list) else jr.split(key, n_repeat)
    model_fit_l, em_res_l = [], []
    for k in key_l:
        model_fit = model_class(n_neuron=y_train.shape[1], **config)
        em_res = model_fit.fit_em(y_train, hyperparam={}, key=k, **fit_kwargs)
        em_res_l.append(em_res)
        model_fit_l.append(model_fit)
    return model_fit_l, em_res_l


def evaluate_model_one_config(
    model_fit_l,
    y_test,
    key=None,
    n_time_per_chunk=None,
    latent_downsample_frac=(0.2, 0.4, 0.6, 0.8),
    downsample_n_repeat=10,
    metric_type_l=(
        "log_marginal_test",
        "log_one_step_predictive_marginal_test",
        "downsampled_lml",
        "jump_consensus",
    ),
    jump_dynamics_index=1,
    jump_consensus_window_size=5,
    jump_consensus_jump_p_thresh=0.4,
    jump_consensus_consensus_thresh=0.8,
):
    """Per-chain evaluation metrics + best chain per metric
    (reference model_selection_helper.py:62-143).

    The overall metric is the mean of the downsampled-LML metrics
    (reference model_selection_helper.py:130-138)."""
    key = jr.PRNGKey(1) if key is None else key
    latent_downsample_frac = list(latent_downsample_frac)
    metric_type_l = list(metric_type_l)

    decoding_res_l = [
        m.decode_latent(y_test, n_time_per_chunk=n_time_per_chunk)
        for m in model_fit_l
    ]

    lml_test = [float(d["log_marginal_final"]) for d in decoding_res_l]
    one_step_sum = [
        float(np.asarray(d["log_one_step_predictive_marginals_all"]).sum())
        for d in decoding_res_l
    ]
    dyn_marg_l = (
        [np.asarray(d["posterior_dynamics_marg"]) for d in decoding_res_l]
        if "jump_consensus" in metric_type_l
        else None
    )
    masked_lml_per_frac = {}
    if "downsampled_lml" in metric_type_l:
        for frac in latent_downsample_frac:
            masked_lml_per_frac[frac] = [
                np.array(
                    [
                        get_downsampled_lml(
                            m, y_test, downsample_frac=frac,
                            n_repeat=downsample_n_repeat, key=key,
                        )["value"]
                    ]
                )
                for m in model_fit_l
            ]

    return _assemble_eval_from_parts(
        lml_test, one_step_sum, dyn_marg_l, masked_lml_per_frac,
        metric_type_l, latent_downsample_frac, jump_dynamics_index,
        jump_consensus_window_size, jump_consensus_jump_p_thresh,
        jump_consensus_consensus_thresh,
    )


#: fit_em kwargs the batched backend honors (all other keys force the
#: serial path; n_time_per_chunk/save_every only change memory/em_res
#: retention, not results — chunking is exact)
_BATCHED_FIT_KWARGS = frozenset({
    "n_iter", "log_posterior_init", "n_time_per_chunk", "dt",
    "likelihood_scale", "save_every", "posterior_init_kwargs", "verboase",
    "verbose", "m_step_step_size", "m_step_maxiter", "m_step_tol",
})


def _batched_backend_applicable(hyperparam_dict, fit_kwargs, model_class_str,
                                n_configs, n_repeat):
    from poor_man_gplvm_tpu.parallel import sweep as _sweep

    if model_class_str not in model_class_dict:
        return False
    if n_configs * n_repeat <= 1:
        return False
    # check against THIS family's ctor keys, not the all-family union:
    # e.g. noise_std on a poisson class must fall through to the serial
    # path so its immediate TypeError surfaces before any device work
    if set(hyperparam_dict) - set(_sweep._config_defaults(model_class_str)):
        return False
    if set(fit_kwargs) - _BATCHED_FIT_KWARGS:
        return False
    if fit_kwargs.get("log_posterior_init") is not None:
        return False
    # the batched init reads only random_scale; unknown init kwargs must
    # take the serial path, which raises TypeError like the reference
    if set(fit_kwargs.get("posterior_init_kwargs") or {}) - {"random_scale"}:
        return False
    if float(fit_kwargs.get("dt", 1.0)) != 1.0:
        return False
    return True


def model_selection_one_split(
    y,
    hyperparam_dict,
    train_index=None,
    test_index=None,
    test_frac=0.2,
    key=None,
    model_to_return_type="best_overall",
    fit_kwargs=default_fit_kwargs,
    model_class_str="poisson",
    n_repeat=5,
    latent_downsample_frac=(0.2, 0.4, 0.6, 0.8),
    downsample_n_repeat=10,
    metric_type_l=(
        "log_marginal_test",
        "log_one_step_predictive_marginal_test",
        "downsampled_lml",
        "jump_consensus",
    ),
    jump_dynamics_index=1,
    jump_consensus_window_size=5,
    jump_consensus_jump_p_thresh=0.4,
    jump_consensus_consensus_thresh=0.8,
    verbose=True,
    backend="auto",
    mesh=None,
):
    """Fit + evaluate all grid configs on one contiguous train/test split
    (reference model_selection_helper.py:145-239).

    ``backend``:

    * ``'serial'`` — the reference's host loop over configs x chains.
    * ``'batched'`` — the whole (config x chain) tree runs as bucketed
      vmapped device programs (fit, test decodes, every downsampled-LML
      mask decode), numerically matching the serial path
      (poor_man_gplvm_tpu.parallel.sweep).  Requires all swept keys and
      fit_kwargs to be batchable (see ``_batched_backend_applicable``).
    * ``'auto'`` (default) — 'batched' whenever applicable and more than
      one run is requested.

    ``mesh``: optional ``jax.sharding.Mesh`` — the batched backend shards
    every program's run axis over all mesh devices (pure DP; results are
    identical to the single-device batched path).  Requires the batched
    backend to be applicable.
    """
    key = jr.PRNGKey(0) if key is None else key
    if backend not in ("auto", "serial", "batched"):
        raise ValueError(f"unknown backend {backend!r}")
    if mesh is not None and backend == "serial":
        raise ValueError(
            "mesh= requires the batched backend (the serial host loop "
            "runs one device program per config)"
        )
    if backend != "serial":
        n_configs = int(
            np.prod([len(v) for v in hyperparam_dict.values()])
        ) if hyperparam_dict else 1
        applicable = _batched_backend_applicable(
            hyperparam_dict, fit_kwargs, model_class_str, n_configs, n_repeat
        )
        if (backend == "batched" or mesh is not None) and not applicable:
            raise ValueError(
                "backend='batched' cannot handle this grid/fit_kwargs "
                "combination (shape-incompatible or unsupported keys) — "
                "use backend='serial'"
            )
        if applicable:
            return _model_selection_one_split_batched(
                y, hyperparam_dict, train_index, test_index, test_frac, key,
                model_to_return_type, fit_kwargs, model_class_str, n_repeat,
                latent_downsample_frac, downsample_n_repeat, metric_type_l,
                jump_dynamics_index, jump_consensus_window_size,
                jump_consensus_jump_p_thresh, jump_consensus_consensus_thresh,
                verbose, mesh=mesh,
            )
    T, n_neuron = y.shape
    metric_type_l = list(metric_type_l)

    if "latentonly" in model_class_str:
        metric_type_l = [m for m in metric_type_l if "jump" not in m]

    if train_index is None:
        train_index = slice(0, int(T * (1 - test_frac)))
    if test_index is None:
        test_index = slice(int(T * (1 - test_frac)), T)
    y_train = jnp.array(y[train_index])
    y_test = jnp.array(y[test_index])

    hyperparam_grid_l, hyperparam_grid_df = generate_hyperparam_grid(
        hyperparam_dict
    )
    model_eval_result_all_configs = {}

    best_model, best_model_l, best_config = None, None, None
    model_to_return_l = []
    metric_overall_best = -np.inf

    fit_kwargs = dict(fit_kwargs)
    if fit_kwargs.get("log_posterior_init") is not None:
        fit_kwargs["log_posterior_init"] = fit_kwargs["log_posterior_init"][
            train_index
        ]

    for ii, param_dict in enumerate(hyperparam_grid_l):
        if verbose:
            print(f"== Config {ii + 1} of {len(hyperparam_grid_l)} ==")
        key, _ = jr.split(key)
        key_fit, key_eval = jr.split(key)

        model_fit_l, em_res_l = fit_model_one_config(
            param_dict, y_train, key=key_fit, fit_kwargs=fit_kwargs,
            model_class_str=model_class_str, n_repeat=n_repeat,
        )
        model_eval_result = evaluate_model_one_config(
            model_fit_l, y_test, key=key_eval,
            latent_downsample_frac=latent_downsample_frac,
            downsample_n_repeat=downsample_n_repeat,
            metric_type_l=metric_type_l,
            jump_dynamics_index=jump_dynamics_index,
            jump_consensus_window_size=jump_consensus_window_size,
            jump_consensus_jump_p_thresh=jump_consensus_jump_p_thresh,
            jump_consensus_consensus_thresh=jump_consensus_consensus_thresh,
        )
        if not model_eval_result_all_configs:
            for k in model_eval_result:
                model_eval_result_all_configs[k + "_best_value"] = []
                model_eval_result_all_configs[k + "_best_index"] = []
        for k in model_eval_result:
            model_eval_result_all_configs[k + "_best_value"].append(
                model_eval_result[k]["best_value"]
            )
            model_eval_result_all_configs[k + "_best_index"].append(
                model_eval_result[k]["best_index"]
            )

        current_best = model_eval_result["metric_overall"]["best_value"]
        if current_best > metric_overall_best:
            metric_overall_best = current_best
            best_model = model_fit_l[
                model_eval_result["metric_overall"]["best_index"]
            ]
            best_model_l = model_fit_l
            best_config = param_dict

        if model_to_return_type == "best_per_config":
            model_to_return_l.append(
                model_fit_l[model_eval_result["metric_overall"]["best_index"]]
            )
        elif model_to_return_type == "all":
            model_to_return_l.append(model_fit_l)

    if model_to_return_type == "best_overall":
        model_to_return_l = [best_model]
    elif model_to_return_type == "best_config":
        model_to_return_l = [best_model_l]

    model_eval_result_all_configs = pd.DataFrame(
        model_eval_result_all_configs
    ).join(hyperparam_grid_df)
    return {
        "model_to_return_l": model_to_return_l,
        "best_config": best_config,
        "best_model": best_model,
        "best_model_l": best_model_l,
        "model_eval_result_all_configs": model_eval_result_all_configs,
        "hyperparam_grid_df": hyperparam_grid_df,
        "hyperparam_tosweep_keys": hyperparam_grid_df.columns,
    }


def _downsample_masks(key, n_latent_bin, downsample_frac, n_repeat):
    """The exact mask stream get_downsampled_lml draws (same jr calls)."""
    key_l = jr.split(key, n_repeat)
    n_sel = int(n_latent_bin * downsample_frac)
    masks = []
    for k in key_l:
        chosen = jr.choice(k, n_latent_bin, shape=(n_sel,), replace=False)
        masks.append(jnp.zeros(n_latent_bin).at[chosen].set(1))
    return jnp.stack(masks)


def _assemble_eval_from_parts(
    lml_test, one_step_sum, dyn_marg_l, masked_lml_per_frac, metric_type_l,
    latent_downsample_frac, jump_dynamics_index, jump_consensus_window_size,
    jump_consensus_jump_p_thresh, jump_consensus_consensus_thresh,
):
    """Shared metric assembly for ONE config's chains (reference
    model_selection_helper.py:62-143): both the serial
    ``evaluate_model_one_config`` and the batched backend feed per-chain
    scalars/arrays here, so the metric definitions cannot drift apart.

    ``masked_lml_per_frac[frac][chain]`` is an array of masked-decode
    LMLs (one per mask repeat, or a 1-element array of the pre-averaged
    value from the serial path); ``dyn_marg_l`` may be None when no jump
    metric is requested."""
    n_chain = len(lml_test)
    model_eval_result = {}
    if "log_marginal_test" in metric_type_l:
        model_eval_result["log_marginal_test"] = {
            "value_per_fit": np.asarray(lml_test, dtype=np.float64),
            "best_value": None, "best_index": None,
        }
    if "log_one_step_predictive_marginal_test" in metric_type_l:
        model_eval_result["log_one_step_predictive_marginal_test"] = {
            "value_per_fit": np.asarray(one_step_sum, dtype=np.float64),
            "best_value": None, "best_index": None,
        }
    if "downsampled_lml" in metric_type_l:
        for frac in latent_downsample_frac:
            vals = np.array([
                float(np.mean(masked_lml_per_frac[frac][c]))
                for c in range(n_chain)
            ])
            model_eval_result[f"downsampled_lml_{frac}"] = {
                "value_per_fit": vals, "best_value": None, "best_index": None,
            }
    if "jump_consensus" in metric_type_l and dyn_marg_l is not None:
        window_sizes = (
            [jump_consensus_window_size]
            if isinstance(jump_consensus_window_size, int)
            else list(jump_consensus_window_size)
        )
        jump_p_all_chain = np.array([
            np.asarray(d)[:, jump_dynamics_index] for d in dyn_marg_l
        ]).T
        for ws in window_sizes:
            name = (
                "jump_consensus"
                if isinstance(jump_consensus_window_size, int)
                else f"jump_consensus_{ws}"
            )
            vals = []
            for jump_p in jump_p_all_chain.T:
                frac_consensus, _, _ = get_jump_consensus(
                    jump_p, jump_p_all_chain, window_size=ws,
                    jump_p_thresh=jump_consensus_jump_p_thresh,
                    consensus_thresh=jump_consensus_consensus_thresh,
                )
                vals.append(frac_consensus)
            model_eval_result[name] = {
                "value_per_fit": np.array(vals),
                "best_value": None, "best_index": None,
            }
    # overall = mean of downsampled-lml metrics when computed; otherwise
    # fall back to the first available metric (the reference crashes with
    # a KeyError here if 'downsampled_lml' was excluded from
    # metric_type_l — model_selection_helper.py:135-138; documented fix)
    ds_keys = [
        f"downsampled_lml_{frac}"
        for frac in latent_downsample_frac
        if f"downsampled_lml_{frac}" in model_eval_result
    ]
    if ds_keys:
        value_per_fit = np.zeros(n_chain)
        for k in ds_keys:
            value_per_fit += model_eval_result[k]["value_per_fit"]
        value_per_fit /= len(ds_keys)
    elif model_eval_result:
        first = next(iter(model_eval_result))
        value_per_fit = np.asarray(
            model_eval_result[first]["value_per_fit"], dtype=np.float64
        ).copy()
    else:
        value_per_fit = np.zeros(n_chain)
    model_eval_result["metric_overall"] = {
        "value_per_fit": value_per_fit, "best_value": None, "best_index": None,
    }
    for k in model_eval_result:
        vals = model_eval_result[k]["value_per_fit"]
        model_eval_result[k]["best_value"] = np.max(vals)
        model_eval_result[k]["best_index"] = int(np.argmax(vals))
    return model_eval_result


def _model_selection_one_split_batched(
    y, hyperparam_dict, train_index, test_index, test_frac, key,
    model_to_return_type, fit_kwargs, model_class_str, n_repeat,
    latent_downsample_frac, downsample_n_repeat, metric_type_l,
    jump_dynamics_index, jump_consensus_window_size,
    jump_consensus_jump_p_thresh, jump_consensus_consensus_thresh, verbose,
    mesh=None,
):
    """backend='batched': the serial tree (fit chains -> decode -> masked
    decodes -> consensus) recast as bucketed vmapped device programs, with
    the serial path's exact RNG derivation so results match
    (reference model_selection_helper.py:145-239; SURVEY §3.5 notes the
    whole tree is embarrassingly parallel)."""
    from poor_man_gplvm_tpu.parallel import sweep as _sweep

    T, n_neuron = y.shape
    metric_type_l = list(metric_type_l)
    if "latentonly" in model_class_str:
        metric_type_l = [m for m in metric_type_l if "jump" not in m]

    if train_index is None:
        train_index = slice(0, int(T * (1 - test_frac)))
    if test_index is None:
        test_index = slice(int(T * (1 - test_frac)), T)
    y_train = jnp.array(y[train_index])
    y_test = jnp.array(y[test_index])

    hyperparam_grid_l, hyperparam_grid_df = generate_hyperparam_grid(
        hyperparam_dict
    )
    n_cfg = len(hyperparam_grid_l)

    # the serial loop's exact per-config key evolution
    key_fit_l, key_eval_l = [], []
    for _ in range(n_cfg):
        key, _unused = jr.split(key)
        key_fit, key_eval = jr.split(key)
        key_fit_l.append(key_fit)
        key_eval_l.append(key_eval)

    fk = dict(default_fit_kwargs)
    fk.update(fit_kwargs or {})
    n_iter = fk.get("n_iter", 20)
    likelihood_scale = float(fk.get("likelihood_scale", 1.0))
    random_scale = float(
        (fk.get("posterior_init_kwargs") or {}).get("random_scale", 0.1)
    )

    config_l, run_keys = [], []
    for ii, cfg in enumerate(hyperparam_grid_l):
        chain_keys = jr.split(key_fit_l[ii], n_repeat)
        for c in range(n_repeat):
            config_l.append(dict(cfg))
            run_keys.append(chain_keys[c])
    B = len(config_l)

    if verbose:
        print(
            f"== batched model selection: {n_cfg} configs x {n_repeat} "
            f"chains = {B} runs =="
        )
    per_run = _sweep.sweep_fit_model_class(
        y_train, config_l, run_keys, model_class_str, n_iter=n_iter,
        likelihood_scale=likelihood_scale, random_scale=random_scale,
        m_step_size=float(fk.get("m_step_step_size", 0.01)),
        m_maxiter=int(fk.get("m_step_maxiter", 1000)),
        m_tol=float(fk.get("m_step_tol", 1e-6)),
        mesh=mesh,
    )

    # per-run downsampled masks, drawn exactly like the serial path (same
    # eval key shared across fracs and chains WITHIN a config)
    masks_per_run = {}
    model_class = model_class_dict[model_class_str]
    # the model class's real ctor default (sweep._config_defaults), not a
    # duplicated literal that could desynchronize
    _L_default = _sweep._config_defaults(model_class_str)["n_latent_bin"]
    L_per_cfg = [
        cfg.get("n_latent_bin", _L_default) for cfg in hyperparam_grid_l
    ]
    if "downsampled_lml" in metric_type_l:
        for frac in latent_downsample_frac:
            masks_l = []
            for ii in range(n_cfg):
                masks_cfg = _downsample_masks(
                    key_eval_l[ii], L_per_cfg[ii], frac, downsample_n_repeat
                )
                masks_l.extend([masks_cfg] * n_repeat)
            masks_per_run[frac] = masks_l

    dec_per_run, masked_per_run = _sweep.sweep_eval_model_class(
        y_test, per_run, config_l, model_class_str, masks_per_run,
        likelihood_scale=1.0, mesh=mesh,
    )

    # materialize model objects (fitted params/tuning) for the return
    # contract; one ctor per distinct CONFIG (the ctor runs the basis
    # SVD — repeating it per chain would redo n_repeat identical (L, L)
    # SVDs), shallow-copied per chain since params/tuning are replaced
    # and everything else (basis, kernels) is immutable
    import copy as _copy

    template_per_cfg = [
        model_class(n_neuron=n_neuron, **cfg) for cfg in hyperparam_grid_l
    ]
    model_fit_all = []
    for i in range(B):
        m = _copy.copy(template_per_cfg[i // n_repeat])
        m.params = per_run[i]["params"]
        m.tuning = per_run[i]["tuning"]
        model_fit_all.append(m)

    model_eval_result_all_configs = {}
    best_model, best_model_l, best_config = None, None, None
    model_to_return_l = []
    metric_overall_best = -np.inf
    for ii, param_dict in enumerate(hyperparam_grid_l):
        runs = list(range(ii * n_repeat, (ii + 1) * n_repeat))
        lml_test = [
            float(dec_per_run[i]["log_marginal_final"]) for i in runs
        ]
        one_step = [
            float(np.asarray(dec_per_run[i]["ratios"]).sum()) for i in runs
        ]
        dyn_marg_l = [
            np.asarray(dec_per_run[i]["posterior_dynamics_marg"])
            for i in runs
        ]
        masked = {
            frac: [np.asarray(masked_per_run[frac][i]) for i in runs]
            for frac in masks_per_run
        }
        model_eval_result = _assemble_eval_from_parts(
            lml_test, one_step, dyn_marg_l, masked, metric_type_l,
            latent_downsample_frac, jump_dynamics_index,
            jump_consensus_window_size, jump_consensus_jump_p_thresh,
            jump_consensus_consensus_thresh,
        )
        if not model_eval_result_all_configs:
            for k in model_eval_result:
                model_eval_result_all_configs[k + "_best_value"] = []
                model_eval_result_all_configs[k + "_best_index"] = []
        for k in model_eval_result:
            model_eval_result_all_configs[k + "_best_value"].append(
                model_eval_result[k]["best_value"]
            )
            model_eval_result_all_configs[k + "_best_index"].append(
                model_eval_result[k]["best_index"]
            )
        model_fit_l = [model_fit_all[i] for i in runs]
        current_best = model_eval_result["metric_overall"]["best_value"]
        if current_best > metric_overall_best:
            metric_overall_best = current_best
            best_model = model_fit_l[
                model_eval_result["metric_overall"]["best_index"]
            ]
            best_model_l = model_fit_l
            best_config = param_dict
        if model_to_return_type == "best_per_config":
            model_to_return_l.append(
                model_fit_l[model_eval_result["metric_overall"]["best_index"]]
            )
        elif model_to_return_type == "all":
            model_to_return_l.append(model_fit_l)

    if model_to_return_type == "best_overall":
        model_to_return_l = [best_model]
    elif model_to_return_type == "best_config":
        model_to_return_l = [best_model_l]

    model_eval_result_all_configs = pd.DataFrame(
        model_eval_result_all_configs
    ).join(hyperparam_grid_df)
    return {
        "model_to_return_l": model_to_return_l,
        "best_config": best_config,
        "best_model": best_model,
        "best_model_l": best_model_l,
        "model_eval_result_all_configs": model_eval_result_all_configs,
        "hyperparam_grid_df": hyperparam_grid_df,
        "hyperparam_tosweep_keys": hyperparam_grid_df.columns,
    }


@partial(jax.jit, static_argnames=["observation_model"])
def _masked_lml_batch(y_test, tuning, hyper, trans, ma_neuron, masks,
                      observation_model):
    """All latent-mask decodes of ``get_downsampled_lml`` as one vmapped
    forward-filter program.  Module-level jit: a per-call
    ``jax.jit(jax.vmap(...))`` wrapper would retrace+recompile the whole
    T-step scan on EVERY (frac, chain) evaluation.  The 1-D (N,) neuron
    mask passes straight through — a dense (T, N) mask would add ~T*N*4
    bytes of pointless operand per decode."""
    from poor_man_gplvm_tpu.ops import hmm

    def one(mask):
        return hmm.forward_filter_lml(
            y_test, tuning, hyper, trans, ma_neuron, mask,
            observation_model=observation_model,
        )

    return jax.vmap(one)(masks)


def get_downsampled_lml(
    model_fit, y_test, downsample_frac=0.2, n_repeat=10, key=None, **kwargs
):
    """Held-out LML under random latent masks keeping ``frac * L`` bins — a
    complexity-penalty metric (reference model_selection_helper.py:243-260).

    The mask decodes run as ONE vmapped filter program (the smoother does
    not change log_marginal_final) unless extra decode kwargs force the
    serial per-mask path."""
    key = jr.PRNGKey(4) if key is None else key
    masks = _downsample_masks(
        key, model_fit.n_latent_bin, downsample_frac, n_repeat
    )
    if not kwargs:
        hyper = {}
        if hasattr(model_fit, "noise_std"):
            hyper["noise_std"] = model_fit.noise_std
        trans, _ = model_fit._make_transition(hyper)
        lml_l = np.asarray(_masked_lml_batch(
            jnp.asarray(y_test, dtype=jnp.float32), model_fit.tuning, hyper,
            trans, model_fit.ma_neuron_default, masks,
            model_fit.observation_model,
        ))
    else:
        lml_l = [
            model_fit.decode_latent(y_test, ma_latent=masks[i], **kwargs)[
                "log_marginal_final"
            ]
            for i in range(n_repeat)
        ]
    return {"value": float(np.mean(lml_l)), "std": float(np.std(lml_l))}


def get_jump_consensus(
    jump_p, jump_p_all_chain, window_size=5, jump_p_thresh=0.4,
    consensus_thresh=0.8,
):
    """Fraction of one chain's detected jumps corroborated (within a +/-
    window) by at least ``consensus_thresh`` of all chains
    (reference model_selection_helper.py:264-299)."""
    jump_p = np.asarray(jump_p)
    jump_p_all_chain = np.asarray(jump_p_all_chain)
    jump_time_index = np.nonzero(jump_p >= jump_p_thresh)[0]

    jump_time_index_consensus = []
    whether_consensus_ma = []
    for jti in jump_time_index:
        # the raw (possibly negative-start) slice is the REFERENCE metric
        # definition (model_selection_helper.py:285-286): for
        # jti < window_size the slice is empty, so an early jump is never
        # counted as consensus — clamping the start would change the
        # metric (and hence model selection) for such jumps
        window = jump_p_all_chain[jti - window_size : jti + window_size, :]
        whether = (window > jump_p_thresh).any(axis=0).mean() >= consensus_thresh
        whether_consensus_ma.append(whether)
        if whether:
            jump_time_index_consensus.append(jti)
    jump_time_index_consensus = np.array(jump_time_index_consensus, dtype=int)
    whether_consensus_ma = np.array(whether_consensus_ma)

    frac_consensus = (
        whether_consensus_ma.mean() if len(whether_consensus_ma) else np.nan
    )
    is_jump_filtered = np.zeros(len(jump_p))
    if len(jump_time_index_consensus) > 0:
        is_jump_filtered[jump_time_index_consensus] = 1
    return frac_consensus, is_jump_filtered, whether_consensus_ma


def get_jump_consensus_shuffle(
    jump_p, jump_p_all_chain, chain_index, n_shuffle=1000, window_size=5,
    jump_p_thresh=0.4, consensus_thresh=0.8, key=None,
):
    """Circular-shift null distribution for the jump-consensus metric,
    vectorized over shuffles (reference model_selection_helper.py:302-420)."""
    key = jr.PRNGKey(42) if key is None else key
    jump_p = jnp.asarray(jump_p)
    jump_p_all_chain = jnp.asarray(jump_p_all_chain)

    n_time, n_total_chains = jump_p_all_chain.shape
    other_mask = jnp.arange(n_total_chains) != chain_index
    jump_p_other = jump_p_all_chain[:, other_mask]
    n_other = int(jump_p_other.shape[1])

    shuffle_keys = jr.split(key, n_shuffle)

    def shifts_for(k):
        chain_keys = jr.split(k, n_other)
        return jax.vmap(
            lambda kk: jr.randint(kk, shape=(), minval=0, maxval=n_time)
        )(chain_keys)

    shift_amounts = jax.vmap(shifts_for)(shuffle_keys)  # (n_shuffle, n_other)
    time_idx = jnp.arange(n_time)
    shifted_idx = (time_idx[None, None, :] - shift_amounts[:, :, None]) % n_time
    shuffled_other = jump_p_other[
        shifted_idx, jnp.arange(n_other)[None, :, None]
    ].transpose(0, 2, 1)  # (n_shuffle, n_time, n_other)

    shuffled_all = jnp.zeros((n_shuffle, n_time, n_total_chains))
    shuffled_all = shuffled_all.at[:, :, chain_index].set(jump_p[None, :])
    shuffled_all = shuffled_all.at[:, :, other_mask].set(shuffled_other)

    is_jump = jump_p >= jump_p_thresh
    jump_time_indices = np.where(np.asarray(is_jump))[0]

    if len(jump_time_indices) == 0:
        frac_consensus_distribution = jnp.zeros(n_shuffle)
    else:
        per_jump = []
        for jti in jump_time_indices:
            start = max(0, int(jti) - window_size)
            end = min(n_time, int(jti) + window_size + 1)
            window = shuffled_all[:, start:end, :]
            chain_has_jump = jnp.any(window > jump_p_thresh, axis=1)
            consensus_frac = jnp.mean(chain_has_jump, axis=1)
            per_jump.append(consensus_frac >= consensus_thresh)
        frac_consensus_distribution = jnp.mean(
            jnp.stack(per_jump, axis=0), axis=0
        )

    dist = np.asarray(frac_consensus_distribution)
    return {
        "frac_consensus_distribution": dist,
        "percentile_2_5": float(np.percentile(dist, 2.5)),
        "percentile_97_5": float(np.percentile(dist, 97.5)),
        "mean": float(dist.mean()),
        "std": float(dist.std()),
    }


def get_lml_test_history(y_test, model, tuning_saved, do_nb=True,
                         ma_temporal=None, batched=True):
    """Held-out LML for each saved tuning snapshot
    (reference model_selection_helper.py:424-445).

    ``batched`` (default): all snapshots share shapes and transitions, so
    the whole history evaluates as ONE vmapped-over-tuning device program
    (the smoother does not change ``log_marginal_final``, so the full
    decode reduces to the forward-filter LML — same invariant as
    ``get_downsampled_lml``).  ``batched=False`` keeps the serial
    per-snapshot decode loop."""
    if ma_temporal is not None:
        ma_neuron = jnp.ones(y_test.shape[1])[None, :] * jnp.asarray(
            ma_temporal
        )[:, None]
    else:
        ma_neuron = None

    if not batched:
        lml_test_l = []
        for tun_ in tuning_saved:
            if do_nb:
                res = model.decode_latent_naive_bayes(
                    y_test, tuning=tun_, ma_neuron=ma_neuron
                )
                lml_test_l.append(res["log_marginal_total"])
            else:
                res = model.decode_latent(
                    y_test, tuning=tun_, ma_neuron=ma_neuron
                )
                lml_test_l.append(res["log_marginal_final"])
        return np.array(lml_test_l)

    if len(tuning_saved) == 0:
        return np.array([])
    import jax

    from poor_man_gplvm_tpu.ops import emissions as _em
    from poor_man_gplvm_tpu.ops import hmm as _hmm

    y_test = jnp.asarray(y_test, dtype=jnp.float32)
    if ma_neuron is None:
        ma_neuron = model.ma_neuron_default
    ma_latent = model.ma_latent_default
    hyper = {}
    if hasattr(model, "noise_std"):
        hyper["noise_std"] = model.noise_std
    obs = model.observation_model
    tun_stack = jnp.stack([jnp.asarray(t) for t in tuning_saved])

    if do_nb:
        def one(tun):
            _, _, lml, _ = _em.get_naive_bayes_ma(
                y_test, tun, hyper, ma_neuron, ma_latent,
                observation_model=obs,
            )
            return lml
    else:
        trans, _ = model._make_transition(hyper)

        def one(tun):
            return _hmm.forward_filter_lml(
                y_test, tun, hyper, trans, ma_neuron, ma_latent,
                observation_model=obs,
            )

    return np.asarray(jax.jit(jax.vmap(one))(tun_stack))
