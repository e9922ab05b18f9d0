"""Reference-compatible decoder module (drop-in import surface).

Mirrors the reference's ``poor_man_gplvm.decoder`` function names and
signatures (reference decoder.py), implemented on this package's engine:
likelihoods from :mod:`poor_man_gplvm_tpu.ops.emissions`, filtering/
smoothing from :mod:`poor_man_gplvm_tpu.ops.hmm`.
"""

from __future__ import annotations

import jax.numpy as jnp

from poor_man_gplvm_tpu.ops.emissions import (  # noqa: F401
    get_loglikelihood_ma_all,
    get_loglikelihood_ma_all_changing_dt,
    get_naive_bayes_ma,
    get_naive_bayes_ma_chunk,
    gaussian_loglik,
    poisson_loglik,
)
from poor_man_gplvm_tpu.ops.hmm import (  # noqa: F401
    JointTransition,
    compute_transition_posterior_prob,
    filter_combined,
    smooth_combined_chunked,
)

__all__ = [
    "get_loglikelihood_ma_poisson",
    "get_loglikelihood_ma_gaussian",
    "get_loglikelihood_ma_all",
    "get_loglikelihood_ma_all_changing_dt",
    "get_naive_bayes_ma",
    "get_naive_bayes_ma_chunk",
    "filter_one_step",
    "filter_all_step",
    "filter_all_step_combined_ma",
    "smooth_one_step",
    "smooth_all_step",
    "smooth_all_step_combined_ma_chunk",
    "compute_transition_posterior_prob",
]


def get_loglikelihood_ma_poisson(y, tuning, hyperparam, ma_neuron, ma_latent,
                                 dt=1.0):
    """Single-timepoint Poisson log-likelihood over latent bins
    (reference decoder.py:31-48 signature)."""
    return poisson_loglik(
        jnp.asarray(y)[None, :], tuning, jnp.asarray(ma_neuron)[None, :],
        ma_latent, dt=dt,
    )[0]


def get_loglikelihood_ma_gaussian(y, tuning, hyperparam, ma_neuron, ma_latent,
                                  dt=1.0):
    """Single-timepoint Gaussian log-likelihood over latent bins
    (reference decoder.py:50-57 signature)."""
    return gaussian_loglik(
        jnp.asarray(y)[None, :], tuning, hyperparam["noise_std"],
        jnp.asarray(ma_neuron)[None, :], ma_latent, dt=dt,
    )[0]


def filter_one_step(carry, ll_curr, log_latent_transition_kernel_l,
                    log_dynamics_transition_kernel, likelihood_scale=1):
    """One causal filter step in log space
    (reference decoder.py:151-172 signature): carry = (log_posterior_prev,
    log_marginal_tillprev) -> (carry_next, (log_post, log_prior, ratio))."""
    from poor_man_gplvm_tpu.ops.hmm import _forward_scan_log

    trans = _joint(
        log_latent_transition_kernel_l, log_dynamics_transition_kernel
    )
    post, prior, ratios, carry_out = _forward_scan_log(
        ll_curr[None], trans, carry, likelihood_scale
    )
    return carry_out, (post[0], prior[0], ratios[0])


def filter_all_step(log_likelihood_all, log_latent_transition_kernel_l,
                    log_dynamics_transition_kernel, carry_init=None,
                    likelihood_scale=1):
    """Causal filter over a precomputed (T, L) log-likelihood, log space
    (reference decoder.py:174-187 signature)."""
    from poor_man_gplvm_tpu.ops.hmm import _forward_scan_log

    trans = _joint(
        log_latent_transition_kernel_l, log_dynamics_transition_kernel
    )
    if carry_init is None:
        carry_init = (trans.uniform_log_init(), jnp.array(0.0))
    post, prior, ratios, carry_out = _forward_scan_log(
        log_likelihood_all, trans, carry_init, likelihood_scale
    )
    return post, carry_out[1], prior, ratios


def smooth_one_step(carry, x, log_latent_transition_kernel_l,
                    log_dynamics_transition_kernel):
    """One acausal smoother step in log space
    (reference decoder.py:200-226 signature)."""
    trans = _joint(
        log_latent_transition_kernel_l, log_dynamics_transition_kernel
    )
    log_smooth_next, log_acc = carry
    log_filt_curr, log_prior_next = x
    log_smooth_curr, inside = trans.smooth_step_log(
        log_smooth_next, log_filt_curr, log_prior_next
    )
    return (log_smooth_curr, jnp.logaddexp(log_acc, inside)), log_smooth_curr


def smooth_all_step(log_causal_posterior_all, log_causal_prior_all,
                    log_latent_transition_kernel_l,
                    log_dynamics_transition_kernel, carry_init=None):
    """Reverse smoother over one chunk, log space
    (reference decoder.py:230-256 signature).  Returns
    (log_acausal_posterior_all, log_accumulated_joint_final)."""
    from poor_man_gplvm_tpu.ops.hmm import JOINT_ACC_INIT, _backward_scan_log

    trans = _joint(
        log_latent_transition_kernel_l, log_dynamics_transition_kernel
    )
    if carry_init is None:
        carry_init = (
            log_causal_posterior_all[-1],
            jnp.full(trans.joint_shape(), JOINT_ACC_INIT),
        )
        smooth, acc = _backward_scan_log(
            log_causal_posterior_all[:-1], log_causal_prior_all, trans,
            carry_init,
        )
        smooth = jnp.concatenate(
            [smooth, log_causal_posterior_all[-1][None]], axis=0
        )
    else:
        smooth, acc = _backward_scan_log(
            log_causal_posterior_all, log_causal_prior_all, trans, carry_init
        )
    return smooth, acc


def _joint(log_latent_transition_kernel_l, log_dynamics_transition_kernel):
    return JointTransition(
        Tdyn=jnp.exp(log_dynamics_transition_kernel),
        Tlat=jnp.exp(log_latent_transition_kernel_l),
        logTdyn=log_dynamics_transition_kernel,
        logTlat=log_latent_transition_kernel_l,
    )


def filter_all_step_combined_ma(
    y, tuning, hyperparam, log_latent_transition_kernel_l,
    log_dynamics_transition_kernel, ma_neuron, ma_latent, carry_init=None,
    likelihood_scale=1, observation_model="poisson", engine="prob",
):
    """Fused likelihood + causal filter (reference decoder.py:189-198).

    Returns (log_posterior_all, log_marginal_final, log_prior_curr_all,
    log_one_step_predictive_marginals, log_likelihood_all)."""
    trans = _joint(
        log_latent_transition_kernel_l, log_dynamics_transition_kernel
    )
    ma_neuron = jnp.broadcast_to(jnp.asarray(ma_neuron), jnp.asarray(y).shape)
    return filter_combined(
        y, tuning, hyperparam, trans, ma_neuron, ma_latent,
        carry_init=carry_init, likelihood_scale=likelihood_scale,
        observation_model=observation_model, engine=engine,
    )


def smooth_all_step_combined_ma_chunk(
    y, tuning, hyperparam, log_latent_transition_kernel_l,
    log_dynamics_transition_kernel, ma_neuron, ma_latent=None,
    likelihood_scale=1, n_time_per_chunk=10000, observation_model="poisson",
    engine="prob",
):
    """Chunked forward-backward smoother (reference decoder.py:258-332).

    Returns the reference 6-tuple (log_acausal_posterior_all,
    log_marginal_final, log_causal_posterior_all,
    log_one_step_predictive_marginals, log_accumulated_joint,
    log_likelihood_all)."""
    trans = _joint(
        log_latent_transition_kernel_l, log_dynamics_transition_kernel
    )
    return smooth_combined_chunked(
        y, tuning, hyperparam, trans, ma_neuron, ma_latent,
        likelihood_scale=likelihood_scale, n_time_per_chunk=n_time_per_chunk,
        observation_model=observation_model, engine=engine,
    )
