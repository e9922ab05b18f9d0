"""Reference-compatible latent-only decoder module.

Mirrors ``poor_man_gplvm.decoder_latentonly`` on this package's engine.
"""

from __future__ import annotations

import jax.numpy as jnp

from poor_man_gplvm_tpu.ops.emissions import (  # noqa: F401
    get_loglikelihood_ma_all,
    get_loglikelihood_ma_all_changing_dt,
    get_naive_bayes_ma,
    get_naive_bayes_ma_chunk,
)
from poor_man_gplvm_tpu.ops.hmm import (  # noqa: F401
    LatentTransition,
    compute_transition_posterior_prob_latent,
    filter_combined,
    smooth_combined_chunked,
)

__all__ = [
    "filter_all_step_combined_ma_latent",
    "smooth_all_step_combined_ma_chunk_latent",
    "compute_transition_posterior_prob_latent",
]


def _latent(log_latent_transition_kernel):
    return LatentTransition(
        T=jnp.exp(log_latent_transition_kernel),
        logT=log_latent_transition_kernel,
    )


def filter_all_step_combined_ma_latent(
    y, tuning, hyperparam, log_latent_transition_kernel, ma_neuron, ma_latent,
    carry_init=None, likelihood_scale=1, observation_model="poisson",
    engine="prob",
):
    """Fused likelihood + causal filter, latent-only
    (reference decoder_latentonly.py:82-94)."""
    trans = _latent(log_latent_transition_kernel)
    ma_neuron = jnp.broadcast_to(jnp.asarray(ma_neuron), jnp.asarray(y).shape)
    return filter_combined(
        y, tuning, hyperparam, trans, ma_neuron, ma_latent,
        carry_init=carry_init, likelihood_scale=likelihood_scale,
        observation_model=observation_model, engine=engine,
    )


def smooth_all_step_combined_ma_chunk_latent(
    y, tuning, hyperparam, log_latent_transition_kernel, ma_neuron,
    ma_latent=None, likelihood_scale=1, n_time_per_chunk=10000,
    observation_model="poisson", engine="prob",
):
    """Chunked forward-backward smoother, latent-only
    (reference decoder_latentonly.py:156-224)."""
    trans = _latent(log_latent_transition_kernel)
    return smooth_combined_chunked(
        y, tuning, hyperparam, trans, ma_neuron, ma_latent,
        likelihood_scale=likelihood_scale, n_time_per_chunk=n_time_per_chunk,
        observation_model=observation_model, engine=engine,
    )


def filter_one_step_latent(carry, ll_curr, log_latent_transition_kernel,
                           likelihood_scale=1):
    """One causal filter step, latent-only, log space
    (reference decoder_latentonly.py:33-56)."""
    from poor_man_gplvm_tpu.ops.hmm import _forward_scan_log

    trans = _latent(log_latent_transition_kernel)
    post, prior, ratios, carry_out = _forward_scan_log(
        ll_curr[None], trans, carry, likelihood_scale
    )
    return carry_out, (post[0], prior[0], ratios[0])


def filter_all_step_latent(log_likelihood_all, log_latent_transition_kernel,
                           carry_init=None, likelihood_scale=1):
    """Causal filter over a precomputed (T, L) log-likelihood, latent-only
    (reference decoder_latentonly.py:58-81).  Returns
    (log_posterior_all, log_marginal_final, log_prior_all, ratios)."""
    from poor_man_gplvm_tpu.ops.hmm import _forward_scan_log

    trans = _latent(log_latent_transition_kernel)
    if carry_init is None:
        carry_init = (trans.uniform_log_init(), jnp.array(0.0))
    post, prior, ratios, carry_out = _forward_scan_log(
        log_likelihood_all, trans, carry_init, likelihood_scale
    )
    return post, carry_out[1], prior, ratios


def smooth_one_step_latent(carry, x, log_latent_transition_kernel):
    """One acausal smoother step, latent-only, log space
    (reference decoder_latentonly.py:96-123)."""
    trans = _latent(log_latent_transition_kernel)
    log_smooth_next, log_acc = carry
    log_filt_curr, log_prior_next = x
    log_smooth_curr, inside = trans.smooth_step_log(
        log_smooth_next, log_filt_curr, log_prior_next
    )
    return (log_smooth_curr, jnp.logaddexp(log_acc, inside)), log_smooth_curr


def smooth_all_step_latent(log_causal_posterior_all, log_causal_prior_all,
                           log_latent_transition_kernel, carry_init=None):
    """Reverse smoother over one chunk, latent-only, log space
    (reference decoder_latentonly.py:126-154)."""
    from poor_man_gplvm_tpu.ops.hmm import JOINT_ACC_INIT, _backward_scan_log

    trans = _latent(log_latent_transition_kernel)
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
