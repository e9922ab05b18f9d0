"""Legacy per-neuron LBFGS M-step on grouped statistics.

Equivalent of reference poor_man_gplvm/fit_tuning_with_basis.py
(the pre-Adam fitting path, kept for parity): params are a (weights, bias)
tuple per neuron, the objective is the grouped Poisson log joint normalized
by the latent-bin count, and the solver is LBFGS vmapped over neurons.

The reference uses ``jaxopt.LBFGS`` (unavailable here) and defines
``m_step_get_tuning_all_neuron_grouped`` twice (reference
fit_tuning_with_basis.py:37 and :100 — the second shadows the first); this
module uses ``optax.lbfgs`` and defines the function once.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import optax
from jax import vmap
from jax.scipy.special import xlogy

from poor_man_gplvm_tpu.ops.emissions import PRECISION

__all__ = [
    "glm_get_tuning",
    "gaussian_logprior",
    "get_log_prior_params",
    "group_spk_occupancy_chunk_neuron",
    "get_log_poisson_p_y_given_params_oneneuron_grouped",
    "get_log_poisson_p_y_joint_params_oneneuron_grouped",
    "m_step_get_tuning_all_neuron_grouped",
]


@jax.jit
def glm_get_tuning(params, basis):
    """softplus(basis @ w + b) with a (w, b) param tuple
    (reference fit_tuning_with_basis.py:13-22)."""
    params_w, params_b = params
    return jax.nn.softplus(basis.dot(params_w) + params_b)


@jax.jit
def gaussian_logprior(params, var):
    return jnp.sum(-jnp.sum(params**2, axis=0) / (2 * var))


@jax.jit
def get_log_prior_params(params_one, prior_hyper):
    """Gaussian prior on the weights only (not the bias)
    (reference fit_tuning_with_basis.py:29-33)."""
    return gaussian_logprior(params_one[0], prior_hyper)


def group_spk_occupancy_chunk_neuron(spk, post_x_l, n_neuron_per_chunk=100,
                                     dt=1.0):
    """Grouped statistics: posterior-weighted spikes (L, N) and occupancy
    (L,) with optional per-time dt, chunked over neurons for memory
    (reference fit_tuning_with_basis.py:59-76).  The chunked elementwise
    reduction is replaced with one (L, T) @ (T, N) matmul."""
    n_time = spk.shape[0]
    dt_l = jnp.broadcast_to(jnp.asarray(dt, dtype=spk.dtype), (n_time,))
    t_b = (post_x_l * dt_l[:, None]).sum(axis=0)  # (L,)
    s_b = jnp.matmul(post_x_l.T, spk, precision=PRECISION)  # (L, N)
    del n_neuron_per_chunk  # matmul form needs no neuron chunking
    return s_b, t_b


def get_log_poisson_p_y_given_params_oneneuron_grouped(params_one, s_b_one,
                                                       basis, t_b):
    """Grouped Poisson log-likelihood for one neuron
    (reference fit_tuning_with_basis.py:79-88)."""
    pf_one = glm_get_tuning(params_one, basis)  # (L,)
    return jnp.sum(xlogy(s_b_one, pf_one + 1e-20) - pf_one * t_b)


def get_log_poisson_p_y_joint_params_oneneuron_grouped(params_one, s_b_one,
                                                       basis, t_b,
                                                       prior_hyper):
    """Log joint, normalized by the latent-bin count
    (reference fit_tuning_with_basis.py:90-96)."""
    l_p = get_log_poisson_p_y_given_params_oneneuron_grouped(
        params_one, s_b_one, basis, t_b
    )
    l_prior = get_log_prior_params(params_one, prior_hyper)
    return (l_p + l_prior) / s_b_one.shape[0]


def _neg_objective(params_one, s_b_one, basis, t_b, prior_hyper):
    return -get_log_poisson_p_y_joint_params_oneneuron_grouped(
        params_one, s_b_one, basis, t_b, prior_hyper
    )


@partial(jax.jit, static_argnames=["maxiter"])
def _lbfgs_one_neuron(params_one, s_b_one, basis, t_b, prior_hyper, maxiter):
    """LBFGS solve for one neuron's (w, b) via optax.lbfgs."""
    opt = optax.lbfgs()
    fun = partial(_neg_objective, s_b_one=s_b_one, basis=basis, t_b=t_b,
                  prior_hyper=prior_hyper)
    value_and_grad = optax.value_and_grad_from_state(fun)

    def step(carry, _):
        params, state = carry
        value, grad = value_and_grad(params, state=state)
        updates, state = opt.update(
            grad, state, params, value=value, grad=grad, value_fn=fun
        )
        params = optax.apply_updates(params, updates)
        return (params, state), value

    (params, state), values = jax.lax.scan(
        step, (params_one, opt.init(params_one)), None, length=maxiter
    )
    return params, fun(params)


def m_step_get_tuning_all_neuron_grouped(
    params_init, spk, tuning_basis, posterior_marg, prior_hyper, maxiter=500,
    stepsize=0.001, n_time_per_chunk=50000, n_neuron_per_chunk=100, dt=1,
):
    """Per-neuron LBFGS M-step vmapped over the neuron axis
    (reference fit_tuning_with_basis.py:100-115).

    params_init: ((n_basis, N), (N,)) weights/bias tuple.
    Returns (params_fit, tuning_fit (L, N), final_err)."""
    del stepsize, n_time_per_chunk  # optax.lbfgs line-searches its own step
    s_b, t_b = group_spk_occupancy_chunk_neuron(
        spk, posterior_marg, n_neuron_per_chunk=n_neuron_per_chunk, dt=dt
    )
    runner = vmap(
        partial(_lbfgs_one_neuron, basis=tuning_basis, t_b=t_b,
                prior_hyper=prior_hyper, maxiter=maxiter),
        in_axes=((-1, -1), -1),
        out_axes=((-1, -1), -1),
    )
    params_fit, final_losses = runner(params_init, s_b)
    tuning_fit = glm_get_tuning(params_fit, tuning_basis)
    return params_fit, tuning_fit, final_losses.sum()


def get_s_b(spk_chunk, post_x_l):
    """Posterior-weighted spikes per latent state, (L, N)
    (reference fit_tuning_with_basis.py:55-57), at the module's
    ``PRECISION``."""
    import jax.numpy as jnp

    return jnp.matmul(post_x_l.T, spk_chunk, precision=PRECISION)
