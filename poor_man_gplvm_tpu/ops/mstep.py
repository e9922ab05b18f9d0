"""M-step: sufficient statistics, tuning links, objectives, optimizers.

Equivalent of the reference M-step layer
(reference: poor_man_gplvm/fit_tuning_helper.py).

The EM M-step operates on *grouped* sufficient statistics
(posterior-weighted counts ``y_weighted`` (L, N) and posterior-weighted
occupancy ``t_weighted`` (L,)), so its cost is independent of T.  The
statistics themselves are one (T, L)^T @ (T, N) matmul.

The Poisson objective deliberately uses the grouped form
``sum xlogy(y_w, f) - f * t_w`` and NOT ``poisson.logpmf`` — the grouped
expectation of the log joint (reference fit_tuning_helper.py:79).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import optax

from poor_man_gplvm_tpu.ops.emissions import PRECISION
from jax import tree_util
from jax.scipy.special import xlogy
from jax.scipy.stats import norm

__all__ = [
    "get_tuning_linear",
    "get_tuning_softplus",
    "get_statistics",
    "gaussian_m_step_analytic",
    "poisson_m_step_objective",
    "poisson_m_step_objective_smoothness",
    "make_adam_runner",
    "make_adam_runner_cached",
    "tree_l2_norm",
]


@jax.jit
def get_tuning_linear(params, basis):
    """tuning = basis @ params; params: (n_basis, N), basis: (L, n_basis).
    The product runs at the module's ``PRECISION`` (f32-exact by default;
    see ``config.set_matmul_precision``)."""
    return jnp.matmul(basis, params, precision=PRECISION)


@jax.jit
def get_tuning_softplus(params, basis):
    """softplus link for nonnegative Poisson rates."""
    return jax.nn.softplus(get_tuning_linear(params, basis))


@jax.jit
def _get_statistics_block(log_posterior_probs, y):
    posterior_probs = jnp.exp(log_posterior_probs)
    y_weighted = jnp.matmul(posterior_probs.T, y, precision=PRECISION)
    t_weighted = posterior_probs.sum(axis=0)
    return y_weighted, t_weighted


def get_statistics(log_posterior_probs, y, n_time_per_chunk=200_000):
    """Posterior-weighted observation and occupancy per latent bin
    (reference fit_tuning_helper.py:28-42).

    Accumulated over time chunks so the exp + high-precision matmul
    transients stay O(chunk) at T ~ 1e6 scales (results identical up to
    float summation order).  Returns (y_weighted (L, N), t_weighted (L,))."""
    T = log_posterior_probs.shape[0]
    if T <= n_time_per_chunk:
        return _get_statistics_block(log_posterior_probs, y)
    y_weighted = None
    for start in range(0, T, n_time_per_chunk):
        sl = slice(start, start + n_time_per_chunk)
        yw, tw = _get_statistics_block(log_posterior_probs[sl], y[sl])
        if y_weighted is None:
            y_weighted, t_weighted = yw, tw
        else:
            y_weighted = y_weighted + yw
            t_weighted = t_weighted + tw
    return y_weighted, t_weighted


@jax.jit
def gaussian_m_step_analytic(hyperparam, basis_mat, y_weighted, t_weighted):
    """Closed-form ridge solve for Gaussian emissions
    (reference fit_tuning_helper.py:44-61):
    ``w = (B^T D B / s^2 + I / tau^2)^{-1} B^T y_w / s^2``.  The gram and
    right-hand-side products run at the module's ``PRECISION``."""
    n_basis = basis_mat.shape[1]
    noise_var = hyperparam["noise_std"] ** 2
    param_prior_std = hyperparam["param_prior_std"]
    gram = jnp.einsum("qd,q,qb->db", basis_mat, t_weighted, basis_mat,
                      precision=PRECISION)
    H = gram / noise_var + jnp.eye(n_basis) / (param_prior_std**2)
    rhs = jnp.matmul(basis_mat.T, y_weighted,
                     precision=PRECISION) / noise_var
    return jnp.linalg.solve(H, rhs)


def poisson_m_step_objective(param, hyperparam, basis_mat, y_weighted, t_weighted):
    """Negative expected log joint on grouped statistics + Gaussian prior
    (reference fit_tuning_helper.py:63-81)."""
    param_prior_std = hyperparam["param_prior_std"]
    pf_hat = get_tuning_softplus(param, basis_mat)  # (L, N)
    norm_term = pf_hat * t_weighted[:, None]
    fit_term = xlogy(y_weighted, pf_hat + 1e-20)
    log_likelihood = jnp.sum(fit_term - norm_term)
    log_prior = norm.logpdf(param, 0.0, param_prior_std).sum()
    return -log_likelihood - log_prior


def poisson_m_step_objective_smoothness(
    param, hyperparam, basis_mat, y_weighted, t_weighted
):
    """Poisson objective plus a squared-second-finite-difference roughness
    penalty on the tuning curves (reference fit_tuning_helper.py:83-119)."""
    param_prior_std = hyperparam["param_prior_std"]
    smoothness_penalty = hyperparam["smoothness_penalty"]
    tuning = get_tuning_softplus(param, basis_mat)
    second_diff = tuning[2:] - 2.0 * tuning[1:-1] + tuning[:-2]
    roughness_term = smoothness_penalty * jnp.sum(second_diff**2)
    norm_term = tuning * t_weighted[:, None]
    fit_term = xlogy(y_weighted, tuning + 1e-20)
    log_likelihood = jnp.sum(fit_term - norm_term)
    log_prior = norm.logpdf(param, 0.0, param_prior_std).sum()
    return -log_likelihood - log_prior + roughness_term


def tree_l2_norm(tree_x, squared=False):
    """L2 norm across a pytree (reference fit_tuning_helper.py:199-205)."""
    squared_tree = tree_util.tree_map(lambda leaf: jnp.sum(jnp.square(leaf)), tree_x)
    sqnorm = tree_util.tree_reduce(jnp.add, squared_tree)
    return sqnorm if squared else jnp.sqrt(sqnorm)


def make_adam_runner(fun, step_size, maxiter=1000, tol=1e-6):
    """jit'd while-loop Adam with the reference's stopping rule
    (reference fit_tuning_helper.py:124-196): run at least 5 warmup
    iterations, stop when the relative loss change drops below ``tol`` or at
    ``maxiter - 1``.  Loss/error histories are pre-allocated at ``maxiter``
    (trimmed host-side by callers for shape stability).

    Returns ``(run_fn, opt_init_fn)``; ``run_fn(init_params, opt_state,
    *args)`` -> dict with params / opt_state / n_iter / final_loss /
    final_error / loss_history / error_history.  The optimizer state is
    threaded across EM iterations by callers (reference core.py:316-326)."""
    opt = optax.adam(step_size)

    @jax.jit
    def run(init_params, opt_state, *args):
        params = init_params
        loss, grads = jax.value_and_grad(fun)(params, *args)
        error = tree_l2_norm(grads)

        loss_history = jnp.zeros(maxiter).at[0].set(loss)
        error_history = jnp.zeros(maxiter).at[0].set(error)
        carry = (0, params, opt_state, error, loss, loss, loss_history, error_history)

        def cond_fun(c):
            i, _, _, _, loss, loss_prev, _, _ = c
            min_iters = 5
            rel_change = jnp.abs(loss - loss_prev) / jnp.maximum(jnp.abs(loss), 1e-8)
            return (i < (maxiter - 1)) & ((i < min_iters) | (rel_change > tol))

        def body_fun(c):
            i, params, opt_state, _, loss, _, loss_hist, err_hist = c
            # NOTE: the first body iteration re-evaluates value_and_grad at
            # the unchanged init params, duplicating the pre-loop eval.
            # This mirrors the reference loop exactly
            # (fit_tuning_helper.py:168) — removing it would shift which
            # params the stopping rule and histories are evaluated at,
            # breaking loss_history/n_iter parity for a ~1/n_iter saving.
            new_loss, grads = jax.value_and_grad(fun)(params, *args)
            updates, new_opt_state = opt.update(grads, opt_state, params)
            new_params = optax.apply_updates(params, updates)
            new_error = tree_l2_norm(grads)
            new_i = i + 1
            return (
                new_i,
                new_params,
                new_opt_state,
                new_error,
                new_loss,
                loss,
                loss_hist.at[new_i].set(new_loss),
                err_hist.at[new_i].set(new_error),
            )

        i, params, opt_state, error, loss, _, loss_history, error_history = (
            jax.lax.while_loop(cond_fun, body_fun, carry)
        )
        return {
            "params": params,
            "opt_state": opt_state,
            "n_iter": i + 1,
            "final_loss": loss,
            "final_error": error,
            "loss_history": loss_history,
            "error_history": error_history,
        }

    return run, opt.init


def package_adam_result(adam_res, host_trim=True, extra=None):
    """Package an adam_runner result dict for m_step callers.

    ``host_trim=True`` (the default, for direct API use) trims the
    pre-allocated loss/error histories to the realized iteration count on the
    host.  ``host_trim=False`` returns device arrays untouched so fit_em can
    run sync-free and batch-trim after the EM loop (each host sync stalls
    the device queue)."""
    out = {
        "params": adam_res["params"],
        "opt_state": adam_res["opt_state"],
        "n_iter": adam_res["n_iter"],
        "final_loss": adam_res["final_loss"],
        "final_error": adam_res["final_error"],
        "loss_history": adam_res["loss_history"],
        "error_history": adam_res["error_history"],
    }
    if extra:
        out.update(extra)
    if host_trim:
        import numpy as np

        n_iter = int(adam_res["n_iter"])
        out["n_iter"] = n_iter
        out["loss_history"] = np.asarray(adam_res["loss_history"])[:n_iter]
        out["error_history"] = np.asarray(adam_res["error_history"])[:n_iter]
    return out


def batch_trim_m_step_histories(m_step_res_l):
    """Host-trim deferred (host_trim=False) M-step histories in one batch.

    Stacks all iterations' n_iter / loss_history / error_history device
    arrays and moves them host-side with three transfers total instead of
    three blocking syncs per EM iteration.  Mutates and returns the dict."""
    import numpy as np

    if not m_step_res_l.get("loss_history"):
        return m_step_res_l
    if isinstance(m_step_res_l["n_iter"][0], (int, np.integer)):
        return m_step_res_l  # already trimmed (host_trim=True path)
    n_arr = np.asarray(jnp.stack(m_step_res_l["n_iter"])).astype(int)
    loss_h = np.asarray(jnp.stack(m_step_res_l["loss_history"]))
    err_h = np.asarray(jnp.stack(m_step_res_l["error_history"]))
    m_step_res_l["n_iter"] = [int(v) for v in n_arr]
    m_step_res_l["loss_history"] = [loss_h[j, :v] for j, v in enumerate(n_arr)]
    m_step_res_l["error_history"] = [err_h[j, :v] for j, v in enumerate(n_arr)]
    return m_step_res_l


@functools.lru_cache(maxsize=64)
def make_adam_runner_cached(fun, step_size, maxiter=1000, tol=1e-6):
    """Memoized make_adam_runner: the jitted while-loop runner is shared
    across model instances / fit_em calls with the same optimizer config, so
    repeated fits (sweeps!) skip its recompilation.  The reference rebuilds
    (and recompiles) the runner on every fit_em call (core.py:841-846)."""
    return make_adam_runner(fun, step_size, maxiter=maxiter, tol=tol)
