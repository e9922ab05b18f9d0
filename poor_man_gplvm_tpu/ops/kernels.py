"""Kernel functions and transition-matrix builders.

Reimplementation of the reference kernel layer
(reference: poor_man_gplvm/gp_kernel.py:14-149).  Instead of the reference's
vmap-of-vmap over scalar kernel closures, every kernel here is built as one
vectorized broadcast over the full (L, L) grid, which XLA lowers to a handful
of fused VPU ops — no per-element dispatch, static shapes throughout.

Every kernel returns ``(val, log_val)`` pairs like the reference so that both
probability-space (fast path) and log-space (exactness path) inference
engines share one source of truth.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp

__all__ = [
    "rbf_kernel",
    "rbf_kernel_multi_d",
    "uniform_kernel",
    "discrete_transition_kernel",
    "rbf_gram",
    "uniform_gram",
    "create_transition_prob_1d",
    "create_transition_prob_latent_1d",
    "get_custom_kernel_rbf_plus_isolated",
]


def _safe_log(val):
    """log with -inf for zeros (mirrors reference behaviour: the reference's
    get_log clamp at gp_kernel.py:8-12 compares against +inf and therefore
    never fires for zero inputs, so zeros map to -inf there too)."""
    return jnp.where(val > 0, jnp.log(jnp.where(val > 0, val, 1.0)), -jnp.inf)


# ---------------------------------------------------------------------------
# scalar-convention kernels (kept for API parity; cf. gp_kernel.py:14-40)
# ---------------------------------------------------------------------------

def rbf_kernel(x, y, ls, var):
    """RBF kernel ``exp(-||x-y||^2 / ls^2) * var`` (note: no factor 1/2,
    matching reference gp_kernel.py:15-20). Returns (val, log_val)."""
    dist_sq = jnp.sum(jnp.square(jnp.asarray(x) - jnp.asarray(y)))
    log_val = -dist_sq / ls**2 + jnp.log(var)
    return jnp.exp(log_val), log_val


def rbf_kernel_multi_d(x, y, ls, var):
    """Multi-dimensional RBF with per-dimension lengthscales
    (reference gp_kernel.py:22-27)."""
    dist_sq_per_dim = jnp.square(jnp.asarray(x) - jnp.asarray(y))
    log_val = -jnp.sum(dist_sq_per_dim / jnp.asarray(ls) ** 2) + jnp.log(var)
    return jnp.exp(log_val), log_val


def uniform_kernel(x, y, n_state):
    """Uniform kernel 1/n (reference gp_kernel.py:36-40)."""
    val = 1.0 / n_state
    return val, jnp.log(val)


def discrete_transition_kernel(x, y, trans_mat):
    """Table-lookup kernel (reference gp_kernel.py:30-34)."""
    val = trans_mat[x, y]
    return val, _safe_log(val)


# ---------------------------------------------------------------------------
# vectorized Gram builders (device path)
# ---------------------------------------------------------------------------

def rbf_gram(points, ls, var=1.0):
    """Full (L, L) RBF Gram matrix in one broadcast.

    ``gram[i, j] = exp(-(points[i]-points[j])^2 / ls^2) * var``
    Returns (val, log_val).
    """
    points = jnp.asarray(points, dtype=jnp.float32)
    diff = points[:, None] - points[None, :]
    log_val = -(diff * diff) / (ls**2) + jnp.log(var)
    return jnp.exp(log_val), log_val


def uniform_gram(n_state, dtype=jnp.float32):
    """(n, n) uniform matrix with value 1/n. Returns (val, log_val)."""
    val = jnp.full((n_state, n_state), 1.0 / n_state, dtype=dtype)
    return val, jnp.log(val)


def _row_normalize(val, log_val):
    """Row-normalize a kernel matrix in both prob and log space
    (reference gp_kernel.py:77-79)."""
    normalizer = val.sum(axis=-1, keepdims=True)
    return val / normalizer, log_val - jnp.log(normalizer)


# ---------------------------------------------------------------------------
# transition-probability builders
# ---------------------------------------------------------------------------

@jax.jit
def create_transition_prob_1d(
    possible_latent_bin,
    possible_dynamics,
    movement_variance=1.0,
    p_move_to_jump=0.01,
    p_jump_to_move=0.01,
    custom_kernel=None,
):
    """Build the (dynamics-conditioned) latent transition stack and the 2x2
    dynamics transition matrix (reference gp_kernel.py:43-89).

    Per-dynamics latent kernels: ``[RBF(movement_variance as lengthscale),
    uniform]`` (or ``[custom_kernel, uniform]``), each row-normalized.
    NOTE: like the reference (gp_kernel.py:57-59), ``movement_variance`` is
    used as the RBF *lengthscale* argument.

    Returns
    -------
    (latent_transition_kernel_l, log_latent_transition_kernel_l,
     dynamics_transition_kernel, log_dynamics_transition_kernel)
    with shapes ((n_dyn, L, L), (n_dyn, L, L), (n_dyn, n_dyn), (n_dyn, n_dyn)).
    """
    possible_latent_bin = jnp.asarray(possible_latent_bin)
    n_latent_bin = possible_latent_bin.shape[0]

    if custom_kernel is None:
        move_val, move_log = rbf_gram(possible_latent_bin, movement_variance, 1.0)
    else:
        custom_kernel = jnp.asarray(custom_kernel)
        move_val = custom_kernel
        move_log = _safe_log(custom_kernel)
    move_val, move_log = _row_normalize(move_val, move_log)

    jump_val, jump_log = uniform_gram(n_latent_bin)
    jump_val, jump_log = _row_normalize(jump_val, jump_log)

    latent_transition_kernel_l = jnp.stack([move_val, jump_val])
    log_latent_transition_kernel_l = jnp.stack([move_log, jump_log])

    dynamics_transition_kernel = jnp.array(
        [
            [1.0 - p_move_to_jump, p_move_to_jump],
            [p_jump_to_move, 1.0 - p_jump_to_move],
        ]
    )
    log_dynamics_transition_kernel = _safe_log(dynamics_transition_kernel)

    del possible_dynamics  # implied by the 2x2 structure; kept for API parity
    return (
        latent_transition_kernel_l,
        log_latent_transition_kernel_l,
        dynamics_transition_kernel,
        log_dynamics_transition_kernel,
    )


@jax.jit
def create_transition_prob_latent_1d(
    possible_latent_bin, movement_variance=1.0, custom_kernel=None
):
    """Single (L, L) latent transition matrix for the latent-only models
    (reference gp_kernel.py:91-119). Returns (val, log_val), row-normalized."""
    possible_latent_bin = jnp.asarray(possible_latent_bin)
    if custom_kernel is None:
        val, log_val = rbf_gram(possible_latent_bin, movement_variance, 1.0)
    else:
        custom_kernel = jnp.asarray(custom_kernel)
        val = custom_kernel
        log_val = _safe_log(custom_kernel)
    return _row_normalize(val, log_val)


def get_custom_kernel_rbf_plus_isolated(
    possible_latent_bin,
    tuning_lengthscale,
    transition_lengthscale,
    var=1.0,
    p_to_isolated=0.001,
):
    """RBF kernel plus one 'isolated' latent bin (index 0)
    (reference gp_kernel.py:122-149).

    Tuning kernel: isolated bin shares no smoothness with the others
    (its row/col zeroed, diagonal set to ``var``).
    Transition kernel: uniform row out of the isolated bin; fixed probability
    ``p_to_isolated`` into it from everywhere else; remaining mass row-
    normalized to ``1 - p_to_isolated``.
    """
    possible_latent_bin = jnp.asarray(possible_latent_bin)
    n_latent_bin = possible_latent_bin.shape[0]

    tuning_kernel, _ = rbf_gram(possible_latent_bin, tuning_lengthscale, var)
    tuning_kernel = tuning_kernel.at[0, :].set(0.0)
    tuning_kernel = tuning_kernel.at[:, 0].set(0.0)
    tuning_kernel = tuning_kernel.at[0, 0].set(var)

    transition_kernel, _ = rbf_gram(
        possible_latent_bin, transition_lengthscale, var
    )
    # NOTE: mirror of the reference's operation order (gp_kernel.py:145-148):
    # the `* (1/n)` there multiplies the WHOLE matrix after setting row 0 to
    # ones; rows 1: are subsequently renormalized so only row 0 keeps the 1/n.
    transition_kernel = transition_kernel.at[0, :].set(1.0) * (1.0 / n_latent_bin)
    transition_kernel = transition_kernel.at[1:, 0].set(p_to_isolated)
    rest = transition_kernel[1:, 1:]
    rest = rest / rest.sum(axis=1, keepdims=True) * (1.0 - p_to_isolated)
    transition_kernel = transition_kernel.at[1:, 1:].set(rest)
    return tuning_kernel, transition_kernel
