"""Emission log-likelihoods, in matmul form.

Redesign of the reference emission layer
(reference: poor_man_gplvm/decoder.py:30-149).

The reference computes the (T, L) log-likelihood with a vmap over time of an
elementwise (L, N) reduction.  Here the same quantity is exactly two
matmuls, which XLA hands to the accelerator's matmul units:

Poisson (lam = tuning*dt + RATE_FLOOR, all entries > 0 so xlogy == y*log):
    ll[t, l] = (ma*y)[t] @ log(lam)[l]  -  ma[t] @ lam[l]
               - sum_n ma[t, n] * gammaln(y[t, n] + 1)

Gaussian (mu = tuning*dt, scalar noise_std):
    ll[t, l] = -1/(2 s^2) * ( (ma*y^2)[t].sum - 2 (ma*y)[t] @ mu[l]
                              + ma[t] @ (mu^2)[l] )
               - (log s + log sqrt(2 pi)) * ma[t].sum

Constants mirror the reference exactly: RATE_FLOOR=1e-20 (decoder.py:39),
masked latent bins forced to MASK_NEG=-1e20 (decoder.py:46).
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
from jax.scipy.special import gammaln, logsumexp

RATE_FLOOR = 1e-20
MASK_NEG = -1e20

# Log-likelihoods feed log-marginal parity targets (<=1e-5 relative), so
# these contractions run at float32 accuracy, not the accelerator's default
# reduced-precision inputs (TF32 on GPUs).  Switchable with
# config.set_matmul_precision.
PRECISION = jax.lax.Precision.HIGHEST

__all__ = [
    "RATE_FLOOR",
    "MASK_NEG",
    "poisson_loglik",
    "poisson_lgamma_term",
    "gaussian_loglik",
    "get_loglikelihood_ma_all",
    "get_loglikelihood_ma_all_changing_dt",
    "get_naive_bayes_ma",
    "get_naive_bayes_ma_chunk",
]


def _broadcast_neuron_mask(ma_neuron, y):
    ma_neuron = jnp.asarray(ma_neuron, dtype=y.dtype)
    return jnp.broadcast_to(ma_neuron, y.shape)


def poisson_lgamma_term(y, ma_neuron):
    """(T,) mask-weighted ``sum_n gammaln(y+1)`` — the parameter-free part
    of the Poisson LL.  Data-only, so it is loop-invariant across EM
    iterations: the fused EM fast path computes it ONCE per fit and feeds
    it back through ``lgamma_term=`` (measured ~31 ms/EM-iteration saved at
    T=1e6, N=500 — gammaln over (T, N) is the single most expensive
    elementwise op in the iteration)."""
    y = jnp.asarray(y)
    ma_neuron = jnp.asarray(ma_neuron, dtype=y.dtype)
    # elementwise-multiply + reduce, NOT a matvec: a matmul operand forces
    # XLA to materialize the (T, N) gammaln output as a real HBM buffer
    # (2 GB at the north-star — measured to tip the fused EM program into
    # RESOURCE_EXHAUSTED), while this form fuses the transcendental into
    # the row reduction with no temporary
    if ma_neuron.ndim == 1:
        ma_neuron = ma_neuron[None, :]
    return (gammaln(y + 1.0) * ma_neuron).sum(axis=-1)


def poisson_loglik(y, tuning, ma_neuron, ma_latent, dt=1.0, lgamma_term=None):
    """(T, L) Poisson log-likelihood via matmuls.

    y: (T, N) counts; tuning: (L, N) rates; ma_neuron: (N,) or (T, N);
    ma_latent: (L,); dt: scalar or (T,); lgamma_term: optional precomputed
    ``poisson_lgamma_term(y, ma_neuron)`` (loop-invariant across EM
    iterations).
    Matches reference decoder.py:31-48 elementwise semantics exactly.
    """
    y = jnp.asarray(y)
    ma_1d = jnp.asarray(ma_neuron, dtype=y.dtype)
    if lgamma_term is None:
        lgamma_term = poisson_lgamma_term(y, ma_1d)

    dt_arr = jnp.asarray(dt)
    if dt_arr.ndim == 0:
        lam = tuning * dt_arr + RATE_FLOOR  # (L, N)
        log_lam = jnp.log(lam)
        if ma_1d.ndim == 1:
            # static neuron mask: fold it into the (L, N) side — ONE
            # (T, N)@(N, L) matmul instead of two and no (T, N)
            # temporaries (the "- sum_n ma*lam" term is an (L,) vector).
            # Same contraction, same result to f32 rounding (~2e-7 rel);
            # measured 90 -> 75 ms at T=1e6, L=N=500 (44 ms with the
            # lgamma term hoisted).
            ll = (
                jnp.matmul(y, (log_lam * ma_1d[None, :]).T,
                           precision=PRECISION)
                - (lam * ma_1d[None, :]).sum(axis=-1)[None, :]
                - lgamma_term[:, None]
            )
        else:
            ma = _broadcast_neuron_mask(ma_1d, y)
            ll = (
                jnp.matmul(y * ma, log_lam.T, precision=PRECISION)
                - jnp.matmul(ma, lam.T, precision=PRECISION)
                - lgamma_term[:, None]
            )
    else:
        ma = _broadcast_neuron_mask(ma_1d, y)
        ym = y * ma
        # per-time dt: the 1e-20 floor does not factor out of log(tuning*dt),
        # so fall back to a time-batched elementwise contraction (only the
        # naive-Bayes path uses changing dt; cf. decoder.py:73-85).
        lam = tuning[None, :, :] * dt_arr[:, None, None] + RATE_FLOOR  # (T,L,N)
        ll = (
            jnp.einsum("tn,tln->tl", ym, jnp.log(lam), precision=PRECISION)
            - jnp.einsum("tn,tln->tl", ma, lam, precision=PRECISION)
            - lgamma_term[:, None]
        )

    return jnp.where(jnp.asarray(ma_latent, dtype=bool)[None, :], ll, MASK_NEG)


def gaussian_loglik(y, tuning, noise_std, ma_neuron, ma_latent, dt=1.0):
    """(T, L) Gaussian log-likelihood via matmuls.

    Matches reference decoder.py:50-57; ``noise_std`` may be a scalar or a
    per-neuron (N,) vector (the reference broadcasts it through
    ``norm.logpdf``)."""
    y = jnp.asarray(y)
    ma = _broadcast_neuron_mask(ma_neuron, y)
    dt_arr = jnp.asarray(dt)
    noise_std = jnp.asarray(noise_std)
    const = -(jnp.log(noise_std) + 0.5 * math.log(2.0 * math.pi))

    if dt_arr.ndim == 0:
        mu = tuning * dt_arr  # (L, N)
        w = 1.0 / (noise_std**2)  # scalar or (N,) precision weights
        quad = (
            (ma * y * y * w).sum(axis=-1)[:, None]
            - 2.0 * jnp.matmul(ma * y * w, mu.T, precision=PRECISION)
            + jnp.matmul(ma * w, (mu * mu).T, precision=PRECISION)
        )
        ll = -0.5 * quad + (ma * const).sum(axis=-1)[:, None]
    else:
        mu = tuning[None, :, :] * dt_arr[:, None, None]  # (T, L, N)
        resid = (y[:, None, :] - mu) / noise_std
        ll = (-0.5 * resid * resid + const) * ma[:, None, :]
        ll = ll.sum(axis=-1)

    return jnp.where(jnp.asarray(ma_latent, dtype=bool)[None, :], ll, MASK_NEG)


@partial(jax.jit, static_argnames=["observation_model"])
def get_loglikelihood_ma_all(
    y_l, tuning, hyperparam, ma_neuron, ma_latent, observation_model="poisson",
    lgamma_term=None,
):
    """(T, L) log-likelihood, dt=1 (reference decoder.py:60-71).

    ``lgamma_term``: optional precomputed ``poisson_lgamma_term`` (Poisson
    only) so callers that evaluate the LL many times on the same data (the
    fused EM iteration scan) skip the per-call gammaln over (T, N)."""
    if observation_model == "poisson":
        return poisson_loglik(y_l, tuning, ma_neuron, ma_latent,
                              lgamma_term=lgamma_term)
    return gaussian_loglik(y_l, tuning, hyperparam["noise_std"], ma_neuron, ma_latent)


@partial(jax.jit, static_argnames=["observation_model"])
def get_loglikelihood_ma_all_changing_dt(
    y_l, tuning, hyperparam, ma_neuron, ma_latent, dt_l, observation_model="poisson"
):
    """(T, L) log-likelihood with per-time dt (reference decoder.py:73-85)."""
    if observation_model == "poisson":
        return poisson_loglik(y_l, tuning, ma_neuron, ma_latent, dt=dt_l)
    return gaussian_loglik(
        y_l, tuning, hyperparam["noise_std"], ma_neuron, ma_latent, dt=dt_l
    )


@partial(jax.jit, static_argnames=["observation_model"])
def get_naive_bayes_ma(
    y_l, tuning, hyperparam, ma_neuron, ma_latent, dt_l=1.0, observation_model="poisson"
):
    """Per-time posterior with no temporal smoothing
    (reference decoder.py:88-102).

    Returns (log_post (T,L), log_marginal_l (T,), log_marginal scalar,
    ll_per_pos_l (T,L))."""
    dt_arr = jnp.asarray(dt_l, dtype=jnp.float32)
    if dt_arr.ndim == 0:
        # scalar dt (the common case): the fixed-dt matmul form is exact and
        # avoids the changing-dt path's (T, L, N) elementwise tensor
        # (~100x less HBM traffic at T=1e5, L=N=100)
        if observation_model == "poisson":
            ll = poisson_loglik(y_l, tuning, ma_neuron, ma_latent, dt=dt_arr)
        else:
            ll = gaussian_loglik(
                y_l, tuning, hyperparam["noise_std"], ma_neuron, ma_latent,
                dt=dt_arr,
            )
    else:
        ll = get_loglikelihood_ma_all_changing_dt(
            y_l, tuning, hyperparam, ma_neuron, ma_latent, dt_arr,
            observation_model=observation_model,
        )
    log_marginal_l = logsumexp(ll, axis=-1, keepdims=True)
    log_post = ll - log_marginal_l
    log_marginal = jnp.sum(log_marginal_l)
    return log_post, log_marginal_l[:, 0], log_marginal, ll


def get_naive_bayes_ma_chunk(
    y,
    tuning,
    hyperparam,
    ma_neuron,
    ma_latent,
    dt_l=1.0,
    n_time_per_chunk=10000,
    observation_model="poisson",
):
    """Chunked naive Bayes (reference decoder.py:106-149).

    Chunking here is purely a peak-memory knob; results are chunk-invariant.
    Returns (log_post_l, log_marginal_l, log_marginal_total, ll_per_pos_l)."""
    n_time_tot = y.shape[0]
    n_chunks = -(-n_time_tot // n_time_per_chunk)
    # keep scalar dt scalar: per-time dt forces the (T, L, N) elementwise
    # likelihood path; the scalar matmul form is ~100x less HBM traffic
    dt_arr = jnp.asarray(dt_l, dtype=jnp.float32)
    if dt_arr.ndim > 0:
        dt_arr = jnp.broadcast_to(dt_arr, (n_time_tot,))
    # keep a (N,) mask un-broadcast: the likelihoods broadcast it per chunk
    # internally, and materializing a (T, N) copy up front would add an
    # O(T*N) device buffer — the very thing this chunked driver bounds
    ma_neuron = jnp.asarray(ma_neuron, dtype=jnp.float32)
    ma_is_2d = ma_neuron.ndim == 2

    log_post_l, log_marginal_l_l, ll_l = [], [], []
    log_marginal_total = 0.0
    for n in range(n_chunks):
        sl = slice(n * n_time_per_chunk, (n + 1) * n_time_per_chunk)
        log_post, lml_l, lml, ll = get_naive_bayes_ma(
            y[sl], tuning, hyperparam,
            ma_neuron[sl] if ma_is_2d else ma_neuron, ma_latent,
            dt_arr if dt_arr.ndim == 0 else dt_arr[sl],
            observation_model=observation_model,
        )
        log_post_l.append(log_post)
        log_marginal_l_l.append(lml_l)
        ll_l.append(ll)
        log_marginal_total = log_marginal_total + lml
    return (
        jnp.concatenate(log_post_l, axis=0),
        jnp.concatenate(log_marginal_l_l, axis=0),
        log_marginal_total,
        jnp.concatenate(ll_l, axis=0),
    )
