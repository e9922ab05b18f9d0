"""Sequential HMM filter/smoother as Pallas kernels through Triton.

Under ``lax.scan`` every time step of the forward or backward recursion is
a handful of separately launched GPU kernels around ~40 kFLOP of real work
at L=100, so the scan is bound by launch latency.  These kernels run the
whole recursion in ONE program per sequence: the time loop is inside the
kernel, the carry stays in registers, and the (L, L) latent transition is
loaded once and held in registers for every step.  Per step the program
does one (1, L) @ (L, L) vector-matrix product per dynamics channel (a
broadcast multiply and a reduction; Triton's dot wants at least 16 rows),
and a uniform-row channel (the jump transition) replaces its product with
a scalar sum.  The likelihood enters as precomputed max-shifted weights
``exp(scale * (ll - rowmax))``, so no transcendental sits on the
sequential path.

The transition block lives in registers, so the kernels are built for
``L <= engine.KERNEL_MAX_L`` only.  Layout: the latent axis is padded to a
power of two (Triton's block shapes); padded columns carry zero transition
mass and zero weight, so they hold exactly zero posterior.  The time axis
is not padded.

Both the joint model (n_dyn=2) and the latent-only model (n_dyn=1, trivial
dynamics) use the same kernels.  ``interpret=True`` runs them with the
Pallas interpreter (tests on the CPU).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from poor_man_gplvm_tpu.ops.emissions import PRECISION

NUM_WARPS = 8


def _pow2(x):
    return max(16, 1 << (int(x) - 1).bit_length())


def _call(kernel, out_shape, interpret, name):
    return pl.pallas_call(
        kernel,
        out_shape=out_shape,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name=name,
    )


def _pad_lat(x, Lp, axes):
    pad = [(0, 0)] * x.ndim
    for a in axes:
        pad[a] = (0, Lp - x.shape[a])
    return jnp.pad(x.astype(jnp.float32), pad)


# ---------------------------------------------------------------------------
# forward (causal filter)
# ---------------------------------------------------------------------------


def _filter_kernel(w_ref, tlat_ref, tdyn_ref, init_ref, post_ref, prior_ref,
                   *, n_dyn, T, uniform_rows):
    tdyn = [[tdyn_ref[p, d] for d in range(n_dyn)] for p in range(n_dyn)]
    # uniform channels keep one row, the others their whole block
    mats = [tlat_ref[d, 0] if uniform_rows[d] else tlat_ref[d]
            for d in range(n_dyn)]

    def body(t, carry):
        w = w_ref[t]
        priors = []
        for d in range(n_dyn):
            q = tdyn[0][d] * carry[0]
            for p in range(1, n_dyn):
                q = q + tdyn[p][d] * carry[p]
            if uniform_rows[d]:
                priors.append(jnp.sum(q) * mats[d])
            else:
                priors.append(jnp.sum(q[:, None] * mats[d], axis=0))
        us = [pr * w for pr in priors]
        s = us[0].sum()
        for u in us[1:]:
            s = s + u.sum()
        # guard like the prob engine: all prior mass on zero-weight bins
        # must degrade gracefully, not NaN-poison the carry
        inv = 1.0 / jnp.maximum(s, 1e-38)
        new = tuple(u * inv for u in us)
        for d in range(n_dyn):
            post_ref[t, d] = new[d]
            prior_ref[t, d] = priors[d]
        return new

    init = tuple(init_ref[d] for d in range(n_dyn))
    jax.lax.fori_loop(0, T, body, init)


@functools.partial(jax.jit,
                   static_argnames=["uniform_rows", "interpret"])
def filter_chunk_pallas(ll, tlat, tdyn, p_init, likelihood_scale,
                        uniform_rows, interpret=False):
    """Causal filter over (T, L) log-likelihoods.

    ll: (T, L); tlat: (n_dyn, L, L) row-stochastic; tdyn: (n_dyn, n_dyn);
    p_init: (n_dyn, L) probability-space carry; ``uniform_rows``: static
    per-channel flags (``hmm._uniform_row_flags``).
    Returns (post (T, n_dyn, L), prior (T, n_dyn, L), ratios (T,)).
    """
    T, L = ll.shape
    n_dyn = tlat.shape[0]
    Lp = _pow2(L)
    m = jnp.max(ll, axis=1)
    w = jnp.exp(likelihood_scale * (ll - m[:, None]))
    sds = jax.ShapeDtypeStruct((T, n_dyn, Lp), jnp.float32)
    post, prior = _call(
        functools.partial(_filter_kernel, n_dyn=n_dyn, T=T,
                          uniform_rows=tuple(uniform_rows)),
        [sds, sds], interpret, "hmm_filter",
    )(_pad_lat(w, Lp, (1,)), _pad_lat(tlat, Lp, (1, 2)),
      tdyn.astype(jnp.float32), _pad_lat(p_init, Lp, (1,)))
    post, prior = post[..., :L], prior[..., :L]
    # per-step log-marginal ratios, recomputed vectorized over T
    s = jnp.einsum("tdl,tl->t", prior, w, precision=PRECISION)
    ratios = jnp.log(s) + likelihood_scale * m
    return post, prior, ratios


# ---------------------------------------------------------------------------
# backward (acausal smoother)
# ---------------------------------------------------------------------------


def _smoother_kernel(filt_ref, prior_ref, tlatT_ref, tdyn_ref, init_ref,
                     smooth_ref, r_ref, *, n_dyn, T, uniform_rows):
    tdyn = [[tdyn_ref[d, e] for e in range(n_dyn)] for d in range(n_dyn)]
    # the pull s[e] = Tlat[e] @ r[e] = r[e] @ Tlat[e]^T (tlatT_ref holds
    # the transposed blocks); a constant channel's pull is sum(r) times
    # its first transposed row
    mats = [tlatT_ref[e, 0] if uniform_rows[e] else tlatT_ref[e]
            for e in range(n_dyn)]

    def body(i, carry):
        t = T - 1 - i
        rs, ss = [], []
        for e in range(n_dyn):
            pr = prior_ref[t, e]
            safe = jnp.where(pr > 0, pr, 1.0)
            r = jnp.where(pr > 0, carry[e] / safe, 0.0)
            rs.append(r)
            if uniform_rows[e]:
                ss.append(jnp.sum(r) * mats[e])
            else:
                ss.append(jnp.sum(r[:, None] * mats[e], axis=0))
        sms = []
        for d in range(n_dyn):
            pull = tdyn[d][0] * ss[0]
            for e in range(1, n_dyn):
                pull = pull + tdyn[d][e] * ss[e]
            sms.append(filt_ref[t, d] * pull)
        norm = sms[0].sum()
        for sm in sms[1:]:
            norm = norm + sm.sum()
        inv = 1.0 / jnp.maximum(norm, 1e-38)
        new = tuple(sm * inv for sm in sms)
        for d in range(n_dyn):
            smooth_ref[t, d] = new[d]
            r_ref[t, d] = rs[d]
        return new

    init = tuple(init_ref[d] for d in range(n_dyn))
    jax.lax.fori_loop(0, T, body, init)


@functools.partial(jax.jit,
                   static_argnames=["uniform_rows", "interpret"])
def smoother_chunk_pallas(filt_xs, prior_xs, tlat, tdyn, smooth_init,
                          uniform_rows, interpret=False):
    """Backward smoother over (T', n_dyn, L) filter posteriors and the
    +1-shifted priors.  Returns (smooth (T', n_dyn, L), ratios (T', n_dyn,
    L)), ratios being the smoother/prior pull ratios the pairwise joint is
    accumulated from."""
    T, n_dyn, L = filt_xs.shape
    Lp = _pow2(L)
    sds = jax.ShapeDtypeStruct((T, n_dyn, Lp), jnp.float32)
    smooth, r = _call(
        functools.partial(_smoother_kernel, n_dyn=n_dyn, T=T,
                          uniform_rows=tuple(uniform_rows)),
        [sds, sds], interpret, "hmm_smoother",
    )(_pad_lat(filt_xs, Lp, (2,)), _pad_lat(prior_xs, Lp, (2,)),
      _pad_lat(jnp.swapaxes(tlat, -1, -2), Lp, (1, 2)),
      tdyn.astype(jnp.float32), _pad_lat(smooth_init, Lp, (1,)))
    return smooth[..., :L], r[..., :L]
