"""Generic forward-backward smoother engines over discrete state spaces.

Redesign of the reference inference engine
(reference: poor_man_gplvm/decoder.py:151-332 and decoder_latentonly.py).

Design departures from the reference (all invisible at the API level — the
chunked driver returns the same 6-tuple of log-space arrays):

* One generic engine serves both the joint (dynamics x latent) and the
  latent-only models.  The state-space structure lives in a small pytree
  ``Transition`` object that knows how to push a distribution forward
  (``push``), pull a smoother ratio backward (``pull``), and weight the
  pairwise-joint accumulation (``outer_acc``).

* The default engine (``engine='prob'``) runs the classic *scaled* forward
  /backward recursions in probability space: per step the transition apply is
  a dense matvec and the likelihood enters via a
  max-shifted exp, with the per-step normalizer accumulated as the running
  log-marginal.  This avoids the reference's per-step (state,)-shaped
  logsumexp trees entirely.

* The smoother does NOT carry the (n_dyn, n_dyn, L, L) accumulated pairwise
  joint through the scan (reference decoder.py:219-221 carries ~1M floats per
  step at L=500).  In probability space the accumulated joint factorizes:

      acc[d,e,i,j] = Tdyn[d,e] * Tlat[e,i,j] * sum_t filt_t[d,i] * r_t[e,j]

  where r_t = smooth_t / prior_t, so the whole accumulation is ONE
  (T, S)^T @ (T, S) matmul after the scan — matmul work instead of
  scan-carry bandwidth.

* ``engine='log'`` is a faithful log-space mirror of the reference's
  operation order, used for exactness tests and as a fallback.

* Which engine runs is decided by ``ops.engine.resolve_engine`` (the one
  place that looks at the platform); memory thresholds are fractions of
  ``ops.engine.device_memory_budget``.

Chunking (``n_time_per_chunk``) is preserved as the peak-memory knob and is
mathematically exact, as in the reference (decoder.py:258-332).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.scipy.special import logsumexp

from poor_man_gplvm_tpu.ops import engine as eng
from poor_man_gplvm_tpu.ops.emissions import (
    PRECISION,
    get_loglikelihood_ma_all,
    get_loglikelihood_ma_all_changing_dt,
)

# Zero-probability sentinel for log-space accumulators and floors.  The
# reference uses -1e40 (decoder.py:240), which is NOT representable in
# float32: embedding it as an f32 constant overflows to -inf with a
# RuntimeWarning on every trace.  We use the largest representable
# magnitude instead — numerically interchangeable (exp() underflows to 0
# and logaddexp(JOINT_ACC_INIT, x) == x exactly for any finite x of
# ordinary scale), but finite, so log-space subtractions stay NaN-free
# and traces stay warning-free.
JOINT_ACC_INIT = -3.0e38

__all__ = [
    "LatentTransition",
    "JointTransition",
    "smooth_combined_chunked",
    "filter_combined",
    "compute_transition_posterior_prob",
    "compute_transition_posterior_prob_latent",
    "prob_to_log",
]


def prob_to_log(p, floor=JOINT_ACC_INIT):
    """Elementwise log with a finite floor for exact zeros.

    Probability-space inference underflows tiny posteriors to 0; the log-space
    reference would report large negative values there.  Anything below
    float32 tiny carries no probability mass, so we floor at ``floor``
    (default ``JOINT_ACC_INIT = -3.0e38``, the f32-representable stand-in
    for the reference's -1e40 untouched-joint init — see its comment)."""
    return jnp.where(p > 0, jnp.log(jnp.where(p > 0, p, 1.0)), floor)


# ---------------------------------------------------------------------------
# Transition structures
# ---------------------------------------------------------------------------


def _uniform_row_flags(mats):
    """Static per-matrix flags: True when a (stack of) transition matrices
    is CONSTANT — every entry equal, the jump channel's uniform law — which
    lets the sequential kernels replace that channel's matvec with a scalar
    sum.  The constant-entry requirement (not merely identical rows) is
    what makes the smoother's ``sum(r) * row`` pull shortcut exact.
    Concrete matrices only; tracers get all-False.

    The flag count is ONE per matrix (1 for a 2-D input, n_dyn for a 3-D
    stack) in every branch: these tuples are pytree aux data, so a
    trace-time fallback with a different length than the concrete path
    would make structurally-identical Transitions incompatible across
    jit/vmap contexts."""
    n = 1 if len(mats.shape) == 2 else mats.shape[0]
    try:
        arr = np.asarray(mats).reshape((n,) + tuple(mats.shape[-2:]))
    except Exception:
        return tuple(False for _ in range(n))
    return tuple(
        bool(np.all(np.abs(a - a[0, 0]) < 1e-12)) for a in arr
    )


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class LatentTransition:
    """Latent-only (L, L) transition (reference decoder_latentonly.py)."""

    T: jnp.ndarray  # (L, L) row-normalized, prob space; T[i, j] = p(j | i)
    logT: jnp.ndarray  # (L, L)
    uniform_rows: tuple = None

    def __post_init__(self):
        if self.uniform_rows is None:
            object.__setattr__(
                self, "uniform_rows", _uniform_row_flags(self.T)
            )

    def tree_flatten(self):
        return (self.T, self.logT), self.uniform_rows

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, uniform_rows=aux)

    # shapes / inits ---------------------------------------------------
    @property
    def n_latent(self):
        return self.T.shape[-1]

    def uniform_log_init(self):
        L = self.n_latent
        return jnp.log(jnp.ones((L,), dtype=self.T.dtype) / L)

    def bcast_ll(self, x):
        return x

    def latent_marginal_log(self, logp):
        return logp

    def split_marginals(self, p):
        return p, None

    # probability-space engine ----------------------------------------
    def push(self, p):
        return jnp.matmul(p, self.T, precision=PRECISION)

    def push_batch(self, p):
        # (T', L) -> (T', L): one batched matmul, parallel over time
        return jnp.matmul(p, self.T, precision=PRECISION)

    def pull(self, r):
        return jnp.matmul(self.T, r, precision=PRECISION)

    def outer_acc(self, P, R):
        # P: (T', L) filter posteriors; R: (T', L) smooth/prior ratios
        return jnp.einsum("ti,tj->ij", P, R, precision=PRECISION) * self.T

    def joint_shape(self):
        L = self.n_latent
        return (L, L)

    # sequential-kernel engine ---------------------------------------
    def pallas_filter(self, ll, p_init, likelihood_scale, interpret):
        from poor_man_gplvm_tpu.ops.pallas import scan_kernels as sk

        post, prior, ratios = sk.filter_chunk_pallas(
            ll, self.T[None], jnp.ones((1, 1), dtype=self.T.dtype),
            p_init[None], likelihood_scale, uniform_rows=self.uniform_rows,
            interpret=interpret,
        )
        return post[:, 0], prior[:, 0], ratios

    def pallas_smooth(self, filt_xs, prior_xs, smooth_init, interpret):
        from poor_man_gplvm_tpu.ops.pallas import scan_kernels as sk

        smooth, r = sk.smoother_chunk_pallas(
            filt_xs[:, None], prior_xs[:, None],
            self.T[None], jnp.ones((1, 1), dtype=self.T.dtype),
            smooth_init[None], uniform_rows=self.uniform_rows,
            interpret=interpret,
        )
        return smooth[:, 0], r[:, 0]

    # log-space engine (reference op order) ---------------------------
    def push_log(self, logp):
        return logsumexp(logp[:, None] + self.logT, axis=0)

    def smooth_step_log(self, log_smooth_next, log_filt_curr, log_prior_next):
        inside = (
            self.logT
            + (log_smooth_next - log_prior_next)[None, :]
            + log_filt_curr[:, None]
        )
        return logsumexp(inside, axis=1), inside


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class JointTransition:
    """Joint dynamics x latent transition (reference decoder.py:151-256).

    State shape (n_dyn, L).  Forward push applies the dynamics transition
    first, then the dynamics-conditioned latent transition — same order as
    reference decoder.py:160-164."""

    Tdyn: jnp.ndarray  # (n_dyn, n_dyn); Tdyn[d, e] = p(e | d)
    Tlat: jnp.ndarray  # (n_dyn, L, L); Tlat[e, i, j] = p(j | i, dyn=e)
    logTdyn: jnp.ndarray
    logTlat: jnp.ndarray
    uniform_rows: tuple = None

    def __post_init__(self):
        if self.uniform_rows is None:
            object.__setattr__(
                self, "uniform_rows", _uniform_row_flags(self.Tlat)
            )

    def tree_flatten(self):
        return (
            self.Tdyn, self.Tlat, self.logTdyn, self.logTlat,
        ), self.uniform_rows

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, uniform_rows=aux)

    # shapes / inits ---------------------------------------------------
    @property
    def n_latent(self):
        return self.Tlat.shape[-1]

    @property
    def n_dyn(self):
        return self.Tdyn.shape[0]

    def uniform_log_init(self):
        n_dyn, L = self.n_dyn, self.n_latent
        return jnp.log(jnp.ones((n_dyn, L), dtype=self.Tlat.dtype) / (n_dyn * L))

    def bcast_ll(self, x):
        return x[None, :]

    def latent_marginal_log(self, logp):
        return logsumexp(logp, axis=-2)

    def split_marginals(self, p):
        return p.sum(axis=-2), p.sum(axis=-1)

    # probability-space engine ----------------------------------------
    def push(self, p):
        q = jnp.einsum("pl,pd->dl", p, self.Tdyn, precision=PRECISION)
        return jnp.einsum("di,dij->dj", q, self.Tlat, precision=PRECISION)

    def push_batch(self, p):
        # (T', n_dyn, L) -> (T', n_dyn, L): batched matmuls, parallel over time
        q = jnp.einsum("tpl,pd->tdl", p, self.Tdyn, precision=PRECISION)
        return jnp.einsum("tdi,dij->tdj", q, self.Tlat, precision=PRECISION)

    def pull(self, r):
        s = jnp.einsum("eij,ej->ei", self.Tlat, r, precision=PRECISION)
        return jnp.einsum("de,ei->di", self.Tdyn, s, precision=PRECISION)

    def outer_acc(self, P, R):
        # P: (T', n_dyn, L); R: (T', n_dyn, L)
        raw = jnp.einsum("tdi,tej->deij", P, R, precision=PRECISION)
        return raw * self.Tdyn[:, :, None, None] * self.Tlat[None, :, :, :]

    def joint_shape(self):
        n_dyn, L = self.n_dyn, self.n_latent
        return (n_dyn, n_dyn, L, L)

    # sequential-kernel engine ---------------------------------------
    def pallas_filter(self, ll, p_init, likelihood_scale, interpret):
        from poor_man_gplvm_tpu.ops.pallas import scan_kernels as sk

        return sk.filter_chunk_pallas(
            ll, self.Tlat, self.Tdyn, p_init, likelihood_scale,
            uniform_rows=self.uniform_rows, interpret=interpret,
        )

    def pallas_smooth(self, filt_xs, prior_xs, smooth_init, interpret):
        from poor_man_gplvm_tpu.ops.pallas import scan_kernels as sk

        return sk.smoother_chunk_pallas(
            filt_xs, prior_xs, self.Tlat, self.Tdyn, smooth_init,
            uniform_rows=self.uniform_rows, interpret=interpret,
        )

    # log-space engine (reference op order) ---------------------------
    def push_log(self, logp):
        a = logsumexp(logp[:, None, :] + self.logTdyn[:, :, None], axis=0)
        return logsumexp(a[:, :, None] + self.logTlat, axis=1)

    def smooth_step_log(self, log_smooth_next, log_filt_curr, log_prior_next):
        # broadcast to (dyn_curr, dyn_next, lat_curr, lat_next)
        inside = (
            self.logTlat[None, :, :, :]
            + self.logTdyn[:, :, None, None]
            + (log_smooth_next - log_prior_next)[None, :, None, :]
            + log_filt_curr[:, None, :, None]
        )
        return logsumexp(inside, axis=(1, 3)), inside


# ---------------------------------------------------------------------------
# probability-space scans
# ---------------------------------------------------------------------------


def _forward_scan_prob(ll, trans, carry, likelihood_scale):
    def step(p_prev, ll_t):
        prior = trans.push(p_prev)
        m = jnp.max(ll_t)
        w = jnp.exp(likelihood_scale * (ll_t - m))
        u = prior * trans.bcast_ll(w)
        s = jnp.sum(u)
        p = u / jnp.maximum(s, jnp.finfo(u.dtype).tiny)
        ratio = jnp.log(s) + likelihood_scale * m
        return p, (p, prior, ratio)

    p_last, (post, prior, ratios) = lax.scan(step, carry[0], ll)
    # the log-marginal is the (pairwise) sum of the per-step ratios, not a
    # running sum carried through T sequential f32 additions, whose
    # rounding grows with T
    return post, prior, ratios, (p_last, carry[1] + jnp.sum(ratios))


def forward_filter_lml(y, tuning, hyper, trans, ma_neuron, ma_latent,
                       likelihood_scale=1.0, observation_model="poisson"):
    """Forward-filter log marginal — the quantity ``decode_latent``
    reports as ``log_marginal_final`` (the smoother does not change it).

    One emission build + one prob-space forward scan; vmap-safe.  Shared
    core of the downsampled-LML metric (reference
    model_selection_helper.py:243-260): ``selection.get_downsampled_lml``
    and ``parallel.sweep``'s batched evaluation both dispatch here so the
    masked-LML semantics (emission hyper handling, carry init,
    likelihood_scale) cannot drift apart."""
    ll = get_loglikelihood_ma_all(
        y, tuning, hyper, ma_neuron, ma_latent,
        observation_model=observation_model,
    )
    carry0 = (
        jnp.exp(trans.uniform_log_init()), jnp.array(0.0, dtype=jnp.float32)
    )
    *_, (_p, lml) = _forward_scan_prob(ll, trans, carry0, likelihood_scale)
    return lml


def _backward_scan_prob_ratios(p_filt_xs, p_prior_xs, trans, p_smooth_init):
    """Reverse smoother scan returning the per-step pull ratios.  Single
    definition of the backward step body — the pipeline engine
    (parallel/spmd.py) accumulates its pairwise joint from the ratios
    AFTER masking padded rows, so it consumes this instead of
    ``_backward_scan_prob``."""

    def step(p_smooth_next, x):
        p_filt_t, p_prior_next = x
        safe_prior = jnp.where(p_prior_next > 0, p_prior_next, 1.0)
        r = jnp.where(p_prior_next > 0, p_smooth_next / safe_prior, 0.0)
        p_smooth = p_filt_t * trans.pull(r)
        p_smooth = p_smooth / jnp.maximum(
            jnp.sum(p_smooth), jnp.finfo(p_smooth.dtype).tiny
        )
        return p_smooth, (p_smooth, r)

    _, (smooth, ratios) = lax.scan(
        step, p_smooth_init, (p_filt_xs, p_prior_xs), reverse=True
    )
    return smooth, ratios


def _backward_scan_prob(p_filt_xs, p_prior_xs, trans, p_smooth_init):
    smooth, ratios = _backward_scan_prob_ratios(
        p_filt_xs, p_prior_xs, trans, p_smooth_init
    )
    acc = trans.outer_acc(p_filt_xs, ratios)
    return smooth, acc


# ---------------------------------------------------------------------------
# log-space scans (faithful mirror of the reference's op order)
# ---------------------------------------------------------------------------


def _forward_scan_log(ll, trans, carry, likelihood_scale):
    def step(c, ll_t):
        logp_prev, logz = c
        log_prior = trans.push_log(logp_prev)
        unnorm = log_prior + likelihood_scale * trans.bcast_ll(ll_t)
        ratio = logsumexp(unnorm)
        logp = unnorm - ratio
        return (logp, logz + ratio), (logp, log_prior, ratio)

    (logp_last, logz), (post, prior, ratios) = lax.scan(step, carry, ll)
    return post, prior, ratios, (logp_last, logz)


def _backward_scan_log(log_filt_xs, log_prior_xs, trans, carry_init):
    def step(c, x):
        log_smooth_next, acc = c
        log_filt_t, log_prior_next = x
        log_smooth_curr, inside = trans.smooth_step_log(
            log_smooth_next, log_filt_t, log_prior_next
        )
        acc = jnp.logaddexp(acc, inside)
        return (log_smooth_curr, acc), log_smooth_curr

    (_, acc), smooth = lax.scan(
        step, carry_init, (log_filt_xs, log_prior_xs), reverse=True
    )
    return smooth, acc


# ---------------------------------------------------------------------------
# jitted per-chunk programs
# ---------------------------------------------------------------------------

#: engines that run the sequential kernels (ops/pallas/scan_kernels.py)
_KERNEL_ENGINES = ("pallas", "pallas_interpret")
#: sequential engines whose recursions run in probability space
_PROB_ENGINES = ("prob",) + _KERNEL_ENGINES


@partial(jax.jit, static_argnames=["observation_model", "engine"])
def _filter_chunk(
    y, tuning, hyperparam, trans, ma_neuron, ma_latent, carry,
    likelihood_scale, observation_model, engine, dt_l=None,
):
    if dt_l is None:
        ll = get_loglikelihood_ma_all(
            y, tuning, hyperparam, ma_neuron, ma_latent,
            observation_model=observation_model,
        )
    else:
        ll = get_loglikelihood_ma_all_changing_dt(
            y, tuning, hyperparam, ma_neuron, ma_latent, dt_l,
            observation_model=observation_model,
        )
    if engine in _KERNEL_ENGINES:
        post, prior, ratios = trans.pallas_filter(
            ll, carry[0], likelihood_scale, engine == "pallas_interpret"
        )
        carry_out = (post[-1], carry[1] + ratios.sum())
    else:
        scan_fn = _forward_scan_prob if engine == "prob" else _forward_scan_log
        post, prior, ratios, carry_out = scan_fn(
            ll, trans, carry, likelihood_scale
        )
    return post, prior, ratios, carry_out, ll


@partial(jax.jit, static_argnames=["engine"])
def _backward_chunk(filt_xs, prior_xs, trans, carry, engine):
    if filt_xs.shape[0] == 0:  # T=1 sequence: nothing to smooth over
        return filt_xs, carry
    if engine in _KERNEL_ENGINES:
        smooth_init, acc_in = carry
        smooth, r = trans.pallas_smooth(
            filt_xs, prior_xs, smooth_init, engine == "pallas_interpret"
        )
        acc = trans.outer_acc(filt_xs, r)
        return smooth, (smooth[0], acc_in + acc)
    if engine == "prob":
        smooth_init, acc_in = carry
        smooth, acc = _backward_scan_prob(filt_xs, prior_xs, trans, smooth_init)
        return smooth, (smooth[0], acc_in + acc)
    smooth, acc = _backward_scan_log(filt_xs, prior_xs, trans, carry)
    return smooth, (smooth[0], acc)


# ---------------------------------------------------------------------------
# device-side scan over chunks
#
# The host-loop drivers below dispatch 2 jitted programs per chunk.  For
# uniform "head" chunks the whole forward (and backward) pass is instead ONE
# lax.scan program: the chunk axis becomes the scan axis and the carry rides
# in device memory.  The final (possibly ragged) chunk is peeled off and
# handled by the host path so scan shapes stay static.
# ---------------------------------------------------------------------------


def _dyn_chunk(y, ma_arr, dt_l, off, nc, ma_is_2d, has_dt):
    """Slice one nc-length chunk at (traced) offset ``off`` out of the full
    sequence.  dynamic_slice keeps the big arrays as plain program inputs —
    no (C, nc, ...) copy is ever materialized for the scan."""
    y_c = lax.dynamic_slice_in_dim(y, off, nc, axis=0)
    ma_c = (
        lax.dynamic_slice_in_dim(ma_arr, off, nc, axis=0) if ma_is_2d
        else jnp.broadcast_to(ma_arr, y_c.shape)
    )
    dt_c = lax.dynamic_slice_in_dim(dt_l, off, nc, axis=0) if has_dt else None
    return y_c, ma_c, dt_c


@partial(jax.jit, static_argnames=[
    "observation_model", "engine", "emit", "ma_is_2d", "has_dt", "nc",
    "c_head"])
def _filter_scan_head(
    y, tuning, hyperparam, trans, ma_arr, ma_latent, carry0,
    likelihood_scale, dt_l, observation_model, engine, emit, ma_is_2d,
    has_dt, nc, c_head,
):
    """Forward filter over the first c_head*nc timesteps, scanned as
    (c_head, nc, ...) chunks in one program.  The head slice/reshape happens
    INSIDE the program so XLA aliases the caller's buffer instead of the
    host materializing a near-full copy of ``y`` (2 GB at north-star scale).

    emit='full'       -> per-chunk (post, prior, ratios, ll)
    emit='store_f32'/'store_bf16' -> (post[cast], ratios)   (filter-store)
    emit='ckpt'       -> (carry_in_p, first_prior, ratios)  (checkpoint)
    """

    def step(carry, n):
        y_c, ma_c, dt_c = _dyn_chunk(
            y, ma_arr, dt_l, n * nc, nc, ma_is_2d, has_dt
        )
        post, prior, ratios, carry_out, ll = _filter_chunk(
            y_c, tuning, hyperparam, trans, ma_c, ma_latent, carry,
            likelihood_scale, observation_model, engine, dt_c,
        )
        if emit == "full":
            out = (post, prior, ratios, ll)
        elif emit == "store_bf16":
            out = (post.astype(jnp.bfloat16), ratios)
        elif emit == "store_f32":
            out = (post, ratios)
        else:  # 'ckpt'
            out = (carry[0], prior[0], ratios)
        return carry_out, out

    return lax.scan(step, carry0, jnp.arange(c_head))


@partial(jax.jit, static_argnames=["engine"])
def _backward_scan_head(filt_r, prior_shift_r, trans, carry, engine):
    def step(c, xs):
        filt_c, prior_c = xs
        smooth, c = _backward_chunk(filt_c, prior_c, trans, c, engine)
        return c, smooth

    carry, smooth_r = lax.scan(
        step, carry, (filt_r, prior_shift_r), reverse=True
    )
    return smooth_r, carry


def _marginalize_emit(smooth, trans, marginal_smooth):
    if marginal_smooth:
        lat_m, dyn_m = trans.split_marginals(smooth)
        return (
            prob_to_log(lat_m), None if dyn_m is None else prob_to_log(dyn_m)
        )
    return prob_to_log(smooth)


@partial(jax.jit, static_argnames=["engine", "marginal_smooth"])
def _backward_filterstore_scan_head(post_r, trans, carry, engine,
                                    marginal_smooth):
    def step(c, post_stored):
        post = post_stored.astype(jnp.float32)
        prior_xs = trans.push_batch(post)
        smooth, c = _backward_chunk(post, prior_xs, trans, c, engine)
        return c, _marginalize_emit(smooth, trans, marginal_smooth)

    carry, outs = lax.scan(step, carry, post_r, reverse=True)
    return outs, carry


@partial(jax.jit, static_argnames=[
    "observation_model", "engine", "marginal_smooth", "ma_is_2d", "has_dt",
    "nc", "c_head"])
def _backward_ckpt_scan_head(
    y, tuning, hyperparam, trans, ma_arr, ma_latent, p_in_r,
    first_prior_next_r, likelihood_scale, dt_l, carry, observation_model,
    engine, marginal_smooth, ma_is_2d, has_dt, nc, c_head,
):
    def step(c, xs):
        n, fp_next, p_in = xs
        y_c, ma_c, dt_c = _dyn_chunk(
            y, ma_arr, dt_l, n * nc, nc, ma_is_2d, has_dt
        )
        post, prior, _r, _co, _ll = _filter_chunk(
            y_c, tuning, hyperparam, trans, ma_c, ma_latent,
            (p_in, jnp.array(0.0, dtype=jnp.float32)), likelihood_scale,
            observation_model, engine, dt_c,
        )
        prior_shifted = jnp.concatenate([prior[1:], fp_next[None]], axis=0)
        smooth, c = _backward_chunk(post, prior_shifted, trans, c, engine)
        return c, _marginalize_emit(smooth, trans, marginal_smooth)

    carry, outs = lax.scan(
        step, carry, (jnp.arange(c_head), first_prior_next_r, p_in_r),
        reverse=True,
    )
    return outs, carry


def _head_flags(ma_neuron, dt_l):
    return ma_neuron.ndim == 2, dt_l is not None


# ---------------------------------------------------------------------------
# public drivers
# ---------------------------------------------------------------------------


def filter_combined(
    y, tuning, hyperparam, trans, ma_neuron, ma_latent, carry_init=None,
    likelihood_scale=1.0, observation_model="poisson", engine="prob",
):
    """Causal filter over the full sequence (one chunk).

    Mirrors reference ``filter_all_step_combined_ma`` (decoder.py:189-198);
    returns log-space (log_posterior_all, log_marginal_final, log_prior_all,
    log_one_step_predictive_marginals, log_likelihood_all)."""
    engine = eng.resolve_engine(
        engine, y.shape[0], trans.n_latent, getattr(trans, "n_dyn", 1)
    )
    if engine == "pallas_parallel":
        # the fixed-point engine is a smoother-level strategy; the causal
        # filter has no parallel variant — run the sequential engine
        engine = eng.sequential_engine(trans.n_latent)
    if carry_init is None:
        log_init = trans.uniform_log_init()
        carry_init = (log_init, jnp.array(0.0, dtype=jnp.float32))
    if engine in _PROB_ENGINES:
        carry = (jnp.exp(carry_init[0]), carry_init[1])
    else:
        carry = carry_init
    post, prior, ratios, carry_out, ll = _filter_chunk(
        y, tuning, hyperparam, trans, ma_neuron, ma_latent, carry,
        likelihood_scale, observation_model, engine,
    )
    if engine in _PROB_ENGINES:
        post, prior = prob_to_log(post), prob_to_log(prior)
    return post, carry_out[1], prior, ratios, ll


def auto_chunk_size(n_time_tot, state_size, n_latent, budget=None):
    """Memory-estimate-driven ``n_time_per_chunk`` (used when None is
    passed).

    Single chunk whenever the full-mode working set fits within
    ``FULL_MODE_FRAC`` of the device budget — chunking is mathematically
    exact (reference decoder.py:258-332) so its only upside is bounding
    peak memory, while every extra chunk costs host round-trips.  Past
    that, size chunks so the per-chunk filter working set stays within
    ``CHUNK_WORKSET_FRAC`` of the budget, never below the reference-compat
    10000 (reference core.py:261,594)."""
    per_t = (3 * state_size + n_latent) * 4  # posterior+prior+ratio+ll, f32
    budget = eng.device_memory_budget() if budget is None else budget
    if n_time_tot * per_t <= eng.FULL_MODE_FRAC * budget:
        return int(n_time_tot)
    chunk = int(eng.CHUNK_WORKSET_FRAC * budget // per_t)
    return int(np.clip(chunk, 10_000, n_time_tot))


def auto_memory_mode(n_time, state_size, n_latent, budget=None):
    """memory_mode='auto' for the sequential engines: 'full' while the
    whole-sequence working set fits ``FULL_MODE_FRAC`` of the device
    budget, else the f32 filter store while one stored posterior array fits
    ``FILTER_STORE_FRAC`` (the 2-pass store beats the 3-pass checkpoint
    recompute), else 'checkpoint'."""
    budget = eng.device_memory_budget() if budget is None else budget
    est_bytes = n_time * (3 * state_size + n_latent) * 4
    est_store = n_time * state_size * 4  # one (T, state) f32 array
    if est_bytes <= eng.FULL_MODE_FRAC * budget:
        return "full"
    if est_store <= eng.FILTER_STORE_FRAC * budget:
        return "filter"
    return "checkpoint"


def smooth_combined_chunked(
    y,
    tuning,
    hyperparam,
    trans,
    ma_neuron,
    ma_latent=None,
    likelihood_scale=1.0,
    n_time_per_chunk=None,
    observation_model="poisson",
    engine="prob",
    dt_l=None,
    memory_mode="auto",
    marginal_smooth=False,
    scan_carry_in=None,
    want_scan_carry=False,
    scan_fast=False,
    lgamma_term=None,
    want_acc=True,
):
    """Chunked forward-backward smoother — the E-step workhorse.

    Same contract as reference ``smooth_all_step_combined_ma_chunk``
    (decoder.py:258-332) / ``..._latent`` (decoder_latentonly.py:156-224):

    Returns ``(log_acausal_posterior_all, log_marginal_final,
    log_causal_posterior_all, log_one_step_predictive_marginals,
    log_accumulated_joint, log_likelihood_all)``.

    The backward pass consumes the +1-shifted causal prior exactly as the
    reference (decoder.py:315): chunk [a, b) pairs with priors [a+1, b+1),
    and the final timestep's smoothed posterior equals its filter posterior.

    ``n_time_per_chunk=None`` (the default) resolves via ``auto_chunk_size``:
    one chunk when the full working set fits on-device, else a memory-driven
    size — results are identical either way (chunking is exact), only peak
    memory and host round-trips differ.

    ``lgamma_term``: optional precomputed ``emissions.poisson_lgamma_term``
    — consumed by the parallel-in-time engine (the path the fused EM scan
    takes); the sequential chunked paths recompute it per chunk.

    ``want_acc=False``: the caller will discard ``log_accumulated_joint``
    (the fused mid-EM iterations do — reference fit_em never consumes it,
    core.py:650-676).  The parallel-in-time engine then skips the
    pairwise-joint accumulation inside its backward emit kernel
    (~2*n_dyn^2*T*Lp^2 FLOPs) and returns None in that slot; the other
    engines ignore the hint — their accumulation is ordinary traced XLA,
    which XLA dead-code-eliminates ONLY when this smoother is traced into
    a larger program that drops the joint (e.g. the fused EM scan).  When
    a host loop calls them directly the acc is an output of the jitted
    program and is still computed; the SPMD mesh path likewise ignores
    the hint (models/base._smooth drops it before sharded_smooth).

    ``memory_mode``: 'full' stores the filter posteriors/priors/likelihoods
    for the whole sequence (reference behaviour); 'checkpoint' stores only
    per-chunk boundary carries and RECOMPUTES the filter during the backward
    pass (exact, ~2x filter compute, O(chunk) extra memory instead of
    O(T)) — under 'checkpoint' the returned log_causal_posterior_all and
    log_likelihood_all are None.  'auto' picks by ``auto_memory_mode``
    (prob-space engines only; 'log' always stores).

    ``engine`` is resolved by ``ops.engine.resolve_engine`` ('auto' picks
    per platform and sequence length).
    """
    eng.check_engine(engine)
    if memory_mode not in ("auto", "full", "checkpoint", "filter",
                           "filter_bf16"):
        raise ValueError(
            "memory_mode must be one of 'auto'/'full'/'checkpoint'/'filter'/"
            f"'filter_bf16', got {memory_mode!r}"
        )
    y = jnp.asarray(y)
    n_time_tot = y.shape[0]
    n_dyn_ = getattr(trans, "n_dyn", 1)
    engine = eng.resolve_engine(engine, n_time_tot, trans.n_latent, n_dyn_)
    if n_time_per_chunk is None:
        n_time_per_chunk = auto_chunk_size(
            n_time_tot,
            int(np.prod(trans.uniform_log_init().shape)),
            tuning.shape[0],
        )
    n_chunks = -(-n_time_tot // n_time_per_chunk)

    ma_neuron = jnp.asarray(ma_neuron, dtype=jnp.float32)
    if ma_latent is None:
        ma_latent = jnp.ones(tuning.shape[0], dtype=jnp.float32)

    if engine == "pallas_parallel":
        return _smooth_parallel_driver(
            y, tuning, hyperparam, trans, ma_neuron, ma_latent,
            likelihood_scale, observation_model, dt_l, memory_mode,
            marginal_smooth, n_time_per_chunk,
            scan_carry_in=scan_carry_in, want_scan_carry=want_scan_carry,
            scan_fast=scan_fast, lgamma_term=lgamma_term,
            want_acc=want_acc,
        )
    if want_scan_carry:
        raise ValueError(
            "want_scan_carry requires the parallel-in-time engine "
            "(use parallel_scan_carry_spec to gate the request)"
        )

    if memory_mode == "auto":
        memory_mode = "full" if engine == "log" else auto_memory_mode(
            n_time_tot, int(np.prod(trans.uniform_log_init().shape)),
            tuning.shape[0],
        )
    if memory_mode in ("checkpoint", "filter", "filter_bf16") and engine == "log":
        raise ValueError(
            f"memory_mode={memory_mode!r} requires a prob-space engine"
        )
    if memory_mode in ("filter", "filter_bf16"):
        return _smooth_chunked_filterstore(
            y, tuning, hyperparam, trans, ma_neuron, ma_latent,
            likelihood_scale, n_time_per_chunk, observation_model, engine,
            dt_l, marginal_smooth=marginal_smooth,
            store_dtype=jnp.float32 if memory_mode == "filter"
            else jnp.bfloat16,
        )
    if memory_mode == "checkpoint":
        return _smooth_chunked_checkpoint(
            y, tuning, hyperparam, trans, ma_neuron, ma_latent,
            likelihood_scale, n_time_per_chunk, observation_model, engine,
            dt_l, marginal_smooth=marginal_smooth,
        )
    def _full_out(smooth_log, *rest):
        # full-mode marginal_smooth: same lean (latent_marg, dyn_marg)
        # contract as the checkpoint/filter paths, marginalized at return
        if not marginal_smooth:
            return (smooth_log,) + rest
        if smooth_log.ndim == 3:
            pair = (
                logsumexp(smooth_log, axis=1), logsumexp(smooth_log, axis=2)
            )
        else:
            pair = (smooth_log, None)
        return (pair,) + rest

    # ---- device-side chunk scan fast path (uniform head + host tail) ----
    if engine in _PROB_ENGINES and n_chunks >= 3:
        nc = n_time_per_chunk
        c_head = n_chunks - 1
        th = c_head * nc
        ma_is_2d, has_dt = _head_flags(ma_neuron, dt_l)
        carry0 = (
            jnp.exp(trans.uniform_log_init()),
            jnp.array(0.0, dtype=jnp.float32),
        )
        carry, (post_h, prior_h, ratio_h, ll_h) = _filter_scan_head(
            y, tuning, hyperparam, trans, ma_neuron, ma_latent, carry0,
            likelihood_scale, dt_l, observation_model, engine, "full",
            ma_is_2d, has_dt, nc, c_head,
        )
        y_t = y[th:]
        ma_t = (
            ma_neuron[th:] if ma_is_2d
            else jnp.broadcast_to(ma_neuron, y_t.shape)
        )
        dt_t = None if dt_l is None else dt_l[th:]
        post_t, prior_t, ratio_t, carry, ll_t = _filter_chunk(
            y_t, tuning, hyperparam, trans, ma_t, ma_latent, carry,
            likelihood_scale, observation_model, engine, dt_t,
        )
        log_marginal_final = carry[1]
        state_shape = post_h.shape[2:]
        post_head_flat = post_h.reshape(th, *state_shape)
        prior_head_flat = prior_h.reshape(th, *state_shape)

        # backward: host tail (last-step special case), then scanned head
        bwd_carry = (
            post_t[-1], jnp.zeros(trans.joint_shape(), dtype=jnp.float32)
        )
        smooth_t, bwd_carry = _backward_chunk(
            post_t[:-1], prior_t[1:], trans, bwd_carry, engine
        )
        smooth_t = jnp.concatenate([smooth_t, post_t[-1][None]], axis=0)
        prior_shift_r = jnp.concatenate(
            [prior_head_flat[1:], prior_t[0][None]], axis=0
        ).reshape(c_head, nc, *state_shape)
        smooth_h, bwd_carry = _backward_scan_head(
            post_h, prior_shift_r, trans, bwd_carry, engine
        )
        smooth_all = jnp.concatenate(
            [smooth_h.reshape(th, *state_shape), smooth_t], axis=0
        )
        post_all = jnp.concatenate([post_head_flat, post_t], axis=0)
        ratios_all = jnp.concatenate([ratio_h.reshape(-1), ratio_t], axis=0)
        ll_all = jnp.concatenate(
            [ll_h.reshape(th, ll_h.shape[-1]), ll_t], axis=0
        )
        return _full_out(
            prob_to_log(smooth_all), log_marginal_final,
            prob_to_log(post_all), ratios_all, prob_to_log(bwd_carry[1]),
            ll_all,
        )

    # ---- forward pass over chunks ----
    carry = None
    post_chunks, prior_chunks, ratio_chunks, ll_chunks = [], [], [], []
    for n in range(n_chunks):
        y_chunk, ma_chunk, dt_chunk = _chunk_inputs(
            y, ma_neuron, dt_l, n, n_time_per_chunk
        )

        if carry is None:
            log_init = trans.uniform_log_init()
            if engine in _PROB_ENGINES:
                carry = (jnp.exp(log_init), jnp.array(0.0, dtype=jnp.float32))
            else:
                carry = (log_init, jnp.array(0.0, dtype=jnp.float32))

        post, prior, ratios, carry, ll = _filter_chunk(
            y_chunk, tuning, hyperparam, trans, ma_chunk, ma_latent, carry,
            likelihood_scale, observation_model, engine, dt_chunk,
        )
        post_chunks.append(post)
        prior_chunks.append(prior)
        ratio_chunks.append(ratios)
        ll_chunks.append(ll)
    log_marginal_final = carry[1]

    prior_all = jnp.concatenate(prior_chunks, axis=0)
    ratios_all = jnp.concatenate(ratio_chunks, axis=0)
    ll_all = jnp.concatenate(ll_chunks, axis=0)

    # ---- backward pass over chunks, reversed ----
    smooth_chunks = [None] * n_chunks
    bwd_carry = None
    for n in range(n_chunks - 1, -1, -1):
        a = n * n_time_per_chunk
        b = min((n + 1) * n_time_per_chunk, n_time_tot)
        filt_chunk = post_chunks[n]
        prior_shifted = prior_all[a + 1 : b + 1]

        if bwd_carry is None:  # last chunk: smoother starts from last filter post
            filt_xs = filt_chunk[:-1]
            if engine in _PROB_ENGINES:
                bwd_carry = (
                    filt_chunk[-1],
                    jnp.zeros(trans.joint_shape(), dtype=jnp.float32),
                )
            else:
                bwd_carry = (
                    filt_chunk[-1],
                    jnp.full(trans.joint_shape(), JOINT_ACC_INIT),
                )
            smooth, bwd_carry = _backward_chunk(
                filt_xs, prior_shifted, trans, bwd_carry, engine
            )
            smooth = jnp.concatenate([smooth, filt_chunk[-1][None]], axis=0)
        else:
            smooth, bwd_carry = _backward_chunk(
                filt_chunk, prior_shifted, trans, bwd_carry, engine
            )
        smooth_chunks[n] = smooth

    smooth_all = jnp.concatenate(smooth_chunks, axis=0)
    post_all = jnp.concatenate(post_chunks, axis=0)
    acc = bwd_carry[1]

    if engine in _PROB_ENGINES:
        smooth_all = prob_to_log(smooth_all)
        post_all = prob_to_log(post_all)
        acc = prob_to_log(acc)

    return _full_out(
        smooth_all, log_marginal_final, post_all, ratios_all, acc, ll_all
    )


def parallel_scan_carry_spec(n_time, trans, engine):
    """Warm-start carry spec ((n_dyn, C, L)) when `smooth_combined_chunked`
    with this engine and shape runs the parallel-in-time driver, else
    None."""
    from poor_man_gplvm_tpu.ops.pallas import parallel_scan as ps

    if not engine_resolves_parallel(n_time, trans, engine):
        return None
    return ps.carry_spec(n_time, trans.n_latent, getattr(trans, "n_dyn", 1))


def engine_resolves_parallel(n_time, trans, engine):
    """Whether ``smooth_combined_chunked`` with this engine and shape routes
    to the parallel-in-time driver — the predicate behind the warm-start
    carry spec and the fused EM path's loop-invariant lgamma precompute
    (which only that driver consumes)."""
    return eng.resolve_engine(
        engine, n_time, trans.n_latent, getattr(trans, "n_dyn", 1)
    ) == "pallas_parallel"


def _smooth_parallel_driver(
    y, tuning, hyperparam, trans, ma_neuron, ma_latent, likelihood_scale,
    observation_model, dt_l, memory_mode, marginal_smooth, n_time_per_chunk,
    scan_carry_in=None, want_scan_carry=False, scan_fast=False,
    lgamma_term=None, want_acc=True,
):
    """engine='pallas_parallel': fixed-point parallel-in-time scans
    (ops/pallas/parallel_scan.py).  C chunks of the sequence advance
    simultaneously per sequential step, with the chunk-boundary carries
    solved by fixed-point iteration over whole passes — exact at
    convergence, ~C x fewer sequential steps.  Falls back to the platform's
    sequential engine when the sequence is too short to chunk."""
    from poor_man_gplvm_tpu.ops.pallas import parallel_scan as ps

    T = y.shape[0]
    is_joint = hasattr(trans, "Tdyn")
    n_dyn = trans.n_dyn if is_joint else 1
    L = trans.n_latent
    cfg = ps.choose_parallel_config(T, L, n_dyn)
    if cfg is None:
        if want_scan_carry:
            raise ValueError(
                "want_scan_carry requested but the problem is too small "
                "for the parallel engine"
            )
        return smooth_combined_chunked(
            y, tuning, hyperparam, trans, ma_neuron, ma_latent,
            likelihood_scale=likelihood_scale,
            n_time_per_chunk=n_time_per_chunk,
            observation_model=observation_model,
            engine=eng.sequential_engine(L), dt_l=dt_l,
            memory_mode=memory_mode, marginal_smooth=marginal_smooth,
        )

    # a 1-D neuron mask is broadcast to (T, N) exactly as the sequential
    # chunk paths do, so every engine evaluates the same emission
    # contraction: folding the mask into the (L, N) side changes the
    # log-likelihood by ~2e-7 relative, which at N=500 moves posteriors by
    # ~1e-4.  lgamma_term (when the fused EM path precomputed it) skips
    # the per-iteration gammaln over (T, N)
    if ma_neuron.ndim == 1:
        ma_neuron = jnp.broadcast_to(ma_neuron, y.shape)
    if dt_l is None:
        ll = get_loglikelihood_ma_all(
            y, tuning, hyperparam, ma_neuron, ma_latent,
            observation_model=observation_model, lgamma_term=lgamma_term,
        )
    else:
        ll = get_loglikelihood_ma_all_changing_dt(
            y, tuning, hyperparam, ma_neuron, ma_latent, dt_l,
            observation_model=observation_model,
        )

    tlat = trans.Tlat if is_joint else trans.T[None]
    tdyn = trans.Tdyn if is_joint else jnp.ones((1, 1), dtype=jnp.float32)
    p_init = jnp.exp(trans.uniform_log_init())
    if not is_joint:
        p_init = p_init[None]

    want_post = memory_mode == "full" or (
        memory_mode == "auto"
        and auto_memory_mode(T, n_dyn * L, L) == "full"
    )

    # fast mode (fused mid-EM iterations): a 1e-4 boundary-carry tolerance
    # keeps the log-marginal error ~1e-9 relative — far inside the
    # mid-iteration needs — while making the skip-all-finals-passes
    # prediction (4x drift <= tol) attainable once the EM trajectory
    # settles.  Strict mode uses ps.STRICT_TOL.
    smooth, log_marginal, post, ratios, acc, ll, diag, carries = (
        ps.smooth_parallel(
            ll, tlat, tdyn, p_init, likelihood_scale,
            marginal=marginal_smooth,
            want_post=want_post, config=cfg, warm_start=scan_carry_in,
            fast=scan_fast, tol=1e-4 if scan_fast else ps.STRICT_TOL,
            want_carry=want_scan_carry, want_acc=want_acc,
        )
    )  # NOTE: the ll buffer is donated into the call; the returned ll is
    #   the pass-through (None unless want_post)

    if marginal_smooth:
        lat_m, dyn_m = smooth
        smooth_all = (
            prob_to_log(lat_m),
            prob_to_log(dyn_m) if is_joint else None,
        )
    else:
        smooth_all = prob_to_log(smooth if is_joint else smooth[:, 0])
    post_all = (
        prob_to_log(post if is_joint else post[:, 0]) if want_post else None
    )
    acc_log = (
        prob_to_log(acc if is_joint else acc[0, 0])
        if acc is not None else None
    )
    ll_all = ll if want_post else None
    out = (smooth_all, log_marginal, post_all, ratios, acc_log, ll_all)
    if want_scan_carry:
        # (fwd, bwd, drift, diagnostics) for warm-starting the next
        # same-shape solve — e.g. the next EM iteration's fixed points.
        # diagnostics = (fwd_passes, bwd_passes, emit_delta_f, emit_delta_b)
        return out + ((carries[0], carries[1], carries[2],
                       (diag[0], diag[1], diag[4], diag[5])),)
    return out


def _chunk_inputs(y, ma_neuron, dt_l, n, n_time_per_chunk):
    """Slice chunk ``n``'s (y, neuron-mask, dt) inputs — the single
    definition of the chunk windowing shared by every chunked driver."""
    sl = slice(n * n_time_per_chunk, (n + 1) * n_time_per_chunk)
    y_chunk = y[sl]
    if ma_neuron.ndim == 2:
        ma_chunk = ma_neuron[sl]
    else:
        ma_chunk = jnp.broadcast_to(ma_neuron, y_chunk.shape)
    dt_chunk = None if dt_l is None else dt_l[sl]
    return y_chunk, ma_chunk, dt_chunk


def _concat_marginal_pairs(chunks):
    """Concatenate per-chunk ``(latent_marg, dyn_marg_or_None)`` smoother
    pairs along time — the single definition of the marginal-pair assembly
    contract (dyn is None exactly when the latent-only path produced the
    pair)."""
    lat_all = jnp.concatenate([c[0] for c in chunks], axis=0)
    if chunks[0][1] is None:
        return (lat_all, None)
    return (lat_all, jnp.concatenate([c[1] for c in chunks], axis=0))


def _smooth_chunked_checkpoint(
    y, tuning, hyperparam, trans, ma_neuron, ma_latent, likelihood_scale,
    n_time_per_chunk, observation_model, engine, dt_l,
    marginal_smooth=False,
):
    """Activation-checkpointed two-pass smoother: forward pass stores only
    each chunk's input carry, per-step marginal ratios and first prior row;
    the backward pass recomputes each chunk's filter from its carry.  Exact
    (the recomputation reproduces the forward pass bit-for-bit)."""
    n_time_tot = y.shape[0]
    n_chunks = -(-n_time_tot // n_time_per_chunk)

    # ---- device-side chunk scan fast path (uniform head + host tail) ----
    if n_chunks >= 3:
        nc = n_time_per_chunk
        c_head = n_chunks - 1
        th = c_head * nc
        ma_is_2d, has_dt = _head_flags(ma_neuron, dt_l)
        carry0 = (
            jnp.exp(trans.uniform_log_init()),
            jnp.array(0.0, dtype=jnp.float32),
        )
        carry, (p_in_h, first_prior_h, ratio_h) = _filter_scan_head(
            y, tuning, hyperparam, trans, ma_neuron, ma_latent, carry0,
            likelihood_scale, dt_l, observation_model, engine, "ckpt",
            ma_is_2d, has_dt, nc, c_head,
        )
        y_t = y[th:]
        ma_t = (
            ma_neuron[th:] if ma_is_2d
            else jnp.broadcast_to(ma_neuron, y_t.shape)
        )
        dt_t = None if dt_l is None else dt_l[th:]
        # tail forward outputs are kept (O(chunk) memory, the checkpoint
        # budget) so the backward pass doesn't recompute the tail
        post_t, prior_t, ratio_t, carry, _ll = _filter_chunk(
            y_t, tuning, hyperparam, trans, ma_t, ma_latent, carry,
            likelihood_scale, observation_model, engine, dt_t,
        )
        del _ll
        log_marginal_final = carry[1]
        ratios_all = jnp.concatenate([ratio_h.reshape(-1), ratio_t], axis=0)

        bwd_carry = (
            post_t[-1], jnp.zeros(trans.joint_shape(), dtype=jnp.float32)
        )
        smooth_t_raw, bwd_carry = _backward_chunk(
            post_t[:-1], prior_t[1:], trans, bwd_carry, engine
        )
        smooth_t_raw = jnp.concatenate(
            [smooth_t_raw, post_t[-1][None]], axis=0
        )
        smooth_t = _marginalize_emit(smooth_t_raw, trans, marginal_smooth)
        first_prior_next_r = jnp.concatenate(
            [first_prior_h[1:], prior_t[0][None]], axis=0
        )
        del post_t, prior_t, smooth_t_raw
        smooth_h, bwd_carry = _backward_ckpt_scan_head(
            y, tuning, hyperparam, trans, ma_neuron, ma_latent, p_in_h,
            first_prior_next_r, likelihood_scale, dt_l, bwd_carry,
            observation_model, engine, marginal_smooth, ma_is_2d, has_dt,
            nc, c_head,
        )
        if marginal_smooth:
            head_pair = (
                smooth_h[0].reshape(th, smooth_h[0].shape[-1]),
                None if smooth_t[1] is None
                else smooth_h[1].reshape(th, smooth_h[1].shape[-1]),
            )
            smooth_all = _concat_marginal_pairs([head_pair, smooth_t])
        else:
            state_shape = smooth_t.shape[1:]
            smooth_all = jnp.concatenate(
                [smooth_h.reshape(th, *state_shape), smooth_t], axis=0
            )
        acc = prob_to_log(bwd_carry[1])
        return smooth_all, log_marginal_final, None, ratios_all, acc, None

    # ---- forward: keep carries + ratios + first-prior rows only ----
    carry = (
        jnp.exp(trans.uniform_log_init()), jnp.array(0.0, dtype=jnp.float32)
    )
    chunk_carries = []
    first_priors = []
    ratio_chunks = []
    for n in range(n_chunks):
        chunk_carries.append(carry)
        y_chunk, ma_chunk, dt_chunk = _chunk_inputs(
            y, ma_neuron, dt_l, n, n_time_per_chunk
        )
        post, prior, ratios, carry, _ll = _filter_chunk(
            y_chunk, tuning, hyperparam, trans, ma_chunk, ma_latent, carry,
            likelihood_scale, observation_model, engine, dt_chunk,
        )
        first_priors.append(prior[0])
        ratio_chunks.append(ratios)
        del post, prior, _ll
    log_marginal_final = carry[1]
    ratios_all = jnp.concatenate(ratio_chunks, axis=0)

    # ---- backward: recompute filter per chunk, smooth, accumulate ----
    smooth_chunks = [None] * n_chunks
    bwd_carry = None
    for n in range(n_chunks - 1, -1, -1):
        y_chunk, ma_chunk, dt_chunk = _chunk_inputs(
            y, ma_neuron, dt_l, n, n_time_per_chunk
        )
        post, prior, _r, _c, _ll = _filter_chunk(
            y_chunk, tuning, hyperparam, trans, ma_chunk, ma_latent,
            chunk_carries[n], likelihood_scale, observation_model, engine,
            dt_chunk,
        )
        del _r, _c, _ll
        if bwd_carry is None:  # globally last chunk
            filt_xs = post[:-1]
            prior_shifted = prior[1:]
            bwd_carry = (
                post[-1], jnp.zeros(trans.joint_shape(), dtype=jnp.float32)
            )
            smooth, bwd_carry = _backward_chunk(
                filt_xs, prior_shifted, trans, bwd_carry, engine
            )
            smooth = jnp.concatenate([smooth, post[-1][None]], axis=0)
        else:
            prior_shifted = jnp.concatenate(
                [prior[1:], first_priors[n + 1][None]], axis=0
            )
            smooth, bwd_carry = _backward_chunk(
                post, prior_shifted, trans, bwd_carry, engine
            )
        # convert per chunk: keeps the conversion transients O(chunk)
        if marginal_smooth:
            lat_m, dyn_m = trans.split_marginals(smooth)
            smooth_chunks[n] = (
                prob_to_log(lat_m),
                None if dyn_m is None else prob_to_log(dyn_m),
            )
        else:
            smooth_chunks[n] = prob_to_log(smooth)
        del post, prior, smooth

    if marginal_smooth:
        smooth_all = _concat_marginal_pairs(smooth_chunks)
    else:
        smooth_all = jnp.concatenate(smooth_chunks, axis=0)
    acc = prob_to_log(bwd_carry[1])
    return smooth_all, log_marginal_final, None, ratios_all, acc, None


@partial(jax.jit, static_argnames=["engine", "marginal_smooth", "is_last"])
def _backward_filterstore_chunk(
    post_stored, trans, carry, engine, marginal_smooth, is_last
):
    """One fused backward program for memory_mode='filter'/'filter_bf16':
    upcast the stored filter posteriors, reconstruct the +1-shifted causal
    priors with one batched (time-parallel) transition push, run the
    backward smoother, and marginalize/convert in place."""
    post = post_stored.astype(jnp.float32)
    if is_last:
        filt_xs = post[:-1]
        prior_xs = trans.push_batch(filt_xs)
        carry = (post[-1], jnp.zeros(trans.joint_shape(), dtype=jnp.float32))
        smooth, carry = _backward_chunk(filt_xs, prior_xs, trans, carry, engine)
        smooth = jnp.concatenate([smooth, post[-1][None]], axis=0)
    else:
        prior_xs = trans.push_batch(post)
        smooth, carry = _backward_chunk(post, prior_xs, trans, carry, engine)
    if marginal_smooth:
        lat_m, dyn_m = trans.split_marginals(smooth)
        out = (prob_to_log(lat_m), None if dyn_m is None else prob_to_log(dyn_m))
    else:
        out = prob_to_log(smooth)
    return out, carry


def _smooth_chunked_filterstore(
    y, tuning, hyperparam, trans, ma_neuron, ma_latent, likelihood_scale,
    n_time_per_chunk, observation_model, engine, dt_l,
    marginal_smooth=False, store_dtype=jnp.float32,
):
    """Two-pass smoother that STORES the forward filter posteriors (optionally
    in bfloat16) instead of recomputing them in the backward pass.

    Versus memory_mode='checkpoint' this trades memory for one full
    sequential sweep: the backward pass reconstructs the causal priors with a
    single batched transition push (time-parallel matmul work) rather than
    re-running the T-step filter recursion.  With ``store_dtype=bfloat16`` the stored
    posteriors cost 2 bytes/state and the smoothed posteriors deviate from
    the exact result by O(1e-3) relative (probabilities are in [0, 1], so
    bf16's 8-bit mantissa gives ~0.4%% worst-case rounding); the returned
    log-marginal is exact because it comes from the forward pass."""
    n_time_tot = y.shape[0]
    n_chunks = -(-n_time_tot // n_time_per_chunk)
    emit = "store_f32" if store_dtype == jnp.float32 else "store_bf16"

    # ---- device-side chunk scan fast path (uniform head + host tail) ----
    if n_chunks >= 3:
        nc = n_time_per_chunk
        c_head = n_chunks - 1
        th = c_head * nc
        ma_is_2d, has_dt = _head_flags(ma_neuron, dt_l)
        carry0 = (
            jnp.exp(trans.uniform_log_init()),
            jnp.array(0.0, dtype=jnp.float32),
        )
        carry, (post_h, ratio_h) = _filter_scan_head(
            y, tuning, hyperparam, trans, ma_neuron, ma_latent, carry0,
            likelihood_scale, dt_l, observation_model, engine, emit,
            ma_is_2d, has_dt, nc, c_head,
        )
        y_t = y[th:]
        ma_t = (
            ma_neuron[th:] if ma_is_2d
            else jnp.broadcast_to(ma_neuron, y_t.shape)
        )
        dt_t = None if dt_l is None else dt_l[th:]
        post_t, _pr, ratio_t, carry, _ll = _filter_chunk(
            y_t, tuning, hyperparam, trans, ma_t, ma_latent, carry,
            likelihood_scale, observation_model, engine, dt_t,
        )
        log_marginal_final = carry[1]
        ratios_all = jnp.concatenate([ratio_h.reshape(-1), ratio_t], axis=0)
        del _pr, _ll

        # NOTE: post_t stays float32 — only the *stored* head chunks need
        # the compact store_dtype; downcasting the tail here would seed the
        # whole backward head scan with avoidable bf16 rounding
        smooth_t, bwd_carry = _backward_filterstore_chunk(
            post_t, trans,
            (jnp.zeros(()), jnp.zeros(())), engine, marginal_smooth, True,
        )
        smooth_h, bwd_carry = _backward_filterstore_scan_head(
            post_h, trans, bwd_carry, engine, marginal_smooth
        )
        if marginal_smooth:
            head_pair = (
                smooth_h[0].reshape(th, smooth_h[0].shape[-1]),
                None if smooth_t[1] is None
                else smooth_h[1].reshape(th, smooth_h[1].shape[-1]),
            )
            smooth_all = _concat_marginal_pairs([head_pair, smooth_t])
        else:
            state_shape = smooth_t.shape[1:]
            smooth_all = jnp.concatenate(
                [smooth_h.reshape(th, *state_shape), smooth_t], axis=0
            )
        acc = prob_to_log(bwd_carry[1])
        return smooth_all, log_marginal_final, None, ratios_all, acc, None

    # ---- forward: store filter posteriors (downcast) + ratios ----
    carry = (
        jnp.exp(trans.uniform_log_init()), jnp.array(0.0, dtype=jnp.float32)
    )
    post_chunks = [None] * n_chunks
    ratio_chunks = []
    for n in range(n_chunks):
        y_chunk, ma_chunk, dt_chunk = _chunk_inputs(
            y, ma_neuron, dt_l, n, n_time_per_chunk
        )
        post, prior, ratios, carry, _ll = _filter_chunk(
            y_chunk, tuning, hyperparam, trans, ma_chunk, ma_latent, carry,
            likelihood_scale, observation_model, engine, dt_chunk,
        )
        post_chunks[n] = post.astype(store_dtype)
        ratio_chunks.append(ratios)
        del post, prior, _ll
    log_marginal_final = carry[1]
    ratios_all = jnp.concatenate(ratio_chunks, axis=0)

    # ---- backward: priors via batched push, no filter recompute ----
    smooth_chunks = [None] * n_chunks
    bwd_carry = None
    for n in range(n_chunks - 1, -1, -1):
        smooth_chunks[n], bwd_carry = _backward_filterstore_chunk(
            post_chunks[n], trans,
            bwd_carry if bwd_carry is not None
            else (jnp.zeros(()), jnp.zeros(())),  # placeholder, unused
            engine, marginal_smooth, bwd_carry is None,
        )
        post_chunks[n] = None  # release the stored chunk eagerly

    if marginal_smooth:
        smooth_all = _concat_marginal_pairs(smooth_chunks)
    else:
        smooth_all = jnp.concatenate(smooth_chunks, axis=0)
    acc = prob_to_log(bwd_carry[1])
    return smooth_all, log_marginal_final, None, ratios_all, acc, None


# ---------------------------------------------------------------------------
# transition posterior extraction (reference decoder.py:334-375,
# decoder_latentonly.py:226-248)
# ---------------------------------------------------------------------------


@jax.jit
def compute_transition_posterior_prob(log_accumulated_joint_total):
    """12-key dict of joint/conditional transition posteriors for the joint
    model (reference decoder.py:334-375)."""
    log_joint_full = log_accumulated_joint_total - logsumexp(
        log_accumulated_joint_total
    )
    log_joint_latent = logsumexp(log_joint_full, axis=(0, 1))
    log_joint_dynamics = logsumexp(log_joint_full, axis=(2, 3))
    log_transition_latent = log_joint_latent - logsumexp(
        log_joint_latent, axis=1, keepdims=True
    )
    log_transition_dynamics = log_joint_dynamics - logsumexp(
        log_joint_dynamics, axis=1, keepdims=True
    )
    log_transition_full = log_joint_full - logsumexp(
        log_joint_full, axis=(1, 3), keepdims=True
    )
    return {
        "p_joint_full": jnp.exp(log_joint_full),
        "p_joint_latent": jnp.exp(log_joint_latent),
        "p_joint_dynamics": jnp.exp(log_joint_dynamics),
        "p_transition_full": jnp.exp(log_transition_full),
        "p_transition_latent": jnp.exp(log_transition_latent),
        "p_transition_dynamics": jnp.exp(log_transition_dynamics),
        "log_joint_full": log_joint_full,
        "log_joint_latent": log_joint_latent,
        "log_joint_dynamics": log_joint_dynamics,
        "log_transition_full": log_transition_full,
        "log_transition_latent": log_transition_latent,
        "log_transition_dynamics": log_transition_dynamics,
    }


@jax.jit
def compute_transition_posterior_prob_latent(log_accumulated_joint_total):
    """4-key dict for the latent-only model
    (reference decoder_latentonly.py:226-248)."""
    log_joint_latent = log_accumulated_joint_total - logsumexp(
        log_accumulated_joint_total
    )
    log_transition_latent = log_joint_latent - logsumexp(
        log_joint_latent, axis=1, keepdims=True
    )
    return {
        "p_joint_latent": jnp.exp(log_joint_latent),
        "p_transition_latent": jnp.exp(log_transition_latent),
        "log_joint_latent": log_joint_latent,
        "log_transition_latent": log_transition_latent,
    }
