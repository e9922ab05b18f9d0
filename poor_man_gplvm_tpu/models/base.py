"""Shared model machinery: constructors, EM template, decode wrappers.

Equivalent of the reference model layer
(reference: poor_man_gplvm/core.py:76-1094).  The reference duplicates the
whole EM/decode template across its two abstract classes; here a single
``_GPLVMCommon`` implements both, parameterized by ``has_dynamics``, while
the public classes keep the reference's exact ctor signatures, method
signatures, and em_res/decode_res key contracts.

Functional-core / thin-OO-shell: all numerics live in
:mod:`poor_man_gplvm_tpu.ops`; the classes hold a handful of scalars plus
``params`` (n_basis, N) and ``tuning`` (L, N).
"""

from __future__ import annotations

from abc import ABC, abstractmethod

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
from jax.scipy.special import logsumexp

from poor_man_gplvm_tpu.ops import emissions, hmm
from poor_man_gplvm_tpu.ops import engine as eng
from poor_man_gplvm_tpu.ops.basis import generate_basis
from poor_man_gplvm_tpu.utils import compat
from poor_man_gplvm_tpu.utils.progress import progress

# jitted so the transient (T, N) gammaln buffer lives only inside this one
# small program (see _fused_mid_iters)
_lgamma_term_jit = jax.jit(emissions.poisson_lgamma_term)

_OOM_GUIDANCE = """
[poor_man_gplvm_tpu] The device ran out of memory for this program. Knobs,
in order of preference (all mathematically exact):
  1. memory_mode='checkpoint'  — O(chunk) smoother state, ~1.4x slower than
     the default filter store at large T.
  2. Smaller n_time_per_chunk (e.g. 50_000) — bounds per-chunk buffers.
  3. output_mode='lean' (fit_em) — keeps one (T, L) posterior instead of
     the full results dict.
  4. inference_engine='prob' — the sequential engine, whose chunked memory
     modes bound its state by chunk; the parallel-in-time engine holds
     full-sequence buffers.
  5. fused=False (fit_em) — per-iteration dispatch, smaller programs.
Also free unrelated device arrays: buffers from earlier results count
against the same device memory."""


def _first_failed_certificate(diag_mid):
    """(iteration, residuals) of the first fused iteration whose post-hoc
    emit residual breaks the 1e-3 certificate, or None.  Written as
    ~(x <= tol), not (x > tol): NaN residuals (a diverged solve) must FAIL
    the certificate, and NaN > tol is False while ~(NaN <= tol) is True."""
    if "scan_emit_delta" not in diag_mid:
        return None
    emit_delta = np.asarray(diag_mid["scan_emit_delta"])
    bad_mask = ~(emit_delta <= 1e-3)
    if np.any(bad_mask):
        bad = int(np.argmax(bad_mask.any(axis=1)))
        return bad, emit_delta[bad]
    return None


def _with_oom_guidance(fn):
    """Re-raise a device RESOURCE_EXHAUSTED error with the memory knobs
    (``_OOM_GUIDANCE``) appended."""
    import functools

    @functools.wraps(fn)
    def wrapper(self, *a, **k):
        try:
            return fn(self, *a, **k)
        except jax.errors.JaxRuntimeError as e:
            if "RESOURCE_EXHAUSTED" not in str(e):
                raise
            raise jax.errors.JaxRuntimeError(str(e) + _OOM_GUIDANCE) from e

    return wrapper


def build_decode_prog(observation_model, engine, has_dyn, n_time_per_chunk,
                      memory_mode=None):
    """Build the (unjitted) one-dispatch decode program: smoother +
    prob-space transforms + transition posterior, as one traceable
    function of ``(y, tuning, hyper, trans, ma_neuron, ma_latent,
    likelihood_scale)``.

    This is the single definition of decode's result-dict contract
    (reference core.py:454-497 keys, with the final log-marginal under
    the private key ``_log_marginal_final`` so callers control the host
    sync).  ``_GPLVMCommon._decode_fused_prog`` jits it per model config;
    ``validation.shuffle_and_decode`` vmaps it over shuffles — sharing it
    keeps the per-shuffle stacked dicts locked to ``decode_latent``'s
    keys."""

    def _prog(y, tuning, hyper, trans, ma_neuron, ma_latent,
              likelihood_scale):
        kw = {} if memory_mode is None else {"memory_mode": memory_mode}
        (
            log_post, log_marginal_final, _log_causal,
            log_one_step_pred, log_acc, log_likelihood_all,
        ) = hmm.smooth_combined_chunked(
            y, tuning, hyper, trans, ma_neuron, ma_latent,
            likelihood_scale=likelihood_scale,
            n_time_per_chunk=n_time_per_chunk,
            observation_model=observation_model, engine=engine, **kw,
        )
        posterior_all = jnp.exp(log_post)
        res = {
            "log_posterior_all": log_post,
            "posterior_all": posterior_all,
            "log_one_step_predictive_marginals_all": log_one_step_pred,
            "log_likelihood_all": log_likelihood_all,
            "_log_marginal_final": log_marginal_final,
        }
        if has_dyn:
            res["posterior_latent_marg"] = posterior_all.sum(axis=1)
            res["posterior_dynamics_marg"] = posterior_all.sum(axis=2)
            if log_acc is not None:
                res.update(hmm.compute_transition_posterior_prob(log_acc))
        else:
            if log_acc is not None:
                res.update(
                    hmm.compute_transition_posterior_prob_latent(log_acc)
                )
        return res

    return _prog


class _GPLVMCommon(ABC):
    """Template shared by latent-only and jump models."""

    has_dynamics: bool = False
    observation_model: str = "poisson"

    # ------------------------------------------------------------------
    # construction helpers
    # ------------------------------------------------------------------
    def _init_common(
        self,
        n_neuron,
        n_latent_bin,
        tuning_lengthscale,
        param_prior_std,
        movement_variance,
        explained_variance_threshold_basis,
        rng_init_int,
        w_init_variance,
        w_init_mean,
        basis_type,
        custom_tuning_kernel,
        custom_transition_kernel,
        smoothness_penalty,
        inference_engine,
    ):
        self.n_latent_bin = n_latent_bin
        self.tuning_lengthscale = tuning_lengthscale
        self.param_prior_std = param_prior_std
        self.movement_variance = movement_variance
        self.explained_variance_threshold_basis = explained_variance_threshold_basis
        self.rng_init_int = rng_init_int
        self.rng_init = jr.PRNGKey(rng_init_int)
        self.n_neuron = n_neuron
        self.possible_latent_bin = jnp.arange(self.n_latent_bin)
        self.w_init_variance = w_init_variance
        self.w_init_mean = w_init_mean
        self.smoothness_penalty = smoothness_penalty
        self.basis_type = basis_type
        self.custom_tuning_kernel = custom_tuning_kernel
        self.custom_transition_kernel = custom_transition_kernel
        # 'auto' picks per platform and sequence length at each smoothing
        # call; explicit names pin an engine (ops/engine.py lists them)
        self.inference_engine = eng.check_engine(
            "auto" if inference_engine is None else inference_engine
        )

        self.tuning_basis = generate_basis(
            self.tuning_lengthscale,
            self.n_latent_bin,
            self.explained_variance_threshold_basis,
            include_bias=True,
            basis_type=basis_type,
            custom_kernel=custom_tuning_kernel,
        )
        self.n_basis = self.tuning_basis.shape[1]
        self.ma_neuron_default = jnp.ones(self.n_neuron)
        self.ma_latent_default = jnp.ones(self.n_latent_bin)
        self.adam_runner = None
        self.opt_state_init_fun = None
        self.initialize_params(self.rng_init)

    # pickle support: drop unpicklable jit closures (reference core.py:757-767)
    def __getstate__(self):
        state = self.__dict__.copy()
        state["adam_runner"] = None
        state["opt_state_init_fun"] = None
        state.pop("_fused_prog_cache", None)
        state.pop("_trans_cache", None)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)

    @abstractmethod
    def get_tuning(self, params, hyperparam, tuning_basis):
        """Link function mapping basis weights to tuning curves."""

    @abstractmethod
    def sample_y(self, latent_l, hyperparam=None, tuning=None, dt=1.0, key=None):
        """Sample observations given a latent path."""

    @abstractmethod
    def m_step(
        self, param_curr, y, log_posterior_curr, tuning_basis, hyperparam,
        opt_state_curr=None, host_trim=True,
    ):
        """One M-step on grouped statistics."""

    # dynamics-specific hooks -----------------------------------------
    #: hyperparam keys the transition matrices depend on (subclass sets);
    #: used as the memoization key for _make_transition
    _TRANSITION_HYPER_KEYS: tuple = ()

    @abstractmethod
    def _build_transition(self, hyperparam):
        """Build the hmm.Transition pytree + reference-style matrices from
        instance attributes with per-call hyperparam overrides
        (the load-bearing hyperparam.get(key, self.key) pattern,
        reference core.py:469-471,608-616)."""

    def _make_transition(self, hyperparam):
        """Memoized `_build_transition`: repeated decode/fit calls with the
        same dynamics hyperparameters reuse the built (L, L) matrices
        instead of re-dispatching the kernel builder (one device program +
        tiny ops whose dispatch latency shows up on every decode)."""
        key = self._transition_cache_key(hyperparam)
        if key is None:
            return self._build_transition(hyperparam)
        cache = getattr(self, "_trans_cache", None)
        if cache is None:
            cache = self._trans_cache = {}
        hit = cache.get(key)
        if hit is None:
            if len(cache) >= 64:  # sweeps over many configs: stay bounded
                cache.clear()
            hit = cache[key] = self._build_transition(hyperparam)
        return hit

    def _transition_cache_key(self, hyperparam):
        if self.custom_transition_kernel is not None:
            return None  # array-valued dependency: don't guess identity
        vals = []
        for k in self._TRANSITION_HYPER_KEYS:
            v = hyperparam.get(k, getattr(self, k))
            if not isinstance(v, (int, float, np.integer, np.floating)):
                return None  # traced/array override: bypass the cache
            vals.append(float(v))
        return tuple(vals)

    @abstractmethod
    def init_latent_posterior(self, T, key, random_scale=0.1):
        """Initial E-step posterior (different between the 1D and jump
        families — intentional per the reference, core.py:241-250 vs 571-583)."""

    # ------------------------------------------------------------------
    # shared numerics
    # ------------------------------------------------------------------
    def initialize_params(self, key):
        params_init = (
            jax.random.normal(key, (self.n_basis, self.n_neuron))
            * jnp.sqrt(self.w_init_variance)
            + self.w_init_mean
        )
        tuning_init = self.get_tuning(
            params_init, hyperparam={}, tuning_basis=self.tuning_basis
        )
        self.params = params_init
        self.tuning = tuning_init
        return params_init, tuning_init

    def _smooth(self, y, tuning, hyperparam, trans, ma_neuron, ma_latent,
                likelihood_scale, n_time_per_chunk, mesh=None,
                **smooth_kwargs):
        if mesh is not None:
            # multi-chip E-step: time/neuron sharded over the mesh
            # (memory_mode/engine are single-chip knobs and do not apply —
            # time sharding already bounds per-device memory)
            from poor_man_gplvm_tpu.parallel import spmd

            out = spmd.sharded_smooth(
                mesh, y, tuning, hyperparam, trans, ma_neuron, ma_latent,
                likelihood_scale=likelihood_scale,
                observation_model=self.observation_model,
            )
            if smooth_kwargs.get("marginal_smooth"):
                # emulate the lean contract: (latent_marg, dyn_marg) pair
                log_acausal = out[0]
                if self.has_dynamics:
                    pair = (
                        logsumexp(log_acausal, axis=1),
                        logsumexp(log_acausal, axis=2),
                    )
                else:
                    pair = (log_acausal, None)
                return (pair,) + tuple(out[1:])
            return out
        return hmm.smooth_combined_chunked(
            y, tuning, hyperparam, trans, ma_neuron, ma_latent,
            likelihood_scale=likelihood_scale,
            n_time_per_chunk=n_time_per_chunk,
            observation_model=self.observation_model,
            engine=self.inference_engine,
            **smooth_kwargs,
        )

    def _decode_fused_prog(self, hyperparam, n_time_per_chunk):
        """One-dispatch decode program: smoother + prob-space transforms +
        transition posterior, compiled once per static config and cached on
        the instance: decode's 4-6 separately dispatched programs become
        one.  Returns None when the hyperparam values aren't traceable
        (fall back to the unfused path)."""
        if not all(
            isinstance(v, (int, float, np.integer, np.floating,
                           np.ndarray, jnp.ndarray))
            for v in hyperparam.values()
        ):
            return None
        static_key = (
            "decode", self.inference_engine, self.observation_model,
            tuple(sorted(hyperparam)), n_time_per_chunk,
        )
        cache = getattr(self, "_fused_prog_cache", None)
        if cache is None:
            cache = self._fused_prog_cache = {}
        prog = cache.get(static_key)
        if prog is None:
            prog = cache[static_key] = jax.jit(build_decode_prog(
                self.observation_model, self.inference_engine,
                self.has_dynamics, n_time_per_chunk,
            ))
        return prog

    @_with_oom_guidance
    def _decode_dispatch(
        self, y, tuning, hyperparam, trans, ma_neuron, ma_latent,
        likelihood_scale, n_time_per_chunk, t_l, mesh, tsd_wrap_keys,
        build_res,
    ):
        """Shared decode_latent driver for both model families: try the
        one-dispatch fused program (skipped under a mesh), else fall back
        to the composed smoother path.  ``tsd_wrap_keys`` are the fast-path
        result keys wrapped as TsdFrames when ``t_l`` is given;
        ``build_res(log_posterior_all, log_one_step_pred, log_acc,
        log_likelihood_all)`` builds the family-specific slow-path dict.
        In both paths the ``float()`` host sync comes LAST, after all
        device work is enqueued — one overlapped wait instead of a
        mid-call stall."""
        prog = None if mesh is not None else self._decode_fused_prog(
            hyperparam, n_time_per_chunk
        )
        if prog is not None:
            res = prog(
                jnp.asarray(y), tuning, dict(hyperparam), trans,
                ma_neuron, ma_latent, likelihood_scale,
            )
            log_marginal_final = res.pop("_log_marginal_final")
            if t_l is not None:
                for k in tsd_wrap_keys:
                    res[k] = compat.tsdframe(d=np.asarray(res[k]), t=t_l)
            res["log_marginal_final"] = float(log_marginal_final)
            return res

        (
            log_posterior_all, log_marginal_final, _log_causal,
            log_one_step_pred, log_acc, log_likelihood_all,
        ) = self._smooth(
            jnp.asarray(y), tuning, hyperparam, trans, ma_neuron, ma_latent,
            likelihood_scale, n_time_per_chunk, mesh=mesh,
        )
        decoding_res = build_res(
            log_posterior_all, log_one_step_pred, log_acc, log_likelihood_all
        )
        decoding_res["log_marginal_final"] = float(log_marginal_final)
        return decoding_res

    def predict_expected_rate(self, post_latent_marg, tuning=None):
        """Expected firing rate under the latent posterior
        (reference core.py:716-733)."""
        if tuning is None:
            tuning = self.tuning
        prec = emissions.PRECISION  # the configured statistics precision
        if compat.is_tsdframe(post_latent_marg):
            vals = post_latent_marg.d
            rate = jnp.einsum("pn,tp->tn", tuning, vals, precision=prec)
            return compat.tsdframe(d=np.asarray(rate), t=post_latent_marg.t)
        rate = jnp.einsum("pn,tp->tn", tuning, post_latent_marg,
                          precision=prec)
        return rate

    # ------------------------------------------------------------------
    # naive-Bayes decoding (shared; reference core.py:179-207, 499-524)
    # ------------------------------------------------------------------
    def decode_latent_naive_bayes(
        self, y, tuning=None, hyperparam=None, ma_neuron=None, ma_latent=None,
        likelihood_scale=1.0, n_time_per_chunk=10000, dt_l=1.0,
        observation_model=None, t_l=None,
    ):
        hyperparam = {} if hyperparam is None else hyperparam
        if compat.is_tsdframe(y):
            t_l = y.t
            y = y.d
        if ma_neuron is None:
            ma_neuron = self.ma_neuron_default
        if ma_latent is None:
            ma_latent = self.ma_latent_default
        if tuning is None:
            tuning = self.tuning
        if observation_model is None:
            observation_model = self.observation_model
        del likelihood_scale  # unused by the reference NB path too

        log_post, log_marginal_l, log_marginal_total, ll_per_pos_l = (
            emissions.get_naive_bayes_ma_chunk(
                jnp.asarray(y), tuning, hyperparam, ma_neuron, ma_latent,
                dt_l=dt_l, n_time_per_chunk=n_time_per_chunk,
                observation_model=observation_model,
            )
        )
        posterior_latent = jnp.exp(log_post)
        if t_l is not None:
            posterior_latent = compat.tsdframe(d=np.asarray(posterior_latent), t=t_l)
        return {
            "log_posterior_latent": log_post,
            "log_marginal_l": log_marginal_l,
            "log_marginal_total": float(log_marginal_total),
            "posterior_latent": posterior_latent,
            "ll_per_pos_l": ll_per_pos_l,
        }

    # ------------------------------------------------------------------
    # batched short-epoch decoding (reactivation/ripple workloads)
    # ------------------------------------------------------------------
    def decode_latent_epochs(
        self, y, intervals, hyperparam=None, ma_neuron=None, ma_latent=None,
        likelihood_scale=1.0, t_l=None, batch_size=None,
    ):
        """Smoother-decode many short epochs as ONE vmapped device program.

        The reference's reactivation/ripple workflow decodes hundreds of
        ~1 s epochs in a host loop (reference reactivation_analysis.py:21-55
        and the ``get_naive_bayes_ma_chunk`` chunk loop, decoder.py:134-148)
        — each iteration paying a full dispatch.  Here the epochs are
        right-padded to the longest epoch, stacked to ``(E, Tmax, N)`` and
        smoothed by one jitted ``vmap`` over the epoch axis.  Padding is
        EXACT: padded rows carry an all-zero neuron mask, so their emission
        likelihood is constant across states — they contribute identically
        zero to the per-epoch log-marginal, and (because constant
        likelihood factors cancel in the backward recursion) the smoothed
        posterior over the real rows equals each epoch's standalone
        smoother output.

        Parameters
        ----------
        y : (T, N) array or TsdFrame — the full binned spike matrix.
        intervals : (E, 2) int array of ``[start, end)`` bin indices, or a
            pynapple-style IntervalSet (requires ``t_l`` or a TsdFrame
            ``y`` to convert times to bins).
        batch_size : optional int — decode epochs in batches of this size
            (one dispatch per batch) to bound device memory for very large
            E x Tmax; default = all epochs in one program.

        Returns a dict with ``posterior_latent_marg`` (E, Tmax, L) padded
        with NaN past each epoch's end, ``posterior_mean`` (E, L) mean over
        real rows, ``log_marginal_per_epoch`` (E,), ``lengths`` (E,) and
        ``valid`` (E, Tmax).
        """
        hyperparam = {} if hyperparam is None else hyperparam
        if compat.is_tsdframe(y):
            t_l = y.t if t_l is None else t_l
            y = y.d
        y = np.asarray(y)
        if hasattr(intervals, "values") and hasattr(intervals, "loc"):
            intervals = np.asarray(intervals.values)
        intervals = np.asarray(intervals)
        if intervals.ndim != 2 or intervals.shape[1] != 2:
            raise ValueError(
                f"intervals must be (E, 2); got {intervals.shape}"
            )
        if not np.issubdtype(intervals.dtype, np.integer):
            if t_l is None:
                raise ValueError(
                    "float (time-valued) intervals need t_l (or a "
                    "TsdFrame y) to convert to bin indices"
                )
            t_l = np.asarray(t_l)
            starts = np.searchsorted(t_l, intervals[:, 0], side="left")
            ends = np.searchsorted(t_l, intervals[:, 1], side="right")
            intervals = np.stack([starts, ends], axis=1)
        lengths = (intervals[:, 1] - intervals[:, 0]).astype(np.int64)
        if np.any(lengths <= 0):
            raise ValueError("every interval must contain >= 1 bin")
        E = len(intervals)
        Tmax = int(lengths.max())
        N = y.shape[1]

        ma_neuron = (
            self.ma_neuron_default if ma_neuron is None
            else np.asarray(ma_neuron, np.float32)
        )
        if np.asarray(ma_neuron).ndim != 1:
            raise ValueError(
                "decode_latent_epochs supports 1-D ma_neuron only (the "
                "2-D slot carries the epoch padding mask)"
            )
        ma_latent = (
            self.ma_latent_default if ma_latent is None else ma_latent
        )
        trans, _ = self._make_transition(hyperparam)
        hyper_num = {
            k: v for k, v in hyperparam.items()
            if isinstance(v, (int, float, np.integer, np.floating,
                              np.ndarray, jnp.ndarray))
        }

        # stack + pad host-side (epochs are short by construction)
        y_b = np.zeros((E, Tmax, N), np.float32)
        valid = np.zeros((E, Tmax), np.float32)
        for e, (a, b) in enumerate(intervals):
            y_b[e, : b - a] = y[a:b]
            valid[e, : b - a] = 1.0
        ma_b = valid[:, :, None] * np.asarray(ma_neuron, np.float32)[None, None, :]

        engine = (
            self.inference_engine
            if self.inference_engine in ("prob", "log") else "prob"
        )
        prog = self._epoch_decode_prog(engine, tuple(sorted(hyper_num)))

        post_parts, lml_parts = [], []
        bs = E if batch_size is None else int(batch_size)
        for s0 in range(0, E, bs):
            post_p, lml_p = prog(
                jnp.asarray(y_b[s0:s0 + bs]), jnp.asarray(ma_b[s0:s0 + bs]),
                self.tuning, trans, jnp.asarray(ma_latent),
                {k: jnp.asarray(v, jnp.float32) for k, v in
                 hyper_num.items()},
                jnp.float32(likelihood_scale),
            )
            post_parts.append(np.asarray(post_p))
            lml_parts.append(np.asarray(lml_p))
        post = np.concatenate(post_parts, axis=0)  # (E, Tmax, L)
        lml = np.concatenate(lml_parts, axis=0)  # (E,)

        mean = (
            (post * valid[:, :, None]).sum(axis=1)
            / lengths[:, None].astype(np.float64)
        )
        post = np.where(valid[:, :, None] > 0, post, np.nan)
        return {
            "posterior_latent_marg": post,
            "posterior_mean": mean,
            "log_marginal_per_epoch": lml,
            "lengths": lengths,
            "valid": valid.astype(bool),
        }

    def _epoch_decode_prog(self, engine, hyper_keys):
        """Jitted vmapped epoch smoother, cached per static config."""
        key = ("epochs", engine, self.observation_model, hyper_keys)
        cache = getattr(self, "_fused_prog_cache", None)
        if cache is None:
            cache = self._fused_prog_cache = {}
        prog = cache.get(key)
        if prog is not None:
            return prog
        obs = self.observation_model
        has_dyn = self.has_dynamics

        def one(y_e, ma2d_e, tuning, trans, ma_latent, hyper, scale):
            smooth, lml, *_ = hmm.smooth_combined_chunked(
                y_e, tuning, hyper, trans, ma2d_e, ma_latent,
                likelihood_scale=scale, observation_model=obs,
                engine=engine, want_acc=False,
            )
            post = jnp.exp(smooth)
            return (post.sum(axis=1) if has_dyn else post), lml

        prog = cache[key] = jax.jit(jax.vmap(
            one, in_axes=(0, 0, None, None, None, None, None)
        ))
        return prog

    def _fused_mid_iters(
        self, y_, hyperparam, trans, tuning_basis, ma_neuron, ma_latent,
        likelihood_scale, n_time_per_chunk, memory_mode, params, opt_state,
        log_post_marg, n_mid, output_mode="full", scan_ws=None,
        scan_fast=True,
    ):
        """Middle EM iterations as ONE lax.scan device program.

        Each scanned iteration is the same math as the host loop — M-step
        on the latent-marginal posterior, tuning link, lean-marginal
        E-step (identical values to the full E-step, reduced outputs) —
        but the host dispatches a single program for all of them instead
        of ~4 per iteration.  Used for iterations [start+1, n_iter-1)
        when nothing per-iteration is observable (no checkpointing /
        profiling / snapshots / progress bar).  Returns the final carry
        plus stacked per-iteration log-marginals and M-step diagnostics."""
        from poor_man_gplvm_tpu.ops import hmm as _hmm

        # mirror the host loop's per-mode memory default exactly so the
        # fused trajectory is bit-identical to the loop trajectory
        mm = memory_mode or (
            "checkpoint" if output_mode == "lean" else "auto"
        )
        obs = self.observation_model
        engine = self.inference_engine

        # numeric hyperparam entries enter the program as OPERANDS so a
        # hyperparameter sweep (same shapes, different values) reuses one
        # compiled program instead of recompiling per config; non-numeric
        # entries stay static (they steer trace-time decisions)
        hyper_num = {
            k: v for k, v in hyperparam.items()
            if isinstance(
                v, (int, float, jnp.ndarray, np.ndarray, np.generic)
            )
            and not isinstance(v, (bool, np.bool_))
        }
        hyper_static = {
            k: v for k, v in hyperparam.items() if k not in hyper_num
        }

        # warm-start the parallel-in-time fixed points across EM iterations:
        # consecutive iterations' boundary carries differ only by one M-step
        # of tuning drift, so seeding iteration k+1's fixed points with
        # iteration k's converged carries cuts the pass count from ~3 toward
        # 1-2 per direction (the convergence certificate is still enforced
        # every iteration, so exactness is unaffected)
        ws_spec = _hmm.parallel_scan_carry_spec(y_.shape[0], trans, engine)
        # The warm-start plumbing (boundary carries + drift predictors +
        # certificates threaded through the EM scan state) costs a fixed
        # overhead per iteration, while the pass savings scale with the
        # per-pass matvec work ~ T*n_dyn*L^2.  Engage it only where the
        # savings dominate: at least 5e10 work units (the north-star shape
        # is 2.5e11, the headline shape 2e9).
        # An explicit engine='pallas_parallel' keeps warm-start regardless
        # (the user asked for the parallel engine; tests force it).
        if ws_spec is not None and engine != "pallas_parallel":
            n_dyn_ws = getattr(trans, "n_dyn", 1)
            work = float(y_.shape[0]) * n_dyn_ws * trans.n_latent ** 2
            if work < 5e10:
                ws_spec = None

        def prog(params_opt, log_post_in, ws_in, y_in, basis_in, trans_in,
                 ma_n, ma_l, hyper_in, scale_in, lgamma_in):
            # all arrays enter as operands so nothing large is baked into
            # the program as a constant (a closed-over device array becomes
            # an embedded constant — 400 MB at T=100k, GBs at north-star).
            # log_post_in/ws_in arrive as separate arguments so the (T, L)
            # posterior carry (~2 GB at the north-star) can be DONATED and
            # the output carry aliased onto it — see donate_post below for
            # when that is safe.  params/opt_state are NOT donated:
            # iteration start_iter appends them to params_saved.
            hp = {**hyper_static, **hyper_in}
            carry = (params_opt[0], params_opt[1], log_post_in, ws_in)

            def body(c, _):
                params_c, opt_c, log_post, ws = c
                m_res = self.m_step(
                    params_c, y_in, log_post, basis_in, hp,
                    opt_state_curr=opt_c, host_trim=False,
                )
                params_n = m_res["params"]
                opt_n = m_res.get("opt_state", None)
                tuning = self.get_tuning(params_n, hp, basis_in)
                smooth_kw = dict(
                    likelihood_scale=scale_in,
                    n_time_per_chunk=n_time_per_chunk,
                    observation_model=obs, engine=engine,
                    memory_mode=mm, marginal_smooth=True,
                    lgamma_term=lgamma_in,
                    # mid iterations never consume the pairwise joint —
                    # skip its in-kernel accumulation (reference fit_em
                    # also discards it, core.py:650-676)
                    want_acc=False,
                )
                diag = {
                    k: v for k, v in m_res.items()
                    if k not in ("params", "opt_state")
                }
                if ws_spec is not None:
                    smooth_out, lml, _c2, _p, _a, _l, ws_out = (
                        _hmm.smooth_combined_chunked(
                            y_in, tuning, hp, trans_in, ma_n, ma_l,
                            scan_carry_in=ws, want_scan_carry=True,
                            scan_fast=scan_fast,
                            **smooth_kw,
                        )
                    )
                    f_new, b_new, drift, (fp, bp, ef, eb) = ws_out
                    ws_new = (f_new, b_new, drift, jnp.array(True))
                    diag["scan_passes"] = jnp.stack([fp, bp])
                    diag["scan_emit_delta"] = jnp.stack([ef, eb])
                    diag["scan_drift"] = drift[:2]
                else:
                    smooth_out, lml, _c2, _p, _a, _l = (
                        _hmm.smooth_combined_chunked(
                            y_in, tuning, hp, trans_in, ma_n, ma_l,
                            **smooth_kw,
                        )
                    )
                    ws_new = ws
                lat_log = smooth_out[0]
                return (params_n, opt_n, lat_log, ws_new), (lml, diag)

            return jax.lax.scan(body, carry, None, length=n_mid)

        # cache the jitted program per (static config) — a fresh jax.jit
        # per call would retrace AND recompile every fit_em invocation
        # (measured ~5 s per call at T=100k), defeating the fast path
        # donate the posterior carry ONLY when fit_em holds no other
        # reference to the incoming buffer: for has_dynamics=False models
        # in full output mode, iteration start_iter's snapshot
        # (log_posterior_all_saved) IS the same array object as the
        # latent-only log_posterior_curr, and donating it would leave a
        # deleted array in em_res on an accelerator (CPU ignores donation,
        # so tests there can't catch it).  Jump models snapshot the pre-logsumexp
        # joint posterior — a different buffer — and lean mode snapshots
        # nothing.
        donate_post = self.has_dynamics or output_mode == "lean"
        cache_key = (
            n_mid, mm, obs, engine, n_time_per_chunk, output_mode, ws_spec,
            donate_post, scan_fast,
            tuple(sorted(hyper_num.keys())),
            tuple(sorted((k, str(v)) for k, v in hyper_static.items())),
        )
        cache = getattr(self, "_fused_prog_cache", None)
        if cache is None:
            cache = self._fused_prog_cache = {}
        fused_prog = cache.get(cache_key)
        if fused_prog is None:
            fused_prog = cache[cache_key] = jax.jit(
                prog, donate_argnums=(1, 2) if donate_post else (2,)
            )
        # ``scan_ws``/the returned carry exist so a caller that runs several
        # fused segments over the SAME data within one fit (e.g. a future
        # checkpoint-every-k-iterations loop) can thread the converged
        # boundary carries between segments.  fit_em's single segment
        # deliberately passes None (cold seed) and discards the result:
        # carries are only valid for identical (y, shapes, transitions),
        # and across fit_em calls the data may change.
        if ws_spec is not None:
            ws0 = scan_ws if scan_ws is not None else (
                jnp.zeros(ws_spec, jnp.float32),
                jnp.zeros(ws_spec, jnp.float32),
                jnp.full((4,), jnp.inf, jnp.float32),
                jnp.array(False),
            )
        else:
            ws0 = ()
        # loop-invariant emission precompute: the gammaln(y+1) contraction
        # depends only on the data, so compute it ONCE per fused segment in
        # its own small program and feed it in as an operand: XLA does not
        # hoist it out of the iteration scan on its own, and its own
        # program bounds the transient (T, N) gammaln buffer's liveness.
        # Only the parallel-in-time driver consumes it — don't pay the
        # (T, N) reduction on paths that would recompute it per chunk.
        lg = (
            _lgamma_term_jit(y_, ma_neuron)
            if obs == "poisson"
            and _hmm.engine_resolves_parallel(y_.shape[0], trans, engine)
            else None
        )
        (params, opt_state, log_post, ws), (lml_mid, diag_mid) = fused_prog(
            (params, opt_state), log_post_marg, ws0, y_, tuning_basis, trans,
            ma_neuron, ma_latent,
            {k: jnp.asarray(v, dtype=jnp.float32) for k, v in
             hyper_num.items()},
            jnp.float32(likelihood_scale), lg,
        )
        return params, opt_state, log_post, lml_mid, diag_mid, \
            (ws if ws_spec is not None else None)

    # ------------------------------------------------------------------
    # EM template (reference core.py:259-373 / 592-713)
    # ------------------------------------------------------------------
    @_with_oom_guidance
    def fit_em(
        self, y, hyperparam=None, key=None, n_iter=20, log_posterior_init=None,
        opt_state_curr=None, ma_neuron=None, ma_latent=None,
        n_time_per_chunk=None, dt=1.0, likelihood_scale=1.0, save_every=None,
        posterior_init_kwargs=None, verboase=True, profile=False,
        checkpoint_dir=None, checkpoint_every=None, resume=False,
        output_mode="full", memory_mode=None, nan_guard=None, mesh=None,
        **kwargs,
    ):
        """``dt`` is accepted but UNUSED, exactly like the reference
        (core.py:261,594 accept dt=1. and never thread it into the E-step
        likelihood or M-step statistics): the fitted tuning absorbs the
        bin width (rate per bin, not per unit time).  Use
        decode_latent_naive_bayes(dt_l=...) for explicit per-bin dt.

        output_mode='lean' (for T x L scales beyond single-device memory):
        the E-step emits only the latent/dynamics marginal posteriors
        (memory_mode='checkpoint' + marginal smoothing, or pass
        memory_mode='filter_bf16' for the faster 2-pass bf16 filter store).
        Lean em_res keeps ONE (T, L) posterior (prob space, 'posterior' /
        'posterior_latent_marg'): 'log_posterior_final' is None and
        save_every posterior snapshots are skipped — at T=1e6 x L=500 each
        retained copy is ~2 GB.  em_res's
        log_posterior_final/posterior hold the LATENT-MARGINAL (T, L)
        posterior, posterior_dynamics_marg is still exact, and
        log_posterior_init is not retained."""
        hyperparam = {} if hyperparam is None else hyperparam
        key = jr.PRNGKey(0) if key is None else key
        posterior_init_kwargs = (
            {"random_scale": 0.1} if posterior_init_kwargs is None
            else posterior_init_kwargs
        )
        verboase = kwargs.pop("verbose", verboase)

        # asarray, NOT array: nothing in fit_em donates or mutates y_, and
        # jnp.array's copy=True compiles a device-to-device 'jit_copy' of
        # the whole spike matrix when the caller already device_put it —
        # at the north-star scale that is a 2 GB allocation per call
        if compat.is_tsdframe(y):
            y_ = jnp.asarray(y.d)
        else:
            y_ = jnp.asarray(y)

        # adopt hyperparam overrides into instance attrs (reference
        # core.py:272-276, 608-616)
        self._adopt_hyperparam(hyperparam)

        if save_every is None:
            save_every = n_iter

        trans, kernel_attrs = self._make_transition(hyperparam)

        if ma_neuron is None:
            ma_neuron = self.ma_neuron_default
        if ma_latent is None:
            ma_latent = self.ma_latent_default

        # regenerate basis when a new tuning_lengthscale is swept
        # (reference core.py:296-300)
        if "tuning_lengthscale" in hyperparam:
            tuning_basis = generate_basis(
                self.tuning_lengthscale, self.n_latent_bin,
                self.explained_variance_threshold_basis, include_bias=True,
                basis_type=self.basis_type,
                custom_kernel=self.custom_tuning_kernel,
            )
            if tuning_basis.shape[1] != self.params.shape[0]:
                # the swept lengthscale changed the basis RANK: the old
                # params (and any optimizer state built from them) no
                # longer fit, so re-initialize them for the new shape
                # (the reference crashes in its first M-step here,
                # core.py:296-300 — documented fix)
                self.tuning_basis = tuning_basis
                self.n_basis = tuning_basis.shape[1]
                self.initialize_params(key)
                key, _ = jax.random.split(key, 2)
                if (opt_state_curr is not None
                        and self.opt_state_init_fun is not None):
                    opt_state_curr = self.opt_state_init_fun(self.params)
        else:
            tuning_basis = self.tuning_basis

        if log_posterior_init is None:
            log_posterior_init, _ = self.init_latent_posterior(
                y_.shape[0], key, **posterior_init_kwargs
            )
            key, _ = jax.random.split(key, 2)
        elif isinstance(log_posterior_init, np.ndarray) and \
                log_posterior_init.dtype == np.float64:
            # reference-produced inits floor -inf at -1e40 (core.py:250),
            # which overflows (with a RuntimeWarning) when the f64 host
            # array is cast to f32 on device; clamp to the shared finite
            # sentinel first — both values carry zero probability mass
            log_posterior_init = np.maximum(
                log_posterior_init, hmm.JOINT_ACC_INIT
            ).astype(np.float32)

        log_posterior_curr = log_posterior_init
        log_marginal_l = []
        m_step_res_l = {}
        params = self.params
        start_iter = 0

        # durable checkpoint/resume (equivalent of the reference's
        # pickle-only persistence; SURVEY.md §5)
        checkpointer = None
        if checkpoint_dir is not None:
            from poor_man_gplvm_tpu.utils.checkpoint import EMCheckpointer

            checkpointer = EMCheckpointer(checkpoint_dir)
            if checkpoint_every is None:
                checkpoint_every = 1
            if resume:
                state = checkpointer.restore()
                if state is not None:
                    params = jnp.asarray(state["params"])
                    if state.get("opt_state") is not None:
                        opt_state_curr = jax.tree.map(
                            jnp.asarray, state["opt_state"]
                        )
                    log_posterior_curr = jnp.asarray(state["log_posterior"])
                    start_iter = int(state["step"]) + 1
                    if start_iter >= n_iter:
                        # the checkpoint already covers every requested
                        # iteration — the EM loop body would never run,
                        # leaving tuning/log_posterior_all unbound below
                        raise ValueError(
                            f"resume: checkpoint step {start_iter - 1} "
                            f">= n_iter={n_iter}; nothing to do. Pass a "
                            "larger n_iter to continue training, or load "
                            "the checkpoint state directly."
                        )

        if n_iter <= start_iter:
            # an empty iteration schedule would leave tuning /
            # log_posterior_all unbound below and die with a confusing
            # UnboundLocalError (same guard as the resume case above)
            raise ValueError(
                f"n_iter={n_iter} requests no EM iterations "
                f"(start_iter={start_iter}); n_iter must be >= 1."
            )

        log_posterior_all_saved, params_saved = [], []
        tuning_saved, iter_saved, log_marginal_saved = [], [], []

        import time as _time

        phase_times = {"m_step": [], "e_step": [], "collect": []}

        # fused fast path: run the MIDDLE EM iterations as one lax.scan
        # program (one device dispatch instead of ~4 per iteration).
        # Iteration 0 stays on the host (it produces the save_every
        # snapshots), as does the final iteration (full-output E-step).
        fused = kwargs.pop("fused", None)
        can_fuse = (
            checkpointer is None and not profile and mesh is None
            and save_every >= n_iter and (n_iter - start_iter) >= 3
            and self.inference_engine != "log"
        )
        use_fused = (
            (fused if fused is not None else not verboase) and can_fuse
        )
        iter_schedule = (
            [start_iter, n_iter - 1] if use_fused
            else range(start_iter, n_iter)
        )

        # NOTE on warm-started fixed points: only the FUSED mid-iteration
        # segment warm-starts the parallel-in-time scans — the boundary
        # carries ride the lax.scan state there, which is memory-free.
        # Host-loop E-steps (first/last iteration, decode) run cold on the
        # round-2 program exactly: both exporting carries from and adding
        # warm-seed operands to a standalone solve perturb XLA's buffer
        # packing by +2-4 GB of temp arena at north-star shapes (measured,
        # see parallel_scan._smooth_parallel_jit), and the host iterations
        # are ~2 of n_iter so the warm-start win there is negligible.

        for i in progress(iter_schedule, verboase, desc="EM", total=n_iter):
            t0 = _time.time()
            m_res = self.m_step(
                params, y_, log_posterior_curr, tuning_basis, hyperparam,
                opt_state_curr=opt_state_curr, host_trim=False,
            )
            if profile:
                jax.block_until_ready(m_res["params"])
            t1 = _time.time()
            params = m_res["params"]
            opt_state_curr = m_res.get("opt_state", None)
            if output_mode == "lean":
                # the init posterior was consumed by iteration 0's M-step and
                # lean mode does not retain it in em_res — free the buffer
                log_posterior_init = None

            tuning = self.get_tuning(params, hyperparam, tuning_basis)
            # release the previous iteration's posteriors before the E-step
            # allocates the new ones (matters at T ~ 1e6 x L ~ 500 scales)
            if i > start_iter and i % save_every != 0:
                log_posterior_all = None
            log_posterior_curr = None
            if output_mode == "lean":
                lean_dyn_marg = None
                (
                    smooth_out, log_marginal_final, _log_causal,
                    _log_pred, _log_acc, _ll,
                ) = self._smooth(
                    y_, tuning, hyperparam, trans, ma_neuron, ma_latent,
                    likelihood_scale, n_time_per_chunk, mesh=mesh,
                    memory_mode=memory_mode or "checkpoint",
                    marginal_smooth=True, want_acc=False,
                )
                log_posterior_all, lean_dyn_marg = smooth_out
                log_posterior_curr = log_posterior_all
                # one sync per iteration at lean (near-HBM-capacity) scales:
                # fully async dispatch lets the host enqueue the next
                # iteration's E-step while this one's buffers are still
                # live, and enqueue-time output allocation then doubles the
                # footprint (observed OOM at T=1e6 x L=500 on one chip)
                jax.block_until_ready(log_posterior_curr)
            else:
                (
                    log_posterior_all, log_marginal_final, _log_causal,
                    _log_pred, _log_acc, _ll,
                ) = self._smooth(
                    y_, tuning, hyperparam, trans, ma_neuron, ma_latent,
                    likelihood_scale, n_time_per_chunk, mesh=mesh,
                    want_acc=False,
                    **({"memory_mode": memory_mode} if memory_mode else {}),
                )

                if self.has_dynamics:
                    log_posterior_curr = logsumexp(log_posterior_all, axis=1)
                else:
                    log_posterior_curr = log_posterior_all
            if profile:
                jax.block_until_ready(log_posterior_curr)
            t2 = _time.time()

            if not m_step_res_l:
                m_step_res_l = {k: [] for k in m_res.keys()}
            for k in m_res.keys():
                if k not in ["params", "opt_state"]:
                    m_step_res_l[k].append(m_res[k])
            log_marginal_l.append(log_marginal_final)

            if i % save_every == 0:
                if output_mode != "lean":
                    # lean runs sit near HBM capacity: retaining a full
                    # posterior snapshot defeats the point of lean
                    log_posterior_all_saved.append(log_posterior_all)
                params_saved.append(params)
                tuning_saved.append(tuning)
                log_marginal_saved.append(log_marginal_final)
                iter_saved.append(i)
            if checkpointer is not None and i % checkpoint_every == 0:
                checkpointer.save(
                    i,
                    {
                        "step": i,
                        "params": params,
                        "opt_state": opt_state_curr,
                        "log_posterior": log_posterior_curr,
                        "rng": key,
                    },
                )
            t3 = _time.time()
            phase_times["m_step"].append(t1 - t0)
            phase_times["e_step"].append(t2 - t1)
            phase_times["collect"].append(t3 - t2)

            if use_fused and i == start_iter:
                n_mid = n_iter - 1 - (start_iter + 1)
                if n_mid > 0:
                    # keep the segment's (cheap) param inputs so a failed
                    # fast segment can be redone strictly; the posterior
                    # input is donated and must be replayed instead
                    seg_params, seg_opt = params, opt_state_curr
                    fused_out = self._fused_mid_iters(
                        y_, hyperparam, trans, tuning_basis, ma_neuron,
                        ma_latent, likelihood_scale, n_time_per_chunk,
                        memory_mode, params, opt_state_curr,
                        log_posterior_curr, n_mid,
                        output_mode=output_mode,
                    )
                    bad_cert = _first_failed_certificate(fused_out[4])
                    if bad_cert is not None:
                        # the post-hoc certificate caught a fast-mode solve
                        # whose drift prediction was violated (rare: seen
                        # at shapes right at the warm-start work floor in
                        # early, fast-moving EM iterations).  The fix is
                        # mechanical — redo the segment with strict
                        # raw-movement exits (tol 1e-6, no skipped finals
                        # passes) — so do that instead of failing the fit.
                        import warnings as _warnings

                        _warnings.warn(
                            "parallel-scan warm-start certificate failed "
                            f"at fused iteration {bad_cert[0]} (emit "
                            f"residual {bad_cert[1]}); re-running the "
                            "fused segment with strict fixed-point exits."
                        )
                        # start_iter's E-step inputs are all still bound
                        # and the smoother is deterministic: replay it to
                        # reproduce the donated posterior carry exactly
                        if output_mode == "lean":
                            _sm = self._smooth(
                                y_, tuning, hyperparam, trans, ma_neuron,
                                ma_latent, likelihood_scale,
                                n_time_per_chunk, mesh=mesh,
                                memory_mode=memory_mode or "checkpoint",
                                marginal_smooth=True, want_acc=False,
                            )
                            log_post_replay = _sm[0][0]
                        else:
                            _sm = self._smooth(
                                y_, tuning, hyperparam, trans, ma_neuron,
                                ma_latent, likelihood_scale,
                                n_time_per_chunk, mesh=mesh,
                                want_acc=False,
                                **({"memory_mode": memory_mode}
                                   if memory_mode else {}),
                            )
                            log_post_replay = (
                                logsumexp(_sm[0], axis=1)
                                if self.has_dynamics else _sm[0]
                            )
                        jax.block_until_ready(log_post_replay)
                        fused_out = self._fused_mid_iters(
                            y_, hyperparam, trans, tuning_basis, ma_neuron,
                            ma_latent, likelihood_scale, n_time_per_chunk,
                            memory_mode, seg_params, seg_opt,
                            log_post_replay, n_mid,
                            output_mode=output_mode, scan_fast=False,
                        )
                        bad_cert = _first_failed_certificate(fused_out[4])
                        if bad_cert is not None:
                            raise FloatingPointError(
                                "parallel-scan certificate failed even "
                                "with strict fixed-point exits at fused "
                                f"iteration {bad_cert[0]}: emit residual "
                                f"{bad_cert[1]} > 1e-3. The solve did not "
                                "converge — rerun with fused=False or "
                                "inference_engine='prob'."
                            )
                    (
                        params, opt_state_curr, log_posterior_curr,
                        lml_mid, diag_mid, _ws_fused,
                    ) = fused_out
                    log_marginal_l.extend(
                        lml_mid[j] for j in range(n_mid)
                    )
                    if "scan_passes" in diag_mid:
                        # (n_mid, 2) fwd/bwd fixed-point pass counts —
                        # warm-start effectiveness diagnostic
                        self._scan_passes_mid = np.asarray(
                            diag_mid.pop("scan_passes")
                        )
                    if "scan_drift" in diag_mid:
                        # (n_mid, 2) per-iteration boundary-carry movement
                        self._scan_drift_mid = np.asarray(
                            diag_mid.pop("scan_drift")
                        )
                    if "scan_emit_delta" in diag_mid:
                        # certificate already checked (and any failure
                        # already redone strictly) before consumption —
                        # keep the residuals as a diagnostic
                        self._scan_emit_delta_mid = np.asarray(
                            diag_mid.pop("scan_emit_delta")
                        )
                    for k in m_step_res_l:
                        if k in diag_mid:
                            m_step_res_l[k].extend(
                                diag_mid[k][j] for j in range(n_mid)
                            )
                    # divergence check over the fused iterations in one
                    # bulk transfer (the per-iteration check cannot run
                    # inside the scanned program; a diverged fused run
                    # wastes the remaining scanned iterations but still
                    # fails loudly with the right iteration index)
                    _check_mid = nan_guard if nan_guard is not None else (
                        output_mode == "lean"
                    )
                    if _check_mid:
                        lml_host = np.asarray(lml_mid)
                        if not np.all(np.isfinite(lml_host)):
                            bad = int(np.argmax(~np.isfinite(lml_host)))
                            raise FloatingPointError(
                                "EM diverged: log marginal is "
                                f"{lml_host[bad]} at iteration "
                                f"{start_iter + 1 + bad} (fused segment; "
                                f"T={y_.shape[0]}, "
                                f"n_latent_bin={self.n_latent_bin}). "
                                "Check hyperparam values and masks."
                            )

            # failure detection: a non-finite log marginal means the fit has
            # diverged (bad hyperparameters / degenerate masks) and every
            # further iteration is wasted work.  Checking costs one scalar
            # D2H, so it's on by default only where the loop already syncs
            # (lean mode); pass nan_guard=True to force it elsewhere.
            check_nan = nan_guard if nan_guard is not None else (
                output_mode == "lean"
            )
            if check_nan and not np.isfinite(float(log_marginal_final)):
                raise FloatingPointError(
                    f"EM diverged: log marginal is {float(log_marginal_final)}"
                    f" at iteration {i} (T={y_.shape[0]},"
                    f" n_latent_bin={self.n_latent_bin}). Check hyperparam"
                    " values and neuron/latent masks; checkpoints up to the"
                    " previous iteration are intact."
                )

        # deferred host work: trim Adam histories in one batch (saves ~3
        # blocking device syncs per EM iteration)
        from poor_man_gplvm_tpu.ops.mstep import batch_trim_m_step_histories

        batch_trim_m_step_histories(m_step_res_l)

        # update attributes (reference core.py:344-349 / 678-686)
        self.params = params
        self.tuning = tuning
        self.log_marginal_final = log_marginal_final
        for attr_name, attr_val in kernel_attrs.items():
            setattr(self, attr_name, attr_val)
        self.tuning_basis = tuning_basis

        # stay on device: transfers to host happen lazily on access
        # (np.asarray), which matters when the host link is slow
        log_posterior_curr = None
        posterior = jnp.exp(log_posterior_all)
        if output_mode == "lean":
            # drop the log-space copy: at lean scales each retained (T, L)
            # array is ~2 GB and the prob-space marginal is the useful one
            log_posterior_all = None
        em_res = {
            "log_posterior_all_saved": log_posterior_all_saved,
            "log_posterior_init": log_posterior_init,
            "params_saved": params_saved,
            "tuning_saved": tuning_saved,
            "iter_saved": iter_saved,
            "params": params,
            "tuning": tuning,
            "log_posterior_final": log_posterior_all,
            "log_marginal": log_marginal_final,
            "log_marginal_l": log_marginal_l,
            "log_marginal_saved": log_marginal_saved,
            "posterior": posterior,
            "m_step_res_l": m_step_res_l,
        }
        if profile:
            em_res["profile"] = phase_times
        if self.has_dynamics and output_mode == "lean":
            posterior_latent_marg = posterior  # already the latent marginal
            posterior_dynamics_marg = jnp.exp(lean_dyn_marg)
            em_res["posterior_latent_marg"] = posterior_latent_marg
            em_res["posterior_dynamics_marg"] = posterior_dynamics_marg
        elif self.has_dynamics:
            posterior_latent_marg = jnp.sum(posterior, axis=1)
            posterior_dynamics_marg = jnp.sum(posterior, axis=2)
            if compat.is_tsdframe(y):
                posterior_latent_marg = compat.tsdframe(
                    d=posterior_latent_marg, t=y.t
                )
                posterior_dynamics_marg = compat.tsdframe(
                    d=posterior_dynamics_marg, t=y.t
                )
            em_res["posterior_latent_marg"] = posterior_latent_marg
            em_res["posterior_dynamics_marg"] = posterior_dynamics_marg
        elif compat.is_tsdframe(y):
            em_res["posterior"] = compat.tsdframe(d=posterior, t=y.t)
        return em_res

    @abstractmethod
    def _adopt_hyperparam(self, hyperparam):
        """Copy per-call hyperparam overrides back onto instance attrs."""
