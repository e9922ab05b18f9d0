"""Experimental: Poisson jump model with a time-varying population gain.

Equivalent of reference poor_man_gplvm/experimental/
(core_exp.py, fit_tuning_helper_exp.py, decoder_exp.py, test_exp.py):
rate(t, n) = g_t * lambda(x_t, n).  The gain M-step is the per-time MLE
``g_t = total spikes_t / total expected rate_t``
(reference fit_tuning_helper_exp.py:79-103) — vectorized here into a single
(T, L) @ (L,) matvec instead of the reference's vmap over timepoints.

The gain enters the emission likelihood exactly like a per-time dt
(``lambda*g*dt + 1e-20``, reference decoder_exp.py:86-99), so decoding
reuses the main engine's changing-dt path with ``dt_l = gain * dt``.

NOTE: unlike the reference (core_exp.py:148-153, which mutates self.tuning
inside m_step — flagged in SURVEY.md §5), tuning is threaded explicitly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
from jax.scipy.special import logsumexp, xlogy
from jax.scipy.stats import norm

from poor_man_gplvm_tpu.models.jump1d import PoissonGPLVMJump1D
from poor_man_gplvm_tpu.ops import emissions, hmm
from poor_man_gplvm_tpu.utils import compat
from poor_man_gplvm_tpu.utils.progress import progress
from poor_man_gplvm_tpu.ops import kernels as gpk
from poor_man_gplvm_tpu.ops import mstep as fth
from poor_man_gplvm_tpu.ops.emissions import PRECISION

__all__ = [
    "PoissonGPLVMGain1D_gain",
    "get_statistics_gain",
    "get_gain_mstep",
    "get_gain_mstep_chunk",
    "poisson_m_step_objective_gain",
    "shuffle_and_decode_gain",
]


@jax.jit
def get_statistics_gain(log_posterior_probs, y, gain):
    """Posterior-weighted observation/time/gain per latent bin
    (reference fit_tuning_helper_exp.py:61-76)."""
    posterior_probs = jnp.exp(log_posterior_probs)
    y_weighted = jnp.matmul(posterior_probs.T, y, precision=PRECISION)
    t_weighted = posterior_probs.sum(axis=0)
    gain_weighted = jnp.matmul(
        posterior_probs.T, gain, precision=PRECISION
    ) / (t_weighted + 1e-20)
    return y_weighted, t_weighted, gain_weighted


@jax.jit
def get_gain_mstep(y, log_posterior, tuning):
    """Per-time gain MLE: total spikes / total expected rate
    (reference fit_tuning_helper_exp.py:79-103).  One matvec:
    total expected rate_t = post_t . rowsum(tuning)."""
    posterior = jnp.exp(log_posterior)  # (T, L)
    total_expected = jnp.matmul(
        posterior, tuning.sum(axis=1), precision=PRECISION
    )
    return y.sum(axis=1) / (total_expected + 1e-20)


def get_gain_mstep_chunk(y, log_posterior, tuning, n_time_per_chunk=10000):
    """Chunked gain M-step (reference fit_tuning_helper_exp.py:105-122)."""
    n_chunks = -(-y.shape[0] // n_time_per_chunk)
    parts = []
    for n in range(n_chunks):
        sl = slice(n * n_time_per_chunk, (n + 1) * n_time_per_chunk)
        parts.append(get_gain_mstep(y[sl], log_posterior[sl], tuning))
    return jnp.concatenate(parts, axis=0)


def poisson_m_step_objective_gain(
    weight, hyperparam, basis_mat, y_weighted, t_weighted, gain_weighted
):
    """Gain-aware Poisson objective: rates scaled by the posterior-weighted
    gain per latent bin (reference fit_tuning_helper_exp.py:144-164)."""
    param_prior_std = hyperparam["param_prior_std"]
    tuning_base = fth.get_tuning_softplus(weight, basis_mat)
    pf_hat = tuning_base * gain_weighted[:, None]
    norm_term = pf_hat * t_weighted[:, None]
    fit_term = xlogy(y_weighted, pf_hat + 1e-20)
    log_likelihood = jnp.sum(fit_term - norm_term)
    log_prior = norm.logpdf(weight, 0.0, param_prior_std).sum()
    return -log_likelihood - log_prior


class PoissonGPLVMGain1D_gain(PoissonGPLVMJump1D):
    """Poisson jump model + per-timestep population gain
    (reference experimental/core_exp.py:28-293)."""

    def initialize_params(self, key):
        out = super().initialize_params(key)
        self.gain = None
        return out

    def _resolve_gain(self, gain, T):
        if gain is not None:
            return jnp.asarray(gain)
        if self.gain is not None and len(self.gain) == T:
            return self.gain
        return jnp.ones(T)

    def get_gain(self, y, log_posterior_curr, tuning=None):
        tuning = self.tuning if tuning is None else tuning
        return get_gain_mstep(y, log_posterior_curr, tuning)

    def get_gain_chunk(self, y, log_posterior_curr, n_time_per_chunk=10000,
                       tuning=None):
        tuning = self.tuning if tuning is None else tuning
        return get_gain_mstep_chunk(y, log_posterior_curr, tuning,
                                    n_time_per_chunk)

    # ------------------------------------------------------------------
    def sample_y(self, latent_l, hyperparam=None, tuning=None, dt=1.0,
                 gain=None, key=None):
        key = jr.PRNGKey(10) if key is None else key
        if tuning is None:
            tuning = self.tuning
        gain = self._resolve_gain(gain, len(latent_l))
        rate = tuning[latent_l, :] * gain[:, None]
        return jax.random.poisson(key, rate * dt)

    def sample(self, T, hyperparam=None, key=None, init_dynamics=None,
               init_latent=None, dt=1.0, tuning=None, gain=None):
        hyperparam = {} if hyperparam is None else hyperparam
        key = jr.PRNGKey(0) if key is None else key
        key_l = jax.random.split(key, T + 1)
        movement_variance = hyperparam.get("movement_variance", self.movement_variance)
        p_move_to_jump = hyperparam.get("p_move_to_jump", self.p_move_to_jump)
        p_jump_to_move = hyperparam.get("p_jump_to_move", self.p_jump_to_move)
        latent_l = self.sample_latent(
            T, key_l[0], movement_variance, p_move_to_jump, p_jump_to_move,
            init_dynamics, init_latent,
        )
        gain = self._resolve_gain(gain, T)
        y_l = self.sample_y(latent_l[:, 1], hyperparam, tuning, dt, gain, key_l[1])
        return latent_l, y_l

    # ------------------------------------------------------------------
    def _decode_latent(
        self, y, tuning, hyperparam, log_latent_transition_kernel_l,
        log_dynamics_transition_kernel, ma_neuron, ma_latent=None,
        likelihood_scale=1.0, n_time_per_chunk=10000, gain=None, mesh=None,
    ):
        """Gain-aware decode: gain folded into the per-time dt of the
        emission likelihood (reference experimental/decoder_exp.py).
        ``mesh``: run the smoother sharded over a ('data','time','neuron')
        device mesh (the gain rides the per-time dt operand)."""
        gain = self._resolve_gain(gain, len(y))
        trans = hmm.JointTransition(
            Tdyn=jnp.exp(log_dynamics_transition_kernel),
            Tlat=jnp.exp(log_latent_transition_kernel_l),
            logTdyn=log_dynamics_transition_kernel,
            logTlat=log_latent_transition_kernel_l,
        )
        if mesh is not None:
            from poor_man_gplvm_tpu.parallel import spmd

            return spmd.sharded_smooth(
                mesh, y, tuning, hyperparam, trans, ma_neuron, ma_latent,
                likelihood_scale=likelihood_scale,
                observation_model=self.observation_model, dt_l=gain,
            )
        return hmm.smooth_combined_chunked(
            y, tuning, hyperparam, trans, ma_neuron, ma_latent,
            likelihood_scale=likelihood_scale,
            n_time_per_chunk=n_time_per_chunk,
            observation_model=self.observation_model,
            engine=self.inference_engine, dt_l=gain,
        )

    def get_gain_mstep_chunk(self, y, log_posterior=None, tuning=None,
                             n_time_per_chunk=10000):
        """Instance wrapper over the chunked gain MLE
        (reference experimental/test_exp.py:13 call signature)."""
        if log_posterior is None:
            log_posterior = self.log_posterior
        if tuning is None:
            tuning = self.tuning
        return get_gain_mstep_chunk(y, log_posterior, tuning,
                                    n_time_per_chunk=n_time_per_chunk)

    def decode_latent_naive_bayes(
        self, y, tuning=None, hyperparam=None, ma_neuron=None, ma_latent=None,
        likelihood_scale=1.0, n_time_per_chunk=10000, dt_l=1.0, gain=None,
        gain_refit_n_iter=1, t_l=None,
    ):
        """Naive-Bayes decode with iterative gain refitting
        (reference core_exp.py:95-126; the reference has no ``t_l`` — it
        is honored here like the sibling classes: TsdFrame input or an
        explicit ``t_l`` yields a time-indexed ``posterior_latent``)."""
        hyperparam = {} if hyperparam is None else hyperparam
        if compat.is_tsdframe(y):
            t_l = y.t
            y = y.d
        if tuning is None:
            tuning = self.tuning
        if ma_neuron is None:
            ma_neuron = self.ma_neuron_default
        if ma_latent is None:
            ma_latent = self.ma_latent_default
        gain = self._resolve_gain(gain, len(y))
        y = jnp.asarray(y)
        dt_eff = jnp.broadcast_to(jnp.asarray(dt_l, dtype=jnp.float32),
                                  (y.shape[0],))

        for _ in range(gain_refit_n_iter):
            log_post, _, _, _ = emissions.get_naive_bayes_ma_chunk(
                y, tuning, hyperparam, ma_neuron, ma_latent,
                dt_l=gain * dt_eff, n_time_per_chunk=n_time_per_chunk,
                observation_model="poisson",
            )
            gain = self.get_gain_chunk(
                y, log_post, n_time_per_chunk=n_time_per_chunk, tuning=tuning
            )
        log_post, log_marginal_l, log_marginal_total, ll_per_pos_l = (
            emissions.get_naive_bayes_ma_chunk(
                y, tuning, hyperparam, ma_neuron, ma_latent,
                dt_l=gain * dt_eff, n_time_per_chunk=n_time_per_chunk,
                observation_model="poisson",
            )
        )
        res = {
            "log_posterior": log_post,
            "log_marginal_l": log_marginal_l,
            "log_marginal": float(log_marginal_total),
            "ll_per_pos_l": ll_per_pos_l,
            "gain": gain,
        }
        if t_l is not None:
            res["posterior_latent"] = compat.tsdframe(
                d=np.exp(np.asarray(log_post)), t=t_l
            )
        return res

    # ------------------------------------------------------------------
    def m_step(self, param_curr, y, log_posterior_curr, tuning_basis,
               hyperparam, opt_state_curr=None, gain_curr=None,
               host_trim=True):
        """Joint M-step: Adam on gain-weighted tuning statistics, then the
        per-time gain MLE under the new tuning
        (reference core_exp.py:128-170)."""
        gain_curr = self._resolve_gain(gain_curr, len(y))
        y_weighted, t_weighted, gain_weighted = get_statistics_gain(
            log_posterior_curr, y, gain_curr
        )
        adam_res = self.adam_runner(
            param_curr, opt_state_curr, hyperparam, tuning_basis, y_weighted,
            t_weighted, gain_weighted,
        )
        tuning = self.get_tuning(adam_res["params"], hyperparam, tuning_basis)
        if len(y) > 50000:
            gain_new = get_gain_mstep_chunk(y, log_posterior_curr, tuning)
        else:
            gain_new = get_gain_mstep(y, log_posterior_curr, tuning)

        from poor_man_gplvm_tpu.ops.mstep import package_adam_result

        return package_adam_result(
            adam_res, host_trim=host_trim,
            extra={"tuning": tuning, "gain": gain_new},
        )

    def fit_em(
        self, y, hyperparam=None, key=None, n_iter=20, log_posterior_init=None,
        ma_neuron=None, ma_latent=None, n_time_per_chunk=10000, dt=1.0,
        likelihood_scale=1.0, save_every=None, gain_init=None,
        m_step_step_size=0.01, m_step_maxiter=1000, m_step_tol=1e-6,
        verboase=True, mesh=None, **kwargs,
    ):
        """Custom EM loop alternating tuning/gain M-steps with gain-aware
        E-steps (reference core_exp.py:172-293)."""
        hyperparam_ = dict(hyperparam or {})
        hyperparam_["param_prior_std"] = hyperparam_.get(
            "param_prior_std", self.param_prior_std
        )
        key = jr.PRNGKey(0) if key is None else key
        y = jnp.asarray(y)

        self.gain = (
            jnp.ones(len(y)) if gain_init is None else jnp.asarray(gain_init)
        )
        self.adam_runner, opt_state_init_fun = fth.make_adam_runner_cached(
            poisson_m_step_objective_gain, m_step_step_size,
            maxiter=m_step_maxiter, tol=m_step_tol,
        )
        opt_state_curr = opt_state_init_fun(self.params)

        _, log_lat_l, _, log_dyn = gpk.create_transition_prob_1d(
            self.possible_latent_bin, self.possible_dynamics,
            hyperparam_.get("movement_variance", self.movement_variance),
            hyperparam_.get("p_move_to_jump", self.p_move_to_jump),
            hyperparam_.get("p_jump_to_move", self.p_jump_to_move),
        )
        self.log_latent_transition_kernel_l = log_lat_l
        self.log_dynamics_transition_kernel = log_dyn

        if ma_neuron is None:
            ma_neuron = self.ma_neuron_default
        if ma_latent is None:
            ma_latent = self.ma_latent_default
        if log_posterior_init is None:
            log_posterior_init, _ = self.init_latent_posterior(len(y), key)

        log_posterior_curr = log_posterior_init
        param_curr = self.params
        gain_curr = self.gain
        if save_every is None:
            save_every = n_iter

        params_saved, tuning_saved, gain_saved = [], [], []
        iter_saved, log_marginal_saved = [], []
        log_marginal_l = []
        m_step_res_l = {}

        for i in progress(range(n_iter), verboase, desc="EM(gain)"):
            m_step_res = self.m_step(
                param_curr, y, log_posterior_curr, self.tuning_basis,
                hyperparam_, opt_state_curr, gain_curr, host_trim=False,
            )
            param_curr = m_step_res["params"]
            gain_curr = m_step_res["gain"]
            opt_state_curr = m_step_res["opt_state"]
            tuning = m_step_res["tuning"]
            self.gain = gain_curr
            if i == 0:
                m_step_res_l = {k: [] for k in m_step_res}
            for k in m_step_res:
                if k not in ["params", "opt_state", "gain"]:
                    m_step_res_l[k].append(m_step_res[k])

            (
                log_posterior_all, log_marginal_final, _causal, _pred,
                _acc, _ll,
            ) = self._decode_latent(
                y, tuning, hyperparam_, self.log_latent_transition_kernel_l,
                self.log_dynamics_transition_kernel, ma_neuron, ma_latent,
                likelihood_scale, n_time_per_chunk, gain_curr, mesh=mesh,
            )
            log_posterior_curr = logsumexp(log_posterior_all, axis=1)
            log_marginal_l.append(log_marginal_final)

            if i % save_every == 0:
                params_saved.append(param_curr)
                tuning_saved.append(tuning)
                gain_saved.append(gain_curr)
                iter_saved.append(i)
                log_marginal_saved.append(log_marginal_final)

        from poor_man_gplvm_tpu.ops.mstep import batch_trim_m_step_histories

        batch_trim_m_step_histories(m_step_res_l)

        self.params = param_curr
        self.tuning = tuning
        self.gain = gain_curr
        self.log_marginal_final = log_marginal_final

        posterior = jnp.exp(log_posterior_all)
        self.posterior_latent_marg = jnp.sum(posterior, axis=1)
        self.posterior_dynamics_marg = jnp.sum(posterior, axis=2)
        # reference core_exp keeps the latent-marginal log posterior on the
        # instance for post-fit gain refits (experimental/test_exp.py:13)
        self.log_posterior = jnp.log(self.posterior_latent_marg + 1e-38)

        return {
            "log_posterior_all_saved": [],
            "log_posterior_init": log_posterior_init,
            "params_saved": params_saved,
            "tuning_saved": tuning_saved,
            "gain_saved": gain_saved,
            "iter_saved": iter_saved,
            "params": self.params,
            "tuning": self.tuning,
            "gain": self.gain,
            "log_posterior_final": log_posterior_all,
            "log_marginal": log_marginal_final,
            "log_marginal_l": log_marginal_l,
            "log_marginal_saved": log_marginal_saved,
            "posterior": posterior,
            "posterior_latent_marg": self.posterior_latent_marg,
            "posterior_dynamics_marg": self.posterior_dynamics_marg,
            "m_step_res_l": m_step_res_l,
        }


def shuffle_and_decode_gain(model, spk_mat, n_shuffle=100, seed=None,
                            verbose=True, **decode_kwargs):
    """Circular-shuffle null for the gain model: each shuffle re-fits the
    gain during naive-Bayes decoding (reference experimental/test_exp.py)."""
    from poor_man_gplvm_tpu.validation import circular_shuffle_data

    decoding_res_l = []
    for y_sh in progress(
        circular_shuffle_data(spk_mat, n_shuffle=n_shuffle, seed=seed),
        verbose, total=n_shuffle,
    ):
        decoding_res_l.append(
            model.decode_latent_naive_bayes(y_sh, **decode_kwargs)
        )
    return {
        k: np.array([np.asarray(d[k]) for d in decoding_res_l])
        for k in decoding_res_l[0].keys()
    }
