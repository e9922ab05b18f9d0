"""Jump models: smooth 1-D latent + 2-state (continuous/jump) dynamics HMM.

Equivalents of reference ``AbstractGPLVMJump1D``,
``PoissonGPLVMJump1D`` (flagship) and ``GaussianGPLVMJump1D``
(reference: poor_man_gplvm/core.py:376-916).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np

from poor_man_gplvm_tpu.models.base import _GPLVMCommon
from poor_man_gplvm_tpu.ops import kernels as gpk
from poor_man_gplvm_tpu.ops import mstep as fth
from poor_man_gplvm_tpu.ops import hmm
from poor_man_gplvm_tpu.ops.hmm import JOINT_ACC_INIT
from poor_man_gplvm_tpu.utils import compat

__all__ = ["AbstractGPLVMJump1D", "PoissonGPLVMJump1D", "GaussianGPLVMJump1D"]


@partial(jax.jit, static_argnums=(0, 1))
def _init_posterior_random(T, n_latent_bin, key, random_scale):
    posterior = jax.random.uniform(key, shape=(T, n_latent_bin)) * random_scale
    posterior = posterior / posterior.sum(axis=1, keepdims=True)
    log_posterior = jnp.log(posterior)
    # reference core.py floors -inf at -1e40; that is not f32-representable,
    # so use the shared finite sentinel (see ops/hmm.py JOINT_ACC_INIT)
    log_posterior = jnp.where(
        log_posterior == -jnp.inf, JOINT_ACC_INIT, log_posterior
    )
    return log_posterior, posterior


class AbstractGPLVMJump1D(_GPLVMCommon):
    """GPLVM with smooth 1d latent + jumps.

    The latent governs firing rate; the 2-state dynamics governs the latent
    transition law (RBF-smooth when 'continuous', uniform when 'jump').
    Matches reference core.py:376-733 contracts.
    """

    has_dynamics = True

    def __init__(
        self,
        n_neuron,
        n_latent_bin=100,
        tuning_lengthscale=1.0,
        param_prior_std=1.0,
        movement_variance=1.0,
        explained_variance_threshold_basis=0.999,
        rng_init_int=123,
        w_init_variance=1.0,
        w_init_mean=0.0,
        p_move_to_jump=0.01,
        p_jump_to_move=0.01,
        basis_type="rbf",
        custom_tuning_kernel=None,
        custom_transition_kernel=None,
        smoothness_penalty=0.0,
        inference_engine="auto",
    ):
        self.p_move_to_jump = p_move_to_jump
        self.p_jump_to_move = p_jump_to_move
        self.possible_dynamics = jnp.arange(2)
        self._init_common(
            n_neuron, n_latent_bin, tuning_lengthscale, param_prior_std,
            movement_variance, explained_variance_threshold_basis,
            rng_init_int, w_init_variance, w_init_mean, basis_type,
            custom_tuning_kernel, custom_transition_kernel, smoothness_penalty,
            inference_engine,
        )

    # ------------------------------------------------------------------
    def _adopt_hyperparam(self, hyperparam):
        self.tuning_lengthscale = hyperparam.get(
            "tuning_lengthscale", self.tuning_lengthscale
        )
        self.movement_variance = hyperparam.get(
            "movement_variance", self.movement_variance
        )
        self.p_move_to_jump = hyperparam.get("p_move_to_jump", self.p_move_to_jump)
        self.p_jump_to_move = hyperparam.get("p_jump_to_move", self.p_jump_to_move)

    _TRANSITION_HYPER_KEYS = (
        "movement_variance", "p_move_to_jump", "p_jump_to_move",
    )

    def _build_transition(self, hyperparam):
        movement_variance = hyperparam.get("movement_variance", self.movement_variance)
        p_move_to_jump = hyperparam.get("p_move_to_jump", self.p_move_to_jump)
        p_jump_to_move = hyperparam.get("p_jump_to_move", self.p_jump_to_move)
        (
            lat_kernel_l, log_lat_kernel_l, dyn_kernel, log_dyn_kernel,
        ) = gpk.create_transition_prob_1d(
            self.possible_latent_bin, self.possible_dynamics, movement_variance,
            p_move_to_jump, p_jump_to_move,
            custom_kernel=self.custom_transition_kernel,
        )
        trans = hmm.JointTransition(
            Tdyn=dyn_kernel, Tlat=lat_kernel_l,
            logTdyn=log_dyn_kernel, logTlat=log_lat_kernel_l,
        )
        kernel_attrs = {
            "log_latent_transition_kernel_l": log_lat_kernel_l,
            "log_dynamics_transition_kernel": log_dyn_kernel,
        }
        return trans, kernel_attrs

    def _decode_latent(
        self, y, tuning, hyperparam, log_latent_transition_kernel_l,
        log_dynamics_transition_kernel, ma_neuron, ma_latent=None,
        likelihood_scale=1.0, n_time_per_chunk=None,
    ):
        """Decode latent and dynamics from explicit transition matrices
        (reference abstract signature, core.py:440-449)."""
        trans = hmm.JointTransition(
            Tdyn=jnp.exp(log_dynamics_transition_kernel),
            Tlat=jnp.exp(log_latent_transition_kernel_l),
            logTdyn=log_dynamics_transition_kernel,
            logTlat=log_latent_transition_kernel_l,
        )
        return self._smooth(
            y, tuning, hyperparam, trans, ma_neuron, ma_latent,
            likelihood_scale, n_time_per_chunk,
        )

    # ------------------------------------------------------------------
    def decode_latent(
        self, y, tuning=None, hyperparam=None, ma_neuron=None, ma_latent=None,
        likelihood_scale=1.0, n_time_per_chunk=None, t_l=None, mesh=None,
    ):
        """Full smoother decode; 7 base keys + 12 transition-posterior keys
        (reference core.py:454-497).  ``mesh``: run the smoother sharded
        over a ('data','time','neuron') device mesh."""
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

        trans, _ = self._make_transition(hyperparam)

        def build_res(log_posterior_all, log_one_step_pred, log_acc,
                      log_likelihood_all):
            posterior_all = jnp.exp(log_posterior_all)
            posterior_latent_marg = jnp.sum(posterior_all, axis=1)
            posterior_dynamics_marg = jnp.sum(posterior_all, axis=2)
            if t_l is not None:
                posterior_latent_marg = compat.tsdframe(
                    d=np.asarray(posterior_latent_marg), t=t_l
                )
                posterior_dynamics_marg = compat.tsdframe(
                    d=np.asarray(posterior_dynamics_marg), t=t_l
                )
            res = {
                "log_posterior_all": log_posterior_all,
                "posterior_all": posterior_all,
                "posterior_latent_marg": posterior_latent_marg,
                "posterior_dynamics_marg": posterior_dynamics_marg,
                "log_one_step_predictive_marginals_all": log_one_step_pred,
                "log_likelihood_all": log_likelihood_all,
            }
            if log_acc is not None:
                res.update(hmm.compute_transition_posterior_prob(log_acc))
            return res

        return self._decode_dispatch(
            y, tuning, hyperparam, trans, ma_neuron, ma_latent,
            likelihood_scale, n_time_per_chunk, t_l, mesh,
            ("posterior_latent_marg", "posterior_dynamics_marg"), build_res,
        )

    # ------------------------------------------------------------------
    def sample_latent(
        self, T, key=None, movement_variance=1, p_move_to_jump=0.01,
        p_jump_to_move=0.01, init_dynamics=None, init_latent=None,
    ):
        """Ancestral sampling of (dynamics, latent) paths via lax.scan
        (reference core.py:526-555). Returns (T, 2) [dynamics, latent]."""
        key = jr.PRNGKey(0) if key is None else key
        lat_kernel_l, _, dyn_kernel, _ = gpk.create_transition_prob_1d(
            self.possible_latent_bin, self.possible_dynamics, movement_variance,
            p_move_to_jump, p_jump_to_move,
        )
        # deliberate key REUSE across the two init draws and the step
        # split: reproduces the reference's exact random stream
        # (core.py:531-535); the correlated init draws are a documented
        # reference quirk, kept for seed-for-seed sample parity
        if init_dynamics is None:
            init_dynamics = jax.random.choice(key, self.possible_dynamics)
        if init_latent is None:
            init_latent = jax.random.choice(key, self.possible_latent_bin)
        key_l = jax.random.split(key, T)

        possible_dynamics = self.possible_dynamics
        possible_latent_bin = self.possible_latent_bin

        def step(carry, k):
            k1, k2 = jax.random.split(k, 2)
            dynamics_prev, latent_prev = carry
            dynamics_curr = jax.random.choice(
                k1, possible_dynamics, p=dyn_kernel[dynamics_prev]
            )
            latent_curr = jax.random.choice(
                k2, possible_latent_bin, p=lat_kernel_l[dynamics_curr][latent_prev]
            )
            return (dynamics_curr, latent_curr), jnp.array(
                [dynamics_curr, latent_curr]
            )

        _, latent_l = jax.lax.scan(step, (init_dynamics, init_latent), xs=key_l)
        return latent_l

    def sample(
        self, T, hyperparam=None, key=None, init_dynamics=None,
        init_latent=None, dt=1.0, tuning=None,
    ):
        """Sample latent path + observations (reference core.py:558-569)."""
        hyperparam = {} if hyperparam is None else hyperparam
        key = jr.PRNGKey(0) if key is None else key
        key_l = jax.random.split(key, T)
        movement_variance = hyperparam.get("movement_variance", self.movement_variance)
        p_move_to_jump = hyperparam.get("p_move_to_jump", self.p_move_to_jump)
        p_jump_to_move = hyperparam.get("p_jump_to_move", self.p_jump_to_move)
        latent_l = self.sample_latent(
            T, key_l[0], movement_variance, p_move_to_jump, p_jump_to_move,
            init_dynamics, init_latent,
        )
        y_l = self.sample_y(latent_l[:, 1], hyperparam, tuning, dt, key_l[1])
        return latent_l, y_l

    def init_latent_posterior(self, T, key, random_scale=0.1):
        """Pure-random init — intentionally different from the 1D family
        (reference core.py:571-583)."""
        return _init_posterior_random(T, self.n_latent_bin, key, random_scale)


class PoissonGPLVMJump1D(AbstractGPLVMJump1D):
    """Poisson GPLVM with jumps — the flagship model
    (reference core.py:746-849)."""

    observation_model = "poisson"

    def loglikelihood(self, y, ypred, hyperparam):
        return jax.scipy.stats.poisson.logpmf(y, ypred + 1e-40)

    def get_tuning(self, params, hyperparam, tuning_basis):
        return fth.get_tuning_softplus(params, tuning_basis)

    def decode_latent_naive_bayes(
        self, y, tuning=None, hyperparam=None, ma_neuron=None, ma_latent=None,
        likelihood_scale=1.0, n_time_per_chunk=10000, dt_l=1.0, t_l=None,
    ):
        return super().decode_latent_naive_bayes(
            y, tuning=tuning, hyperparam=hyperparam, ma_neuron=ma_neuron,
            ma_latent=ma_latent, likelihood_scale=likelihood_scale,
            n_time_per_chunk=n_time_per_chunk, dt_l=dt_l,
            observation_model="poisson", t_l=t_l,
        )

    def sample_y(self, latent_l, hyperparam=None, tuning=None, dt=1.0, key=None):
        key = jr.PRNGKey(10) if key is None else key
        if tuning is None:
            tuning = self.tuning
        rate = tuning[latent_l, :]
        return jax.random.poisson(key, rate * dt)

    def m_step(
        self, param_curr, y, log_posterior_curr, tuning_basis, hyperparam,
        opt_state_curr=None, host_trim=True,
    ):
        """Adam M-step with optimizer-state continuity
        (reference core.py:802-827).  ``host_trim=False`` defers history
        trimming (a host sync) to the caller — fit_em batch-trims after the
        EM loop."""
        y_weighted, t_weighted = fth.get_statistics(log_posterior_curr, y)
        adam_res = self.adam_runner(
            param_curr, opt_state_curr, hyperparam, tuning_basis, y_weighted,
            t_weighted,
        )
        return fth.package_adam_result(adam_res, host_trim=host_trim)

    def fit_em(
        self, y, hyperparam=None, key=None, n_iter=20, log_posterior_init=None,
        ma_neuron=None, ma_latent=None, n_time_per_chunk=None, dt=1.0,
        likelihood_scale=1.0, save_every=None, m_step_step_size=0.01,
        m_step_maxiter=1000, m_step_tol=1e-6, **kwargs,
    ):
        hyperparam_ = dict(hyperparam or {})
        hyperparam_["param_prior_std"] = hyperparam_.get(
            "param_prior_std", self.param_prior_std
        )
        hyperparam_["smoothness_penalty"] = hyperparam_.get(
            "smoothness_penalty", self.smoothness_penalty
        )
        self.adam_runner, self.opt_state_init_fun = fth.make_adam_runner_cached(
            fth.poisson_m_step_objective_smoothness
            if self.basis_type == "bspline"
            else fth.poisson_m_step_objective,
            m_step_step_size, maxiter=m_step_maxiter, tol=m_step_tol,
        )
        opt_state_curr = self.opt_state_init_fun(self.params)
        return super().fit_em(
            y, hyperparam=hyperparam_, key=key, n_iter=n_iter,
            log_posterior_init=log_posterior_init, ma_neuron=ma_neuron,
            ma_latent=ma_latent, n_time_per_chunk=n_time_per_chunk, dt=dt,
            likelihood_scale=likelihood_scale, save_every=save_every,
            opt_state_curr=opt_state_curr, **kwargs,
        )


class GaussianGPLVMJump1D(AbstractGPLVMJump1D):
    """Gaussian GPLVM with jumps: linear link + analytic ridge M-step
    (reference core.py:852-916)."""

    observation_model = "gaussian"

    def __init__(self, n_neuron, noise_std=0.5, **kwargs):
        super().__init__(n_neuron, **kwargs)
        self.noise_std = noise_std

    def loglikelihood(self, y, ypred, hyperparam):
        return jax.scipy.stats.norm.logpdf(y, ypred, hyperparam["noise_std"])

    def get_tuning(self, params, hyperparam, tuning_basis):
        return fth.get_tuning_linear(params, tuning_basis)

    def decode_latent(
        self, y, tuning=None, hyperparam=None, ma_neuron=None, ma_latent=None,
        likelihood_scale=1.0, n_time_per_chunk=None, t_l=None, mesh=None,
    ):
        # NOTE: unlike the reference (core.py:879-882, which drops t_l for
        # this class only), t_l is supported here for API consistency.
        hyperparam_ = dict(hyperparam or {})
        hyperparam_["noise_std"] = hyperparam_.get("noise_std", self.noise_std)
        return super().decode_latent(
            y, tuning=tuning, hyperparam=hyperparam_, ma_neuron=ma_neuron,
            ma_latent=ma_latent, likelihood_scale=likelihood_scale,
            n_time_per_chunk=n_time_per_chunk, t_l=t_l, mesh=mesh,
        )

    def decode_latent_naive_bayes(
        self, y, tuning=None, hyperparam=None, ma_neuron=None, ma_latent=None,
        likelihood_scale=1.0, n_time_per_chunk=10000, dt_l=1.0, t_l=None,
    ):
        hyperparam_ = dict(hyperparam or {})
        hyperparam_["noise_std"] = hyperparam_.get("noise_std", self.noise_std)
        return super().decode_latent_naive_bayes(
            y, tuning=tuning, hyperparam=hyperparam_, ma_neuron=ma_neuron,
            ma_latent=ma_latent, likelihood_scale=likelihood_scale,
            n_time_per_chunk=n_time_per_chunk, dt_l=dt_l,
            observation_model="gaussian", t_l=t_l,
        )

    def sample_y(self, latent_l, hyperparam=None, tuning=None, dt=1.0, key=None):
        hyperparam = {} if hyperparam is None else hyperparam
        key = jr.PRNGKey(10) if key is None else key
        if tuning is None:
            tuning = self.tuning
        noise_std = hyperparam.get("noise_std", self.noise_std)
        rate = tuning[latent_l, :] * dt
        noise_std = noise_std * jnp.sqrt(dt)
        return jax.random.normal(key, shape=rate.shape) * noise_std + rate

    def m_step(
        self, param_curr, y, log_posterior_curr, tuning_basis, hyperparam,
        opt_state_curr=None, host_trim=True,
    ):
        y_weighted, t_weighted = fth.get_statistics(log_posterior_curr, y)
        params_new = fth.gaussian_m_step_analytic(
            hyperparam, tuning_basis, y_weighted, t_weighted
        )
        return {"params": params_new, "opt_state": None}

    def fit_em(
        self, y, hyperparam=None, key=None, n_iter=20, log_posterior_init=None,
        ma_neuron=None, ma_latent=None, n_time_per_chunk=None, dt=1.0,
        likelihood_scale=1.0, save_every=None, **kwargs,
    ):
        hyperparam_ = dict(hyperparam or {})
        hyperparam_["noise_std"] = hyperparam_.get("noise_std", self.noise_std)
        hyperparam_["param_prior_std"] = hyperparam_.get(
            "param_prior_std", self.param_prior_std
        )
        return super().fit_em(
            y, hyperparam=hyperparam_, key=key, n_iter=n_iter,
            log_posterior_init=log_posterior_init, ma_neuron=ma_neuron,
            ma_latent=ma_latent, n_time_per_chunk=n_time_per_chunk, dt=dt,
            likelihood_scale=likelihood_scale, save_every=save_every, **kwargs,
        )
