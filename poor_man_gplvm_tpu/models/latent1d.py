"""Latent-only models: smooth 1-D latent, no dynamics HMM.

Equivalents of reference ``AbstractGPLVM1D``, ``PoissonGPLVM1D``
and ``GaussianGPLVM1D`` (reference: poor_man_gplvm/core.py:76-373, 919-1094).
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

__all__ = ["AbstractGPLVM1D", "PoissonGPLVM1D", "GaussianGPLVM1D"]


@partial(jax.jit, static_argnums=(0, 1))
def _init_posterior_uniform_noise(T, n_latent_bin, key, random_scale):
    posterior = jnp.ones((T, n_latent_bin)) / n_latent_bin
    posterior = posterior + jax.random.uniform(key, shape=posterior.shape) * random_scale
    posterior = posterior / posterior.sum(axis=1, keepdims=True)
    log_posterior = jnp.log(posterior)
    # reference core.py floors -inf at -1e40; that is not f32-representable,
    # so use the shared finite sentinel (see ops/hmm.py JOINT_ACC_INIT)
    log_posterior = jnp.where(
        log_posterior == -jnp.inf, JOINT_ACC_INIT, log_posterior
    )
    return log_posterior, posterior


class AbstractGPLVM1D(_GPLVMCommon):
    """GPLVM with smooth 1d latent (no dynamics)
    (reference core.py:76-373)."""

    has_dynamics = False

    def __init__(
        self,
        n_neuron,
        n_latent_bin=100,
        tuning_lengthscale=5.0,
        param_prior_std=1.0,
        movement_variance=1.0,
        explained_variance_threshold_basis=0.999,
        rng_init_int=123,
        w_init_variance=1.0,
        w_init_mean=0.0,
        basis_type="rbf",
        custom_tuning_kernel=None,
        custom_transition_kernel=None,
        smoothness_penalty=0.0,
        inference_engine="auto",
    ):
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

    _TRANSITION_HYPER_KEYS = ("movement_variance",)

    def _build_transition(self, hyperparam):
        movement_variance = hyperparam.get("movement_variance", self.movement_variance)
        kernel, log_kernel = gpk.create_transition_prob_latent_1d(
            self.possible_latent_bin, movement_variance,
            custom_kernel=self.custom_transition_kernel,
        )
        trans = hmm.LatentTransition(T=kernel, logT=log_kernel)
        kernel_attrs = {"log_latent_transition_kernel": log_kernel}
        return trans, kernel_attrs

    def _decode_latent(
        self, y, tuning, hyperparam, log_latent_transition_kernel, ma_neuron,
        ma_latent=None, likelihood_scale=1.0, n_time_per_chunk=None,
    ):
        """Decode the latent from an explicit transition matrix
        (reference abstract signature, core.py:126-134)."""
        trans = hmm.LatentTransition(
            T=jnp.exp(log_latent_transition_kernel),
            logT=log_latent_transition_kernel,
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
        """Full smoother decode; 5 base keys + 4 transition-posterior keys
        (reference core.py:136-177).  ``mesh``: run the smoother sharded
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
            if t_l is not None:
                posterior_all = compat.tsdframe(
                    d=np.asarray(posterior_all), t=t_l
                )
            res = {
                "log_posterior_all": log_posterior_all,
                "posterior_all": posterior_all,
                "log_one_step_predictive_marginals_all": log_one_step_pred,
                "log_likelihood_all": log_likelihood_all,
            }
            if log_acc is not None:
                res.update(
                    hmm.compute_transition_posterior_prob_latent(log_acc)
                )
            return res

        return self._decode_dispatch(
            y, tuning, hyperparam, trans, ma_neuron, ma_latent,
            likelihood_scale, n_time_per_chunk, t_l, mesh,
            ("posterior_all",), build_res,
        )

    # ------------------------------------------------------------------
    def sample_latent(self, T, key=None, movement_variance=1, init_latent=None):
        """Ancestral latent-path sampling (reference core.py:209-229)."""
        key = jr.PRNGKey(0) if key is None else key
        kernel, _ = gpk.create_transition_prob_latent_1d(
            self.possible_latent_bin, movement_variance,
            custom_kernel=self.custom_transition_kernel,
        )
        # deliberate key reuse between the init draw and the step split:
        # reproduces the reference's exact random stream (core.py:213-216)
        if init_latent is None:
            init_latent = jax.random.choice(key, self.possible_latent_bin)
        key_l = jax.random.split(key, T)
        possible_latent_bin = self.possible_latent_bin

        def step(latent_prev, k):
            latent_curr = jax.random.choice(
                k, possible_latent_bin, p=kernel[latent_prev]
            )
            return latent_curr, latent_curr

        _, latent_l = jax.lax.scan(step, init_latent, xs=key_l)
        return latent_l

    def sample(
        self, T, hyperparam=None, key=None, init_latent=None, dt=1.0, tuning=None
    ):
        """Sample latent path + observations (reference core.py:231-239)."""
        hyperparam = {} if hyperparam is None else hyperparam
        key = jr.PRNGKey(0) if key is None else key
        key_l = jax.random.split(key, T)
        movement_variance = hyperparam.get("movement_variance", self.movement_variance)
        latent_l = self.sample_latent(T, key_l[0], movement_variance, init_latent)
        y_l = self.sample_y(latent_l, hyperparam, tuning, dt, key_l[1])
        return latent_l, y_l

    def init_latent_posterior(self, T, key, random_scale=0.1):
        """Uniform + noise init — intentionally different from the jump
        family (reference core.py:241-250)."""
        return _init_posterior_uniform_noise(T, self.n_latent_bin, key, random_scale)


class PoissonGPLVM1D(AbstractGPLVM1D):
    """Poisson latent-only GPLVM (reference core.py:919-1019)."""

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


class GaussianGPLVM1D(AbstractGPLVM1D):
    """Gaussian latent-only GPLVM (reference core.py:1022-1094)."""

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
