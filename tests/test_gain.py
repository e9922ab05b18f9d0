"""Experimental gain model: gain recovery, EM improvement, shuffle test."""

import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest

from poor_man_gplvm_tpu.experimental import (
    PoissonGPLVMGain1D_gain,
    get_gain_mstep,
    get_statistics_gain,
    shuffle_and_decode_gain,
)

T, N, L = 200, 10, 12


@pytest.fixture(scope="module")
def gain_sim():
    model = PoissonGPLVMGain1D_gain(N, n_latent_bin=L, tuning_lengthscale=3.0)
    # time-varying gain: low first half, high second half
    gain_true = np.concatenate([np.full(T // 2, 0.5), np.full(T // 2, 2.0)])
    state_l, y = model.sample(T, key=jr.PRNGKey(0), gain=jnp.asarray(gain_true))
    return model, state_l, y, gain_true


def test_gain_mstep_recovers_scale(gain_sim):
    model, state_l, y, gain_true = gain_sim
    # with the TRUE tuning and a delta posterior at the true latent, the gain
    # MLE should track the applied gain profile
    post = np.full((T, L), 1e-10)
    post[np.arange(T), np.asarray(state_l[:, 1])] = 1.0
    post /= post.sum(axis=1, keepdims=True)
    gain_hat = np.asarray(
        get_gain_mstep(jnp.asarray(y, dtype=jnp.float32), jnp.log(post),
                       model.tuning)
    )
    assert gain_hat[: T // 2].mean() < gain_hat[T // 2 :].mean()
    assert gain_hat[T // 2 :].mean() / gain_hat[: T // 2].mean() > 2.0


def test_statistics_gain_shapes():
    rng = np.random.default_rng(0)
    post = rng.dirichlet(np.ones(L), size=T)
    y = rng.poisson(2.0, (T, N)).astype(np.float32)
    gain = rng.gamma(2.0, 0.5, T).astype(np.float32)
    y_w, t_w, g_w = get_statistics_gain(jnp.log(post), y, gain)
    assert y_w.shape == (L, N) and t_w.shape == (L,) and g_w.shape == (L,)
    # with uniform gain == 1, gain_weighted must be ~1
    _, _, g1 = get_statistics_gain(jnp.log(post), y, jnp.ones(T))
    np.testing.assert_allclose(np.asarray(g1), 1.0, rtol=1e-4)


def test_gain_fit_em(gain_sim):
    model, state_l, y, gain_true = gain_sim
    em = model.fit_em(y, n_iter=3, verboase=False)
    lml = [float(v) for v in em["log_marginal_l"]]
    assert lml[-1] > lml[0]
    assert em["gain"].shape == (T,)
    assert "gain_saved" in em
    # fitted gain tracks the true gain profile direction
    g = np.asarray(em["gain"])
    assert g[T // 2 :].mean() > g[: T // 2].mean()


def test_gain_naive_bayes_refit(gain_sim):
    model, _, y, _ = gain_sim
    model.fit_em(y, n_iter=2, verboase=False)
    res0 = model.decode_latent_naive_bayes(y, gain_refit_n_iter=0,
                                           gain=jnp.ones(T))
    res2 = model.decode_latent_naive_bayes(y, gain_refit_n_iter=2,
                                           gain=jnp.ones(T))
    # refitting the gain must improve the marginal likelihood
    assert res2["log_marginal"] > res0["log_marginal"]
    assert res2["gain"].shape == (T,)


def test_gain_shuffle(gain_sim):
    model, _, y, _ = gain_sim
    model.fit_em(y, n_iter=1, verboase=False)
    res = shuffle_and_decode_gain(model, np.asarray(y), n_shuffle=2,
                                  seed=0, verbose=False)
    assert res["log_marginal_l"].shape == (2, T)


def test_gain_decode_pallas_engine_matches_prob():
    """Gain decode through the sequential kernel (changing-dt path; the
    kernel's interpreter on the CPU) equals the prob engine."""
    import jax.numpy as jnp
    import jax.random as jr
    from poor_man_gplvm_tpu.experimental.gain import PoissonGPLVMGain1D_gain

    T, N, L = 150, 8, 12
    rng = np.random.default_rng(3)
    gain_true = np.exp(rng.normal(0, 0.3, T)).astype(np.float32)

    def make(engine):
        return PoissonGPLVMGain1D_gain(
            N, n_latent_bin=L, tuning_lengthscale=5.0,
            inference_engine=engine,
        )

    m_prob, m_pallas = make("prob"), make("pallas_interpret")
    _, y = m_prob.sample(T, key=jr.PRNGKey(0), gain=gain_true)
    y = np.asarray(y, dtype=np.float32)

    args = (
        jnp.asarray(y), m_prob.tuning, {},
    )
    kw = dict(ma_neuron=jnp.ones(N), ma_latent=jnp.ones(L),
              likelihood_scale=1.0, n_time_per_chunk=64,
              gain=jnp.asarray(gain_true))
    import poor_man_gplvm_tpu.ops.kernels as gpk

    _, log_lat_l, _, log_dyn = gpk.create_transition_prob_1d(
        jnp.arange(L), jnp.arange(2), 1.0, 0.02, 0.05
    )
    out_a = m_prob._decode_latent(*args, log_lat_l, log_dyn, **kw)
    out_b = m_pallas._decode_latent(*args, log_lat_l, log_dyn, **kw)
    np.testing.assert_allclose(float(out_b[1]), float(out_a[1]), rtol=1e-5)
    np.testing.assert_allclose(
        np.exp(np.asarray(out_b[0])), np.exp(np.asarray(out_a[0])),
        rtol=2e-3, atol=2e-5,
    )


def test_gain_decode_and_fit_sharded_matches_serial():
    """Gain decode/fit over an 8-device CPU mesh equals the serial path
    (the gain rides the per-time dt operand of sharded_smooth)."""
    import jax.numpy as jnp
    import jax.random as jr
    from poor_man_gplvm_tpu.experimental.gain import PoissonGPLVMGain1D_gain
    from poor_man_gplvm_tpu.parallel import spmd

    mesh = spmd.make_mesh(8, batch=1)
    T, N, L = 90, 7, 10  # T, N deliberately not divisible by the mesh
    rng = np.random.default_rng(4)
    gain_true = np.exp(rng.normal(0, 0.3, T)).astype(np.float32)

    def make():
        return PoissonGPLVMGain1D_gain(
            N, n_latent_bin=L, tuning_lengthscale=5.0,
            inference_engine="prob",
        )

    m_a, m_b = make(), make()
    _, y = m_a.sample(T, key=jr.PRNGKey(0), gain=gain_true)
    y = np.asarray(y, dtype=np.float32)

    log_post_init, _ = m_a.init_latent_posterior(T, jr.PRNGKey(7))
    em_kw = dict(
        key=jr.PRNGKey(3), n_iter=3, verboase=False,
        log_posterior_init=log_post_init, m_step_maxiter=20,
    )
    em_a = m_a.fit_em(y, **em_kw)
    em_b = m_b.fit_em(y, mesh=mesh, **em_kw)
    np.testing.assert_allclose(
        np.asarray(em_b["log_marginal_l"], dtype=np.float64),
        np.asarray(em_a["log_marginal_l"], dtype=np.float64),
        rtol=1e-5,
    )
    np.testing.assert_allclose(
        np.asarray(em_b["gain"]), np.asarray(em_a["gain"]),
        rtol=1e-4, atol=1e-6,
    )
    np.testing.assert_allclose(
        np.asarray(em_b["posterior"]), np.asarray(em_a["posterior"]),
        rtol=2e-3, atol=1e-5,
    )


def test_gain_nb_decode_tsdframe_and_short_chunk():
    """The gain naive-Bayes decode honors TsdFrame input / t_l like its
    siblings, and a length-1 trailing chunk no longer breaks the chunked
    concatenation (reference squeeze bug)."""
    import numpy as np

    from poor_man_gplvm_tpu.experimental import PoissonGPLVMGain1D_gain
    from poor_man_gplvm_tpu.utils.timeseries import TsdFrame

    m = PoissonGPLVMGain1D_gain(6, n_latent_bin=8, tuning_lengthscale=2.0)
    _, y = m.sample(21, key=jr.PRNGKey(0))
    res = m.decode_latent_naive_bayes(
        np.asarray(y), n_time_per_chunk=10
    )  # chunks 10+10+1: trailing length-1 chunk
    assert np.asarray(res["log_marginal_l"]).shape == (21,)

    t = np.arange(21) * 0.1
    res_t = m.decode_latent_naive_bayes(TsdFrame(d=np.asarray(y), t=t))
    assert "posterior_latent" in res_t
    np.testing.assert_allclose(res_t["posterior_latent"].t, t)
