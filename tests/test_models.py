"""End-to-end model tests: the README-quickstart round-trip
(sample -> fit_em -> decode_latent -> decode_latent_naive_bayes), EM
log-marginal improvement, result-dict contracts, pickling, engine parity.
Mirrors the reference's de-facto integration test (reference README.md:99-169).
"""

import pickle

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest

import poor_man_gplvm_tpu as pmg

T = 300
N_NEURON = 12
N_LATENT = 20

EM_RES_KEYS_JUMP = {
    "log_posterior_all_saved", "log_posterior_init", "params_saved",
    "tuning_saved", "iter_saved", "params", "tuning", "log_posterior_final",
    "log_marginal", "log_marginal_l", "log_marginal_saved", "posterior",
    "posterior_latent_marg", "posterior_dynamics_marg", "m_step_res_l",
}
DECODE_KEYS_JUMP_BASE = {
    "log_posterior_all", "log_marginal_final", "posterior_all",
    "posterior_latent_marg", "posterior_dynamics_marg",
    "log_one_step_predictive_marginals_all", "log_likelihood_all",
}


@pytest.fixture(scope="module")
def sim_jump():
    model = pmg.PoissonGPLVMJump1D(
        N_NEURON, n_latent_bin=N_LATENT, movement_variance=1, tuning_lengthscale=3.0
    )
    state_l, spk = model.sample(T, key=jr.PRNGKey(5))
    return model, state_l, spk


def test_quickstart_jump(sim_jump):
    model, state_l, spk = sim_jump
    assert state_l.shape == (T, 2)
    assert spk.shape == (T, N_NEURON)

    em_res = model.fit_em(spk, key=jr.PRNGKey(3), n_iter=5, verboase=False)
    assert set(em_res.keys()) == EM_RES_KEYS_JUMP

    lml = np.asarray([float(v) for v in em_res["log_marginal_l"]])
    # EM should improve the log marginal overall
    assert lml[-1] > lml[0]

    decode_res = model.decode_latent(spk)
    assert DECODE_KEYS_JUMP_BASE.issubset(decode_res.keys())
    assert "p_transition_latent" in decode_res
    post = decode_res["posterior_all"]
    assert post.shape == (T, 2, N_LATENT)
    np.testing.assert_allclose(post.sum(axis=(1, 2)), 1.0, rtol=1e-4)
    assert decode_res["posterior_latent_marg"].shape == (T, N_LATENT)
    assert decode_res["posterior_dynamics_marg"].shape == (T, 2)

    nb_res = model.decode_latent_naive_bayes(spk)
    assert nb_res["posterior_latent"].shape == (T, N_LATENT)
    np.testing.assert_allclose(
        nb_res["posterior_latent"].sum(axis=1), 1.0, rtol=1e-4
    )


def test_decoding_recovers_latent(sim_jump):
    model, state_l, spk = sim_jump
    em_res = model.fit_em(spk, key=jr.PRNGKey(3), n_iter=8, verboase=False)
    decode_res = model.decode_latent(spk)
    map_latent = np.asarray(decode_res["posterior_latent_marg"]).argmax(axis=1)
    true_latent = np.asarray(state_l[:, 1])
    # latent is identifiable only up to relabeling; check rank correlation
    # magnitude of MAP vs truth is materially above chance
    rho = np.corrcoef(map_latent, true_latent)[0, 1]
    assert abs(rho) > 0.5


def test_engine_parity_fit(sim_jump):
    _, _, spk = sim_jump
    lmls = {}
    for engine in ("prob", "log"):
        model = pmg.PoissonGPLVMJump1D(
            N_NEURON, n_latent_bin=N_LATENT, movement_variance=1,
            tuning_lengthscale=3.0, inference_engine=engine,
        )
        em = model.fit_em(spk, key=jr.PRNGKey(3), n_iter=3, verboase=False)
        lmls[engine] = np.asarray([float(v) for v in em["log_marginal_l"]])
    np.testing.assert_allclose(lmls["prob"], lmls["log"], rtol=1e-5)


def test_chunked_fit_matches_unchunked(sim_jump):
    _, _, spk = sim_jump

    def fresh():
        return pmg.PoissonGPLVMJump1D(
            N_NEURON, n_latent_bin=N_LATENT, movement_variance=1,
            tuning_lengthscale=3.0,
        )

    em_a = fresh().fit_em(
        spk, key=jr.PRNGKey(3), n_iter=3, n_time_per_chunk=10000, verboase=False
    )
    em_b = fresh().fit_em(
        spk, key=jr.PRNGKey(3), n_iter=3, n_time_per_chunk=77, verboase=False
    )
    np.testing.assert_allclose(
        [float(v) for v in em_a["log_marginal_l"]],
        [float(v) for v in em_b["log_marginal_l"]],
        rtol=1e-5,
    )


def test_gaussian_jump_roundtrip():
    model = pmg.GaussianGPLVMJump1D(
        N_NEURON, n_latent_bin=N_LATENT, noise_std=0.5, tuning_lengthscale=3.0
    )
    _, y = model.sample(T, key=jr.PRNGKey(1))
    em_res = model.fit_em(y, key=jr.PRNGKey(2), n_iter=4, verboase=False)
    lml = [float(v) for v in em_res["log_marginal_l"]]
    assert lml[-1] > lml[0]
    res = model.decode_latent(y)
    assert res["posterior_all"].shape == (T, 2, N_LATENT)


def test_poisson_latentonly_roundtrip():
    model = pmg.PoissonGPLVM1D(
        N_NEURON, n_latent_bin=N_LATENT, tuning_lengthscale=3.0
    )
    _, y = model.sample(T, key=jr.PRNGKey(1))
    em_res = model.fit_em(y, key=jr.PRNGKey(2), n_iter=4, verboase=False)
    assert "posterior_latent_marg" not in em_res
    assert em_res["posterior"].shape == (T, N_LATENT)
    lml = [float(v) for v in em_res["log_marginal_l"]]
    assert lml[-1] > lml[0]
    res = model.decode_latent(y)
    assert res["posterior_all"].shape == (T, N_LATENT)
    assert "p_transition_latent" in res
    assert "p_transition_dynamics" not in res


def test_gaussian_latentonly_roundtrip():
    model = pmg.GaussianGPLVM1D(
        N_NEURON, n_latent_bin=N_LATENT, noise_std=0.4, tuning_lengthscale=3.0
    )
    _, y = model.sample(T, key=jr.PRNGKey(1))
    em_res = model.fit_em(y, key=jr.PRNGKey(2), n_iter=3, verboase=False)
    lml = [float(v) for v in em_res["log_marginal_l"]]
    assert lml[-1] > lml[0]


def test_masks_and_downsampled_lml(sim_jump):
    model, _, spk = sim_jump
    ma_latent = np.ones(N_LATENT, dtype=np.float32)
    ma_latent[: N_LATENT // 2] = 0.0
    res = model.decode_latent(spk, ma_latent=jnp.asarray(ma_latent))
    post = res["posterior_all"]
    assert post[:, :, : N_LATENT // 2].max() < 1e-20
    full = model.decode_latent(spk)
    assert res["log_marginal_final"] < full["log_marginal_final"]

    ma2 = np.ones((T, N_NEURON), dtype=np.float32)
    ma2[: T // 2] = 0.0  # spatio-temporal mask
    res2 = model.decode_latent(spk, ma_neuron=jnp.asarray(ma2))
    assert np.isfinite(res2["log_marginal_final"])


def test_predict_expected_rate(sim_jump):
    model, _, spk = sim_jump
    res = model.decode_latent(spk)
    rate = model.predict_expected_rate(np.asarray(res["posterior_latent_marg"]))
    assert rate.shape == (T, N_NEURON)
    assert np.all(np.asarray(rate) >= 0)


def test_pickle_roundtrip(sim_jump):
    model, _, spk = sim_jump
    model.fit_em(spk, n_iter=2, verboase=False)
    blob = pickle.dumps(model)
    model2 = pickle.loads(blob)
    assert model2.adam_runner is None
    np.testing.assert_allclose(
        np.asarray(model2.tuning), np.asarray(model.tuning)
    )
    # refitting after unpickle rebuilds the runner
    em = model2.fit_em(spk, n_iter=1, verboase=False)
    assert np.isfinite(float(em["log_marginal"]))


def test_warm_start_posterior_init(sim_jump):
    model, _, spk = sim_jump
    em1 = model.fit_em(spk, n_iter=2, verboase=False)
    em2 = model.fit_em(
        spk,
        n_iter=1,
        log_posterior_init=jnp.asarray(
            np.log(np.asarray(em1["posterior"]).sum(axis=1))
        ),
        verboase=False,
    )
    assert float(em2["log_marginal"]) >= float(em1["log_marginal_l"][0])


def test_tsdframe_passthrough(sim_jump):
    model, _, spk = sim_jump
    from poor_man_gplvm_tpu.utils import compat

    t_l = np.arange(T) * 0.01
    y_tsd = compat.tsdframe(d=np.asarray(spk), t=t_l)
    res = model.decode_latent(y_tsd)
    assert compat.is_tsdframe(res["posterior_latent_marg"])
    np.testing.assert_allclose(res["posterior_latent_marg"].t, t_l)
    em = model.fit_em(y_tsd, n_iter=1, verboase=False)
    assert compat.is_tsdframe(em["posterior_latent_marg"])


def test_lean_output_mode(sim_jump):
    """output_mode='lean' gives the same marginal posteriors and log
    marginals as the full path."""
    _, _, spk = sim_jump

    def fresh():
        return pmg.PoissonGPLVMJump1D(
            N_NEURON, n_latent_bin=N_LATENT, movement_variance=1,
            tuning_lengthscale=3.0,
        )

    # single iteration: identical up to the marginalization float path
    # (prob-space sum in lean vs logsumexp-of-logs in full); multi-iteration
    # trajectories diverge slightly because EM amplifies those last-ulp
    # differences through the M-step
    em_full = fresh().fit_em(spk, key=jr.PRNGKey(3), n_iter=1, verboase=False)
    em_lean = fresh().fit_em(
        spk, key=jr.PRNGKey(3), n_iter=1, verboase=False, output_mode="lean"
    )
    np.testing.assert_allclose(
        float(em_lean["log_marginal"]), float(em_full["log_marginal"]),
        rtol=1e-6,
    )
    np.testing.assert_allclose(
        np.asarray(em_lean["posterior_latent_marg"]),
        np.asarray(em_full["posterior_latent_marg"]), rtol=1e-4, atol=1e-7,
    )
    np.testing.assert_allclose(
        np.asarray(em_lean["posterior_dynamics_marg"]),
        np.asarray(em_full["posterior_dynamics_marg"]), rtol=1e-4, atol=1e-7,
    )
    assert em_lean["log_posterior_init"] is None
    assert em_lean["posterior"].shape == (T, N_LATENT)

    # multi-iteration: log marginals stay within float-trajectory tolerance
    lml_full = [
        float(v)
        for v in fresh().fit_em(
            spk, key=jr.PRNGKey(3), n_iter=3, verboase=False
        )["log_marginal_l"]
    ]
    lml_lean = [
        float(v)
        for v in fresh().fit_em(
            spk, key=jr.PRNGKey(3), n_iter=3, verboase=False,
            output_mode="lean",
        )["log_marginal_l"]
    ]
    np.testing.assert_allclose(lml_lean, lml_full, rtol=5e-5)


def test_fit_em_nan_guard(sim_jump):
    """nan_guard aborts a diverged fit with an actionable error; finite fits
    are unaffected."""
    model, _, spk = sim_jump
    # a healthy fit passes with the guard forced on
    em = model.fit_em(spk, key=jr.PRNGKey(0), n_iter=2, verboase=False,
                      nan_guard=True)
    assert np.isfinite(float(em["log_marginal"]))
    # poison the data to force a non-finite log marginal
    bad = np.asarray(spk, dtype=np.float32).copy()
    bad[0, 0] = np.nan
    fresh = pmg.PoissonGPLVMJump1D(
        bad.shape[1], n_latent_bin=N_LATENT, movement_variance=1,
        tuning_lengthscale=3.0,
    )
    with pytest.raises(FloatingPointError, match="EM diverged"):
        fresh.fit_em(bad, key=jr.PRNGKey(0), n_iter=2, verboase=False,
                     nan_guard=True)


@pytest.mark.parametrize("output_mode", ["full", "lean"])
def test_fused_em_matches_host_loop(output_mode):
    """The fused fast path (middle EM iterations as one lax.scan program)
    must be BIT-IDENTICAL to the host loop — same math, fewer dispatches."""
    import jax.random as jr

    kw = dict(n_latent_bin=9, movement_variance=1.0, tuning_lengthscale=3.0)
    m1 = pmg.PoissonGPLVMJump1D(5, **kw)
    _, spk = m1.sample(300)
    em1 = m1.fit_em(spk, key=jr.PRNGKey(0), n_iter=5, verboase=False,
                    fused=False, output_mode=output_mode)
    m2 = pmg.PoissonGPLVMJump1D(5, **kw)
    em2 = m2.fit_em(spk, key=jr.PRNGKey(0), n_iter=5, verboase=False,
                    fused=True, output_mode=output_mode)
    np.testing.assert_array_equal(
        np.asarray(em1["log_marginal_l"]), np.asarray(em2["log_marginal_l"])
    )
    np.testing.assert_array_equal(
        np.asarray(em1["params"]), np.asarray(em2["params"])
    )
    assert set(em1.keys()) == set(em2.keys())
    assert len(em2["m_step_res_l"]["n_iter"]) == 5


def test_fused_em_gaussian_and_latentonly():
    import jax.random as jr

    for cls in (pmg.GaussianGPLVMJump1D, pmg.GaussianGPLVM1D,
                pmg.PoissonGPLVM1D):
        m1 = cls(5, n_latent_bin=9, movement_variance=1.0,
                 tuning_lengthscale=3.0)
        _, spk = m1.sample(250)
        em1 = m1.fit_em(spk, key=jr.PRNGKey(1), n_iter=4, verboase=False,
                        fused=False)
        m2 = cls(5, n_latent_bin=9, movement_variance=1.0,
                 tuning_lengthscale=3.0)
        em2 = m2.fit_em(spk, key=jr.PRNGKey(1), n_iter=4, verboase=False,
                        fused=True)
        np.testing.assert_array_equal(
            np.asarray(em1["log_marginal_l"]),
            np.asarray(em2["log_marginal_l"]),
        )


def test_fused_em_program_reuse_across_hyperparams():
    """Numeric hyperparam changes must NOT recompile the fused program
    (sweeps reuse one compiled program per shape)."""
    import jax.random as jr

    m = pmg.PoissonGPLVMJump1D(5, n_latent_bin=9, movement_variance=1.0,
                               tuning_lengthscale=3.0)
    _, spk = m.sample(300)
    m.fit_em(spk, key=jr.PRNGKey(0), n_iter=4, verboase=False, fused=True,
             hyperparam={"movement_variance": 0.5})
    m.fit_em(spk, key=jr.PRNGKey(0), n_iter=4, verboase=False, fused=True,
             hyperparam={"movement_variance": 2.0})
    m.fit_em(spk, key=jr.PRNGKey(0), n_iter=4, verboase=False, fused=True,
             hyperparam={"movement_variance": 2.0, "p_move_to_jump": 0.02})
    # same numeric KEY SET -> same cache entry; the third call adds a key
    assert len(m._fused_prog_cache) == 2


def test_fused_em_no_recompile_across_dynamics_hyperparams():
    """Dynamics-hyperparam changes (p_move_to_jump / movement_variance)
    must reuse the SAME compiled executable, not just the same cache
    entry: the transition matrices enter the fused program as operands,
    so re-fitting with different dynamics values is a zero-compile event
    (VERDICT r2 next #9; mirrors what f4ef290 proved for emission
    numerics)."""
    import jax.random as jr

    m = pmg.PoissonGPLVMJump1D(5, n_latent_bin=9, movement_variance=1.0,
                               tuning_lengthscale=3.0)
    _, spk = m.sample(300)
    grid = [
        {"movement_variance": 0.5, "p_move_to_jump": 0.01},
        {"movement_variance": 2.0, "p_move_to_jump": 0.01},
        {"movement_variance": 2.0, "p_move_to_jump": 0.05},
        {"movement_variance": 4.0, "p_move_to_jump": 0.02},
    ]
    lml = []
    for hp in grid:
        res = m.fit_em(spk, key=jr.PRNGKey(0), n_iter=4, verboase=False,
                       fused=True, hyperparam=hp)
        lml.append(float(np.asarray(res["log_marginal_l"])[-1]))
    assert len(m._fused_prog_cache) == 1
    (prog,) = m._fused_prog_cache.values()
    # one executable total: every grid point hit the same traced program
    assert prog._cache_size() == 1
    # and the dynamics values genuinely steered the result
    assert len(set(lml)) == len(grid)


def test_transition_cache_reuse_and_bust():
    """Repeated decode/fit with the same dynamics hyperparams reuse the
    built transition matrices (one kernel-builder dispatch per distinct
    config — the builder's dispatch latency shows up on every decode
    call); numeric overrides get their own entries and results match a
    cache-free build."""
    import jax.random as jr

    m = pmg.PoissonGPLVMJump1D(6, n_latent_bin=8, movement_variance=1.0,
                               tuning_lengthscale=3.0)
    t1, _ = m._make_transition({})
    t2, _ = m._make_transition({})
    assert t1 is t2
    t3, _ = m._make_transition({"movement_variance": 2.0})
    assert t3 is not t1
    # cached object == fresh build, leaf for leaf
    fresh, _ = m._build_transition({"movement_variance": 2.0})
    for a, b in zip(jax.tree.leaves(t3), jax.tree.leaves(fresh)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # decode twice: same answer, and the ctor-default entry is reused
    _, spk = m.sample(200, key=jr.PRNGKey(0))
    m.fit_em(spk, key=jr.PRNGKey(1), n_iter=2, verboase=False)
    d1 = m.decode_latent(spk)
    d2 = m.decode_latent(spk)
    assert d1["log_marginal_final"] == d2["log_marginal_final"]
    # custom transition kernels bypass the cache entirely
    mc = pmg.PoissonGPLVM1D(
        6, n_latent_bin=8, tuning_lengthscale=3.0,
        custom_transition_kernel=np.eye(8, dtype=np.float32) * 0.9 + 0.0125,
    )
    assert mc._transition_cache_key({}) is None


def test_fused_decode_matches_manual_composition():
    """decode_latent's one-dispatch fused program must equal composing
    _smooth + prob-space transforms + transition posterior by hand (the
    pre-fusion decode path), including under masks and overrides."""
    import jax.random as jr
    from poor_man_gplvm_tpu.ops import hmm

    m = pmg.PoissonGPLVMJump1D(10, n_latent_bin=12, movement_variance=1.0,
                               tuning_lengthscale=3.0)
    _, spk = m.sample(150, key=jr.PRNGKey(0))
    m.fit_em(spk, key=jr.PRNGKey(1), n_iter=2, verboase=False)

    ma_lat = np.ones(12, dtype=np.float32)
    ma_lat[:3] = 0.0
    hyper = {"movement_variance": 2.0}
    dec = m.decode_latent(spk, hyperparam=hyper,
                          ma_latent=jnp.asarray(ma_lat))

    trans, _ = m._make_transition(hyper)
    (log_post, lmf, _lc, lpred, lacc, ll) = m._smooth(
        jnp.asarray(spk), m.tuning, hyper, trans, m.ma_neuron_default,
        jnp.asarray(ma_lat), 1.0, None,
    )
    np.testing.assert_allclose(
        np.asarray(dec["log_posterior_all"]), np.asarray(log_post),
        rtol=0, atol=0,
    )
    assert dec["log_marginal_final"] == float(lmf)
    np.testing.assert_allclose(
        np.asarray(dec["posterior_latent_marg"]),
        np.exp(np.asarray(log_post)).sum(axis=1), rtol=1e-6, atol=1e-7,
    )
    expected_tp = hmm.compute_transition_posterior_prob(lacc)
    for k, v in expected_tp.items():
        np.testing.assert_allclose(
            np.asarray(dec[k]), np.asarray(v), rtol=1e-6, atol=1e-7,
        )


def test_set_matmul_precision_knob(monkeypatch):
    """The deployment precision knob flips the emission/M-step matmul
    precision, keeps results close, and never touches the scan-step
    recursion precision.

    The knob's real jax.clear_caches() is no-op'd here: mid-suite it would
    drop EVERY test's compiled programs.  The retrace the knob needs is
    forced per-model instead by clearing this model's own fused cache; the
    numeric effect of the flip is an accelerator property anyway (CPU
    matmuls are f32 at every Precision), so what this test pins is the
    plumbing."""
    import jax

    from poor_man_gplvm_tpu import config as cfg
    from poor_man_gplvm_tpu.ops import emissions, mstep

    monkeypatch.setattr(jax, "clear_caches", lambda: None)

    m = pmg.PoissonGPLVMJump1D(8, n_latent_bin=10, tuning_lengthscale=3.0)
    _, spk = m.sample(120, key=jr.PRNGKey(0))
    base = m.decode_latent(spk)["log_marginal_final"]
    try:
        cfg.set_matmul_precision("high")
        m._fused_prog_cache.clear()  # per-model retrace, not global
        assert emissions.PRECISION == jax.lax.Precision.HIGH
        assert mstep.PRECISION == jax.lax.Precision.HIGH
        assert pmg.get_matmul_precision() == jax.lax.Precision.HIGH
        # scan-step matvecs stay exact
        from poor_man_gplvm_tpu.ops import hmm as _hmm

        assert _hmm.PRECISION == jax.lax.Precision.HIGHEST
        got = m.decode_latent(spk)["log_marginal_final"]
        assert abs(got - base) <= 1e-4 * abs(base)
        with pytest.raises(ValueError):
            cfg.set_matmul_precision("fp8")
    finally:
        cfg.set_matmul_precision("highest")
    assert emissions.PRECISION == jax.lax.Precision.HIGHEST


def test_fit_em_rejects_empty_schedule():
    m = pmg.PoissonGPLVMJump1D(6, n_latent_bin=8, tuning_lengthscale=2.0)
    _, y = m.sample(50, key=jr.PRNGKey(0))
    with pytest.raises(ValueError, match="n_iter"):
        m.fit_em(y, n_iter=0, verboase=False)


def test_fit_em_swept_lengthscale_rank_change():
    """Sweeping tuning_lengthscale via hyperparam regenerates the basis;
    when the basis RANK changes the params/opt-state are re-initialized
    for the new shape instead of crashing in the first M-step (the
    reference dies with a dot-dimension mismatch here, core.py:296-300)."""
    m = pmg.PoissonGPLVMJump1D(8, n_latent_bin=16, tuning_lengthscale=6.0)
    _, y = m.sample(120, key=jr.PRNGKey(0))
    k_old = m.params.shape[0]
    em = m.fit_em(y, hyperparam={"tuning_lengthscale": 1.5}, n_iter=2,
                  verboase=False, key=jr.PRNGKey(1))
    assert np.isfinite(np.asarray(em["log_marginal_l"])).all()
    assert m.params.shape[0] == m.tuning_basis.shape[1] == m.n_basis
    assert m.params.shape[0] != k_old  # the sweep genuinely changed rank
    # and decode with the refit model works
    dec = m.decode_latent(np.asarray(y), hyperparam={})
    assert np.isfinite(dec["log_marginal_final"])


def test_bspline_basis_and_smoothness_penalty():
    """basis_type='bspline' is reachable (the reference comments it out
    yet selects the smoothness objective for it) and the penalty smooths
    the tuning."""
    from poor_man_gplvm_tpu.ops.basis import generate_basis

    b = np.asarray(generate_basis(None, 30, basis_type="bspline"))
    assert b.shape[0] == 30 and b.shape[1] >= 5
    # partition of unity over the non-bias columns
    np.testing.assert_allclose(b[:, 1:].sum(axis=1), 1.0, atol=1e-5)

    def rough(t):
        return float((np.diff(np.asarray(t), n=2, axis=0) ** 2).sum())

    m_lo = pmg.PoissonGPLVMJump1D(8, n_latent_bin=20, basis_type="bspline",
                                  smoothness_penalty=5.0,
                                  tuning_lengthscale=3.0)
    _, y = m_lo.sample(150, key=jr.PRNGKey(0))
    em = m_lo.fit_em(y, key=jr.PRNGKey(1), n_iter=3, verboase=False)
    lml = np.asarray(em["log_marginal_l"])
    assert np.isfinite(lml).all() and lml[-1] > lml[0]
    m_hi = pmg.PoissonGPLVMJump1D(8, n_latent_bin=20, basis_type="bspline",
                                  smoothness_penalty=500.0,
                                  tuning_lengthscale=3.0)
    m_hi.fit_em(y, key=jr.PRNGKey(1), n_iter=3, verboase=False)
    assert rough(m_hi.tuning) < rough(m_lo.tuning)


def test_oom_error_gets_guidance(monkeypatch):
    """A device RESOURCE_EXHAUSTED error is re-raised once with the memory
    knobs appended (models/base.py _with_oom_guidance); other errors pass
    through untouched, and nothing is retried."""
    import jax as _jax
    import poor_man_gplvm_tpu as pmg
    from poor_man_gplvm_tpu.ops import hmm as _hmm

    m = pmg.PoissonGPLVMJump1D(5, n_latent_bin=8, movement_variance=1,
                               tuning_lengthscale=3.0)
    _, y = m.sample(50)
    seen = {"n_calls": 0}

    def boom(*a, **k):
        seen["n_calls"] += 1
        raise _jax.errors.JaxRuntimeError(
            "RESOURCE_EXHAUSTED: Out of memory while trying to allocate."
        )

    monkeypatch.setattr(_hmm, "smooth_combined_chunked", boom)
    with pytest.raises(_jax.errors.JaxRuntimeError) as ei:
        m.decode_latent(y)
    assert seen["n_calls"] == 1
    msg = str(ei.value)
    assert "memory_mode='checkpoint'" in msg
    assert "output_mode='lean'" in msg
    assert "16 GB" not in msg and "set_config_override" not in msg

    def other(*a, **k):
        raise _jax.errors.JaxRuntimeError("INTERNAL: something else")

    monkeypatch.setattr(_hmm, "smooth_combined_chunked", other)
    with pytest.raises(_jax.errors.JaxRuntimeError) as ei2:
        m.decode_latent(y)
    assert "memory_mode" not in str(ei2.value)


def test_fused_certificate_retry_reproduces_trajectory(monkeypatch):
    """A failed warm-start certificate triggers a strict re-run of the fused
    segment (models/base.py fit_em): the replayed posterior must reproduce
    the exact trajectory, so the retried fit equals an undisturbed one."""
    import poor_man_gplvm_tpu as pmg
    from poor_man_gplvm_tpu.models import base as mbase

    m = pmg.PoissonGPLVMJump1D(8, n_latent_bin=12, movement_variance=1,
                               tuning_lengthscale=4.0)
    _, y = m.sample(400)
    ref = m.fit_em(y, key=jr.PRNGKey(1), n_iter=6, verboase=False)

    calls = {"n": 0}
    real = mbase._first_failed_certificate

    def fake(diag):
        calls["n"] += 1
        if calls["n"] == 1:
            # force the retry branch once; later calls defer to the real
            # check so a genuinely bad strict solve would still raise
            return 0, np.array([1.0, 1.0])
        return real(diag)

    monkeypatch.setattr(mbase, "_first_failed_certificate", fake)
    m2 = pmg.PoissonGPLVMJump1D(8, n_latent_bin=12, movement_variance=1,
                                tuning_lengthscale=4.0)
    with pytest.warns(UserWarning, match="strict fixed-point exits"):
        got = m2.fit_em(y, key=jr.PRNGKey(1), n_iter=6, verboase=False)
    assert calls["n"] >= 2
    np.testing.assert_allclose(
        np.asarray(got["log_marginal_l"]), np.asarray(ref["log_marginal_l"]),
        rtol=1e-6,
    )
