"""engine='pallas_parallel' (fixed-point parallel-in-time scans) vs the
sequential prob engine.  The parallel engine must be EXACT at convergence —
tolerances here are float32 noise, not approximation budgets.

Reference contract: poor_man_gplvm/decoder.py:258-332 (6-tuple), via the
prob engine which is oracle-verified in test_hmm.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from poor_man_gplvm_tpu.ops import hmm, kernels as gpk
from poor_man_gplvm_tpu.ops.pallas import parallel_scan as ps

N, L = 6, 7


def _joint_trans(mv=1.3, pmj=0.05, pjm=0.08):
    lat_l, log_lat_l, dyn, log_dyn = gpk.create_transition_prob_1d(
        jnp.arange(L), jnp.arange(2), movement_variance=mv,
        p_move_to_jump=pmj, p_jump_to_move=pjm,
    )
    return hmm.JointTransition(dyn, lat_l, log_dyn, log_lat_l)


def _run(y, tuning, trans, engine, ma_n=None, ma_l=None, **kw):
    ma_n = np.ones(y.shape[1], np.float32) if ma_n is None else ma_n
    ma_l = np.ones(tuning.shape[0], np.float32) if ma_l is None else ma_l
    return hmm.smooth_combined_chunked(
        y, tuning, {}, trans, ma_n, ma_l, engine=engine, **kw
    )


def _assert_match(ref, par, check_post=True):
    np.testing.assert_allclose(float(par[1]), float(ref[1]), rtol=1e-5)
    np.testing.assert_allclose(
        np.exp(np.asarray(par[0])), np.exp(np.asarray(ref[0])),
        rtol=1e-3, atol=2e-5,
    )
    np.testing.assert_allclose(
        np.asarray(par[3]), np.asarray(ref[3]), rtol=1e-3, atol=1e-4
    )
    np.testing.assert_allclose(
        np.exp(np.asarray(par[4])), np.exp(np.asarray(ref[4])),
        rtol=1e-3, atol=1e-3,
    )
    if check_post:
        np.testing.assert_allclose(
            np.exp(np.asarray(par[2])), np.exp(np.asarray(ref[2])),
            rtol=1e-3, atol=2e-5,
        )


@pytest.mark.parametrize("T", [601, 997])
def test_parallel_joint_matches_prob(T):
    rng = np.random.default_rng(42)
    y = rng.poisson(1.5, size=(T, N)).astype(np.float32)
    tuning = rng.gamma(2.0, 1.0, size=(L, N)).astype(np.float32)
    trans = _joint_trans()
    ref = _run(y, tuning, trans, "prob")
    par = _run(y, tuning, trans, "pallas_parallel")
    _assert_match(ref, par)


def test_parallel_latent_only():
    rng = np.random.default_rng(7)
    T = 640
    y = rng.poisson(1.5, size=(T, N)).astype(np.float32)
    tuning = rng.gamma(2.0, 1.0, size=(L, N)).astype(np.float32)
    kern, log_kern = gpk.create_transition_prob_latent_1d(
        jnp.arange(L), movement_variance=1.1
    )
    trans = hmm.LatentTransition(kern, log_kern)
    ref = _run(y, tuning, trans, "prob")
    par = _run(y, tuning, trans, "pallas_parallel")
    _assert_match(ref, par)


def test_parallel_masked_latent_and_2d_neuron_mask():
    rng = np.random.default_rng(3)
    T = 523
    y = rng.poisson(1.5, size=(T, N)).astype(np.float32)
    tuning = rng.gamma(2.0, 1.0, size=(L, N)).astype(np.float32)
    ma_l = np.ones(L, np.float32)
    ma_l[1] = 0.0
    ma_l[4] = 0.0
    ma_n = (rng.random((T, N)) > 0.2).astype(np.float32)
    trans = _joint_trans()
    ref = _run(y, tuning, trans, "prob", ma_n=ma_n, ma_l=ma_l)
    par = _run(y, tuning, trans, "pallas_parallel", ma_n=ma_n, ma_l=ma_l)
    _assert_match(ref, par)
    assert np.exp(np.asarray(par[0]))[:, :, 1].max() < 1e-20


def test_parallel_changing_dt_and_scale():
    rng = np.random.default_rng(5)
    T = 700
    y = rng.poisson(1.5, size=(T, N)).astype(np.float32)
    tuning = rng.gamma(2.0, 1.0, size=(L, N)).astype(np.float32)
    dt_l = jnp.asarray(rng.uniform(0.5, 1.5, T).astype(np.float32))
    trans = _joint_trans()
    ref = _run(y, tuning, trans, "prob", dt_l=dt_l, likelihood_scale=2.5)
    par = _run(y, tuning, trans, "pallas_parallel", dt_l=dt_l,
               likelihood_scale=2.5)
    _assert_match(ref, par)


def test_parallel_slow_mixing_converges_exactly():
    """Near-reducible chain (tiny jump probability, narrow kernel): the
    fixed-point iteration must run extra passes and still land on the exact
    answer — this exercises the multi-pass path."""
    rng = np.random.default_rng(9)
    T = 800
    y = rng.poisson(1.5, size=(T, N)).astype(np.float32)
    tuning = rng.gamma(2.0, 1.0, size=(L, N)).astype(np.float32)
    trans = _joint_trans(mv=0.3, pmj=0.0005, pjm=0.0005)
    ref = _run(y, tuning, trans, "prob")
    par = _run(y, tuning, trans, "pallas_parallel")
    _assert_match(ref, par)


def test_parallel_marginal_smooth_lean():
    rng = np.random.default_rng(11)
    T = 600
    y = rng.poisson(1.5, size=(T, N)).astype(np.float32)
    tuning = rng.gamma(2.0, 1.0, size=(L, N)).astype(np.float32)
    trans = _joint_trans()
    ref = _run(y, tuning, trans, "prob")
    par = _run(y, tuning, trans, "pallas_parallel",
               memory_mode="checkpoint", marginal_smooth=True)
    lat_m, dyn_m = np.exp(np.asarray(par[0][0])), np.exp(np.asarray(par[0][1]))
    full = np.exp(np.asarray(ref[0]))
    np.testing.assert_allclose(lat_m, full.sum(1), rtol=1e-3, atol=2e-5)
    np.testing.assert_allclose(dyn_m, full.sum(2), rtol=1e-3, atol=2e-5)
    np.testing.assert_allclose(float(par[1]), float(ref[1]), rtol=1e-5)
    assert par[2] is None and par[5] is None


def test_parallel_want_acc_false_identical_and_skips_joint():
    """want_acc=False (fused mid-EM iterations discard the pairwise joint)
    must leave every other output bit-identical and return acc=None —
    covering both the marginal path (in-kernel accumulation skipped) and
    the full path (external contraction skipped)."""
    rng = np.random.default_rng(17)
    T = 600
    y = rng.poisson(1.5, size=(T, N)).astype(np.float32)
    tuning = rng.gamma(2.0, 1.0, size=(L, N)).astype(np.float32)
    trans = _joint_trans()
    # choose_parallel_config ignores want_acc, so both runs use the same
    # chunk count — but they are two separately-compiled programs, and an
    # accelerator's compiler may reassociate float reductions differently
    # between them.  Bit-exact equality is only asserted on the CPU.
    on_cpu = jax.devices()[0].platform == "cpu"
    exact = (np.testing.assert_array_equal if on_cpu
             else lambda a, b: np.testing.assert_allclose(
                 a, b, rtol=1e-6, atol=1e-7))
    for kw in (dict(memory_mode="checkpoint", marginal_smooth=True),
               dict()):
        full = _run(y, tuning, trans, "pallas_parallel", **kw)
        lean = _run(y, tuning, trans, "pallas_parallel", want_acc=False,
                    **kw)
        assert lean[4] is None
        np.testing.assert_allclose(float(lean[1]), float(full[1]),
                                   rtol=0 if on_cpu else 1e-6)
        if kw.get("marginal_smooth"):
            exact(np.asarray(lean[0][0]), np.asarray(full[0][0]))
            exact(np.asarray(lean[0][1]), np.asarray(full[0][1]))
        else:
            exact(np.asarray(lean[0]), np.asarray(full[0]))


def test_parallel_tiny_T_falls_back():
    """Sequences too short to chunk route to the platform's sequential
    engine and still honor the full contract."""
    rng = np.random.default_rng(13)
    T = 40
    y = rng.poisson(1.5, size=(T, N)).astype(np.float32)
    tuning = rng.gamma(2.0, 1.0, size=(L, N)).astype(np.float32)
    trans = _joint_trans()
    ref = _run(y, tuning, trans, "prob")
    par = _run(y, tuning, trans, "pallas_parallel")
    _assert_match(ref, par)


def test_choose_parallel_config_shapes():
    """The chunk count C: DEFAULT_C for long sequences, halved until every
    chunk holds MIN_CHUNK_LEN steps, None when even C=2 cannot."""
    assert ps.choose_parallel_config(30, 100, 2) is None
    assert ps.choose_parallel_config(1_000_000, 500, 2) == ps.DEFAULT_C
    for T in (256, 601, 2048, 20_000, 100_000):
        C = ps.choose_parallel_config(T, 100, 2)
        assert C is not None and C >= 2 and C & (C - 1) == 0
        assert T >= C * ps.MIN_CHUNK_LEN
        assert C == ps.DEFAULT_C or T < 2 * C * ps.MIN_CHUNK_LEN
    assert ps.carry_spec(100_000, 100, 2) == (
        2, ps.choose_parallel_config(100_000, 100, 2), 100)


def test_parallel_fit_em_end_to_end():
    """Model-level: PoissonGPLVMJump1D with inference_engine='pallas_parallel'
    matches the prob engine through 2 EM iterations + decode."""
    import jax.random as jr

    import poor_man_gplvm_tpu as pmg

    T = 600
    kw = dict(n_latent_bin=11, movement_variance=1.0, tuning_lengthscale=3.0)
    m_ref = pmg.PoissonGPLVMJump1D(5, inference_engine="prob", **kw)
    _, spk = m_ref.sample(T)
    em_ref = m_ref.fit_em(spk, key=jr.PRNGKey(0), n_iter=2, verboase=False)
    m_par = pmg.PoissonGPLVMJump1D(
        5, inference_engine="pallas_parallel", **kw
    )
    em_par = m_par.fit_em(spk, key=jr.PRNGKey(0), n_iter=2, verboase=False)
    # iteration 1 is a pure E-step comparison; later iterations accumulate
    # float32-level engine differences through the Adam M-step, so the
    # trajectory tolerance is a few ulps looser
    np.testing.assert_allclose(
        float(em_par["log_marginal_l"][0]),
        float(em_ref["log_marginal_l"][0]), rtol=1e-5,
    )
    np.testing.assert_allclose(
        np.asarray(em_par["log_marginal_l"]),
        np.asarray(em_ref["log_marginal_l"]), rtol=5e-5,
    )
    d_ref = m_ref.decode_latent(spk)
    d_par = m_par.decode_latent(spk)
    np.testing.assert_allclose(
        float(d_par["log_marginal_final"]),
        float(d_ref["log_marginal_final"]), rtol=5e-5,
    )
    # probabilities, absolute scale: the fitted params differ at f32 noise
    # level after 2 Adam M-steps (chaotic amplification), which moves
    # individual posterior entries by O(1e-3..1e-2) even though the
    # log-marginals agree to 5e-5.  Tight per-step parity is asserted by
    # the fixed-parameter engine tests above.
    np.testing.assert_allclose(
        d_par["posterior_latent_marg"], d_ref["posterior_latent_marg"],
        atol=1e-2,
    )


def test_parallel_warm_start_exact_and_fewer_passes():
    """Warm-starting the fixed points from a previous converged solve (the
    next EM iteration's situation: slightly drifted tuning) returns the
    SAME answer with <= as many passes, and typically 1 pass/direction
    (VERDICT round-2 next #3)."""
    T = 997
    rng = np.random.default_rng(3)
    y = rng.poisson(1.5, size=(T, N)).astype(np.float32)
    tuning = rng.gamma(2.0, 1.0, size=(L, N)).astype(np.float32)
    trans = _joint_trans()

    cold = _run(y, tuning, trans, "pallas_parallel", want_scan_carry=True)
    fwd_c, bwd_c, drift_c, (fp_cold, bp_cold, _ef, _eb) = cold[6]

    # slight tuning drift (one M-step's worth)
    tuning2 = tuning * np.float32(1.02)
    ref2 = _run(y, tuning2, trans, "prob")
    warm = _run(
        y, tuning2, trans, "pallas_parallel", want_scan_carry=True,
        scan_carry_in=(fwd_c, bwd_c, drift_c, jnp.array(True)),
    )
    _assert_match(ref2, warm)
    fp_warm, bp_warm = warm[6][3][:2]
    assert int(fp_warm) <= int(fp_cold)
    assert int(bp_warm) <= int(bp_cold)
    # re-solving the SAME problem warm must settle in a single pass
    rewarm = _run(
        y, tuning2, trans, "pallas_parallel", want_scan_carry=True,
        scan_carry_in=(warm[6][0], warm[6][1], warm[6][2], jnp.array(True)),
    )
    _assert_match(_run(y, tuning2, trans, "prob"), rewarm)
    fp_re, bp_re = rewarm[6][3][:2]
    assert int(fp_re) == 1 and int(bp_re) == 1
    # fast mode: once the measured drift has settled (one fast solve on a
    # converged seed), the NEXT fast solve skips every finals-only pass —
    # the emit runs straight from the seed, certified post-hoc by the emit
    # residual
    fast1 = _run(
        y, tuning2, trans, "pallas_parallel", want_scan_carry=True,
        scan_fast=True,
        scan_carry_in=(warm[6][0], warm[6][1], warm[6][2], jnp.array(True)),
    )
    _assert_match(_run(y, tuning2, trans, "prob"), fast1)
    fast2 = _run(
        y, tuning2, trans, "pallas_parallel", want_scan_carry=True,
        scan_fast=True,
        scan_carry_in=(
            fast1[6][0], fast1[6][1], fast1[6][2], jnp.array(True)
        ),
    )
    _assert_match(_run(y, tuning2, trans, "prob"), fast2)
    fp_f, bp_f, ef, eb = fast2[6][3]
    assert int(fp_f) == 0 and int(bp_f) == 0
    assert float(ef) < 1e-4 and float(eb) < 1e-4


def test_want_scan_carry_requires_parallel_engine():
    rng = np.random.default_rng(0)
    y = rng.poisson(1.0, size=(100, N)).astype(np.float32)
    tuning = rng.gamma(2.0, 1.0, size=(L, N)).astype(np.float32)
    with pytest.raises(ValueError, match="want_scan_carry"):
        _run(y, tuning, _joint_trans(), "prob", want_scan_carry=True)


def test_fused_fit_em_warm_start_matches_loop():
    """The fused EM fast path with warm-started fixed points is numerically
    equal to the unfused host loop with the same engine."""
    import jax.random as jr

    import poor_man_gplvm_tpu as pmg

    T = 700
    kw = dict(n_latent_bin=9, movement_variance=1.0, tuning_lengthscale=3.0)
    m_a = pmg.PoissonGPLVMJump1D(5, inference_engine="pallas_parallel", **kw)
    _, spk = m_a.sample(T)
    em_kw = dict(key=jr.PRNGKey(0), n_iter=6, verboase=False,
                 m_step_maxiter=15)
    em_fused = m_a.fit_em(spk, fused=True, **em_kw)
    m_b = pmg.PoissonGPLVMJump1D(5, inference_engine="pallas_parallel", **kw)
    em_loop = m_b.fit_em(spk, fused=False, **em_kw)
    np.testing.assert_allclose(
        np.asarray(em_fused["log_marginal_l"]),
        np.asarray(em_loop["log_marginal_l"]), rtol=1e-5,
    )
    # the warm-start pass diagnostic was recorded for the fused segment
    passes = getattr(m_a, "_scan_passes_mid", None)
    assert passes is not None and passes.shape == (4, 2)
    # middle iterations should settle fast (tuning drift is small)
    assert passes[1:].max() <= passes[0].max()
