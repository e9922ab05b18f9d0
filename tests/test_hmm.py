"""HMM engines vs brute-force float64 oracle; chunk invariance; engine
cross-validation (prob vs log)."""

import jax.numpy as jnp
import numpy as np
import pytest

from poor_man_gplvm_tpu.ops import emissions, hmm, kernels as gpk
from tests.oracle import dense_acc_to_joint, dense_forward_backward, joint_to_dense

T, N, L = 17, 6, 5
N_DYN = 2


@pytest.fixture
def joint_setup():
    rng = np.random.default_rng(42)
    y = rng.poisson(1.5, size=(T, N)).astype(np.float32)
    tuning = rng.gamma(2.0, 1.0, size=(L, N)).astype(np.float32)
    ma_neuron = np.ones(N, dtype=np.float32)
    ma_latent = np.ones(L, dtype=np.float32)
    lat_l, log_lat_l, dyn, log_dyn = gpk.create_transition_prob_1d(
        jnp.arange(L), jnp.arange(N_DYN), movement_variance=1.3,
        p_move_to_jump=0.05, p_jump_to_move=0.08,
    )
    trans = hmm.JointTransition(dyn, lat_l, log_dyn, log_lat_l)
    ll = np.asarray(
        emissions.poisson_loglik(y, tuning, ma_neuron, ma_latent)
    )
    return y, tuning, ma_neuron, ma_latent, trans, ll


@pytest.fixture
def latent_setup():
    rng = np.random.default_rng(7)
    y = rng.poisson(1.5, size=(T, N)).astype(np.float32)
    tuning = rng.gamma(2.0, 1.0, size=(L, N)).astype(np.float32)
    ma_neuron = np.ones(N, dtype=np.float32)
    ma_latent = np.ones(L, dtype=np.float32)
    kern, log_kern = gpk.create_transition_prob_latent_1d(
        jnp.arange(L), movement_variance=1.1
    )
    trans = hmm.LatentTransition(kern, log_kern)
    ll = np.asarray(emissions.poisson_loglik(y, tuning, ma_neuron, ma_latent))
    return y, tuning, ma_neuron, ma_latent, trans, ll


def _run(y, tuning, ma_neuron, ma_latent, trans, engine, chunk=10000, scale=1.0):
    # "pallas" cases run the sequential Triton kernel; off the GPU the test
    # asks for its interpreter explicitly
    if engine == "pallas":
        engine = "pallas_interpret"
    return hmm.smooth_combined_chunked(
        y, tuning, {}, trans, ma_neuron, ma_latent,
        likelihood_scale=scale, n_time_per_chunk=chunk, engine=engine,
    )


@pytest.mark.parametrize("engine", ["prob", "log", "pallas"])
def test_joint_vs_oracle(joint_setup, engine):
    y, tuning, ma_neuron, ma_latent, trans, ll = joint_setup
    M = joint_to_dense(trans.Tdyn, trans.Tlat)
    pi = np.full(N_DYN * L, 1.0 / (N_DYN * L))
    ll_dense = np.tile(ll, (1, N_DYN)).astype(np.float64)  # (d, l) flat index
    oracle = dense_forward_backward(ll_dense, M, pi)

    smooth, lml, filt, ratios, acc, ll_out = _run(
        y, tuning, ma_neuron, ma_latent, trans, engine
    )
    np.testing.assert_allclose(np.asarray(ll_out), ll, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(float(lml), oracle["log_marginal"], rtol=1e-5)
    np.testing.assert_allclose(
        np.asarray(ratios), oracle["log_marginal_ratios"], rtol=1e-4, atol=1e-4
    )
    np.testing.assert_allclose(
        np.exp(np.asarray(filt)).reshape(T, -1), oracle["filtered"],
        rtol=1e-4, atol=1e-5,
    )
    np.testing.assert_allclose(
        np.exp(np.asarray(smooth)).reshape(T, -1), oracle["smoothed"],
        rtol=1e-3, atol=1e-5,
    )
    want_acc = dense_acc_to_joint(oracle["acc_joint"], N_DYN, L)
    np.testing.assert_allclose(
        np.exp(np.asarray(acc)), want_acc, rtol=1e-3, atol=1e-5
    )


@pytest.mark.parametrize("engine", ["prob", "log", "pallas"])
def test_latent_vs_oracle(latent_setup, engine):
    y, tuning, ma_neuron, ma_latent, trans, ll = latent_setup
    M = np.asarray(trans.T, dtype=np.float64)
    pi = np.full(L, 1.0 / L)
    oracle = dense_forward_backward(ll.astype(np.float64), M, pi)

    smooth, lml, filt, ratios, acc, _ = _run(
        y, tuning, ma_neuron, ma_latent, trans, engine
    )
    np.testing.assert_allclose(float(lml), oracle["log_marginal"], rtol=1e-5)
    np.testing.assert_allclose(
        np.exp(np.asarray(smooth)), oracle["smoothed"], rtol=1e-3, atol=1e-5
    )
    np.testing.assert_allclose(
        np.exp(np.asarray(acc)), oracle["acc_joint"], rtol=1e-3, atol=1e-5
    )


@pytest.mark.parametrize("engine", ["prob", "log", "pallas"])
@pytest.mark.parametrize("chunk", [3, 7, T, 10000])
def test_chunk_invariance_joint(joint_setup, engine, chunk):
    y, tuning, ma_neuron, ma_latent, trans, _ = joint_setup
    base = _run(y, tuning, ma_neuron, ma_latent, trans, engine, chunk=10000)
    out = _run(y, tuning, ma_neuron, ma_latent, trans, engine, chunk=chunk)
    np.testing.assert_allclose(float(out[1]), float(base[1]), rtol=1e-6)
    np.testing.assert_allclose(
        np.exp(np.asarray(out[0])), np.exp(np.asarray(base[0])),
        rtol=1e-4, atol=1e-6,
    )
    np.testing.assert_allclose(
        np.exp(np.asarray(out[4])), np.exp(np.asarray(base[4])),
        rtol=1e-4, atol=1e-6,
    )


@pytest.mark.parametrize("chunk", [5, 10000])
def test_engines_agree_joint(joint_setup, chunk):
    y, tuning, ma_neuron, ma_latent, trans, _ = joint_setup
    p = _run(y, tuning, ma_neuron, ma_latent, trans, "prob", chunk=chunk)
    l = _run(y, tuning, ma_neuron, ma_latent, trans, "log", chunk=chunk)
    np.testing.assert_allclose(float(p[1]), float(l[1]), rtol=1e-5)
    np.testing.assert_allclose(
        np.exp(np.asarray(p[0])), np.exp(np.asarray(l[0])), rtol=1e-3, atol=1e-5
    )


def test_latent_mask(joint_setup):
    y, tuning, ma_neuron, _, trans, _ = joint_setup
    ma_latent = np.ones(L, dtype=np.float32)
    ma_latent[1] = 0.0
    smooth, lml, filt, _, _, _ = _run(y, tuning, ma_neuron, ma_latent, trans, "prob")
    post = np.exp(np.asarray(smooth))
    assert post[:, :, 1].max() < 1e-20
    np.testing.assert_allclose(post.sum(axis=(1, 2)), 1.0, rtol=1e-4)


@pytest.mark.parametrize("bigT", [100, 300])
def test_latent_mask_engine_parity(bigT):
    """Regression: the kernel smoother must keep exact zeros (masked latent
    bins) in the carried smoothed posterior and still match the prob
    engine, whole and across chunk boundaries (an earlier blocked kernel
    deviated by ~0.145 abs on its padded time tail)."""
    rng = np.random.default_rng(3)
    y = rng.poisson(1.5, size=(bigT, N)).astype(np.float32)
    tuning = rng.gamma(2.0, 1.0, size=(L, N)).astype(np.float32)
    ma_neuron = np.ones(N, dtype=np.float32)
    ma_latent = np.ones(L, dtype=np.float32)
    ma_latent[1] = 0.0
    ma_latent[3] = 0.0
    lat_l, log_lat_l, dyn, log_dyn = gpk.create_transition_prob_1d(
        jnp.arange(L), jnp.arange(N_DYN), movement_variance=1.3,
        p_move_to_jump=0.05, p_jump_to_move=0.08,
    )
    trans = hmm.JointTransition(dyn, lat_l, log_dyn, log_lat_l)
    ref = _run(y, tuning, ma_neuron, ma_latent, trans, "prob")
    pal = _run(y, tuning, ma_neuron, ma_latent, trans, "pallas")
    np.testing.assert_allclose(float(pal[1]), float(ref[1]), rtol=1e-5)
    np.testing.assert_allclose(
        np.exp(np.asarray(pal[0])), np.exp(np.asarray(ref[0])),
        rtol=1e-3, atol=1e-5,
    )
    # chunked path also crosses the padding boundary per chunk
    pal_c = _run(y, tuning, ma_neuron, ma_latent, trans, "pallas", chunk=37)
    np.testing.assert_allclose(float(pal_c[1]), float(ref[1]), rtol=1e-5)
    np.testing.assert_allclose(
        np.exp(np.asarray(pal_c[0])), np.exp(np.asarray(ref[0])),
        rtol=1e-3, atol=1e-5,
    )


def test_uniform_row_flag_requires_constant_rows():
    """Regression: a transition channel with identical but NON-constant rows
    (possible with custom kernels) must NOT take the uniform-row fast path —
    the smoother shortcut ``sum(r) * row`` is only exact for constant rows.
    Previously the flag checked row-identity only and the pallas smoother
    deviated by ~0.02 absolute probability."""
    rng = np.random.default_rng(11)
    row = rng.random(L).astype(np.float32)
    row /= row.sum()
    lat = np.stack([np.tile(row, (L, 1)), np.full((L, L), 1.0 / L)]).astype(
        np.float32
    )
    assert hmm._uniform_row_flags(lat) == (False, True)
    dyn = np.array([[0.9, 0.1], [0.2, 0.8]], dtype=np.float32)
    trans = hmm.JointTransition(
        jnp.asarray(dyn), jnp.asarray(lat),
        jnp.log(jnp.asarray(dyn)), jnp.log(jnp.asarray(lat)),
    )
    y = rng.poisson(1.5, size=(T, N)).astype(np.float32)
    tuning = rng.gamma(2.0, 1.0, size=(L, N)).astype(np.float32)
    ones_n, ones_l = np.ones(N, np.float32), np.ones(L, np.float32)
    ref = _run(y, tuning, ones_n, ones_l, trans, "prob")
    pal = _run(y, tuning, ones_n, ones_l, trans, "pallas")
    np.testing.assert_allclose(float(pal[1]), float(ref[1]), rtol=1e-5)
    np.testing.assert_allclose(
        np.exp(np.asarray(pal[0])), np.exp(np.asarray(ref[0])),
        rtol=1e-3, atol=1e-5,
    )


def test_likelihood_scale(joint_setup):
    y, tuning, ma_neuron, ma_latent, trans, ll = joint_setup
    M = joint_to_dense(trans.Tdyn, trans.Tlat)
    pi = np.full(N_DYN * L, 1.0 / (N_DYN * L))
    ll_dense = np.tile(ll, (1, N_DYN)).astype(np.float64)
    oracle = dense_forward_backward(ll_dense, M, pi, likelihood_scale=2.5)
    _, lml, _, _, _, _ = _run(
        y, tuning, ma_neuron, ma_latent, trans, "prob", scale=2.5
    )
    np.testing.assert_allclose(float(lml), oracle["log_marginal"], rtol=1e-5)


def test_transition_posterior_extraction(joint_setup):
    y, tuning, ma_neuron, ma_latent, trans, _ = joint_setup
    *_, acc, _ = _run(y, tuning, ma_neuron, ma_latent, trans, "prob")
    res = hmm.compute_transition_posterior_prob(acc)
    assert set(res.keys()) == {
        "p_joint_full", "p_joint_latent", "p_joint_dynamics",
        "p_transition_full", "p_transition_latent", "p_transition_dynamics",
        "log_joint_full", "log_joint_latent", "log_joint_dynamics",
        "log_transition_full", "log_transition_latent", "log_transition_dynamics",
    }
    np.testing.assert_allclose(np.asarray(res["p_joint_full"]).sum(), 1.0, rtol=1e-5)
    np.testing.assert_allclose(
        np.asarray(res["p_transition_latent"]).sum(axis=1), 1.0, rtol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(res["p_transition_dynamics"]).sum(axis=1), 1.0, rtol=1e-5
    )


@pytest.mark.parametrize("engine", ["prob", "pallas"])
def test_checkpoint_memory_mode_exact(joint_setup, engine):
    """Activation-checkpointed smoothing is bit-identical to full storage."""
    y, tuning, ma_neuron, ma_latent, trans, _ = joint_setup
    if engine == "pallas":  # the kernel's interpreter off the GPU
        engine = "pallas_interpret"
    full = hmm.smooth_combined_chunked(
        y, tuning, {}, trans, ma_neuron, ma_latent, n_time_per_chunk=5,
        engine=engine, memory_mode="full",
    )
    ck = hmm.smooth_combined_chunked(
        y, tuning, {}, trans, ma_neuron, ma_latent, n_time_per_chunk=5,
        engine=engine, memory_mode="checkpoint",
    )
    np.testing.assert_array_equal(np.asarray(ck[0]), np.asarray(full[0]))
    np.testing.assert_array_equal(np.asarray(ck[4]), np.asarray(full[4]))
    assert float(ck[1]) == float(full[1])
    assert ck[2] is None and ck[5] is None


def test_checkpoint_marginal_smooth(joint_setup):
    y, tuning, ma_neuron, ma_latent, trans, _ = joint_setup
    full = hmm.smooth_combined_chunked(
        y, tuning, {}, trans, ma_neuron, ma_latent, n_time_per_chunk=5,
    )
    (lat_m, dyn_m), lml, _, ratios, acc, _ = hmm.smooth_combined_chunked(
        y, tuning, {}, trans, ma_neuron, ma_latent, n_time_per_chunk=5,
        memory_mode="checkpoint", marginal_smooth=True,
    )
    from jax.scipy.special import logsumexp

    np.testing.assert_allclose(
        np.exp(np.asarray(lat_m)),
        np.exp(np.asarray(logsumexp(full[0], axis=1))), rtol=1e-5, atol=1e-7,
    )
    np.testing.assert_allclose(
        np.exp(np.asarray(dyn_m)),
        np.exp(np.asarray(logsumexp(full[0], axis=2))), rtol=1e-5, atol=1e-7,
    )
    assert float(lml) == float(full[1])


@pytest.mark.parametrize("memory_mode", ["filter", "filter_bf16"])
def test_filterstore_modes_match_checkpoint(memory_mode):
    """memory_mode='filter' (f32 store) matches the checkpoint smoother to
    float tolerance; 'filter_bf16' to bf16 rounding (~1e-3 on posteriors,
    exact log-marginal)."""
    rng = np.random.default_rng(0)
    T, L, N = 900, 12, 6
    y = jnp.asarray(rng.poisson(1.0, size=(T, N)).astype(np.float32))
    tuning = jnp.asarray(rng.random((L, N)).astype(np.float32)) * 2
    lat_l, log_lat_l, dyn, log_dyn = gpk.create_transition_prob_1d(
        jnp.arange(L), jnp.arange(2), movement_variance=1.3,
        p_move_to_jump=0.05, p_jump_to_move=0.08,
    )
    trans = hmm.JointTransition(dyn, lat_l, log_dyn, log_lat_l)
    ck = hmm.smooth_combined_chunked(
        y, tuning, {}, trans, jnp.ones((T, N)), jnp.ones(L),
        n_time_per_chunk=200, engine="prob", memory_mode="checkpoint",
    )
    fs = hmm.smooth_combined_chunked(
        y, tuning, {}, trans, jnp.ones((T, N)), jnp.ones(L),
        n_time_per_chunk=200, engine="prob", memory_mode=memory_mode,
    )
    tol = 1e-5 if memory_mode == "filter" else 3e-3
    np.testing.assert_allclose(float(fs[1]), float(ck[1]), rtol=1e-6)
    np.testing.assert_allclose(
        np.exp(np.asarray(fs[0])), np.exp(np.asarray(ck[0])), atol=tol
    )
    np.testing.assert_allclose(
        np.asarray(fs[3]), np.asarray(ck[3]), atol=1e-5
    )

    # marginal_smooth variant agrees too
    ckm = hmm.smooth_combined_chunked(
        y, tuning, {}, trans, jnp.ones((T, N)), jnp.ones(L),
        n_time_per_chunk=200, engine="prob", memory_mode="checkpoint",
        marginal_smooth=True,
    )
    fsm = hmm.smooth_combined_chunked(
        y, tuning, {}, trans, jnp.ones((T, N)), jnp.ones(L),
        n_time_per_chunk=200, engine="prob", memory_mode=memory_mode,
        marginal_smooth=True,
    )
    np.testing.assert_allclose(
        np.exp(np.asarray(fsm[0][0])), np.exp(np.asarray(ckm[0][0])), atol=tol
    )


def test_fit_em_memory_mode_kwarg():
    """fit_em(memory_mode='filter') reproduces the default EM trajectory."""
    import poor_man_gplvm_tpu as pmg

    rng = np.random.default_rng(1)
    y = rng.poisson(1.0, size=(400, 8)).astype(np.float32)
    m1 = pmg.PoissonGPLVMJump1D(8, n_latent_bin=10, tuning_lengthscale=3.0)
    m2 = pmg.PoissonGPLVMJump1D(8, n_latent_bin=10, tuning_lengthscale=3.0)
    import jax.random as jr

    em1 = m1.fit_em(y, key=jr.PRNGKey(0), n_iter=3, verboase=False,
                    n_time_per_chunk=150)
    em2 = m2.fit_em(y, key=jr.PRNGKey(0), n_iter=3, verboase=False,
                    n_time_per_chunk=150, memory_mode="filter")
    np.testing.assert_allclose(
        np.asarray(em1["log_marginal_l"]), np.asarray(em2["log_marginal_l"]),
        rtol=1e-5,
    )


@pytest.mark.parametrize("T_case", [256, 257, 511, 30])
def test_pallas_multilane_and_block_boundaries(T_case):
    """The sequential kernels at L=130 (latent axis padded to the next
    power of two, 256) and T around powers of two match the prob engine
    exactly."""
    L_big, N = 130, 7
    rng = np.random.default_rng(1)
    y = jnp.asarray(rng.poisson(1.0, size=(T_case, N)).astype(np.float32))
    tuning = jnp.asarray(rng.random((L_big, N)).astype(np.float32)) * 2
    lat_l, log_lat_l, dyn, log_dyn = gpk.create_transition_prob_1d(
        jnp.arange(L_big), jnp.arange(2), movement_variance=5.0,
        p_move_to_jump=0.05, p_jump_to_move=0.08,
    )
    trans = hmm.JointTransition(dyn, lat_l, log_dyn, log_lat_l)
    outs = {}
    for engine in ["prob", "pallas"]:
        outs[engine] = hmm.smooth_combined_chunked(
            y, tuning, {}, trans, jnp.ones((T_case, N)), jnp.ones(L_big),
            n_time_per_chunk=max(T_case, 1),
            engine="pallas_interpret" if engine == "pallas" else engine,
        )
    np.testing.assert_allclose(
        float(outs["pallas"][1]), float(outs["prob"][1]), rtol=1e-5
    )
    np.testing.assert_allclose(
        np.exp(np.asarray(outs["pallas"][0])),
        np.exp(np.asarray(outs["prob"][0])), atol=2e-4,
    )


def test_auto_chunk_size_resolution():
    """n_time_per_chunk=None -> auto: single chunk at small T, bounded and
    >= reference-compat 10000 at huge T, identical numerics either way."""
    from poor_man_gplvm_tpu.ops.hmm import auto_chunk_size

    assert auto_chunk_size(1000, 200, 100) == 1000
    big = auto_chunk_size(10**8, 1500, 500)
    assert 10_000 <= big < 10**8

    import jax.numpy as jnp
    import numpy as np
    from poor_man_gplvm_tpu.ops import hmm, kernels as gpk

    T, N, L = 101, 5, 7
    rng = np.random.default_rng(0)
    y = jnp.asarray(rng.poisson(1.0, (T, N)), dtype=jnp.float32)
    tuning = jnp.asarray(rng.uniform(0.5, 2.0, (L, N)), dtype=jnp.float32)
    lat_l, log_lat_l, dyn, log_dyn = gpk.create_transition_prob_1d(
        jnp.arange(L), jnp.arange(2), 1.0, 0.02, 0.05
    )
    trans = hmm.JointTransition(dyn, lat_l, log_dyn, log_lat_l)
    args = (y, tuning, {}, trans, jnp.ones((T, N)), jnp.ones(L))
    out_auto = hmm.smooth_combined_chunked(*args, n_time_per_chunk=None)
    out_17 = hmm.smooth_combined_chunked(*args, n_time_per_chunk=17)
    np.testing.assert_allclose(
        np.asarray(out_auto[1]), np.asarray(out_17[1]), rtol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(out_auto[0]), np.asarray(out_17[0]), atol=1e-5
    )


def test_latent_transition_pytree_aux_stable_under_tracing():
    """uniform_rows (pytree aux) must have the same length whether the
    transition is built from a concrete matrix or inside a trace — a
    mismatch makes structurally-identical Transitions incompatible as
    jit/scan carries."""
    import jax

    from poor_man_gplvm_tpu.ops import hmm

    L = 6
    T_mat = jnp.full((L, L), 1.0 / L)
    concrete = hmm.LatentTransition(T_mat, jnp.log(T_mat))
    assert len(concrete.uniform_rows) == 1
    assert concrete.uniform_rows[0] is True

    captured = {}

    def build(m):
        tr = hmm.LatentTransition(m, jnp.log(m))
        captured["aux"] = tr.uniform_rows
        return tr.push(jnp.ones(L) / L)

    jax.jit(build)(T_mat)
    assert len(captured["aux"]) == 1  # traced fallback: same flag count
    assert captured["aux"][0] is False  # tracers are never 'uniform'

    # joint (3-D) stacks keep one flag per dynamics channel in both paths
    stack = jnp.stack([T_mat, T_mat])
    from poor_man_gplvm_tpu.ops.hmm import _uniform_row_flags

    assert len(_uniform_row_flags(stack)) == 2


def test_parallel_upgrade_respects_hbm_budget():
    """'auto' picks the parallel engine only while the parallel driver's
    full-sequence buffers fit PARALLEL_BUDGET_FRAC of the device budget
    (the sequential chunked engines still run beyond that)."""
    from poor_man_gplvm_tpu.ops import engine as eng

    budget = 16e9  # the budget the fractions were first tuned on
    # north-star: ~10 GB of parallel buffers -> upgrades
    assert eng.parallel_fits(1_000_000, 500, 2, budget)
    assert eng.resolve_engine("auto", 1_000_000, 500, 2, on="gpu",
                              budget=budget) == "pallas_parallel"
    # 2x north-star would need ~20 GB -> sequential engine instead
    assert not eng.parallel_fits(2_000_000, 500, 2, budget)
    assert eng.resolve_engine("auto", 2_000_000, 500, 2, on="gpu",
                              budget=budget) == "prob"
    assert eng.resolve_engine("auto", 2_000_000, 100, 2, on="gpu",
                              budget=budget / 4) == "pallas"
    # the same shape fits a budget four times larger
    assert eng.parallel_fits(2_000_000, 500, 2, 4 * budget)
