"""Tests that need an NVIDIA GPU: the compiled Triton kernels and the
engine choice on the card.  Marked ``gpu``; they skip elsewhere (the
``gpu`` fixture decides at test time).  Run on a card with
``PMG_GPU_TESTS=1 python -m pytest tests/test_gpu.py -m gpu``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from poor_man_gplvm_tpu.ops import engine as eng
from poor_man_gplvm_tpu.ops import hmm, kernels as gpk

pytestmark = pytest.mark.gpu


def _problem(T, N, L, seed=0):
    rng = np.random.default_rng(seed)
    lat, log_lat, dyn, log_dyn = gpk.create_transition_prob_1d(
        jnp.arange(L), jnp.arange(2), movement_variance=1.0,
        p_move_to_jump=0.01, p_jump_to_move=0.01,
    )
    trans = hmm.JointTransition(dyn, lat, log_dyn, log_lat)
    y = rng.poisson(0.5, size=(T, N)).astype(np.float32)
    tuning = rng.gamma(2.0, 0.5, size=(L, N)).astype(np.float32)
    return y, tuning, trans


def _run(args, engine, **kw):
    y, tuning, trans = args
    return hmm.smooth_combined_chunked(
        y, tuning, {}, trans, np.ones(y.shape[1]),
        np.ones(tuning.shape[0]), engine=engine, **kw,
    )


@pytest.mark.parametrize("L", [5, 100, 128])
def test_compiled_kernel_matches_prob(gpu, L):
    """The sequential Triton kernels, compiled for the card, against the
    prob engine under strict f32 (including an uneven chunked run)."""
    args = _problem(3_001, 40, L)
    with jax.default_matmul_precision("highest"):
        ref = _run(args, "prob")
        for chunk in (None, 1_000):
            got = _run(args, "pallas", n_time_per_chunk=chunk)
            np.testing.assert_allclose(float(got[1]), float(ref[1]),
                                       rtol=1e-5)
            np.testing.assert_allclose(np.exp(np.asarray(got[0])),
                                       np.exp(np.asarray(ref[0])), atol=1e-4)
            np.testing.assert_allclose(np.exp(np.asarray(got[4])),
                                       np.exp(np.asarray(ref[4])),
                                       rtol=1e-3, atol=1e-4)


def test_parallel_engine_matches_prob(gpu):
    args = _problem(30_000, 60, 100, seed=1)
    with jax.default_matmul_precision("highest"):
        ref = _run(args, "prob")
        got = _run(args, "pallas_parallel")
    np.testing.assert_allclose(float(got[1]), float(ref[1]), rtol=1e-5)
    np.testing.assert_allclose(np.exp(np.asarray(got[0])),
                               np.exp(np.asarray(ref[0])), atol=1e-4)


def test_auto_engine_on_the_card(gpu):
    """'auto' resolves to the compiled kernels, never the interpreter, and
    the memory budget comes from the card."""
    assert eng.device_memory_budget() > 8e9
    short = eng.resolve_engine("auto", eng.PARALLEL_MIN_T - 1, 100, 2)
    assert short == "pallas"
    assert eng.resolve_engine("auto", eng.PARALLEL_MIN_T, 100, 2) == \
        "pallas_parallel"
    assert eng.resolve_engine("auto", 10_000, 500, 2) == "pallas_parallel"
