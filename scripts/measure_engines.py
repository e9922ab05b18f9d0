"""Time the smoother engines on the GPU, end to end through the model API.

Measures, on one card:

* ``decode_latent`` with each engine (``prob``, the sequential Triton
  kernel ``pallas``, the fixed-point ``pallas_parallel``) over a range of T
  at L=100 and L=500 — the data behind ``ops.engine.PARALLEL_MIN_T`` and
  ``KERNEL_MAX_L``;
* ``fit_em`` with ``prob`` against ``pallas`` at a short T, and with
  ``prob`` against ``pallas_parallel`` at the headline T;
* one parallel E-step at the north-star shape for each chunk count C;
* the time and error of the emission-shaped matmul at each
  ``config.set_matmul_precision`` level.

Each row prints as one JSON line and is appended to
``chiprun_out/measure_engines.jsonl``; a failing row is printed with its
error and the run goes on.  Usage: ``python scripts/measure_engines.py
[--quick]`` (``--quick`` runs only the compile-and-compare rows).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
OUT = os.path.join(REPO, "chiprun_out", "measure_engines.jsonl")


def card():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def emit(row):
    line = json.dumps(row)
    print(line, flush=True)
    with open(OUT, "a") as f:
        f.write(line + "\n")


def timed(fn, reps=2):
    """(first-call seconds incl. compile, min steady seconds)."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return first, best


def row(name, fn, **meta):
    try:
        out = fn()
        emit({"row": name, **meta, **out})
    except Exception as e:  # a measurement row, not a check: go on
        emit({"row": name, **meta, "error": f"{type(e).__name__}: {e}"[:600]})
        traceback.print_exc()


def main():
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    quick = "--quick" in sys.argv
    import jax
    import jax.numpy as jnp
    import jax.random as jr

    jax.config.update("jax_compilation_cache_dir", os.environ.get(
        "JAX_COMPILATION_CACHE_DIR", os.path.join(REPO, ".jax_cache")))
    import poor_man_gplvm_tpu as pmg
    from poor_man_gplvm_tpu.ops.pallas import parallel_scan as ps

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: {dev.platform}")
    emit({"row": "card", "nvidia_smi": card(), "kind": dev.device_kind,
          "bytes_limit": dev.memory_stats().get("bytes_limit")})
    rng = np.random.default_rng(0)

    def model(N, L, engine):
        return pmg.PoissonGPLVMJump1D(
            N, n_latent_bin=L, movement_variance=1, tuning_lengthscale=10.0,
            inference_engine=engine,
        )

    def decode_row(T, N, L, engine, ref=None):
        y = jax.device_put(rng.poisson(0.5, size=(T, N)).astype(np.float32))
        m = model(N, L, engine)

        def go():
            first, best = timed(lambda: m.decode_latent(y)["posterior_all"])
            res = m.decode_latent(y)
            out = {"compile_s": first - best, "steady_s": best,
                   "lml": res["log_marginal_final"]}
            if ref is not None:
                mr = model(N, L, "prob")
                rr = mr.decode_latent(y)
                out["lml_rel_vs_prob"] = abs(
                    res["log_marginal_final"] - rr["log_marginal_final"]
                ) / abs(rr["log_marginal_final"])
                out["post_abs_vs_prob"] = float(np.max(np.abs(
                    np.asarray(res["posterior_all"])
                    - np.asarray(rr["posterior_all"]))))
            return out

        row("decode", go, T=T, N=N, L=L, engine=engine)

    # compile-and-compare first: the new kernel at its real width
    with jax.default_matmul_precision("highest"):
        decode_row(10_000, 100, 100, "pallas", ref=True)
        decode_row(20_000, 100, 100, "pallas_parallel", ref=True)
    if quick:
        return

    # crossover: decode at L=100, N=100 over T
    for T in (1_000, 2_000, 5_000, 10_000, 20_000, 50_000, 100_000):
        for engine in ("prob", "pallas", "pallas_parallel"):
            if engine == "pallas_parallel" and ps.choose_parallel_config(
                    T, 100, 2) is None:
                continue
            decode_row(T, 100, 100, engine)
    # L=500: the kernel is not built there; prob vs parallel
    for T in (10_000, 100_000):
        for engine in ("prob", "pallas_parallel"):
            decode_row(T, 500, 500, engine)

    # end to end through fit_em
    def fit_row(T, N, L, engine, n_iter=5):
        y = jax.device_put(rng.poisson(0.5, size=(T, N)).astype(np.float32))

        def go():
            m = model(N, L, engine)
            kw = dict(key=jr.PRNGKey(3), n_iter=n_iter, verboase=False)
            first, best = timed(
                lambda: m.fit_em(y, **kw)["log_marginal_l"][-1], reps=1)
            res = m.fit_em(y, **kw)
            return {"compile_s": first - best, "s_per_iter": best / n_iter,
                    "lml": float(res["log_marginal_l"][-1])}

        row("fit_em", go, T=T, N=N, L=L, engine=engine, n_iter=n_iter)

    for engine in ("prob", "pallas"):
        fit_row(10_000, 100, 100, engine)
    for engine in ("prob", "pallas_parallel"):
        fit_row(100_000, 100, 100, engine)

    # chunk count C at the headline and north-star shapes (one E-step)
    from poor_man_gplvm_tpu.ops import hmm, kernels as gpk

    def estep_row(T, N, L, C):
        y = jax.device_put(rng.poisson(0.5, size=(T, N)).astype(np.float32))
        tuning = jnp.asarray(rng.gamma(2.0, 0.5, size=(L, N)), jnp.float32)
        lat, log_lat, dyn, log_dyn = gpk.create_transition_prob_1d(
            jnp.arange(L), jnp.arange(2), movement_variance=1.0,
            p_move_to_jump=0.01, p_jump_to_move=0.01)
        trans = hmm.JointTransition(dyn, lat, log_dyn, log_lat)

        def go():
            old = ps.DEFAULT_C
            ps.DEFAULT_C = C
            try:
                f = lambda: hmm.smooth_combined_chunked(
                    y, tuning, {}, trans, jnp.ones(N), jnp.ones(L),
                    engine="pallas_parallel", memory_mode="checkpoint",
                    marginal_smooth=True, want_acc=False)[1]
                first, best = timed(f)
                peak = jax.devices()[0].memory_stats().get(
                    "peak_bytes_in_use")
                return {"compile_s": first - best, "steady_s": best,
                        "lml": float(f()), "peak_bytes": peak}
            finally:
                ps.DEFAULT_C = old

        row("estep_C", go, T=T, N=N, L=L, C=C)

    for C in (64, 128, 256, 512):
        estep_row(100_000, 100, 100, C)
    for C in (64, 128, 256, 512):
        estep_row(1_000_000, 500, 500, C)

    # matmul precision levels at the emission shape
    def prec_row(level):
        a = rng.standard_normal((200_000, 500)).astype(np.float32)
        b = rng.standard_normal((500, 500)).astype(np.float32)
        want = a.astype(np.float64) @ b.astype(np.float64)
        prec = {"highest": jax.lax.Precision.HIGHEST,
                "high": jax.lax.Precision.HIGH,
                "default": jax.lax.Precision.DEFAULT}[level]
        ad, bd = jax.device_put(a), jax.device_put(b)
        f = jax.jit(lambda x, z: jnp.matmul(x, z, precision=prec))

        def go():
            first, best = timed(lambda: f(ad, bd), reps=5)
            got = np.asarray(f(ad, bd), np.float64)
            err = float(np.max(np.abs(got - want)) / np.max(np.abs(want)))
            hlo = f.lower(ad, bd).compile().as_text()
            return {"steady_s": best, "tflops": 2 * 200_000 * 500 * 500
                    / best / 1e12, "max_err_rel": err,
                    "tf32_in_hlo": "tf32" in hlo.lower(),
                    "bf16_in_hlo": "bf16" in hlo.lower()}

        row("matmul_precision", go, level=level)

    for level in ("highest", "high", "default"):
        prec_row(level)
    emit({"row": "done"})


if __name__ == "__main__":
    main()
