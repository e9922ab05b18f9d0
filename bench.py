"""Headline benchmark: fit_em sec/EM-iter at T=100k x L=100 bins x N=100.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}

``vs_baseline`` is the speedup over the reference implementation measured on
a CPU (scripts/measure_reference_baseline.py writes BASELINE_MEASURED.json;
the reference publishes no numbers of its own — BASELINE.md); it divides
by a time from another machine.  Runs on the GPU; a device kind missing
from ``_PEAK_TFLOPS`` is an error.

Extra diagnostics go to stderr; stdout carries only the JSON line.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

# persistent XLA compilation cache: $JAX_COMPILATION_CACHE_DIR when set,
# else one fixed directory in the checkout
import jax as _jax_cfg

from poor_man_gplvm_tpu.utils.compile_cache import compile_cache_dir

_jax_cfg.config.update(
    "jax_compilation_cache_dir",
    compile_cache_dir(
        os.path.join(os.path.dirname(os.path.abspath(__file__)), ".jax_cache")
    ),
)
_jax_cfg.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


#: Published dense peak (TFLOP/s) per card by ``device_kind``.  Source:
#: NVIDIA's H100 SXM data sheet (dense, no sparsity): 989 bf16, 495 TF32,
#: 67 float32 outside the tensor cores.  The rates assume the full 700 W
#: power limit; a card set lower cannot hold its top clock under load, so
#: report ``nvidia-smi``'s power.limit beside any share of these.  The
#: scans and emissions here run f32-exact, so "mfu" charges the f32 rate.
_PEAK_TFLOPS = {
    "NVIDIA H100 80GB HBM3": {"bf16": 989.0, "tf32": 495.0, "f32": 67.0},
}


def _peak_f32(kind):
    if kind not in _PEAK_TFLOPS:
        raise KeyError(f"no published peak for device kind {kind!r}; add "
                       "it to bench._PEAK_TFLOPS")
    return _PEAK_TFLOPS[kind]["f32"]


def _em_iter_flops(T, L, N, n_dyn, scan_passes):
    """Analytic FLOPs of one EM iteration.

    emissions (Poisson LL as matmul + reductions)      ~ 4*T*L*N
    fwd+bwd scans: each pass is a (C,L)@(L,L) matvec
      per sequential step per dynamics state           ~ 2*T*n_dyn*L^2 each
    M-step grouped statistics                          ~ 2*T*L*(N+1)

    The pairwise-joint accumulation (one (C,L)@(L,L) post-scan matmul,
    ~2*T*n_dyn*L^2) is NOT counted: EVERY fit_em iteration passes
    want_acc=False (fit_em discards the joint), so no timed iteration
    computes it and counting it would inflate the achieved-FLOP/s.
    """
    return (
        4.0 * T * L * N
        + 2.0 * scan_passes * T * n_dyn * L * L
        + 2.0 * T * L * (N + 1)
    )


def _scan_passes_total(model):
    """Measured fixed-point pass count (fwd+bwd incl. emit passes) per EM
    iteration from the fused-path diagnostic; 6 (3 per direction) when the
    parallel engine didn't run or didn't record."""
    p = getattr(model, "_scan_passes_mid", None)
    if p is None:
        return 6.0
    import numpy as _np

    p = _np.asarray(p, dtype=_np.float64)  # (n_mid, 2) finals-only counts
    return float(p.sum(axis=1).mean()) + 2.0  # + one emit pass per direction


def _run_northstar():
    """North-star diagnostic (T=1e6 x L=500 x N=500, lean outputs).

    Runs FIRST in main(), on a device no other section has used yet: the
    number a dedicated production process would see.  Frees its 2 GB
    spike matrix and every compiled program before returning."""
    import gc

    import jax
    import jax.random as jr

    import poor_man_gplvm_tpu as pmg

    rng = np.random.default_rng(7)
    northstar = None
    northstar_passes = 6.0
    try:
        import jax.numpy as jnp

        Tn, Ln, Nn = 1_000_000, 500, 500
        y_big = jnp.asarray(
            rng.poisson(0.5, size=(Tn, Nn)).astype(np.float32)
        )
        ns_kw = dict(key=jr.PRNGKey(3), n_iter=12, verboase=False,
                     save_every=10**9, output_mode="lean")
        m = pmg.PoissonGPLVMJump1D(
            Nn, n_latent_bin=Ln, movement_variance=1,
            tuning_lengthscale=10.0,
        )
        # warm with the EXACT timed configuration; n_iter=12 is
        # representative of a production EM run and lets the
        # warm-started fixed points reach their steady state
        m.fit_em(y_big, **ns_kw)
        t0 = time.time()
        m.fit_em(y_big, **ns_kw)
        northstar = (time.time() - t0) / 12
        northstar_passes = _scan_passes_total(m)
        log(f"north-star fit_em (T=1e6, L=500, N=500, lean): "
            f"{northstar:.3f} s/iter ({northstar_passes:.1f} scan "
            "passes/iter)")
        del y_big, m
    except Exception as e:  # report the section, run the others
        log(f"north-star skipped: {type(e).__name__}: {e}")
    # free the spike matrix + the north-star program set before the
    # remaining sections compile theirs
    jax.clear_caches()
    gc.collect()
    return northstar, northstar_passes


def main():
    import jax
    import jax.random as jr

    import poor_man_gplvm_tpu as pmg

    T, L, N = 100_000, 100, 100
    # 30 iters ~ a production EM run; it also amortizes the fixed per-fit
    # dispatch/sync cost
    n_timed_iters = 30

    kind = jax.devices()[0].device_kind
    if jax.devices()[0].platform != "gpu":
        raise SystemExit(f"bench.py measures a GPU; found {kind!r}")
    peak = _peak_f32(kind)
    log(f"devices: {jax.devices()}")
    # north-star first: fresh-device measurement (see _run_northstar)
    northstar, northstar_passes = _run_northstar()
    rng = np.random.default_rng(0)
    # pre-place on device: passing host numpy re-uploads ~40 MB on EVERY
    # fit_em call
    y = jax.device_put(rng.poisson(1.0, size=(T, N)).astype(np.float32))

    model = pmg.PoissonGPLVMJump1D(
        N, n_latent_bin=L, movement_variance=1, tuning_lengthscale=10.0
    )
    # warmup: compile all programs with the EXACT timed configuration —
    # the fused EM fast path compiles one program per (shapes, n_iter)
    t0 = time.time()
    model.fit_em(y, key=jr.PRNGKey(3), n_iter=n_timed_iters, verboase=False)
    log(f"warmup (compile) {time.time()-t0:.1f}s")

    sec_per_iter = float("inf")
    for _ in range(2):
        t0 = time.time()
        model.fit_em(y, key=jr.PRNGKey(3), n_iter=n_timed_iters,
                     verboase=False)
        sec_per_iter = min(sec_per_iter, (time.time() - t0) / n_timed_iters)
    log(f"fit_em: {sec_per_iter:.3f} s/iter at T={T}, L={L}, N={N} "
        "(default auto chunking, min of 2)")

    # reference-compat 10k chunking diagnostic (chunking is exact; the
    # default auto path should be at least as fast)
    model.fit_em(y, key=jr.PRNGKey(3), n_iter=n_timed_iters,
                 n_time_per_chunk=10_000, verboase=False)
    sec_10k = float("inf")
    for _ in range(2):
        t0 = time.time()
        model.fit_em(y, key=jr.PRNGKey(3), n_iter=n_timed_iters,
                     n_time_per_chunk=10_000, verboase=False)
        sec_10k = min(sec_10k, (time.time() - t0) / n_timed_iters)
    log(f"fit_em 10k-chunk (reference-compat): {sec_10k:.3f} s/iter")
    sec_per_iter = min(sec_per_iter, sec_10k)

    # decode throughput (secondary diagnostic); block on the posterior so
    # the async dispatch doesn't understate the time
    import jax as _jax

    # pre-place on device: the host->device copy is not decode's work
    y10k = _jax.device_put(y[:10_000])
    _jax.block_until_ready(model.decode_latent(y10k)["log_posterior_all"])
    t0 = time.time()
    reps = 5
    for _ in range(reps):
        dec = model.decode_latent(y10k)
        _jax.block_until_ready(dec["log_posterior_all"])
    decode_sps = reps * 10_000 / (time.time() - t0)
    log(f"decode_latent: {decode_sps:.0f} timesteps/s")

    # fan-out sweep bench: the reference's main fan-out surface
    # (model_selection_helper.py:199-227 is a serial host loop; here the
    # whole 16-config x 4-chain grid is one vmapped device program).
    # Metric: aggregate EM timesteps/s across the batch (the single-stream
    # scan is latency-bound; the batch fills the device).
    sweep_agg = None
    try:
        from poor_man_gplvm_tpu.parallel import sweep as psweep

        Ts = 10_000
        y_s = jax.device_put(y[:Ts])
        ranges = {
            "movement_variance": [0.5, 1.0, 2.0, 4.0],
            "p_move_to_jump": [0.005, 0.01, 0.02, 0.05],
        }
        sweep_iters = 3
        kw = dict(
            n_repeat=4, n_iter=sweep_iters, n_latent_bin=L,
            tuning_lengthscale=10.0, m_maxiter=100,
        )
        res = psweep.sweep_fit_poisson_jump(y_s, ranges, **kw)  # warm/compile
        jax.block_until_ready(res["log_marginal_l"])
        B_runs = int(np.asarray(res["config_index"]).size)
        t0 = time.time()
        res = psweep.sweep_fit_poisson_jump(y_s, ranges, **kw)
        jax.block_until_ready(res["log_marginal_l"])
        dt_sweep = time.time() - t0
        sweep_agg = B_runs * Ts * sweep_iters / dt_sweep
        # comparator: run ONE of the batch's runs serially (same T, same
        # iters) — the honest alternative a user would face for fan-out
        one = psweep.sweep_fit_poisson_jump(
            y_s, {"movement_variance": [1.0]}, n_repeat=1,
            n_iter=sweep_iters, n_latent_bin=L, tuning_lengthscale=10.0,
            m_maxiter=100,
        )
        jax.block_until_ready(one["log_marginal_l"])
        t0 = time.time()
        one = psweep.sweep_fit_poisson_jump(
            y_s, {"movement_variance": [1.0]}, n_repeat=1,
            n_iter=sweep_iters, n_latent_bin=L, tuning_lengthscale=10.0,
            m_maxiter=100,
        )
        jax.block_until_ready(one["log_marginal_l"])
        serial_est = B_runs * (time.time() - t0)
        log(f"sweep fan-out ({B_runs} runs x T={Ts} x {sweep_iters} EM iters):"
            f" {dt_sweep:.2f}s -> {sweep_agg:.0f} aggregate EM timesteps/s"
            f" ({serial_est / dt_sweep:.1f}x faster than {B_runs} serial"
            f" same-size runs, est {serial_est:.2f}s)")
    except Exception as e:
        log(f"sweep bench skipped: {type(e).__name__}: {e}")

    # model_selection_one_split: the reference's actual sweep entry point
    # (model_selection_helper.py:145-239, a serial host loop there) — here
    # backend='batched' runs the whole fit/eval tree as vmapped programs
    one_split_speedup = None
    try:
        from poor_man_gplvm_tpu import selection

        Tsel = 5_000
        y_sel = np.asarray(y[:Tsel])
        sel_kw = dict(
            hyperparam_dict={
                "movement_variance": [0.5, 1.0, 2.0, 4.0],
                "tuning_lengthscale": [10.0],
            },
            fit_kwargs=dict(
                selection.default_fit_kwargs, n_iter=3, verboase=False
            ),
            model_class_str="poisson",
            n_repeat=2,
            latent_downsample_frac=(0.5,),
            downsample_n_repeat=3,
            verbose=False,
        )
        # warm BOTH backends (they compile different program sets), then
        # time each on its second run so neither pays compile time
        selection.model_selection_one_split(
            y_sel, backend="batched", **sel_kw
        )
        selection.model_selection_one_split(
            y_sel, backend="serial", **sel_kw
        )
        t0 = time.time()
        selection.model_selection_one_split(
            y_sel, backend="batched", **sel_kw
        )
        dt_batched = time.time() - t0
        t0 = time.time()
        selection.model_selection_one_split(
            y_sel, backend="serial", **sel_kw
        )
        dt_serial = time.time() - t0
        one_split_speedup = dt_serial / dt_batched
        log(f"model_selection_one_split (4 configs x 2 chains, T={Tsel}):"
            f" batched {dt_batched:.2f}s vs serial {dt_serial:.2f}s"
            f" -> {one_split_speedup:.1f}x")
    except Exception as e:
        log(f"one_split bench skipped: {type(e).__name__}: {e}")

    # batched short-epoch decode: ~100 x 1 s ripple-style epochs as ONE
    # vmapped program vs the reference-shaped per-epoch host loop
    # (reference reactivation_analysis.py:21-55)
    epoch_speedup = None
    try:
        n_ep, ep_len = 100, 100
        starts = rng.integers(0, T - ep_len, size=n_ep)
        intervals = np.stack([starts, starts + ep_len], axis=1)
        y_host = np.asarray(y)
        model.decode_latent_epochs(y_host, intervals)  # warm/compile
        t0 = time.time()
        ep_res = model.decode_latent_epochs(y_host, intervals)
        dt_batched_ep = time.time() - t0
        # per-epoch loop comparator (the reference workflow's shape):
        # decode each epoch separately, warm program
        y_ep0 = jax.device_put(y_host[starts[0]:starts[0] + ep_len])
        jax.block_until_ready(
            model.decode_latent(y_ep0)["log_posterior_all"]
        )
        t0 = time.time()
        for a, b in intervals[:20]:  # 20 epochs, extrapolated
            d = model.decode_latent(jax.device_put(y_host[a:b]))
            jax.block_until_ready(d["log_posterior_all"])
        dt_loop_ep = (time.time() - t0) * (n_ep / 20)
        epoch_speedup = dt_loop_ep / dt_batched_ep
        log(f"epoch decode ({n_ep} x {ep_len}-bin epochs): batched "
            f"{dt_batched_ep:.3f}s vs per-epoch loop {dt_loop_ep:.2f}s "
            f"(est) -> {epoch_speedup:.1f}x")
        del ep_res
    except Exception as e:
        log(f"epoch-decode bench skipped: {type(e).__name__}: {e}")

    # basis-weighted tuning path (BASELINE.json config 4; reference
    # fit_tuning_with_basis.py:100-115 — per-neuron LBFGS vmapped over
    # neurons on grouped statistics)
    basis_mstep_ms = None
    try:
        import jax.numpy as jnp

        from poor_man_gplvm_tpu.ops import fit_tuning_with_basis as ftb
        from poor_man_gplvm_tpu.ops.basis import generate_basis

        Lb, Nb, Tb = 100, 100, 100_000  # Nb bounded by the headline N
        basis_b = jnp.asarray(generate_basis(10.0, Lb))
        rank = basis_b.shape[1]
        post_b = jax.device_put(
            np.random.default_rng(1).dirichlet(
                np.ones(Lb), size=Tb
            ).astype(np.float32)
        )
        y_b = jax.device_put(np.asarray(y[:Tb, :Nb]))
        w0 = jnp.zeros((rank, Nb), jnp.float32)
        b0 = jnp.zeros((Nb,), jnp.float32)
        args = ((w0, b0), y_b, basis_b, post_b, 1.0)
        ftb.m_step_get_tuning_all_neuron_grouped(*args, maxiter=50)
        t0 = time.time()
        _, tuning_fit, _err = ftb.m_step_get_tuning_all_neuron_grouped(
            *args, maxiter=50
        )
        jax.block_until_ready(tuning_fit)
        basis_mstep_ms = (time.time() - t0) * 1e3
        log(f"fit_tuning_with_basis M-step (T={Tb}, L={Lb}, N={Nb}, "
            f"rank={rank}, 50 LBFGS iters): {basis_mstep_ms:.0f} ms")
        del post_b, y_b, tuning_fit
    except Exception as e:
        log(f"basis-tuning bench skipped: {type(e).__name__}: {e}")

    headline_passes = _scan_passes_total(model)

    vs_baseline = None
    baseline_path = os.path.join(os.path.dirname(__file__), "BASELINE_MEASURED.json")
    if os.path.exists(baseline_path):
        with open(baseline_path) as f:
            base = json.load(f)
        ref = base.get(f"fit_em_T{T}_L{L}_N{N}_sec_per_iter")
        if ref:
            vs_baseline = ref / sec_per_iter
            log(f"reference CPU: {ref:.3f} s/iter -> speedup {vs_baseline:.1f}x")

    # achieved FLOP/s + MFU: analytic FLOPs of one EM iteration over the
    # measured wall time, vs the card's published f32 peak
    # headline_passes was captured before the north-star section freed the
    # headline model
    headline_tflops = (
        _em_iter_flops(T, L, N, 2, headline_passes) / sec_per_iter / 1e12
    )
    northstar_tflops = (
        _em_iter_flops(1_000_000, 500, 500, 2, northstar_passes)
        / northstar / 1e12
    ) if northstar else None
    log(f"achieved: headline {headline_tflops:.2f} TFLOP/s"
        + (f", north-star {northstar_tflops:.2f} TFLOP/s"
           if northstar_tflops else "")
        + f"; f32 peak({kind}) {peak:.0f} -> MFU "
        f"{100 * (northstar_tflops or headline_tflops) / peak:.1f}%")

    extra = {
        "decode_timesteps_per_sec": round(decode_sps),
        "sweep_aggregate_timesteps_per_sec": (
            round(sweep_agg) if sweep_agg else None
        ),
        "one_split_batched_vs_serial_speedup": (
            round(one_split_speedup, 1) if one_split_speedup else None
        ),
        "epoch_decode_batched_vs_loop_speedup": (
            round(epoch_speedup, 1) if epoch_speedup else None
        ),
        "basis_mstep_ms": (
            round(basis_mstep_ms, 1) if basis_mstep_ms else None
        ),
        "northstar_T1e6_L500_N500_sec_per_iter": (
            round(northstar, 3) if northstar else None
        ),
        "headline_tflops": round(headline_tflops, 2),
        "northstar_tflops": (
            round(northstar_tflops, 2) if northstar_tflops else None
        ),
        "mfu": round((northstar_tflops or headline_tflops) / peak, 4),
        "device": {"platform": jax.devices()[0].platform, "kind": kind,
                   "count": len(jax.devices())},
    }
    print(
        json.dumps(
            {
                "metric": f"fit_em_sec_per_EM_iter_T{T}_L{L}_N{N}",
                "value": round(sec_per_iter, 4),
                "unit": "s/iter",
                "vs_baseline": round(vs_baseline, 2) if vs_baseline else None,
                "extra": extra,
            }
        )
    )


if __name__ == "__main__":
    main()
