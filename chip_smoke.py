"""GPU smoke run of the main path: fit and decode on one NVIDIA card.

    python chip_smoke.py              # one card, phases 1-5
    python chip_smoke.py --multichip  # four cards: the mesh path only

Phases (one card):

1. each smoother engine at real widths (L=100, T=100k, N=100 and L=500,
   T=100k, N=500) against the sequential ``prob`` engine, and at T=2k,
   L=64 against the float64 dense-HMM oracle (tests/oracle.py, on the
   host); all under ``jax.default_matmul_precision("highest")``;
2. the headline trainer: ``fit_em`` (5 iterations), ``decode_latent`` on
   10k bins and ``decode_latent_epochs`` on 100 x 100-bin epochs;
3. the north-star trainer (T=1e6 x L=500 x N=500, lean, 3 iterations) and
   one E-step of the resolved engine certified against ``prob``;
4. the 16-config x 4-chain ``sweep_fit_poisson_jump`` grid at T=10k;
5. the tests marked ``gpu``, run in a child before this process opens the
   card.

``--multichip`` runs ``sharded_smooth`` (both time engines) and
``fit_em(mesh=)`` on a 4-device mesh at the north-star shape against the
one-card engine, and nothing else.

Tolerances: log-marginal <= 1e-5 relative, posteriors <= 1e-4 absolute
(PARITY.json's bounds).  Any failure ends the run with a non-zero exit
and no result line.  Without a GPU, or away from the repository, the
script exits non-zero.  The last line of stdout is one JSON object:
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
LML_RTOL = 1e-5
POST_ATOL = 1e-4

# shapes (T, N, L)
WIDTHS = ((100_000, 100, 100), (100_000, 500, 500))
ORACLE = (2_000, 32, 64)
HEADLINE = (100_000, 100, 100)
DECODE_T = 10_000
EPOCHS = (100, 100)  # count, bins
NORTHSTAR = (1_000_000, 500, 500)
SWEEP = (10_000, 100, 100)


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg):
    print(msg, flush=True)


def card_lines():
    """nvidia-smi's name and power limit per card, read by a child that
    stays off JAX."""
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.SubprocessError) as e:
        fail(f"no NVIDIA GPU: nvidia-smi did not run ({e})")
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines:
        fail(f"no NVIDIA GPU: nvidia-smi exit {proc.returncode}")
    return lines


def run_card_tests():
    """Phase 5, run first: the tests marked ``gpu``, in a child, before
    this process touches the card."""
    t0 = time.perf_counter()
    env = dict(os.environ, PMG_GPU_TESTS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "tests/test_gpu.py", "-m", "gpu", "-q",
         "-p", "no:cacheprovider", "-p", "no:randomly"],
        cwd=HERE, env=env, capture_output=True, text=True, timeout=900,
    )
    tail = proc.stdout.strip().splitlines()[-1:] or ["(no output)"]
    if proc.returncode != 0 or "skipped" in tail[0] or "passed" not in tail[0]:
        sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
        fail(f"card tests: {tail[0]} (exit {proc.returncode})")
    log(f"phase 5 card tests: {tail[0]} "
        f"({time.perf_counter() - t0:.1f} s, in a child process)")


def setup_jax(n_cards):
    sys.path.insert(0, HERE)
    import jax

    from poor_man_gplvm_tpu.utils.compile_cache import compile_cache_dir

    jax.config.update("jax_compilation_cache_dir",
                      compile_cache_dir(os.path.join(HERE, ".jax_cache")))
    import poor_man_gplvm_tpu

    pkg = os.path.dirname(os.path.abspath(poor_man_gplvm_tpu.__file__))
    if os.path.dirname(pkg) != HERE:
        fail(f"poor_man_gplvm_tpu imported from {pkg}, not this checkout")
    devs = jax.devices()
    if devs[0].platform != "gpu":
        fail(f"JAX found no GPU (default device: {devs[0].platform})")
    if len(devs) < n_cards:
        fail(f"need {n_cards} GPUs, JAX sees {len(devs)}")
    return jax, devs


def peak_bytes(jax):
    return (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")


def timed(jax, fn, steady=True):
    """(result, first-call seconds, second-call seconds or None).  The
    second call (compiled, steady state) is skipped for the long sequential
    references."""
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    if not steady:
        return out, first, None
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, first, time.perf_counter() - t0


def report(phase, name, first, steady, jax, **errs):
    parts = " ".join(f"{k}={v:.3g}" for k, v in errs.items())
    st = "not measured" if steady is None else f"{steady:.3f} s"
    log(f"{phase} {name}: compile+first {first:.3f} s, steady {st},"
        f" peak_bytes_in_use {peak_bytes(jax)}, {parts}")


def check(name, lml_rel=None, post_abs=None):
    if lml_rel is not None and not lml_rel <= LML_RTOL:
        fail(f"{name}: log-marginal rel error {lml_rel:.3g} > {LML_RTOL}")
    if post_abs is not None and not post_abs <= POST_ATOL:
        fail(f"{name}: posterior abs error {post_abs:.3g} > {POST_ATOL}")


def lml_rel(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


def joint_problem(jnp, rng, T, N, L):
    from poor_man_gplvm_tpu.ops import hmm, kernels as gpk

    lat, log_lat, dyn, log_dyn = gpk.create_transition_prob_1d(
        jnp.arange(L), jnp.arange(2), movement_variance=1.0,
        p_move_to_jump=0.01, p_jump_to_move=0.01,
    )
    trans = hmm.JointTransition(dyn, lat, log_dyn, log_lat)
    y = jnp.asarray(rng.poisson(0.5, size=(T, N)).astype("float32"))
    tuning = jnp.asarray(rng.gamma(2.0, 0.5, size=(L, N)), jnp.float32)
    return y, tuning, trans


def phase_engines(jax, np, rng):
    import jax.numpy as jnp

    from poor_man_gplvm_tpu.ops import engine as eng
    from poor_man_gplvm_tpu.ops import hmm

    def smooth(args, engine, **kw):
        y, tuning, trans = args
        N, L = y.shape[1], tuning.shape[0]
        return hmm.smooth_combined_chunked(
            y, tuning, {}, trans, jnp.ones(N), jnp.ones(L), engine=engine,
            **kw)

    for T, N, L in WIDTHS:
        args = joint_problem(jnp, rng, T, N, L)
        ref, first, steady = timed(jax, lambda: smooth(args, "prob"),
                                   steady=False)
        report("phase 1", f"prob T={T} L={L} N={N}", first, steady, jax)
        ref_post = np.exp(np.asarray(ref[0]))
        ref_lml = float(ref[1])
        engines = ["pallas_parallel"]
        if L <= eng.KERNEL_MAX_L:
            engines.insert(0, "pallas")
        for engine in engines:
            out, first, steady = timed(jax, lambda: smooth(args, engine))
            rel = lml_rel(out[1], ref_lml)
            err = float(np.max(np.abs(np.exp(np.asarray(out[0])) - ref_post)))
            report("phase 1", f"{engine} T={T} L={L} N={N} vs prob", first,
                   steady, jax, lml_rel=rel, post_abs=err)
            check(f"{engine} T={T} L={L}", rel, err)
        del ref, ref_post, args

    # small shape against the float64 oracle on the host
    sys.path.insert(0, os.path.join(HERE, "tests"))
    from oracle import dense_forward_backward, joint_to_dense

    from poor_man_gplvm_tpu.ops import emissions

    T, N, L = ORACLE
    y, tuning, trans = joint_problem(jnp, rng, T, N, L)
    ll = np.asarray(emissions.poisson_loglik(y, tuning, jnp.ones(N),
                                             jnp.ones(L)), np.float64)
    oracle = dense_forward_backward(
        np.tile(ll, (1, 2)), joint_to_dense(trans.Tdyn, trans.Tlat),
        np.full(2 * L, 1.0 / (2 * L)),
    )
    for engine in ("prob", "pallas", "pallas_parallel"):
        out, first, steady = timed(jax, lambda: smooth((y, tuning, trans),
                                                       engine))
        rel = lml_rel(out[1], oracle["log_marginal"])
        err = float(np.max(np.abs(np.exp(np.asarray(out[0])).reshape(T, -1)
                                  - oracle["smoothed"])))
        report("phase 1", f"{engine} T={T} L={L} vs float64 oracle", first,
               steady, jax, lml_rel=rel, post_abs=err)
        check(f"{engine} vs oracle", rel, err)


def phase_headline(jax, np):
    import jax.random as jr

    import poor_man_gplvm_tpu as pmg

    T, N, L = HEADLINE
    m = pmg.PoissonGPLVMJump1D(N, n_latent_bin=L, movement_variance=1,
                               tuning_lengthscale=10.0)
    _, y = m.sample(T, key=jr.PRNGKey(1))
    y = jax.block_until_ready(y)
    kw = dict(key=jr.PRNGKey(3), n_iter=5, verboase=False)
    em, first, steady = timed(jax, lambda: m.fit_em(y, **kw))
    lml = np.asarray([float(v) for v in em["log_marginal_l"]])
    if not np.all(np.isfinite(lml)):
        fail(f"headline fit_em: non-finite log-marginal {lml}")
    drops = np.diff(lml) / np.abs(lml[:-1])
    if np.any(drops < -LML_RTOL):
        fail(f"headline fit_em: log-marginal decreased {lml}")
    report("phase 2", f"fit_em T={T} L={L} N={N} 5 iters", first, steady,
           jax, lml_first=lml[0], lml_last=lml[-1])
    y_dec = y[:DECODE_T]
    dec, first, steady = timed(jax, lambda: m.decode_latent(y_dec))
    rowsum = np.asarray(dec["posterior_all"]).sum(axis=(1, 2))
    err = float(np.max(np.abs(rowsum - 1.0)))
    report("phase 2", f"decode_latent {DECODE_T} bins", first, steady, jax,
           rowsum_err=err)
    check("decode_latent row sums", post_abs=err)
    n_ep, ep_len = EPOCHS
    starts = np.random.default_rng(2).integers(0, T - ep_len, size=n_ep)
    intervals = np.stack([starts, starts + ep_len], axis=1)
    y_host = np.asarray(y)
    ep, first, steady = timed(
        jax, lambda: m.decode_latent_epochs(y_host, intervals))
    post = ep["posterior_latent_marg"]
    if post.shape != (n_ep, ep_len, L) or not np.all(
            np.isfinite(ep["log_marginal_per_epoch"])):
        fail(f"decode_latent_epochs: shape {post.shape} or non-finite lml")
    err = float(np.max(np.abs(post.sum(axis=2) - 1.0)))
    report("phase 2", f"decode_latent_epochs {n_ep} x {ep_len} bins", first,
           steady, jax, rowsum_err=err)
    check("decode_latent_epochs row sums", post_abs=err)


def phase_northstar(jax, np):
    import jax.numpy as jnp
    import jax.random as jr

    import poor_man_gplvm_tpu as pmg
    from poor_man_gplvm_tpu.ops import engine as eng
    from poor_man_gplvm_tpu.ops import hmm

    T, N, L = NORTHSTAR
    m = pmg.PoissonGPLVMJump1D(N, n_latent_bin=L, movement_variance=1,
                               tuning_lengthscale=10.0)
    y = jax.block_until_ready(
        jr.poisson(jr.PRNGKey(7), 0.5, (T, N)).astype(jnp.float32))
    t0 = time.perf_counter()
    em = m.fit_em(y, key=jr.PRNGKey(3), n_iter=3, verboase=False,
                  output_mode="lean")
    lml = np.asarray([float(v) for v in em["log_marginal_l"]])
    dt = time.perf_counter() - t0
    if not np.all(np.isfinite(lml)):
        fail(f"north-star fit_em: non-finite log-marginal {lml}")
    resolved = eng.resolve_engine("auto", T, L, 2)
    log(f"phase 3 fit_em T={T} L={L} N={N} lean 3 iters (engine {resolved}):"
        f" {dt:.3f} s incl. compile, peak_bytes_in_use {peak_bytes(jax)},"
        f" lml {lml.tolist()}")
    del em
    trans, _ = m._make_transition({})
    kw = dict(memory_mode="filter", marginal_smooth=True, want_acc=False)
    args = (y, m.tuning, {}, trans, jnp.ones(N), jnp.ones(L))
    with jax.default_matmul_precision("highest"):
        got, first, steady = timed(
            jax, lambda: hmm.smooth_combined_chunked(*args, engine="auto",
                                                     **kw))
        got_lml = float(got[1])
        got_post = got[0][0]
        del got
        ref, rfirst, _ = timed(
            jax, lambda: hmm.smooth_combined_chunked(*args, engine="prob",
                                                     **kw), steady=False)
    rel = lml_rel(got_lml, ref[1])
    err = float(jnp.max(jnp.abs(jnp.exp(got_post) - jnp.exp(ref[0][0]))))
    report("phase 3", f"E-step {resolved} vs prob (prob: compile+first "
           f"{rfirst:.3f} s)", first, steady, jax, lml_rel=rel, post_abs=err)
    check("north-star E-step", rel, err)


def phase_sweep(jax, np):
    import jax.random as jr

    import poor_man_gplvm_tpu as pmg
    from poor_man_gplvm_tpu.parallel import sweep

    T, N, L = SWEEP
    m = pmg.PoissonGPLVMJump1D(N, n_latent_bin=L, movement_variance=1,
                               tuning_lengthscale=10.0)
    _, y = m.sample(T, key=jr.PRNGKey(4))
    ranges = {"movement_variance": [0.5, 1.0, 2.0, 4.0],
              "p_move_to_jump": [0.005, 0.01, 0.02, 0.05]}
    res, first, steady = timed(jax, lambda: sweep.sweep_fit_poisson_jump(
        y, ranges, n_repeat=4, n_iter=3, n_latent_bin=L,
        tuning_lengthscale=10.0, m_maxiter=100)["log_marginal_l"])
    res = np.asarray(res)
    if res.shape[0] != 64 or not np.all(np.isfinite(res)):
        fail(f"sweep: shape {res.shape} or non-finite log-marginals")
    report("phase 4", f"sweep 16 configs x 4 chains T={T} 3 iters", first,
           steady, jax, lml_min=float(res.min()), lml_max=float(res.max()))


def phase_multichip(jax, np):
    import jax.numpy as jnp
    import jax.random as jr

    import poor_man_gplvm_tpu as pmg
    from poor_man_gplvm_tpu.ops import hmm
    from poor_man_gplvm_tpu.parallel import spmd

    T, N, L = NORTHSTAR
    # time-sharded: each card holds a quarter of the sequence and all N
    # neurons, so the emission contraction matches the one-card engine's
    mesh = spmd.make_mesh(4, n_time=4)
    log(f"phase 6 mesh {dict(mesh.shape)}")
    rng = np.random.default_rng(11)
    y, tuning, trans = joint_problem(jnp, rng, T, N, L)
    ones_n, ones_l = jnp.ones(N), jnp.ones(L)
    with jax.default_matmul_precision("highest"):
        ref, first, steady = timed(jax, lambda: hmm.smooth_combined_chunked(
            y, tuning, {}, trans, ones_n, ones_l,
            engine="pallas_parallel")[:2])
        report("phase 6", "one-card pallas_parallel", first, steady, jax)
        for time_engine in ("pscan", "pipeline"):
            got, first, steady = timed(jax, lambda: spmd.sharded_smooth(
                mesh, y, tuning, {}, trans, ones_n, ones_l,
                time_engine=time_engine)[:2], steady=time_engine == "pscan")
            rel = lml_rel(got[1], ref[1])
            err = float(jnp.max(jnp.abs(
                jnp.exp(jax.device_put(got[0], jax.devices()[0]))
                - jnp.exp(ref[0]))))
            report("phase 6", f"sharded_smooth {time_engine} vs one card",
                   first, steady, jax, lml_rel=rel, post_abs=err)
            check(f"sharded_smooth {time_engine}", rel, err)
            del got
    del ref
    kw = dict(key=jr.PRNGKey(3), n_iter=2, verboase=False,
              output_mode="lean", m_step_maxiter=20)

    def fit(mesh_arg):
        mm = pmg.PoissonGPLVMJump1D(N, n_latent_bin=L, movement_variance=1,
                                    tuning_lengthscale=10.0)
        em = mm.fit_em(y, mesh=mesh_arg, **kw)
        return np.asarray([float(v) for v in em["log_marginal_l"]])

    t0 = time.perf_counter()
    one = fit(None)
    t1 = time.perf_counter()
    sharded = fit(mesh)
    t2 = time.perf_counter()
    rel = float(np.max(np.abs(sharded - one) / np.abs(one)))
    log(f"phase 6 fit_em(mesh=) 2 iters vs one card: {t2 - t1:.3f} s vs "
        f"{t1 - t0:.3f} s incl. compile, lml_rel={rel:.3g}")
    check("fit_em(mesh=)", rel)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--multichip", action="store_true",
                        help="run the 4-card mesh path only")
    args = parser.parse_args()
    n_cards = 4 if args.multichip else 1
    cards = card_lines()
    if not os.path.isdir(os.path.join(HERE, "poor_man_gplvm_tpu")):
        fail("run from a checkout: poor_man_gplvm_tpu/ is not beside "
             "chip_smoke.py")
    if not args.multichip:
        run_card_tests()
    jax, devs = setup_jax(n_cards)
    import numpy as np

    for line in cards:
        log(line)
    log(f"jax device kind: {devs[0].device_kind} x {len(devs)}")
    t0 = time.perf_counter()
    if args.multichip:
        phase_multichip(jax, np)
    else:
        rng = np.random.default_rng(0)
        with jax.default_matmul_precision("highest"):
            phase_engines(jax, np, rng)
        phase_headline(jax, np)
        phase_northstar(jax, np)
        phase_sweep(jax, np)
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)


if __name__ == "__main__":
    main()
