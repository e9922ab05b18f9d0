"""Parallel-in-time (chunked fixed-point) forward-backward scans.

A sequential scan pays one dependent (1, L) @ (L, L) product per time step.
These passes advance C chunks of the sequence SIMULTANEOUSLY: each
sequential step performs one batched (C, L) @ (L, L) product per dynamics
channel, which costs about as much wall-clock as the single-row product —
C times the work for the price of one step.  The passes are plain ``lax``:
XLA hands each step's batched product to the GPU's matmul libraries.

Chunk c's recursion needs the carry (filter posterior / smoothed posterior)
at its boundary, which chunk c-1 produces.  We solve for the boundary
carries by FIXED-POINT ITERATION over whole passes:

  pass k:   run all chunks from carry_ins_k  ->  finals_k
  update:   carry_ins_{k+1} = shift(finals_k)   (chunk 0's input is exact)
  stop:     max |carry_ins_{k+1} - carry_ins_k| <= tol

The fixed point of this iteration IS the exact sequential recursion (at
convergence every chunk starts from its true boundary carry), so unlike a
warmup-window approximation the result carries a convergence certificate.
Convergence is geometric in the filter's forgetting rate: the jump channel's
uniform transition row gives the joint chain a Doeblin minorization
(T(s, .) >= p_move_to_jump * uniform), so a boundary perturbation decays at
least like (1 - p_mj)^t inside a chunk; with chunks of thousands of steps
the iteration settles in 2 passes for any practical hyperparameters.  The
pass count is capped at C, at which point the result is exact by induction
(pass k makes chunk k's input exact) — the pathological worst case costs
the same total steps as one sequential sweep.

The fixed-point loops run FINALS-ONLY passes that keep just the
(n_dyn, C, L) boundary carries, then a single emitting pass runs with the
converged boundaries.  The pairwise-joint statistic
``acc[d,e,i,j] = sum_t filt[t,d,i] * r[t,e,j]`` is one post-scan
contraction over the stored posteriors and smoother ratios.

Numerics are identical per step to the ``prob`` engine (scaled
probability-space recursions, f32, Precision.HIGHEST dots), so parity with
the reference (<=1e-5 relative log-marginal, BASELINE.json) is preserved.

Layout: time-within-chunk-major.  ``w_c``/``post_c``/``smooth_c`` are
(tc_eff, [n_dyn,] C, L) with tc_eff = ceil(T/C); each step reads and writes
one contiguous (C, L) tile.  Chunk c owns global rows [c*tc_eff,
(c+1)*tc_eff) clipped to T; rows outside the valid range are hard no-ops
for the carry.

Reference parity targets: poor_man_gplvm/decoder.py:151-332 (the sequential
recursions these passes reproduce), decoder.py:258-332 (chunked driver
contract).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

HIGHEST = jax.lax.Precision.HIGHEST

#: chunks advanced per step by default.  The pass time is set by its
#: sequential step count, so larger C is faster: one E-step at T=1e6,
#: L=500 took 2.74 / 1.46 / 0.93 / 0.65 s at C=64 / 128 / 256 / 512 on an
#: H100 (PERF.md)
DEFAULT_C = 512

#: each chunk should amortize its boundary solve over at least this many
#: steps; shorter sequences use fewer chunks
MIN_CHUNK_LEN = 128

#: strict fixed-point tolerance on the boundary carries (max abs change
#: per pass).  On an H100, 1e-8 left the largest posterior difference
#: against the sequential engine unchanged (PERF.md) and adds passes.
STRICT_TOL = 1e-6


def choose_parallel_config(T, L, n_dyn):
    """The chunk count C for the fixed-point scans, or None when the
    sequence is too short to chunk (fall back to a sequential engine).

    C starts at ``DEFAULT_C`` and halves until every chunk holds at least
    ``MIN_CHUNK_LEN`` steps.  ``L`` and ``n_dyn`` are accepted for the
    callers' sake; the choice depends on T only."""
    del L, n_dyn
    C = DEFAULT_C
    while C > 2 and T < C * MIN_CHUNK_LEN:
        C //= 2
    if T < C * MIN_CHUNK_LEN:
        return None
    return C


# ---------------------------------------------------------------------------
# passes
# ---------------------------------------------------------------------------


def _pfilter_pass(w_c, tlat, tdyn, ins, *, tc_eff, n_valid, finals_only):
    """Forward (causal filter) pass over all C chunks at once.

    w_c: (tc_eff, C, L) likelihood weights; ins: (n_dyn, C, L) chunk-start
    carries.  Returns (post (tc_eff, n_dyn, C, L), svals (tc_eff, C), fin)
    — the per-step normalizers svals are 1.0 on invalid rows — or
    (None, None, fin) when ``finals_only``."""
    C = w_c.shape[1]
    nv = jnp.asarray(n_valid, dtype=jnp.int32)
    chunk_off = jnp.arange(C, dtype=jnp.int32) * tc_eff

    def step(carry, inp):
        tau, w_t = inp
        q = jnp.einsum("pcl,pd->dcl", carry, tdyn, precision=HIGHEST)
        prior = jnp.einsum("dci,dij->dcj", q, tlat, precision=HIGHEST)
        u = prior * w_t[None]
        ssum = jnp.sum(u, axis=(0, 2))  # (C,)
        new = u / jnp.maximum(ssum[None, :, None], 1e-38)
        valid = (chunk_off + tau) < nv
        new = jnp.where(valid[None, :, None], new, carry)
        if finals_only:
            return new, None
        sv = jnp.where(valid, jnp.maximum(ssum, 1e-38), 1.0)
        return new, (new, sv)

    taus = jnp.arange(tc_eff, dtype=jnp.int32)
    fin, out = lax.scan(step, ins, (taus, w_c))
    if finals_only:
        return None, None, fin
    post, svals = out
    return post, svals, fin


def _psmooth_pass(post_c, tlat, tdyn, ins, *, tc_eff, n_valid, marginal,
                  finals_only, want_acc=True):
    """Backward (acausal smoother) pass over all C chunks at once.

    post_c: (tc_eff, n_dyn, C, L) filter posteriors; the +1-shifted causal
    priors are rebuilt with one batched push.  Returns ``(fin,)`` when
    ``finals_only``; ``(latmarg, dynm, acc, fin)`` (``acc`` omitted when
    not ``want_acc``) when ``marginal``; else ``(smooth, r, fin)``.  ``acc``
    is the raw pairwise contraction before the transition weighting."""
    C = post_c.shape[2]
    nv = jnp.asarray(n_valid, dtype=jnp.int32)
    chunk_off = jnp.arange(C, dtype=jnp.int32) * tc_eff
    q = jnp.einsum("tpcl,pd->tdcl", post_c, tdyn, precision=HIGHEST)
    prior_c = jnp.einsum("tdci,dij->tdcj", q, tlat, precision=HIGHEST)
    tlatT = jnp.swapaxes(tlat, -1, -2)

    def step(carry, inp):
        tau, p_filt, p_prior = inp
        safe = jnp.where(p_prior > 0, p_prior, 1.0)
        r = jnp.where(p_prior > 0, carry / safe, 0.0)
        # recursion domain is t in [0, T-2]; row T-1 keeps the carry
        valid = (chunk_off + tau) < (nv - 1)
        r = jnp.where(valid[None, :, None], r, 0.0)
        pull_s = jnp.einsum("ecl,elj->ecj", r, tlatT, precision=HIGHEST)
        pull = jnp.einsum("de,ecl->dcl", tdyn, pull_s, precision=HIGHEST)
        sm = p_filt * pull
        norm = jnp.sum(sm, axis=(0, 2), keepdims=True)
        new = jnp.where(
            valid[None, :, None], sm / jnp.maximum(norm, 1e-38), carry
        )
        if finals_only:
            return new, None
        return new, (new, r)

    taus = jnp.arange(tc_eff, dtype=jnp.int32)
    fin, out = lax.scan(step, ins, (taus, post_c, prior_c), reverse=True)
    if finals_only:
        return (fin,)
    smooth, r = out
    if marginal:
        latmarg = jnp.sum(smooth, axis=1)
        dynm = jnp.sum(smooth, axis=3)
        if not want_acc:
            return (latmarg, dynm, fin)
        acc = jnp.einsum(
            "tdci,tecj->deij", post_c, r, precision=HIGHEST
        )
        return (latmarg, dynm, acc, fin)
    return (smooth, r, fin)


# ---------------------------------------------------------------------------
# fixed-point drivers
# ---------------------------------------------------------------------------


def _chunk_to_flat(x_c, tc_eff, T):
    """(tc_eff, ..., C, L) chunk layout -> (T, ..., L) global time order."""
    # (tc_eff, ..., C, L) -> (C, tc_eff, ..., L)
    perm = (x_c.ndim - 2, 0) + tuple(range(1, x_c.ndim - 2)) + (x_c.ndim - 1,)
    x = jnp.transpose(x_c, perm)[:, :tc_eff]
    return x.reshape((-1,) + x.shape[2:])[:T]


@functools.partial(
    jax.jit,
    static_argnames=["C", "tc_eff", "T", "marginal", "want_post",
                     "max_passes", "tol", "fast", "want_carry", "has_ws",
                     "want_acc"],
    donate_argnums=(0,),  # ll — returned when want_post
)
def _smooth_parallel_jit(ll, tlat, tdyn, p_init, likelihood_scale,
                         fwd_ws, bwd_ws, ws_pred, ws_valid, *,
                         C, tc_eff, T, marginal, want_post, max_passes, tol,
                         fast, want_carry, has_ws, want_acc=True):
    n_dyn, L = tlat.shape[0], tlat.shape[-1]

    # ---- likelihood weights in chunk layout ----
    m = jnp.max(ll, axis=1)  # (T,)
    w = jnp.exp(likelihood_scale * (ll - m[:, None]))
    w_flat = jnp.zeros((C * tc_eff, L), dtype=jnp.float32).at[:T].set(w)
    w_c = jnp.transpose(w_flat.reshape(C, tc_eff, L), (1, 0, 2))
    tdyn = tdyn.astype(jnp.float32)

    # ---- forward fixed point (finals-only loop + one emitting pass) ----
    uniform = jnp.full((n_dyn, L), 1.0 / (n_dyn * L), dtype=jnp.float32)
    ins0 = jnp.broadcast_to(
        uniform[:, None, :], (n_dyn, C, L)
    ).at[:, 0].set(p_init)
    # warm start (has_ws static, ws_valid a traced bool): seed the boundary
    # carries from a previous converged solve — e.g. the prior EM
    # iteration's, where the tuning (hence the carries) moved only
    # slightly.  Chunk 0's input stays the exact initial carry, and the
    # convergence certificate (delta <= tol) is enforced regardless of the
    # seed, so exactness is unaffected; only the pass count changes.
    if has_ws:
        ins0 = jnp.where(ws_valid, fwd_ws, ins0).at[:, 0].set(p_init)

    fwd = functools.partial(_pfilter_pass, tc_eff=tc_eff, n_valid=T)

    # ``fast`` (fused-EM path): exit on the PREDICTED RESIDUAL instead of
    # the raw movement.  The fixed point contracts by a factor lam per
    # pass (a mixing property of the transition/emission structure, stable
    # across EM iterations); the residual after a pass that moved the
    # carries by delta is ~lam*delta, so once lam is known from the
    # PREVIOUS solve (its emit pass's measured residual / its measured
    # drift) the loop can stop after ONE pass where the raw-movement test
    # needed two.  The entry test compares 4x the previous drift against
    # tol: a seed already within tol/4 skips every finals pass and the emit
    # runs straight from it.  Every fast solve is certified post-hoc: the
    # emit pass's own finals measure the ACTUAL residual
    # |F(ins_used)-ins_used| (diag[4:6]), bulk-checked by the fit_em
    # driver.  Strict mode keeps the raw-movement test.
    if fast and has_ws:
        lam_f = jnp.where(
            ws_valid,
            jnp.clip(ws_pred[2] / jnp.maximum(ws_pred[0], 1e-30),
                     1e-12, 1.0),
            jnp.float32(1.0),
        )
        pred_f = jnp.where(ws_valid, 4.0 * ws_pred[0] / lam_f, jnp.inf)
    else:
        lam_f = jnp.float32(1.0)
        pred_f = jnp.array(jnp.inf, jnp.float32)

    def fwd_body(state):
        ins, _delta, k = state
        _, _, fin = fwd(w_c, tlat, tdyn, ins, finals_only=True)
        new_ins = jnp.concatenate([ins[:, :1], fin[:, :-1]], axis=1)
        delta = jnp.max(jnp.abs(new_ins - ins))
        return new_ins, delta, k + 1

    def fwd_cond(state):
        _, delta, k = state
        return jnp.logical_and(delta * lam_f > tol, k < max_passes)

    # strict cold solves always run at least one finals pass; a warm or
    # fast solve may need none
    if has_ws or fast:
        fstate = (ins0, pred_f, jnp.array(0, jnp.int32))
    else:
        fstate = fwd_body(
            (ins0, jnp.array(jnp.inf, jnp.float32), jnp.array(0, jnp.int32))
        )
    ins_used, fwd_delta, fwd_passes = lax.while_loop(
        fwd_cond, fwd_body, fstate
    )
    # the emit pass stores the per-step normalizers (the exact values used
    # in the recursion) alongside the posteriors
    post_c, svals, fin_emit = fwd(w_c, tlat, tdyn, ins_used,
                                  finals_only=False)
    ratios = (
        jnp.log(jnp.transpose(svals).reshape(-1)[:T])
        + likelihood_scale * m
    )
    log_marginal = jnp.sum(ratios)

    c_star = (T - 1) // tc_eff
    r_star = (T - 1) % tc_eff
    # Two statically-gated tails.  want_carry=False (standalone strict
    # solves: host EM iterations, decode) exports no boundary carries;
    # want_carry=True (inside the fused EM scan, where the carries ride
    # the scan state) computes the fresh boundary carries, drift
    # predictors and post-hoc certificates, and reads post_T1 from the
    # emit finals (fin_emit[:, c_star] == post_c[r_star, :, c_star]: rows
    # past n_valid are carry no-ops).  The optimization barriers end the
    # forward phase before the backward phase allocates, so the weights
    # are dead while the smoother outputs are live.
    if want_carry:
        emit_ins_f = jnp.concatenate(
            [ins_used[:, :1], fin_emit[:, :-1]], axis=1
        )
        emit_delta_f = jnp.max(jnp.abs(emit_ins_f - ins_used))
        # drift = how far the converged carries moved from the seed — the
        # predictor for the NEXT same-shape solve's movement (consecutive
        # EM iterations drift comparably, decaying as EM settles).  For a
        # skipped-loop fast solve (fwd_passes == 0) this equals the emit
        # pass's own residual, i.e. the true one-pass movement.
        fwd_drift = jnp.max(jnp.abs(emit_ins_f - ins0))
        post_T1 = fin_emit[:, c_star, :]  # (n_dyn, L), exact
        (post_c, ratios, log_marginal, post_T1, emit_ins_f, emit_delta_f,
         fwd_drift) = lax.optimization_barrier(
            (post_c, ratios, log_marginal, post_T1, emit_ins_f,
             emit_delta_f, fwd_drift)
        )
    else:
        post_c, ratios, log_marginal = lax.optimization_barrier(
            (post_c, ratios, log_marginal)
        )
        post_T1 = post_c[r_star, :, c_star, :]  # (n_dyn, L), exact

    # ---- backward fixed point (finals-only loop + one emitting pass) ----
    guess = jnp.concatenate(
        [post_c[0][:, 1:, :], post_T1[:, None, :]], axis=1
    )
    if has_ws:
        guess = jnp.where(ws_valid, bwd_ws, guess)
    guess = guess.at[:, c_star:, :].set(post_T1[:, None, :])

    bwd = functools.partial(
        _psmooth_pass, tc_eff=tc_eff, n_valid=T, marginal=marginal,
    )

    def bwd_shift(fin):
        new_ins = jnp.concatenate(
            [fin[:, 1:, :], post_T1[:, None, :]], axis=1
        )
        return new_ins.at[:, c_star:, :].set(post_T1[:, None, :])

    # fast mode: predicted-residual exit, see the forward loop's comment
    if fast and has_ws:
        lam_b = jnp.where(
            ws_valid,
            jnp.clip(ws_pred[3] / jnp.maximum(ws_pred[1], 1e-30),
                     1e-12, 1.0),
            jnp.float32(1.0),
        )
        pred_b = jnp.where(ws_valid, 4.0 * ws_pred[1] / lam_b, jnp.inf)
    else:
        lam_b = jnp.float32(1.0)
        pred_b = jnp.array(jnp.inf, jnp.float32)

    def bwd_body(state):
        ins, _delta, k = state
        (fin,) = bwd(post_c, tlat, tdyn, ins, finals_only=True)
        new_ins = bwd_shift(fin)
        delta = jnp.max(jnp.abs(new_ins - ins))
        return new_ins, delta, k + 1

    def bwd_cond(state):
        _, delta, k = state
        return jnp.logical_and(delta * lam_b > tol, k < max_passes)

    if has_ws or fast:
        bstate = (guess, pred_b, jnp.array(0, jnp.int32))
    else:
        bstate = bwd_body(
            (guess, jnp.array(jnp.inf, jnp.float32),
             jnp.array(0, jnp.int32))
        )
    ins_bwd, bwd_delta, bwd_passes = lax.while_loop(
        bwd_cond, bwd_body, bstate
    )
    emit = bwd(post_c, tlat, tdyn, ins_bwd, finals_only=False,
               want_acc=want_acc)
    if marginal and not want_acc:
        out_c, dynm_c, fin_b = emit
        acc_raw = None
    elif marginal:
        out_c, dynm_c, acc_raw, fin_b = emit
    else:
        out_c, r_c, fin_b = emit
        dynm_c = None
        # the pairwise-joint contraction over (t, c) (invalid rows carry
        # r == 0)
        acc_raw = (
            jnp.einsum("tdci,tecj->deij", post_c, r_c, precision=HIGHEST)
            if want_acc else None
        )
    if want_carry:
        emit_ins_b = bwd_shift(fin_b)
        emit_delta_b = jnp.max(jnp.abs(emit_ins_b - ins_bwd))
        bwd_drift = jnp.max(jnp.abs(emit_ins_b - guess))
        (out_c, dynm_c, acc_raw, emit_ins_b, emit_delta_b,
         bwd_drift) = lax.optimization_barrier(
            (out_c, dynm_c, acc_raw, emit_ins_b, emit_delta_b,
             bwd_drift)
        )

    acc = (
        acc_raw * tdyn[:, :, None, None] * tlat[None, :, :, :]
    ) if acc_raw is not None else None

    # ---- reassemble global-time outputs ----
    if marginal:
        smooth_lat = _chunk_to_flat(out_c, tc_eff, T)  # (T, L)
        dynm = _chunk_to_flat(dynm_c[..., None], tc_eff, T)[:, :, 0]
        smooth_out = (smooth_lat, dynm)
    else:
        smooth_out = _chunk_to_flat(out_c, tc_eff, T)
    post_out = _chunk_to_flat(post_c, tc_eff, T) if want_post else None
    ll_out = ll if want_post else None  # pass the donated buffer back out
    # diag grows the emit-pass post-hoc residuals only when the carries
    # are requested
    diag = (fwd_passes, bwd_passes, fwd_delta, bwd_delta)
    if want_carry:
        diag = diag + (emit_delta_f, emit_delta_b)
    # pred vector = [drift_f, drift_b, emit_resid_f, emit_resid_b]: the
    # next same-shape fast solve derives its contraction estimate
    # lam = resid/drift and its entry test from these
    carries = (
        (emit_ins_f, emit_ins_b,
         jnp.stack([fwd_drift, bwd_drift, emit_delta_f, emit_delta_b]))
        if want_carry else None
    )
    return smooth_out, log_marginal, post_out, ratios, acc, ll_out, diag, \
        carries


def carry_spec(T, L, n_dyn, config=None):
    """Shape of the warm-start boundary-carry arrays for this problem:
    (n_dyn, C, L), or None when the parallel engine does not apply."""
    if config is None:
        config = choose_parallel_config(T, L, n_dyn)
    if config is None:
        return None
    return (max(1, n_dyn), config, L)


def smooth_parallel(ll, tlat, tdyn, p_init, likelihood_scale, *,
                    marginal=False, want_post=False, config=None,
                    max_passes=None, tol=STRICT_TOL, warm_start=None,
                    fast=False, want_carry=False, want_acc=True):
    """Fixed-point parallel-in-time forward-backward smoother.

    ll: (T, L) log-likelihood; tlat: (n_dyn, L, L); tdyn: (n_dyn, n_dyn);
    p_init: (n_dyn, L) probability-space initial carry; ``config``: the
    chunk count C (default :func:`choose_parallel_config`).

    Returns (smooth, log_marginal, post, ratios, acc, ll, diag, carries) in
    PROBABILITY space, where smooth is (T, n_dyn, L) or the (latent_marg
    (T, L), dyn_marg (T, n_dyn)) pair when ``marginal``, acc is the
    accumulated pairwise joint (n_dyn, n_dyn, L, L), ll echoes the (donated)
    input log-likelihood when ``want_post`` (None otherwise), diag =
    (fwd_passes, bwd_passes, fwd_delta, bwd_delta) — extended with
    (emit_delta_f, emit_delta_b), the emit passes' post-hoc residuals, when
    ``want_carry`` — and carries = (fwd, bwd, pred(4,)) — the
    freshest boundary carries ((n_dyn, C, L) each, see :func:`carry_spec`)
    plus pred = [drift_f, drift_b, emit_resid_f, emit_resid_b], the
    measured per-direction fixed-point movement and emit residual — when
    ``want_carry``, else None.

    ``warm_start``: optional ``(fwd, bwd, pred, valid)`` — the ``carries``
    of a previous same-shape solve (e.g. the prior EM iteration) plus a
    traced bool.  In strict mode (``fast=False``, the default) a warm seed
    still passes the full pre-emit delta <= tol certificate.  With
    ``fast=True`` the loop exits on the PREDICTED residual lam*delta
    (lam = previous emit residual / previous drift, the measured per-pass
    contraction) — typically ONE finals pass + the emit pass per
    direction — and a seed whose predicted error 4*drift is already <= tol
    skips every finals pass, the emit running straight from it.  Every
    fast solve is certified post-hoc by the emit pass's own residual
    (diag[4:6]), which the caller must check in bulk.

    ``want_acc=False`` returns ``acc=None`` and skips the pairwise-joint
    contraction (~2*n_dyn^2*T*L^2 FLOPs), which the fused mid-EM iterations
    discard.  NOTE: the caller's ``ll`` buffer is DONATED."""
    T, L = ll.shape
    n_dyn = tlat.shape[0]
    C = choose_parallel_config(T, L, n_dyn) if config is None else config
    if C is None:
        raise ValueError(
            f"problem too small for the parallel engine (T={T})"
        )
    tc_eff = -(-T // C)
    if max_passes is None:
        max_passes = C
    has_ws = warm_start is not None
    if not has_ws:
        # statically absent: tiny dummies keep the jit signature stable
        # while the traced program contains no warm-start ops at all
        warm_start = (
            jnp.zeros((1, 1, 1), jnp.float32),
            jnp.zeros((1, 1, 1), jnp.float32),
            jnp.full((4,), jnp.inf, jnp.float32), jnp.array(False),
        )
    fwd_ws, bwd_ws, ws_pred, ws_valid = warm_start
    return _smooth_parallel_jit(
        jnp.asarray(ll, dtype=jnp.float32),
        jnp.asarray(tlat, dtype=jnp.float32),
        jnp.asarray(tdyn, dtype=jnp.float32),
        jnp.asarray(p_init, dtype=jnp.float32),
        likelihood_scale,
        jnp.asarray(fwd_ws, dtype=jnp.float32),
        jnp.asarray(bwd_ws, dtype=jnp.float32),
        jnp.asarray(ws_pred, dtype=jnp.float32),
        ws_valid,
        C=C, tc_eff=tc_eff, T=T, marginal=marginal,
        want_post=want_post, max_passes=int(max_passes), tol=float(tol),
        fast=bool(fast), want_carry=bool(want_carry), has_ws=has_ws,
        want_acc=bool(want_acc),
    )
