"""Multi-chip SPMD inference/EM over a ('data', 'time', 'neuron') device mesh.

The reference is single-process, single-device (SURVEY.md §2.5); this module
is the scaling layer built on ``jax.shard_map`` + XLA collectives (NCCL on
GPUs; the mesh follows the algorithm, since every card reaches every other
at the same rate):

* **data** (DP): independent chains/configs/sessions — the reference's main
  fan-out surface (model_selection_helper.py's serial loops become one SPMD
  program).
* **neuron** (TP): the emission log-likelihood is a sum over neurons
  (reference decoder.py:43), so each shard computes its neurons' partial
  (T, L) term and a ``psum`` over 'neuron' completes it.  The M-step
  decouples over neurons entirely (objective and prior are per-neuron sums),
  so params/opt-state shard over the neuron axis; only the scalar loss used
  by the Adam stopping rule is psum'd (keeping the reference's global-loss
  convergence semantics, fit_tuning_helper.py:154-164).
* **time** (SP), two engines:

  - **cross-mesh fixed-point parallel-in-time scans** (``time_engine=
    'pscan'``, the default for single sequences): every device advances its
    local C chunks simultaneously with the same ops/pallas/parallel_scan
    passes as one device, chunk-boundary carries cross devices via one
    ``ppermute`` per
    pass, and global convergence is a ``pmax`` of boundary deltas.  A
    device boundary is just another chunk boundary, so the mesh converges
    in the same 2-3 passes as one chip and each pass costs
    O(T / (n_time * C)) sequential steps — the time axis MULTIPLIES chunk
    parallelism.  Exact at convergence (fixed-point certificate), pass
    count capped at n_time * C.
  - **software-pipelined staged ppermute schedule** (``'pipeline'``): at
    global step k, time-shard s runs chain b = k - s's local chunk scan and
    hands the boundary carry to shard s+1.  Chains stream through the shard
    pipeline, so a batch of B chains costs (B + n_time - 1) stage-times
    instead of B * n_time — the right schedule for many-chain fan-out.
    Exact — same semantics as the reference's host chunk loop
    (decoder.py:283-324) with the carry crossing devices instead of staying
    in device memory.

  Per-device memory is O(B * T / n_time) either way.

Pipeline parallelism (PP) and expert parallelism (EP) have no counterpart in
this model family (no layer stack, no MoE — SURVEY.md §2.5); sequence
parallelism here plays the role the reference's time chunking played.

Why a ppermute pipeline and not an associative scan: the filter recursion
is linear in the unnormalized state (u_t = diag(w_t) M^T u_{t-1}), so a
time-parallel prefix scan over (S, S) transition operators (S = n_dyn * L)
is mathematically available.  But composing operators costs O(S^3) per
combine versus O(S^2) per sequential matvec step: each shard's local
operator product multiplies total FLOPs by S (~200-1000 here).  The
associative formulation only wins beyond ~S chips; at realistic slice
sizes the exact carry hand-off pipeline (plus full parallelism of all the
matmul-shaped work) dominates, so that is what this module implements.

Arbitrary T and N are supported by exact padding: neurons pad with
zero-masked columns (their LL contribution is identically 0), time pads
with zero-masked rows — a padded step has uniform likelihood, so its filter
ratio is log(1) = 0 (no log-marginal contribution) and its backward pull
factor is exactly 1 (no smoothing contribution); padded rows are sliced off
on the way out and masked out of the pairwise-joint accumulation.
"""

from __future__ import annotations

from functools import lru_cache as _lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from poor_man_gplvm_tpu.ops.emissions import (
    MASK_NEG,
    gaussian_loglik,
    poisson_loglik,
)
from poor_man_gplvm_tpu.ops.hmm import (
    _backward_scan_prob_ratios,
    _forward_scan_prob,
    prob_to_log,
)
from poor_man_gplvm_tpu.ops import emissions as _emissions
from poor_man_gplvm_tpu.ops import mstep as fth

__all__ = [
    "factorize_devices",
    "make_mesh",
    "sharded_smooth",
    "make_sharded_em_step",
    "make_sharded_poisson_em_step",
]


def factorize_devices(n, batch=1, n_neuron=None, n_time=None):
    """Split n devices into (data, time, neuron) axis sizes.

    Heuristic cost model: data parallelism is free (independent chains), so
    it gets the largest divisor of n that is <= ``batch``.  Of the rest,
    time sharding buys O(T/d_time) per-device memory on the dominant scale
    (sequence length) plus pipeline throughput for batched chains, while
    neuron sharding parallelizes the emission matmuls and the M-step with a
    single psum — worth ~2 ways until N_local gets too small to fill a
    matmul.  Default split: time-heavy with neuron capped at 2.  Callers
    with different shapes (e.g. N=2000 neurons, short sequences) pass
    ``n_neuron``/``n_time`` to request axis sizes explicitly."""
    if n_neuron is not None or n_time is not None:
        # explicit axis requests are hard constraints; ``batch`` is only an
        # upper bound on the free data axis, so satisfy the explicit axes
        # FIRST and give data the largest fitting divisor of what remains
        # (a greedy data axis would e.g. reject n=8, batch=4, n_time=8,
        # which the (1, 8, 1) mesh satisfies)
        fixed = (n_time or 1) * (n_neuron or 1)
        if n % fixed:
            raise ValueError(
                f"time({n_time}) * neuron({n_neuron}) = {fixed} does not "
                f"divide {n} devices"
            )
        rest = n // fixed
        data = 1
        while data * 2 <= rest and data * 2 <= batch and rest % (data * 2) == 0:
            data *= 2
        if n_neuron is None:
            n_neuron = rest // data
        elif n_time is None:
            n_time = rest // data
        elif data != rest and rest <= batch:
            # both axes pinned: data must absorb the rest exactly (but
            # never beyond the caller's batch bound — a data axis larger
            # than the chain batch cannot be sharded downstream)
            data = rest
        if data * n_time * n_neuron != n:
            raise ValueError(
                f"data({data}) * time({n_time}) * neuron({n_neuron}) != {n}; "
                f"pass batch/n_time/n_neuron that factor the device count"
            )
        return data, n_time, n_neuron
    data = 1
    while data * 2 <= n and data * 2 <= batch and n % (data * 2) == 0:
        data *= 2
    rest = n // data
    neuron = 1
    if rest % 2 == 0 and rest > 2:
        neuron = 2
    time = rest // neuron
    return data, time, neuron


def make_mesh(n_devices=None, batch=1, devices=None, shape=None,
              n_neuron=None, n_time=None):
    """Build a ('data', 'time', 'neuron') mesh over the available devices.

    ``shape``: explicit (data, time, neuron) tuple overriding the heuristic;
    ``n_neuron``/``n_time``: request single axis sizes (the rest inferred)."""
    if devices is None:
        devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    if shape is not None:
        if int(np.prod(shape)) != n_devices:
            raise ValueError(
                f"mesh shape {tuple(shape)} does not multiply to "
                f"{n_devices} devices"
            )
    else:
        shape = factorize_devices(
            n_devices, batch, n_neuron=n_neuron, n_time=n_time
        )
    arr = np.array(devices[:n_devices]).reshape(shape)
    return Mesh(arr, ("data", "time", "neuron"))


# ---------------------------------------------------------------------------
# building blocks used inside shard_map
# ---------------------------------------------------------------------------


def _ll_partial(y, tuning, ma2d, emission, noise_std, dt=1.0):
    """Per-neuron-shard partial emission LL (T_local, L): psum over
    'neuron' completes it.  Latent masks are applied post-psum.  Reuses the
    matmul forms from ops.emissions with an all-ones latent mask.
    ``dt`` may be a scalar or a per-time (T_local,) vector (the gain
    model's changing-dt path, reference decoder.py:73-85)."""
    ones_lat = jnp.ones(tuning.shape[0], dtype=bool)
    if emission == "poisson":
        return poisson_loglik(y, tuning, ma2d, ones_lat, dt=dt)
    return gaussian_loglik(y, tuning, noise_std, ma2d, ones_lat, dt=dt)


def _commit(buf, new, b, valid):
    """Write ``new`` into buf[b] when valid, else keep buf[b] (b clipped)."""
    cur = lax.dynamic_index_in_dim(buf, b, axis=0, keepdims=False)
    return lax.dynamic_update_index_in_dim(
        buf, jnp.where(valid, new, cur), b, axis=0
    )


def _match_vma(x, target_vma):
    """Promote x to vary over ``target_vma`` so loop carries type-check
    under shard_map's varying-mesh-axes tracking (loop-carried values must
    enter with the vma they leave with)."""
    missing = tuple(target_vma - jax.typeof(x).vma)
    return lax.pcast(x, missing, to="varying") if missing else x


def _staggered_forward(ll, trans, likelihood_scale, axis_name):
    """Software-pipelined exact causal filter over a time-sharded batch.

    ll: (B_local, T_local, L).  At global step k, time-shard s runs chain
    b = k - s's local scan, so B chains drain in (B_local + n_time - 1)
    stage-times.  Shard s's received carry at step k is always shard s-1's
    step-(k-1) output for the same chain, so the hand-off is exact.

    Returns post (B_local, T_local, *state), ratios (B_local, T_local)
    [per-step log marginal ratios], lml (B_local,), final_post
    (B_local, *state) — the last two broadcast to all shards.  The causal
    priors are NOT stored: ``prior[t+1] == trans.push(post[t])`` exactly
    (see ``_forward_scan_prob``), so the backward pass reconstructs them
    with one batched push — halving the pipeline's per-device state."""
    nt = lax.axis_size(axis_name)
    idx = lax.axis_index(axis_name)
    Bl, Tl = ll.shape[0], ll.shape[1]
    state_shape = trans.uniform_log_init().shape
    # loop-carried values must enter the fori_loop varying over the same
    # mesh axes they leave with (ll's axes plus the time axis via idx)
    vma = jax.typeof(ll).vma | {axis_name}
    prom = partial(_match_vma, target_vma=vma)
    fresh = (
        prom(jnp.exp(trans.uniform_log_init()).astype(ll.dtype)),
        prom(jnp.array(0.0, dtype=ll.dtype)),
    )

    post = prom(jnp.zeros((Bl, Tl) + state_shape, dtype=ll.dtype))
    ratios = prom(jnp.zeros((Bl, Tl), dtype=ll.dtype))
    lml = prom(jnp.zeros((Bl,), dtype=ll.dtype))
    final_post = prom(jnp.zeros((Bl,) + state_shape, dtype=ll.dtype))

    perm_fwd = [(i, i + 1) for i in range(nt - 1)]

    def step_k(k, val):
        recv, post, ratios, lml, final_post = val
        b = k - idx
        valid = (b >= 0) & (b < Bl)
        bc = jnp.clip(b, 0, Bl - 1)
        # shard 0 always starts a fresh chain; everyone else continues the
        # carry received from the previous shard
        carry0 = jax.tree.map(
            lambda f, r: jnp.where(idx == 0, f, r), fresh, recv
        )
        ll_b = lax.dynamic_index_in_dim(ll, bc, axis=0, keepdims=False)
        p_out, _pr_out, ra_out, carry_out = _forward_scan_prob(
            ll_b, trans, carry0, likelihood_scale
        )
        post = _commit(post, p_out, bc, valid)
        ratios = _commit(ratios, ra_out, bc, valid)
        on_last = valid & (idx == nt - 1)
        lml = _commit(lml, carry_out[1], bc, on_last)
        final_post = _commit(final_post, carry_out[0], bc, on_last)
        recv = jax.tree.map(
            lambda x: lax.ppermute(x, axis_name, perm_fwd), carry_out
        )
        return recv, post, ratios, lml, final_post

    _, post, ratios, lml, final_post = lax.fori_loop(
        0, Bl + nt - 1, step_k,
        (fresh, post, ratios, lml, final_post),
    )
    # broadcast the last shard's finals to every time shard
    def _bcast(x):
        return lax.psum(
            jnp.where(idx == nt - 1, x, jnp.zeros_like(x)), axis_name
        )

    return post, ratios, _bcast(lml), _bcast(final_post)


def _backward_scan_with_ratios(filt_xs, prior_xs, trans, smooth_init):
    """The single-device backward step body (hmm._backward_scan_prob_ratios);
    the pairwise-joint accumulation happens at the pipeline level after
    masking out padded / global-last rows."""
    return _backward_scan_prob_ratios(filt_xs, prior_xs, trans, smooth_init)


def _staggered_backward(filt, trans, axis_name, n_time_valid=None):
    """Software-pipelined exact smoother (reverse stage order) over a
    time-sharded batch.  filt: (B_local, T_local, *state).

    The +1-shifted causal priors the smoother consumes are reconstructed
    locally with one batched transition push — ``prior[t+1] ==
    trans.push(post[t])`` bit-exactly (see ``_forward_scan_prob``; same
    identity as hmm's filterstore mode), and a non-last shard's
    next-shard-first-prior is the push of its OWN last posterior, so no
    prior buffer and no extra ppermute are needed.

    Uniform-shape trick: the globally last row is made a no-op by feeding a
    ones carry/prior (pull ratio == 1, so smooth == filt there, matching
    reference decoder.py:236-254); its spurious pairwise-joint term — and
    those of any padded rows past ``n_time_valid`` — are masked out of the
    accumulation.  Returns smooth (B_local, T_local, *state) and the
    psum'd accumulated joint acc (B_local, *joint_shape)."""
    nt = lax.axis_size(axis_name)
    idx = lax.axis_index(axis_name)
    Bl, Tl = filt.shape[0], filt.shape[1]
    is_last = idx == nt - 1
    vma = jax.typeof(filt).vma | {axis_name}
    prom = partial(_match_vma, target_vma=vma)

    perm_bwd = [(i + 1, i) for i in range(nt - 1)]
    prior_shifted = jax.vmap(trans.push_batch)(filt)
    ones_state = prom(jnp.ones_like(filt[:, 0]))  # (Bl, *state)
    # the globally last row's prior is the ones no-op, not push(post[-1])
    prior_shifted = jnp.where(
        is_last,
        jnp.concatenate(
            [prior_shifted[:, :-1], ones_state[:, None]], axis=1
        ),
        prior_shifted,
    )

    smooth = prom(jnp.zeros_like(filt))
    ratios_r = prom(jnp.zeros_like(filt))
    ones_one = ones_state[0]

    def step_k(k, val):
        recv, smooth, ratios_r = val
        # chain b's backward visits shard nt-1 at step b, shard s at
        # step b + (nt-1-s)
        b = k - (nt - 1 - idx)
        valid = (b >= 0) & (b < Bl)
        bc = jnp.clip(b, 0, Bl - 1)
        carry0 = jnp.where(is_last, ones_one, recv)
        filt_b = lax.dynamic_index_in_dim(filt, bc, axis=0, keepdims=False)
        prior_b = lax.dynamic_index_in_dim(
            prior_shifted, bc, axis=0, keepdims=False
        )
        sm_out, r_out = _backward_scan_with_ratios(
            filt_b, prior_b, trans, carry0
        )
        smooth = _commit(smooth, sm_out, bc, valid)
        ratios_r = _commit(ratios_r, r_out, bc, valid)
        recv = lax.ppermute(sm_out[0], axis_name, perm_bwd)
        return recv, smooth, ratios_r

    _, smooth, ratios_r = lax.fori_loop(
        0, Bl + nt - 1, step_k, (ones_one, smooth, ratios_r)
    )

    # pairwise-joint accumulation: row t pairs states (t, t+1), so real
    # pairs are t in [0, T_valid - 2]; mask padded rows and the final row
    global_t = idx * Tl + jnp.arange(Tl)
    if n_time_valid is None:
        n_time_valid = nt * Tl
    keep = (global_t < n_time_valid - 1).astype(filt.dtype)
    keep = keep.reshape((1, Tl) + (1,) * (filt.ndim - 2))
    acc = jax.vmap(trans.outer_acc)(filt, ratios_r * keep)
    acc = lax.psum(acc, axis_name)
    return smooth, acc


# ---------------------------------------------------------------------------
# cross-mesh fixed-point parallel-in-time scans (time_engine='pscan')
# ---------------------------------------------------------------------------


def _pscan_smooth_local(ll, trans, scale, t_true, axis_name, tol=None):
    """Per-shard body of the cross-mesh fixed-point smoother.

    KEEP IN SYNC with ops/pallas/parallel_scan._smooth_parallel_jit: the
    chunk-layout packing, boundary-shift rules and validity bounds here
    mirror the single-device driver with the shifts crossing devices via
    ppermute; a numerics or layout change there must land here too (both
    are pinned by equality tests against the prob engine).

    Each device holds a contiguous time shard and runs the
    ops/pallas/parallel_scan passes over its LOCAL C chunks; the
    chunk-boundary carries cross devices with one ``ppermute`` per pass and
    global convergence is a ``pmax`` of the per-device boundary deltas.  A
    device boundary behaves exactly like a chunk boundary, so the whole
    mesh converges in the same 2-3 passes as a single chip, and each pass
    costs O(T / (n_time * C)) sequential steps.  Exact at convergence
    (same fixed-point certificate as the single-chip engine), pass count
    capped at n_time * C where the result is exact by induction.

    ll: (T_local, L) post-psum local log-likelihood (padded rows beyond
    ``t_true`` are hard no-ops via the passes' dynamic validity bound).
    Returns (log_smooth, lml, log_post, ratios, log_acc) — local rows for
    the time-sharded outputs, replicated scalars/acc."""
    from poor_man_gplvm_tpu.ops.pallas import parallel_scan as _ps

    tol = _ps.STRICT_TOL if tol is None else tol
    nt = lax.axis_size(axis_name)
    idx = lax.axis_index(axis_name)
    Tl, L = ll.shape
    is_joint = hasattr(trans, "Tdyn")
    n_dyn = trans.Tdyn.shape[0] if is_joint else 1
    tlat = trans.Tlat if is_joint else trans.T[None]
    tdyn = (
        trans.Tdyn if is_joint else jnp.ones((1, 1), dtype=jnp.float32)
    )
    C = _ps.choose_parallel_config(Tl, L, n_dyn)
    if C is None:
        # local shard too short for the single-device heuristics (tests,
        # tiny problems): a minimal config is still correct — with C=1
        # the fixed point parallelizes purely across devices
        C = max(1, min(16, Tl // 16))
    tc_eff = -(-Tl // C)

    # local validity bounds (rows at global index >= t_true are padding)
    nv_fwd = jnp.clip(t_true - idx * Tl, 0, Tl)
    # backward pass recurses rows with local j < nv - 1
    nv_bwd = jnp.clip(t_true - 1 - idx * Tl, 0, Tl) + 1

    # ---- local chunk-layout weights ----
    m = jnp.max(ll, axis=1)
    w = jnp.exp(scale * (ll - m[:, None]))
    w_flat = jnp.zeros((C * tc_eff, L), dtype=jnp.float32).at[:Tl].set(w)
    w_c = jnp.transpose(w_flat.reshape(C, tc_eff, L), (1, 0, 2))
    tlat_f = tlat.astype(jnp.float32)
    tdyn_f = tdyn.astype(jnp.float32)

    init_p = jnp.exp(trans.uniform_log_init())
    if not is_joint:
        init_p = init_p[None]
    uniform_p = jnp.full((n_dyn, L), 1.0 / (n_dyn * L), dtype=jnp.float32)

    vma = jax.typeof(ll).vma | {axis_name}
    prom = partial(_match_vma, target_vma=vma)
    # the passes' scan carries must keep one varying-mesh-axes type;
    # promote the replicated transition matrices to match the data
    tlat_f, tdyn_f = prom(tlat_f), prom(tdyn_f)

    ins0 = jnp.broadcast_to(uniform_p[:, None, :], (n_dyn, C, L))
    ins0 = prom(jnp.where(
        (idx == 0)
        & (jax.lax.broadcasted_iota(jnp.int32, (1, C, 1), 1) == 0),
        init_p[:, None, :], ins0,
    ))

    fwd = partial(_ps._pfilter_pass, tc_eff=tc_eff, n_valid=nv_fwd)
    perm_f = [(i, i + 1) for i in range(nt - 1)]
    max_passes = nt * C

    def gshift_f(fin):
        recv = lax.ppermute(fin[:, -1], axis_name, perm_f)
        first = jnp.where(idx == 0, init_p, recv)
        return jnp.concatenate([first[:, None], fin[:, :-1]], axis=1)

    def f_body(state):
        ins, _delta, k = state
        _, _, fin = fwd(w_c, tlat_f, tdyn_f, ins, finals_only=True)
        new_ins = gshift_f(fin)
        # pmax makes the delta axis-invariant; promote it back so the
        # loop carry's varying-mesh-axes type stays stable
        delta = prom(lax.pmax(jnp.max(jnp.abs(new_ins - ins)), axis_name))
        return new_ins, delta, k + 1

    def fp_cond(state):
        _, delta, k = state
        return jnp.logical_and(delta > tol, k < max_passes)

    fstate = f_body(
        (ins0, prom(jnp.array(jnp.inf, jnp.float32)),
         prom(jnp.array(0, jnp.int32)))
    )
    ins_used, _fd, _fk = lax.while_loop(fp_cond, f_body, fstate)
    # the emit pass stores the per-step normalizers (invalid rows hold 1.0)
    post_c, svals, _fin = fwd(w_c, tlat_f, tdyn_f, ins_used,
                              finals_only=False)
    ratios = jnp.log(jnp.transpose(svals).reshape(-1)[:Tl]) + scale * m
    global_t = idx * Tl + jnp.arange(Tl)
    ratios = jnp.where(global_t < t_true, ratios, 0.0)
    lml = lax.psum(jnp.sum(ratios), axis_name)

    # ---- backward ----
    local_j = t_true - 1 - idx * Tl  # local index of the global last row
    owner = jnp.logical_and(local_j >= 0, local_j < Tl)
    past = local_j < 0
    jc = jnp.clip(local_j, 0, Tl - 1)
    c_j, tau_j = jc // tc_eff, jc % tc_eff
    pt_local = lax.dynamic_slice(
        post_c, (tau_j, 0, c_j, 0), (1, n_dyn, 1, L)
    )[0, :, 0, :]
    pt1 = lax.psum(jnp.where(owner, pt_local, 0.0), axis_name)
    chunk_ids = jnp.arange(C)
    ovr = jnp.where(owner, chunk_ids >= c_j, past)  # (C,)

    def apply_ovr(ins):
        return jnp.where(ovr[None, :, None], pt1[:, None, :], ins)

    perm_b = [(i + 1, i) for i in range(nt - 1)]

    def gshift_b(fin):
        recv = lax.ppermute(fin[:, 0], axis_name, perm_b)
        new_ins = jnp.concatenate([fin[:, 1:], recv[:, None]], axis=1)
        return apply_ovr(new_ins)

    recv_post0 = lax.ppermute(post_c[0][:, 0], axis_name, perm_b)
    guess = apply_ovr(jnp.concatenate(
        [post_c[0][:, 1:], recv_post0[:, None]], axis=1
    ))

    bwd = partial(
        _ps._psmooth_pass, tc_eff=tc_eff, n_valid=nv_bwd, marginal=False,
    )

    def b_body(state):
        ins, _delta, k = state
        (fin,) = bwd(post_c, tlat_f, tdyn_f, ins, finals_only=True)
        new_ins = gshift_b(fin)
        delta = prom(lax.pmax(jnp.max(jnp.abs(new_ins - ins)), axis_name))
        return new_ins, delta, k + 1

    bstate = b_body(
        (prom(guess), prom(jnp.array(jnp.inf, jnp.float32)),
         prom(jnp.array(0, jnp.int32)))
    )
    ins_bwd, _bd, _bk = lax.while_loop(fp_cond, b_body, bstate)
    out_c, r_c, _f = bwd(post_c, tlat_f, tdyn_f, ins_bwd, finals_only=False)

    # r rows are zeroed on invalid steps inside the pass, so the local
    # contraction sums only real (t, t+1) pairs; psum completes it
    acc_raw = jnp.einsum("tdci,tecj->deij", post_c, r_c,
                         precision=jax.lax.Precision.HIGHEST)
    acc_raw = lax.psum(acc_raw, axis_name)
    # scale with the UNpromoted (replicated) matrices so acc stays
    # axis-invariant, matching its P() out_spec
    acc = (
        acc_raw * tdyn.astype(jnp.float32)[:, :, None, None]
        * tlat[None, :, :, :]
    )
    if not is_joint:
        acc = acc[0, 0]

    smooth_l = _ps._chunk_to_flat(out_c, tc_eff, Tl)
    post_l = _ps._chunk_to_flat(post_c, tc_eff, Tl)
    if not is_joint:
        smooth_l, post_l = smooth_l[:, 0], post_l[:, 0]
    return (
        prob_to_log(smooth_l),
        lml,
        prob_to_log(post_l),
        ratios,
        prob_to_log(acc),
    )


# ---------------------------------------------------------------------------
# drop-in sharded smoother (single sequence) for the model classes
# ---------------------------------------------------------------------------


def _pad_axis(arr, axis, mult):
    n = arr.shape[axis]
    pad = (-n) % mult
    if pad == 0:
        return arr
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, pad)
    return jnp.pad(arr, widths)


def sharded_smooth(
    mesh,
    y,
    tuning,
    hyperparam,
    trans,
    ma_neuron,
    ma_latent=None,
    likelihood_scale=1.0,
    observation_model="poisson",
    dt_l=None,
    time_engine="auto",
):
    """Multi-chip forward-backward smoother: drop-in for
    ``hmm.smooth_combined_chunked`` returning the same 6-tuple
    ``(log_acausal, log_marginal_final, log_causal, log_one_step_pred,
    log_accumulated_joint, log_likelihood_all)`` (reference
    decoder.py:258-332) with time sharded over mesh['time'] and neurons
    over mesh['neuron'].  log_likelihood_all is None (the full (T, L) LL is
    never materialized unsharded).

    ``time_engine`` selects how the sequential scans cross the time axis:

    * ``'pscan'`` — cross-mesh fixed-point parallel-in-time scans: every
      device advances its local chunk batch simultaneously (the
      ops/pallas/parallel_scan passes locally), with chunk-boundary
      carries crossing devices via ``ppermute`` and global convergence by
      ``pmax``; a device boundary is just another chunk boundary, so the
      whole mesh converges in the same 2-3 passes as one device.  Wall-clock
      per pass is O(T / (n_time * C_local)) sequential steps — the time
      axis multiplies chunk parallelism instead of serializing.
    * ``'pipeline'`` — the exact staged-ppermute carry hand-off (one
      device active per stage for a single sequence; still the right
      schedule for many-chain batches via make_sharded_em_step).
    * ``'auto'`` (default) — 'pscan' when the local shard is long enough
      to chunk, else 'pipeline'.

    Works for both state spaces (JointTransition / LatentTransition) and
    both emissions.  T and N need not divide the mesh: padding is exact
    (module docstring)."""
    d_time = mesh.shape["time"]
    d_neuron = mesh.shape["neuron"]
    y = jnp.asarray(y, dtype=jnp.float32)
    T, N = y.shape
    L = tuning.shape[0]

    ma_neuron = jnp.asarray(ma_neuron, dtype=jnp.float32)
    ma2d = jnp.broadcast_to(ma_neuron, y.shape)
    if ma_latent is None:
        ma_latent = jnp.ones(L, dtype=jnp.float32)
    ma_latent = jnp.asarray(ma_latent, dtype=bool)

    noise_std = jnp.asarray(
        hyperparam.get("noise_std", 1.0), dtype=jnp.float32
    )
    if noise_std.ndim == 1:
        # pad per-neuron stds with 1.0 so log(std) stays finite (padded
        # neurons are fully masked, so their value never matters)
        pad = (-N) % d_neuron
        noise_std = jnp.concatenate(
            [noise_std, jnp.ones(pad, noise_std.dtype)]
        ) if pad else noise_std

    # exact padding: masked-out rows/columns contribute identically zero
    y_p = _pad_axis(_pad_axis(y, 0, d_time), 1, d_neuron)
    ma_p = _pad_axis(_pad_axis(ma2d, 0, d_time), 1, d_neuron)
    # padded tuning columns must stay positive for log(lam)
    pad_cols = (-N) % d_neuron
    tuning_p = (
        jnp.pad(tuning, ((0, 0), (0, pad_cols)), constant_values=1.0)
        if pad_cols else tuning
    )
    Tp = y_p.shape[0]

    # per-time dt (gain model): pad with 1.0 (padded rows are fully masked)
    if dt_l is None:
        dt_p = jnp.ones((Tp,), dtype=jnp.float32)
    else:
        dt_p = jnp.concatenate([
            jnp.broadcast_to(
                jnp.asarray(dt_l, dtype=jnp.float32), (T,)
            ),
            jnp.ones((Tp - T,), dtype=jnp.float32),
        ])
    if time_engine not in ("auto", "pscan", "pipeline"):
        raise ValueError(f"unknown time_engine {time_engine!r}")
    if time_engine == "auto":
        from poor_man_gplvm_tpu.ops.pallas.parallel_scan import (
            choose_parallel_config,
        )

        Tl = Tp // d_time
        n_dyn = trans.Tdyn.shape[0] if hasattr(trans, "Tdyn") else 1
        time_engine = (
            "pscan"
            if choose_parallel_config(Tl, L, n_dyn) is not None
            else "pipeline"
        )
    fn = _smooth_program(
        mesh, observation_model, dt_l is not None, noise_std.ndim == 1,
        time_engine,
    )
    log_smooth, lml, log_causal, ratios, log_acc = fn(
        y_p, tuning_p, ma_p, ma_latent, noise_std, dt_p,
        jnp.float32(likelihood_scale), jnp.int32(T), trans,
    )
    return (
        log_smooth[:T],
        lml,
        log_causal[:T],
        ratios[:T],
        log_acc,
        None,
    )


@_lru_cache(maxsize=32)
def _smooth_program(mesh, observation_model, has_dt, noise_is_vec,
                    time_engine="pipeline"):
    """Jitted sharded-smoother program, cached per (mesh, emission, dt/noise
    layout, time engine) so repeated calls (the EM loop) hit the jit trace
    cache instead of re-tracing every iteration.  Everything value-like —
    transition matrices, likelihood scale, valid length — enters as an
    operand."""

    def local(y_b, tuning_b, ma_b, ma_lat, noise_b, dt_b, scale, t_true,
              trans):
        idx = lax.axis_index("time")
        Tl = y_b.shape[0]
        ll = lax.psum(
            _ll_partial(
                y_b, tuning_b, ma_b, observation_model, noise_b,
                dt=dt_b if has_dt else 1.0,
            ),
            "neuron",
        )
        # latent mask on real rows only (padded rows must stay uniform so
        # they are exact no-ops)
        global_t = idx * Tl + jnp.arange(Tl)
        row_real = (global_t < t_true)[:, None]
        ll = jnp.where(row_real & ~ma_lat[None, :], MASK_NEG, ll)

        if time_engine == "pscan":
            return _pscan_smooth_local(ll, trans, scale, t_true, "time")

        post, ratios, lml, _final = _staggered_forward(
            ll[None], trans, scale, "time"
        )
        smooth, acc = _staggered_backward(
            post, trans, "time", n_time_valid=t_true
        )
        return (
            prob_to_log(smooth[0]),
            lml[0],
            prob_to_log(post[0]),
            ratios[0],
            prob_to_log(acc[0]),
        )

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(
            P("time", "neuron"),
            P(None, "neuron"),
            P("time", "neuron"),
            P(),
            P("neuron") if noise_is_vec else P(),
            P("time"),
            P(),
            P(),
            P(),  # trans pytree: replicated (prefix spec)
        ),
        out_specs=(P("time"), P(), P("time"), P("time"), P()),
    )
    return jax.jit(fn)


# ---------------------------------------------------------------------------
# the full sharded EM step (batched fan-out path)
# ---------------------------------------------------------------------------


def make_sharded_em_step(
    mesh,
    basis,
    trans,
    emission="poisson",
    param_prior_std=1.0,
    noise_std=0.5,
    likelihood_scale=1.0,
    m_step_size=0.01,
    m_maxiter=100,
    m_tol=1e-6,
):
    """Build a jitted multi-chip EM step.

    ``emission``: 'poisson' (softplus link, while-loop Adam M-step with the
    reference's global-loss stopping rule) or 'gaussian' (linear link,
    analytic ridge M-step — reference fit_tuning_helper.py:44-61 — which
    needs no communication beyond the psum'd sufficient statistics).
    ``trans``: JointTransition (jump models) or LatentTransition
    (latent-only models).

    Returns ``step(params, opt_state, log_post_latent, y) -> (params',
    opt_state', log_post_latent', log_marginal, final_loss)`` where

    - ``y``: (B, T, N) observations, sharded P('data', 'time', 'neuron')
    - ``params``: (B, n_basis, N), sharded P('data', None, 'neuron')
    - ``log_post_latent``: (B, T, L), sharded P('data', 'time', None)
    - ``log_marginal``: (B,), sharded P('data')

    One call = reference EM iteration i (M-step on the current posterior,
    then E-step with the new tuning; reference core.py:650-669), entirely
    on-device across the mesh; B chains pipeline through the time shards in
    (B_local + d_time - 1) stage-times."""
    opt = optax.adam(m_step_size)
    hyperparam = {
        "param_prior_std": param_prior_std, "noise_std": noise_std,
    }

    def adam_mstep_one(params_b, opt_state_b, y_w, t_w):
        def objective(p):
            return fth.poisson_m_step_objective(
                p, hyperparam, basis, y_w, t_w
            )

        def global_loss(local_loss):
            # params are neuron-sharded; each shard's objective term (LL +
            # prior over its params) sums to the reference's global loss,
            # and using it in the stopping rule keeps trip counts uniform
            # across neuron shards (reference fit_tuning_helper.py:154-164)
            return lax.psum(local_loss, "neuron")

        def cond_fun(c):
            i, _, _, loss, loss_prev = c
            rel = jnp.abs(loss - loss_prev) / jnp.maximum(
                jnp.abs(loss), 1e-8
            )
            return (i < (m_maxiter - 1)) & ((i < 5) | (rel > m_tol))

        def body_fun(c):
            i, p, s, loss, _ = c
            new_loss, grads = jax.value_and_grad(objective)(p)
            updates, s = opt.update(grads, s, p)
            p = optax.apply_updates(p, updates)
            return (i + 1, p, s, global_loss(new_loss), loss)

        loss0 = global_loss(objective(params_b))
        _, params_new, opt_state_new, final_loss, _ = lax.while_loop(
            cond_fun, body_fun, (0, params_b, opt_state_b, loss0, loss0)
        )
        return params_new, opt_state_new, final_loss

    def local_em_step(params, opt_state, log_post, y):
        # shapes (local): params (Bl, n_basis, Nl), log_post (Bl, Tl, L),
        # y (Bl, Tl, Nl)
        # ---- M-step (neuron-sharded params; stats psum'd over time) ----
        post = jnp.exp(log_post)
        # grouped statistics at the configured statistics precision
        # (f32-exact by default; ops/emissions.PRECISION)
        y_w = lax.psum(
            jnp.einsum("btl,btn->bln", post, y,
                       precision=_emissions.PRECISION), "time"
        )  # (Bl, L, Nl)
        t_w = lax.psum(post.sum(axis=1), "time")  # (Bl, L)

        if emission == "poisson":
            params_new, opt_state_new, final_loss = jax.vmap(adam_mstep_one)(
                params, opt_state, y_w, t_w
            )
            tuning_local = jax.vmap(
                lambda p: fth.get_tuning_softplus(p, basis)
            )(params_new)  # (Bl, L, Nl)
        else:
            params_new = jax.vmap(
                lambda yw, tw: fth.gaussian_m_step_analytic(
                    hyperparam, basis, yw, tw
                )
            )(y_w, t_w)
            opt_state_new = opt_state
            tuning_local = jax.vmap(
                lambda p: fth.get_tuning_linear(p, basis)
            )(params_new)

        # ---- E-step (staggered pipeline over time shards) ----
        ll = lax.psum(
            jax.vmap(
                lambda yb, tb: _ll_partial(
                    yb, tb, jnp.ones_like(yb), emission, noise_std
                )
            )(y, tuning_local),
            "neuron",
        )
        post_f, _ratios, lml, _final = _staggered_forward(
            ll, trans, likelihood_scale, "time"
        )
        if emission != "poisson":
            # analytic M-step has no loss; emit a zero with lml's vma so
            # the P('data') out_spec type-checks
            final_loss = 0.0 * lml
        smooth, _acc = _staggered_backward(post_f, trans, "time")
        # latent marginal for the next M-step (reference core.py:668)
        if smooth.ndim == 4:  # joint model: (Bl, Tl, n_dyn, L)
            post_latent = smooth.sum(axis=2)
        else:
            post_latent = smooth
        return (
            params_new, opt_state_new, prob_to_log(post_latent), lml,
            final_loss,
        )

    def _opt_spec(leaf):
        if hasattr(leaf, "ndim") and leaf.ndim >= 3:
            return P("data", None, "neuron")
        return P("data")

    def build(params, opt_state, log_post, y):
        opt_specs = jax.tree.map(_opt_spec, opt_state)
        fn = jax.shard_map(
            local_em_step,
            mesh=mesh,
            in_specs=(
                P("data", None, "neuron"),
                opt_specs,
                P("data", "time", None),
                P("data", "time", "neuron"),
            ),
            out_specs=(
                P("data", None, "neuron"),
                opt_specs,
                P("data", "time", None),
                P("data"),
                P("data"),
            ),
        )
        return jax.jit(fn)(params, opt_state, log_post, y)

    return build


def make_sharded_poisson_em_step(
    mesh,
    basis,
    trans,
    param_prior_std=1.0,
    likelihood_scale=1.0,
    m_step_size=0.01,
    m_maxiter=100,
    m_tol=1e-6,
):
    """Back-compat wrapper: Poisson jump/latent EM step (returns the same
    5-tuple as ``make_sharded_em_step(emission='poisson')``)."""
    return make_sharded_em_step(
        mesh, basis, trans, emission="poisson",
        param_prior_std=param_prior_std, likelihood_scale=likelihood_scale,
        m_step_size=m_step_size, m_maxiter=m_maxiter, m_tol=m_tol,
    )
