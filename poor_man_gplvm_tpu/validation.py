"""Statistical model validation: circular-shuffle nulls, decode-and-threshold
significance, posterior entropy, jump verification.

Equivalent of reference poor_man_gplvm/test.py (the reference's
"test" module is statistical validation run manually, not a unit test —
SURVEY.md §4) and poor_man_gplvm/verify_latent_jump.py.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
from poor_man_gplvm_tpu.utils import compat
from poor_man_gplvm_tpu.utils.progress import progress

__all__ = [
    "circular_shuffle_data",
    "shuffle_and_decode",
    "test_one_model",
    "compute_entropy",
    "get_contrast_axis_and_proj",
    "segment_trial_by_jump",
]


def circular_shuffle_data(spk_tsdf, n_shuffle=100, ep=None, seed=None):
    """Generator of circularly-shuffled copies; each neuron shifted
    independently (reference test.py:10-24)."""
    rng = np.random.default_rng(seed)
    if ep is not None:
        assert compat.is_tsdframe(spk_tsdf), (
            "input data must be a TsdFrame when ep is given"
        )
        spk_tsdf = spk_tsdf.restrict(ep)
    arr = np.asarray(spk_tsdf.d if compat.is_tsdframe(spk_tsdf) else spk_tsdf)
    n_time, n_neuron = arr.shape
    for _ in range(n_shuffle):
        shuffled = arr.copy()
        for j in range(n_neuron):
            shuffled[:, j] = np.roll(arr[:, j], rng.integers(0, n_time))
        yield jnp.asarray(shuffled)


def shuffle_and_decode(model, spk_tsdf, n_time_per_chunk=10000, dt_l=1,
                       n_shuffle=100, ep=None, decoder_type="naive_bayes",
                       seed=None, verbose=True, batched=True,
                       shuffle_batch_size=16, memory_mode=None):
    """Decode each circular shuffle; stack result dicts over shuffles
    (reference test.py:27-45).

    ``batched=True`` (default): shuffles are decoded in vmapped device
    programs of ``shuffle_batch_size`` at a time instead of one dispatch
    per shuffle — each sequential scan step then advances all shuffles as
    one batched matmul, so an n_shuffle=100 null costs a handful of device
    programs (VERDICT round-2 next #7).  Same shuffle stream (identical
    rng consumption) and same stacked result dict as the serial loop.
    ``memory_mode`` passes through to the smoother ('auto' when None);
    under checkpoint/filter modes ``log_likelihood_all`` is None, matching
    ``decode_latent``."""
    if not batched:
        y_shuffled_l = circular_shuffle_data(
            spk_tsdf, n_shuffle=n_shuffle, ep=ep, seed=seed
        )
        decoding_res_l = []
        for y_shuffled in progress(y_shuffled_l, verbose, total=n_shuffle):
            if decoder_type == "naive_bayes":
                res = model.decode_latent_naive_bayes(
                    y_shuffled, n_time_per_chunk=n_time_per_chunk, dt_l=dt_l
                )
            elif decoder_type == "dynamics":
                res = model.decode_latent(
                    y_shuffled, n_time_per_chunk=n_time_per_chunk
                )
            else:
                raise ValueError(f"decoder_type {decoder_type} not supported")
            decoding_res_l.append(res)
        # keep a None entry (e.g. log_likelihood_all under checkpoint/
        # filter memory modes) as None, matching the batched path — not an
        # object array of Nones
        return {
            k: (
                None if decoding_res_l[0][k] is None
                else np.array([np.asarray(d[k]) for d in decoding_res_l])
            )
            for k in decoding_res_l[0].keys()
        }

    if decoder_type not in ("naive_bayes", "dynamics"):
        raise ValueError(f"decoder_type {decoder_type} not supported")
    import itertools

    import jax

    from poor_man_gplvm_tpu.ops import emissions

    # consume the shuffle generator one batch at a time: peak host memory
    # is O(shuffle_batch_size * T * N), not O(n_shuffle * T * N) (an
    # n_shuffle=100 null on a T=1e6 session would otherwise stage ~40 GB
    # before the first dispatch).  The rng stream is drawn in the same
    # serial order either way, so results are identical to the serial path.
    shuffle_gen = circular_shuffle_data(
        spk_tsdf, n_shuffle=n_shuffle, ep=ep, seed=seed
    )

    def _next_batch():
        return np.stack([
            np.asarray(s)
            for s in itertools.islice(shuffle_gen, shuffle_batch_size)
        ])

    tuning = model.tuning
    hyper = {}
    if hasattr(model, "noise_std"):
        hyper["noise_std"] = model.noise_std
    ma_neuron = model.ma_neuron_default
    ma_latent = model.ma_latent_default
    obs = model.observation_model

    out_batches = []
    if decoder_type == "naive_bayes":
        nb = jax.jit(jax.vmap(
            lambda y: emissions.get_naive_bayes_ma(
                y, tuning, hyper, ma_neuron, ma_latent, dt_l=dt_l,
                observation_model=obs,
            )
        ))
        for _ in progress(range(0, n_shuffle, shuffle_batch_size),
                          verbose):
            log_post, lml_l, lml_tot, ll = nb(jnp.asarray(_next_batch()))
            out_batches.append({
                "log_posterior_latent": np.asarray(log_post),
                "log_marginal_l": np.asarray(lml_l),
                "log_marginal_total": np.asarray(lml_tot),
                "posterior_latent": np.exp(np.asarray(log_post)),
                "ll_per_pos_l": np.asarray(ll),
            })
    else:
        from poor_man_gplvm_tpu.models.base import build_decode_prog

        trans, _ = model._make_transition(hyper)
        # prob engine: vmap-safe, numerically the model's own path
        engine = (
            model.inference_engine
            if model.inference_engine in ("prob", "log") else "prob"
        )
        # the model's own decode program (one definition of the
        # decode_res contract — models/base.build_decode_prog), vmapped
        # over shuffles
        prog = build_decode_prog(
            obs, engine, model.has_dynamics, n_time_per_chunk,
            memory_mode=memory_mode if memory_mode else "auto",
        )
        dec = jax.jit(jax.vmap(
            lambda y: prog(y, tuning, hyper, trans, ma_neuron, ma_latent, 1.0)
        ))
        for _ in progress(range(0, n_shuffle, shuffle_batch_size),
                          verbose):
            res = dec(jnp.asarray(_next_batch()))
            batch = {
                # log_likelihood_all is None under checkpoint/filter memory
                # modes (auto-selected at large T*L) — keep the key with
                # None like decode_latent
                k: (np.asarray(v) if v is not None else None)
                for k, v in res.items() if k != "_log_marginal_final"
            }
            batch["log_marginal_final"] = np.asarray(
                res["_log_marginal_final"]
            )
            out_batches.append(batch)

    return {
        k: (
            np.concatenate([b[k] for b in out_batches], axis=0)
            if out_batches[0][k] is not None else None
        )
        for k in out_batches[0]
    }


def test_one_model(y_true, model_fit, n_shuffle=100,
                   decoder_type="naive_bayes", sig_key=None, seed=None):
    """Per-timestep significance: decode true data vs the 97.5%-quantile of the
    circular-shuffle null (reference test.py:48-68)."""
    y_true_t = y_true.t
    y_true_d = y_true.d
    if sig_key is None:
        sig_key = (
            "log_marginal_l"
            if decoder_type == "naive_bayes"
            else "log_one_step_predictive_marginals_all"
        )
    if decoder_type == "naive_bayes":
        res_true = model_fit.decode_latent_naive_bayes(y_true_d)
    elif decoder_type == "dynamics":
        res_true = model_fit.decode_latent(y_true_d)
    else:
        raise ValueError(f"decoder_type {decoder_type} not supported")
    res_shuffle = shuffle_and_decode(
        model_fit, y_true_d, n_time_per_chunk=10000, dt_l=1,
        n_shuffle=n_shuffle, ep=None, decoder_type=decoder_type, seed=seed,
    )
    log_marg_thresh = np.quantile(res_shuffle[sig_key], 0.975, axis=0)
    is_sig = np.asarray(res_true[sig_key]) > log_marg_thresh
    is_sig_tsd = compat.tsd(d=is_sig, t=y_true_t)
    return {
        "decode_res_true": res_true,
        "decode_res_shuffle": res_shuffle,
        "log_marg_thresh": log_marg_thresh,
        "is_sig_tsd": is_sig_tsd,
    }


def compute_entropy(logp_l, axis=(-1, -2)):
    """Posterior entropy over the chosen axes (reference test.py:70-79)."""
    logp_l = np.asarray(logp_l)
    return -np.sum(np.exp(logp_l) * logp_l, axis=axis)


# ---------------------------------------------------------------------------
# jump verification (reference verify_latent_jump.py)
# ---------------------------------------------------------------------------


def get_contrast_axis_and_proj(x_sub, tuning, map_state_pre, map_state_post,
                               map_state_win=3):
    """Population-vector contrast axis between two latent states, and the
    projection of activity onto it (reference verify_latent_jump.py:4-23).
    Each state's axis is averaged over +/- map_state_win adjacent states."""
    tuning = np.asarray(tuning)
    pre_range = slice(map_state_pre - map_state_win, map_state_pre + map_state_win + 1)
    axis_pre = tuning[pre_range].mean(axis=0)
    post_range = slice(
        map_state_post - map_state_win, map_state_post + map_state_win + 1
    )
    axis_post = tuning[post_range].mean(axis=0)
    contrast = axis_pre - axis_post
    contrast = contrast / np.linalg.norm(contrast)
    proj = np.asarray(x_sub).dot(contrast)
    return proj, contrast


def segment_trial_by_jump(jump_p_sub, post_map_sub,
                          jump_p_merge_threshold_time=1, is_jump_threshold=0.5):
    """Segment a trial into continuous-dynamics epochs separated by jump
    epochs; median MAP latent per continuous segment
    (reference verify_latent_jump.py:28-50)."""
    jump_epoch = jump_p_sub.threshold(
        is_jump_threshold
    ).time_support.merge_close_intervals(jump_p_merge_threshold_time)
    continuous_epoch = post_map_sub.time_support.set_diff(jump_epoch)

    post_map_median_per_epoch = {}
    for ii, epoch in enumerate(continuous_epoch):
        restricted = post_map_sub.restrict(epoch)
        post_map_median_per_epoch[ii] = (
            np.nanmedian(np.asarray(restricted.d)) if len(restricted) else np.nan
        )
    return {
        "post_map_median_per_epoch": post_map_median_per_epoch,
        "jump_epoch": jump_epoch,
        "continuous_epoch": continuous_epoch,
    }
