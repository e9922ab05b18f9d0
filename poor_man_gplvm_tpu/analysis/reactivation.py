"""Reactivation analyses: pre/post epoch decoding with shuffle nulls.

Equivalent of reference poor_man_gplvm/reactivation_analysis.py.
Two shuffle types (reference reactivation_analysis.py:14-19): circular spike
shuffles within epoch (tests correlation structure vs single-neuron
activation) and pre/post label permutation (tests whether the boundary
matters at all).  The xarray groupby of the reference's within-ripple
aggregation is replaced with pandas.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pandas as pd
import tqdm

from poor_man_gplvm_tpu.utils import compat

__all__ = [
    "decode_pre_post",
    "circular_shuffle_spikes_within_epoch_and_decode",
    "circular_shuffle_column_independently",
    "random_reassign_prepost_latent_difference",
    "generate_homogeneous_poisson_surrogate_data",
    "decode_ripple_epochs",
    "aggregate_within_ripple_per_epoch",
]


def decode_pre_post(model, spk_mat_d, pre_post_epoch_d=None,
                    decoder_type="naive_bayes", common_ep=None):
    """Decode latents per pre/post epoch; mean posterior per epoch + diff
    (reference reactivation_analysis.py:21-55)."""
    if pre_post_epoch_d is not None and compat.is_tsdframe(spk_mat_d):
        assert "pre" in pre_post_epoch_d and "post" in pre_post_epoch_d
        spk_mat_d = {
            k: spk_mat_d.restrict(ep) for k, ep in pre_post_epoch_d.items()
        }
        if common_ep is not None:
            spk_mat_d = {
                k: v.restrict(common_ep) for k, v in spk_mat_d.items()
            }
    else:
        assert "pre" in spk_mat_d and "post" in spk_mat_d

    post_latent_d = {}
    post_latent_mean_d = {}
    for pre_post, spk_sub in spk_mat_d.items():
        arr = spk_sub.d if compat.is_tsdframe(spk_sub) else spk_sub
        if decoder_type == "naive_bayes":
            res = model.decode_latent_naive_bayes(jnp.array(arr))
            post_latent_marg = np.asarray(res["posterior_latent"])
        elif decoder_type == "dynamics":
            res = model.decode_latent(jnp.array(arr))
            post_latent_marg = np.asarray(res["posterior_latent_marg"])
        else:
            raise ValueError(f"decoder_type {decoder_type} not supported")
        post_latent_d[pre_post] = post_latent_marg
        post_latent_mean_d[pre_post] = post_latent_marg.mean(axis=0)
    post_latent_mean_d["diff"] = (
        post_latent_mean_d["post"] - post_latent_mean_d["pre"]
    )
    post_latent_mean_d = pd.DataFrame(
        post_latent_mean_d, columns=["pre", "post", "diff"]
    )
    return {
        "post_latent_d": post_latent_d,
        "post_latent_mean_d": post_latent_mean_d,
    }


def circular_shuffle_column_independently(spk_mat, min_shift=5, rng=None):
    """Circularly shift each column independently
    (reference reactivation_analysis.py:84-92)."""
    rng = np.random.default_rng(rng)
    spk_mat = np.asarray(spk_mat)
    n_time, n_neuron = spk_mat.shape
    shuffled = spk_mat.copy()
    for j in range(n_neuron):
        shuffled[:, j] = np.roll(
            spk_mat[:, j], rng.integers(min_shift, n_time - min_shift)
        )
    return shuffled


def circular_shuffle_spikes_within_epoch_and_decode(
    model, spk_mat, pre_post_epoch_d, decoder_type="naive_bayes",
    common_ep=None, n_shuffle=100, verbose=True, rng=None, batched=True,
    shuffle_batch_size=32,
):
    """Circular within-epoch per-neuron shuffles -> decode -> stacked mean
    posteriors (reference reactivation_analysis.py:57-82).

    ``batched`` (default): the shuffles are drawn in the reference's exact
    order, then each epoch's shuffle stack decodes as vmapped device
    programs (``shuffle_batch_size`` shuffles per dispatch) instead of
    2 x n_shuffle serial decodes.  ``batched=False`` keeps the serial
    reference loop."""
    rng = np.random.default_rng(rng)
    spk_mat_d = {}
    for pre_post, ep in pre_post_epoch_d.items():
        sub = spk_mat.restrict(ep)
        if common_ep is not None:
            sub = sub.restrict(common_ep)
        spk_mat_d[pre_post] = np.asarray(sub.d)

    if not batched:
        out = {}
        for i in tqdm.trange(n_shuffle, disable=not verbose):
            shuffled_d = {
                k: circular_shuffle_column_independently(
                    v, min_shift=5, rng=rng.integers(2**31)
                )
                for k, v in spk_mat_d.items()
            }
            res = decode_pre_post(
                model, shuffled_d, decoder_type=decoder_type
            )
            out[i] = res["post_latent_mean_d"]
        return pd.concat(out, axis=0)

    if decoder_type not in ("naive_bayes", "dynamics"):
        raise ValueError(f"decoder_type {decoder_type} not supported")
    import jax

    from poor_man_gplvm_tpu.ops import emissions, hmm

    # identical RNG stream: the serial loop draws one child seed per
    # (shuffle, key) in this order — pre-draw only the cheap seeds here
    # and materialize the shuffled matrices per decode batch below, so
    # peak host memory is O(shuffle_batch_size * T * N), not
    # O(n_shuffle * T * N) (hour-long epochs with n_shuffle=500 would
    # otherwise stage 100s of GB before the first dispatch)
    seeds_per_key = {k: [] for k in spk_mat_d}
    for _ in range(n_shuffle):
        for k in spk_mat_d:
            seeds_per_key[k].append(int(rng.integers(2**31)))

    tuning = model.tuning
    hyper = {}
    if hasattr(model, "noise_std"):
        hyper["noise_std"] = model.noise_std
    ma_neuron = model.ma_neuron_default
    ma_latent = model.ma_latent_default
    obs = model.observation_model
    has_dyn = model.has_dynamics

    if decoder_type == "naive_bayes":
        def one(y):
            log_post, *_ = emissions.get_naive_bayes_ma(
                y, tuning, hyper, ma_neuron, ma_latent,
                observation_model=obs,
            )
            return jnp.exp(log_post)  # (T, L)
    else:
        trans, _ = model._make_transition(hyper)
        engine = (
            model.inference_engine
            if model.inference_engine in ("prob", "log") else "prob"
        )

        def one(y):
            smooth, *_ = hmm.smooth_combined_chunked(
                y, tuning, hyper, trans, ma_neuron, ma_latent,
                observation_model=obs, engine=engine,
            )
            post = jnp.exp(smooth)
            return post.sum(axis=1) if has_dyn else post  # (T, L)

    # only the time-mean survives to the host: (S_batch, L) per dispatch
    mean_prog = jax.jit(jax.vmap(lambda y: one(y).mean(axis=0)))
    mean_per_key = {}
    for k, seeds in seeds_per_key.items():
        v = spk_mat_d[k]
        parts = []
        for s0 in tqdm.tqdm(range(0, n_shuffle, shuffle_batch_size),
                            disable=not verbose, desc=f"decode[{k}]"):
            y_b = np.stack([
                circular_shuffle_column_independently(v, min_shift=5, rng=s)
                for s in seeds[s0:s0 + shuffle_batch_size]
            ])  # (S_batch, T_k, N)
            parts.append(np.asarray(mean_prog(jnp.asarray(y_b))))
        mean_per_key[k] = np.concatenate(parts, axis=0)  # (S, L)

    out = {}
    for i in range(n_shuffle):
        means = {k: mean_per_key[k][i] for k in mean_per_key}
        means["diff"] = means["post"] - means["pre"]
        out[i] = pd.DataFrame(means, columns=["pre", "post", "diff"])
    return pd.concat(out, axis=0)


def random_reassign_prepost_latent_difference(posterior_latent_d,
                                              n_shuffle=100, verbose=True,
                                              rng=None):
    """Permute pre/post labels over timepoints; recompute epoch means + diff
    (reference reactivation_analysis.py:94-117)."""
    rng = np.random.default_rng(rng)
    post_concat = np.concatenate(
        [np.asarray(v) for v in posterior_latent_d.values()], axis=0
    )
    keys = list(posterior_latent_d.keys())
    label_l = np.concatenate(
        [np.array([k] * len(np.asarray(v))) for k, v in posterior_latent_d.items()]
    )
    out = {}
    for i in tqdm.trange(n_shuffle, disable=not verbose):
        label_sh = rng.permutation(label_l)
        means = {
            k: post_concat[label_sh == k].mean(axis=0) for k in keys
        }
        means["diff"] = means["post"] - means["pre"]
        out[i] = pd.DataFrame(means, columns=["pre", "post", "diff"])
    return pd.concat(out, axis=0)


def generate_homogeneous_poisson_surrogate_data(
    spk_times, intv_per_ep, count_bin=0.02, n_repeat=50, verbose=True, rng=None,
):
    """Per-epoch homogeneous-Poisson surrogates matching each unit's epoch
    firing rate (reference reactivation_analysis.py:120-151).

    spk_times: TsGroup (pynapple or internal shim).
    Returns (surrogate count matrices list, rate_per_ep, nbins_per_ep,
    concatenated bin timestamps)."""
    rng = np.random.default_rng(rng)
    nbins_per_ep, rate_per_ep, t_l = {}, {}, []
    for k, intv in intv_per_ep.items():
        restricted = spk_times.restrict(intv)
        counted = restricted.count(count_bin)
        nbins_per_ep[k] = counted.shape[0]
        t_l.append(counted.t)
        rate_per_ep[k] = np.asarray(restricted.rate)
    t_l = np.concatenate(t_l)

    surrogates = []
    for _ in tqdm.trange(n_repeat, disable=not verbose):
        parts = [
            rng.poisson(
                rate_per_ep[k] * count_bin,
                size=(nbins_per_ep[k], rate_per_ep[k].shape[0]),
            )
            for k in rate_per_ep
        ]
        surrogates.append(np.concatenate(parts, axis=0))
    return surrogates, rate_per_ep, nbins_per_ep, t_l


def decode_ripple_epochs(model, spk_mat, ripple_intv, t_l=None,
                         hyperparam=None, batch_size=None):
    """Smoother-decode every ripple/burst epoch as one vmapped program.

    The reference decodes short epochs serially (a host loop over epochs,
    reference reactivation_analysis.py:21-55, plus the chunked host loop
    inside ``get_naive_bayes_ma_chunk``, decoder.py:134-148) — one device
    dispatch per epoch.  This wraps ``model.decode_latent_epochs`` (all
    epochs padded + stacked into ONE program) and reshapes the result for
    the reactivation workflow: a tidy per-epoch DataFrame of mean latent
    posteriors plus the per-epoch log-marginals.

    ``spk_mat`` may be a TsdFrame (then ``ripple_intv`` may be a
    time-valued IntervalSet) or a plain (T, N) array with ``ripple_intv``
    as (E, 2) bin-index pairs.

    Returns ``{"epoch_res": <decode_latent_epochs dict>,
    "posterior_mean_df": (E, L) DataFrame,
    "log_marginal_per_epoch": (E,)}``.
    """
    if compat.is_tsdframe(spk_mat):
        t_l = spk_mat.t if t_l is None else t_l
    res = model.decode_latent_epochs(
        spk_mat, ripple_intv, hyperparam=hyperparam, t_l=t_l,
        batch_size=batch_size,
    )
    mean_df = pd.DataFrame(res["posterior_mean"])
    mean_df.index.name = "epoch"
    return {
        "epoch_res": res,
        "posterior_mean_df": mean_df,
        "log_marginal_per_epoch": res["log_marginal_per_epoch"],
    }


def aggregate_within_ripple_per_epoch(posterior_latent, ripple_intv_per_ep):
    """Max within each ripple, mean across ripples, per epoch
    (reference reactivation_analysis.py:153-176; pandas groupby instead of
    xarray)."""
    out = {}
    for ep, intv in ripple_intv_per_ep.items():
        if len(intv) == 0:
            continue
        post_ep = posterior_latent.restrict(intv)
        rip_label = np.asarray(intv.in_interval(post_ep))
        d = np.asarray(post_ep.d)
        flat = d.reshape(d.shape[0], -1)
        df = pd.DataFrame(flat)
        df["ripple_label"] = rip_label
        per_ripple_max = df.groupby("ripple_label").max()
        agg = per_ripple_max.mean(axis=0).to_numpy().reshape(d.shape[1:])
        out[ep] = agg
    return out
