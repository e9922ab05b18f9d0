"""Post-fit posterior analyses: weighted averages, state intervals,
peri-event signals, population-vector distances, sequence matching.

Equivalent of reference poor_man_gplvm/analysis_helper.py:11-192
and :344-388.
"""

from __future__ import annotations

import numpy as np
import pandas as pd
import scipy.ndimage
import scipy.stats
import tqdm

from poor_man_gplvm_tpu.utils import compat

if compat.HAS_PYNAPPLE:  # pragma: no cover - environment dependent
    import pynapple as nap
else:
    from poor_man_gplvm_tpu.utils import timeseries as nap

__all__ = [
    "get_posterior_weighted_average",
    "get_state_interval",
    "shift_timestamp",
    "get_peri_event_with_shuffle",
    "get_consecutive_pv_distance",
    "get_sequence_occurence",
]


def get_posterior_weighted_average(feature, posterior):
    """Occupancy-normalized posterior-weighted average of a feature
    (reference analysis_helper.py:11-30).

    feature: Tsd or TsdFrame; posterior: TsdFrame (latent or dynamics).
    Returns pd.Series (1-D feature) or pd.DataFrame."""
    time_support = feature.time_support.union(posterior.time_support)
    feature = feature.restrict(time_support)
    posterior = posterior.restrict(time_support)
    feature_aligned = feature.interpolate(posterior)
    post_d = np.asarray(posterior.d)
    feat_d = np.asarray(feature_aligned.d)
    columns = getattr(posterior, "columns", np.arange(post_d.shape[1]))
    # zero-occupancy states (posterior never visits them) have no defined
    # average — report NaN explicitly instead of a divide RuntimeWarning
    occ = post_d.sum(axis=0)
    occ = np.where(occ > 0, occ, np.nan)
    if feat_d.ndim == 1:
        pwa = (post_d * feat_d[:, None]).sum(axis=0) / occ
        return pd.Series(pwa, index=columns)
    pwa = np.einsum("tp,tf->pf", post_d, feat_d) / occ[:, None]
    return pd.DataFrame(
        pwa, index=columns, columns=getattr(feature_aligned, "columns", None)
    )


def get_state_interval(p_l, p_thresh=0.8, merge_thresh=1, duration_thresh=2):
    """Threshold a state probability -> merge close intervals -> drop short
    ones (reference analysis_helper.py:32-50)."""
    intv = p_l.threshold(p_thresh).time_support
    intv_merge = intv.merge_close_intervals(merge_thresh)
    starts = np.asarray(intv_merge.start)
    ends = np.asarray(intv_merge.end)
    keep = (ends - starts) > duration_thresh
    return nap.IntervalSet(starts[keep], ends[keep])


def shift_timestamp(ts, time_support=None, rng=None):
    """Shift all timestamps by one uniform random offset, wrapping around
    the time support (reference analysis_helper.py:52-64)."""
    rng = np.random.default_rng(rng)
    if time_support is None:
        time_support = [ts.t[0], ts.t[-1]]
    shift = rng.uniform(time_support[0], time_support[1])
    t_shift = ts.t + shift
    below = t_shift < time_support[0]
    above = t_shift > time_support[1]
    t_shift[below] = t_shift[below] - time_support[0] + time_support[1]
    t_shift[above] = t_shift[above] - time_support[1] + time_support[0]
    return nap.Ts(t=np.sort(t_shift))


def get_peri_event_with_shuffle(
    feature_tsd, event_ts, n_shuffle=100, minmax=4, do_zscore=True,
    return_full_shuffle=False, verbose=True, rng=None,
):
    """Peri-event signal + circularly-shifted-event null
    (reference analysis_helper.py:66-112).

    Returns (peri_event DataFrame (n_event, n_time),
    peri_event_sh DataFrame (n_shuffle, n_time) or list of full shuffles)."""
    rng = np.random.default_rng(rng)
    trim = (feature_tsd.t[0] + minmax, feature_tsd.t[-1] - minmax)
    keep = (event_ts.t > trim[0]) & (event_ts.t < trim[1])
    event_ts = nap.Ts(event_ts.t[keep])

    if compat.HAS_PYNAPPLE:  # pragma: no cover
        peri = nap.compute_perievent_continuous(
            timeseries=feature_tsd, tref=event_ts, minmax=minmax
        ).as_dataframe().T
    else:
        peri = nap.compute_perievent_continuous(
            feature_tsd, event_ts, minmax
        ).as_dataframe().T
    if do_zscore:
        peri = scipy.stats.zscore(peri, axis=1)

    peri_sh_l = []
    for _ in tqdm.trange(n_shuffle, disable=not verbose):
        if compat.HAS_PYNAPPLE:  # pragma: no cover
            ev_sh = nap.shift_timestamps(event_ts, min_shift=1.0, max_shift=10.0)
        else:
            ev_sh = nap.shift_timestamps(
                event_ts, min_shift=1.0, max_shift=10.0,
                rng=rng.integers(2**31),
            )
        keep = (ev_sh.t > trim[0]) & (ev_sh.t < trim[1])
        ev_sh = nap.Ts(ev_sh.t[keep])
        if compat.HAS_PYNAPPLE:  # pragma: no cover
            sh = nap.compute_perievent_continuous(
                timeseries=feature_tsd, tref=ev_sh, minmax=minmax
            ).as_dataframe().T
        else:
            sh = nap.compute_perievent_continuous(
                feature_tsd, ev_sh, minmax
            ).as_dataframe().T
        if do_zscore:
            sh = scipy.stats.zscore(sh, axis=1)
        peri_sh_l.append(sh if return_full_shuffle else np.mean(sh, axis=0))
    if n_shuffle > 0 and not return_full_shuffle:
        peri_sh_l = pd.DataFrame(peri_sh_l)
    return peri, peri_sh_l


def _pairwise_similarity_distance(x1, x2):
    numerator = np.sum(x1 * x2, axis=1)
    norm1 = np.linalg.norm(x1, axis=1)
    norm2 = np.linalg.norm(x2, axis=1)
    denom = norm1 * norm2
    with np.errstate(invalid="ignore", divide="ignore"):
        sim = np.divide(
            numerator, denom, out=np.zeros_like(numerator), where=denom > 0
        )
    dist = 1 - sim
    is_zero1 = norm1 <= 1e-12
    is_zero2 = norm2 <= 1e-12
    dist[is_zero1 & is_zero2] = 0.0
    dist[is_zero1 ^ is_zero2] = 2.0
    return dist


def get_consecutive_pv_distance(X, smooth_window=None, metric="cosine"):
    """Distance between consecutive population vectors with zero-norm edge
    handling (reference analysis_helper.py:120-192)."""
    is_tsd = compat.is_tsdframe(X)
    if is_tsd:
        if smooth_window is not None:
            X = X.smooth(smooth_window)
        X_ = np.asarray(X.d, dtype=float)
    else:
        X_ = np.asarray(X, dtype=float)
        if smooth_window is not None:
            X_ = scipy.ndimage.gaussian_filter1d(X_, smooth_window)
    x1, x2 = X_[:-1], X_[1:]

    if metric == "euclidean":
        dist = np.linalg.norm(x2 - x1, axis=1)
    elif metric == "cosine":
        dist = _pairwise_similarity_distance(x1, x2)
    elif metric == "correlation":
        dist = _pairwise_similarity_distance(
            x1 - x1.mean(axis=1, keepdims=True),
            x2 - x2.mean(axis=1, keepdims=True),
        )
    else:
        raise ValueError(f"Unknown metric: {metric}")

    if is_tsd:
        return nap.Tsd(t=X.t[1:], d=dist)
    return dist


def get_sequence_occurence(sequence, post_latent_map, latent_distance_thresh=1):
    """Vectorized sliding-window match of a latent sequence in the MAP path
    (reference analysis_helper.py:344-388).

    Returns (occurrence Ts, occurrence indices)."""
    sequence = np.array(sequence)
    seq_len = len(sequence)

    if compat.is_tsd_like(post_latent_map):
        data = np.asarray(post_latent_map.d)
        times = post_latent_map.t
    else:
        data = np.asarray(post_latent_map)
        times = None

    if len(data) < seq_len:
        return nap.Ts(np.array([])), np.array([], dtype=int)

    matches = np.ones(len(data) - seq_len + 1, dtype=bool)
    for offset, target_val in enumerate(sequence):
        matches &= (
            np.abs(data[offset : offset + len(matches)] - target_val)
            <= latent_distance_thresh
        )
    idx = np.nonzero(matches)[0]
    if times is not None:
        return nap.Ts(times[idx]), idx
    return nap.Ts(idx.astype(float)), idx
