"""Behavior loading and brain-behavior alignment.

Equivalent of reference root core.py:846-906 (``load_behavior``:
events.csv + optional SLEAP tracking) and core.py:686-812
(``align_brain_and_behavior``: nearest-event join, speed outlier removal,
interpolation, trial segmentation).
"""

from __future__ import annotations

import os

import numpy as np
import pandas as pd

__all__ = ["load_behavior", "align_brain_and_behavior"]

POSITION_CONVERSION = 5.1  # px -> cm (reference core.py:784)


def load_behavior(behavior_file, tracking_file=None):
    """Load events.csv (+ optional SLEAP analysis.h5 nose tracking),
    zero-center positions, derive velocity/speed by first differences
    (reference core.py:846-906)."""
    events = pd.read_csv(os.path.join(behavior_file, "events.csv"))

    if tracking_file:
        import h5py

        with h5py.File(tracking_file, "r") as f:
            nose = f["tracks"][:].T[:, 0, :]
        nose = nose[: events.shape[0], :]
        events["position_x"] = nose[:, 0] - np.nanmean(nose[:, 0])
        events["position_y"] = nose[:, 1] - np.nanmean(nose[:, 1])
    else:
        events["position_x"] = events["centroid_x"] - np.nanmean(
            events["centroid_x"]
        )
        events["position_y"] = events["centroid_y"] - np.nanmean(
            events["centroid_y"]
        )

    events["velocity_x"] = np.diff(
        events["position_x"], prepend=events["position_x"].iloc[0]
    )
    events["velocity_y"] = np.diff(
        events["position_y"], prepend=events["position_y"].iloc[0]
    )
    events["speed"] = np.sqrt(
        events["velocity_x"] ** 2 + events["velocity_y"] ** 2
    )
    return events[
        [
            "position_x", "position_y", "velocity_x", "velocity_y",
            "reward_state", "speed", "timestamp_ms",
        ]
    ]


def align_brain_and_behavior(
    events, spike_rates, units, time_bins, window_size=0.1,
    speed_threshold=4.0, interp_method="linear", order=None,
):
    """Join neural bins with the nearest behavioral sample (to each bin
    center), remove speed outliers (> threshold x std), interpolate gaps,
    and segment trials at reward-state offsets (reference core.py:686-812).

    The nearest-event join is vectorized (searchsorted on the behavior
    timeline) instead of the reference's per-bin argmin loop.
    """
    time_bins = np.asarray(time_bins, dtype=float)
    event_times = events["timestamp_ms"].values / 1000.0
    middles = time_bins + window_size / 2.0

    # nearest behavioral sample to each bin middle; NaN where no sample
    # precedes the middle (mirrors the reference's `any(event_times < middle)`
    # guard, core.py:763-777)
    idx = np.searchsorted(event_times, middles)
    idx = np.clip(idx, 1, len(event_times) - 1)
    left, right = event_times[idx - 1], event_times[idx]
    nearest = np.where(
        np.abs(middles - left) <= np.abs(middles - right), idx - 1, idx
    )
    # `any(event_times < m)` == `m > first event` (event_times sorted for
    # the searchsorted above); the per-bin loop was O(n_bins * n_events)
    has_prior = (
        middles > event_times.min() if len(event_times)
        else np.zeros(len(middles), dtype=bool)
    )

    def col(name):
        vals = events[name].values[nearest].astype(float)
        return np.where(has_prior, vals, np.nan)

    data = pd.DataFrame(
        np.asarray(spike_rates).T, columns=[f"Unit {i}" for i in units]
    )
    data["x"] = col("position_x") / POSITION_CONVERSION
    data["y"] = col("position_y") / POSITION_CONVERSION
    data["v_x"] = col("velocity_x") / POSITION_CONVERSION
    data["v_y"] = col("velocity_y") / POSITION_CONVERSION
    data["speed"] = col("speed") / POSITION_CONVERSION
    data["time"] = time_bins
    data["reward_state"] = col("reward_state")

    speed_std = np.nanstd(data["speed"])
    if speed_std == 0:
        speed_std = 1
    outliers = data["speed"] > speed_threshold * speed_std
    data.loc[outliers, ["x", "y", "v_x", "v_y", "speed"]] = np.nan

    data.interpolate(method=interp_method, inplace=True, order=order)

    # trial segmentation: a trial increments (and a click fires) on each
    # reward_state falling edge (reference core.py:802-810)
    rw = data["reward_state"].values
    prev = np.concatenate([[0.0], rw[:-1]])
    # float truthiness as in the reference's python-level check
    # (NaN is truthy): trial boundary where prev is truthy and curr is not
    prev_truthy = (prev != 0) | np.isnan(prev)
    curr_falsy = (rw == 0) & ~np.isnan(rw)
    click = (prev_truthy & curr_falsy).astype(float)
    click[0] = 0.0
    data = data.assign(trial_id=np.cumsum(click), click=click)
    return data
