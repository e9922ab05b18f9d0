"""Kilosort/Phy output loading.

Equivalent of the fork's Kilosort layer (reference root
core.py:16-390): cluster-label TSVs, params.py sampling rate, unit-label
filtering, sliding-window rates/counts.
"""

from __future__ import annotations

import os

import numpy as np
import pandas as pd

from poor_man_gplvm_tpu.data.binning import bin_spikes_sliding

__all__ = [
    "load_cluster_labels",
    "load_kilosort_spikes",
    "filter_units_by_label",
    "compute_spike_rates",
    "compute_spike_counts_old",
]


def load_cluster_labels(kilosort_dir):
    """Load cluster_group.tsv / cluster_KSLabel.tsv into a normalized
    (cluster_id, label) DataFrame (reference core.py:16-47)."""
    candidates = ["cluster_group.tsv", "cluster_KSLabel.tsv"]
    path = None
    for fn in candidates:
        p = os.path.join(kilosort_dir, fn)
        if os.path.exists(p):
            path = p
            break
    if path is None:
        raise FileNotFoundError(
            f"Could not find cluster label file in {kilosort_dir}. "
            f"Tried: {', '.join(candidates)}"
        )

    df = pd.read_csv(path, sep="\t")
    cols = {c.lower(): c for c in df.columns}
    id_col = cols.get("cluster_id") or cols.get("id")
    lbl_col = cols.get("kslabel") or cols.get("group")
    if id_col is None or lbl_col is None:
        raise ValueError(
            f"Expected columns like cluster_id and KSLabel/group in {path}; "
            f"found {list(df.columns)}"
        )
    out = df[[id_col, lbl_col]].rename(
        columns={id_col: "cluster_id", lbl_col: "label"}
    )
    out["cluster_id"] = pd.to_numeric(out["cluster_id"], errors="coerce").astype(
        "Int64"
    )
    out = out.dropna(subset=["cluster_id"]).astype({"cluster_id": int})
    out["label"] = out["label"].astype(str).str.lower()
    return out


def _read_sampling_rate(kilosort_dir):
    params_path = os.path.join(kilosort_dir, "params.py")
    if not os.path.exists(params_path):
        raise FileNotFoundError(f"params.py not found in {kilosort_dir}")
    with open(params_path) as f:
        lines = [ln for ln in f.read().splitlines() if "sample_rate" in ln]
    if not lines:
        raise ValueError("sample_rate not found in params.py")
    return float(lines[0].split("=")[1].strip())


def keep_ids_for_label(info, use_units):
    """Label filter shared by all loaders (reference core.py:129-142)."""
    use_units = use_units.lower()
    if use_units == "all":
        return info["cluster_id"].values
    if use_units == "good":
        return info.loc[info["label"].eq("good"), "cluster_id"].values
    if use_units == "mua":
        return info.loc[info["label"].eq("mua"), "cluster_id"].values
    if use_units in ("good/mua", "good+mua", "goodmua"):
        return info.loc[info["label"].isin(["good", "mua"]), "cluster_id"].values
    if use_units == "noise":
        return info.loc[info["label"].eq("noise"), "cluster_id"].values
    raise ValueError(f"Unknown use_units='{use_units}'")


def filter_units_by_label(spike_times, spike_clusters, info, use_units):
    keep_ids = keep_ids_for_label(info, use_units)
    mask = np.isin(spike_clusters, keep_ids)
    return spike_times[mask], spike_clusters[mask]


def load_kilosort_spikes(kilosort_dir, use_units="all", adj=None):
    """Load spike times (seconds) + cluster IDs, filtered by unit label.

    ``adj='_sec_adj'`` selects the seconds-adjusted spike_times file
    (already in seconds); otherwise samples are divided by the params.py
    sample_rate (reference core.py:96-148)."""
    spike_times_path = os.path.join(kilosort_dir, f"spike_times{adj}.npy")
    spike_clusters_path = os.path.join(kilosort_dir, "spike_clusters.npy")
    if not all(os.path.exists(p) for p in [spike_times_path, spike_clusters_path]):
        raise FileNotFoundError("Missing required Kilosort output files.")

    sampling_rate = _read_sampling_rate(kilosort_dir)
    spike_times = np.load(spike_times_path).astype(np.float64).ravel()
    if adj != "_sec_adj":
        spike_times = spike_times / sampling_rate
    spike_clusters = np.load(spike_clusters_path).ravel()

    info = load_cluster_labels(kilosort_dir)
    return filter_units_by_label(spike_times, spike_clusters, info, use_units)


def compute_spike_rates(
    kilosort_dir, window_size=1.0, step_size=0.5, use_units="all", sigma=2.5,
    zscore=True, adj=None,
):
    """Smoothed sliding-window firing rates in Hz from Kilosort output
    (reference core.py:49-211)."""
    spike_times, spike_clusters = load_kilosort_spikes(
        kilosort_dir, use_units=use_units, adj=adj
    )
    return bin_spikes_sliding(
        spike_times, spike_clusters, window_size=window_size,
        step_size=step_size, rates=True, sigma=sigma, zscore=zscore,
    )


def compute_spike_counts_old(
    kilosort_dir, window_size=1.0, step_size=0.5, use_units="all", sigma=2.5,
    zscore=True, adj=None,
):
    """Sliding-window spike counts from Kilosort output
    (reference core.py:215-390; identical windowing to compute_spike_rates
    without the rate conversion)."""
    spike_times, spike_clusters = load_kilosort_spikes(
        kilosort_dir, use_units=use_units, adj=adj
    )
    return bin_spikes_sliding(
        spike_times, spike_clusters, window_size=window_size,
        step_size=step_size, rates=False, sigma=sigma, zscore=zscore,
    )
