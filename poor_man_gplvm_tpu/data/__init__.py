"""Data ingestion layer: loaders, binning, bursts, CV, baseline decoders.

Equivalent of the fork's root core.py (reference root core.py,
1845 LoC) — host-side numpy/pandas I/O feeding the device-side model layer.
"""

from poor_man_gplvm_tpu.data.behavior import (
    align_brain_and_behavior,
    load_behavior,
)
from poor_man_gplvm_tpu.data.binning import (
    bin_spikes_sliding,
    compute_spike_counts,
    smooth_and_zscore,
)
from poor_man_gplvm_tpu.data.bursts import (
    detect_population_bursts,
    merge_overlapping_bursts_two_probes,
)
from poor_man_gplvm_tpu.data.cellexplorer import (
    load_cell_metrics,
    mat_struct_to_dict,
)
from poor_man_gplvm_tpu.data.cv import DecoderDataset, cv_split
from poor_man_gplvm_tpu.data.decoders import (
    GaussianBayesDecoder,
    PoissonBayesDecoder,
)
from poor_man_gplvm_tpu.data.grouping import (
    collect_matrix_for,
    collect_matrix_for_bilat,
    sort_units,
)
from poor_man_gplvm_tpu.data.kilosort import (
    compute_spike_counts_old,
    compute_spike_rates,
    load_cluster_labels,
)
from poor_man_gplvm_tpu.data.moser import preprocess_moser_data
from poor_man_gplvm_tpu.data.quality import get_presence_ratio

__all__ = [
    "align_brain_and_behavior",
    "bin_spikes_sliding",
    "collect_matrix_for",
    "collect_matrix_for_bilat",
    "compute_spike_counts",
    "compute_spike_counts_old",
    "compute_spike_rates",
    "cv_split",
    "DecoderDataset",
    "detect_population_bursts",
    "GaussianBayesDecoder",
    "get_presence_ratio",
    "load_behavior",
    "load_cell_metrics",
    "load_cluster_labels",
    "mat_struct_to_dict",
    "merge_overlapping_bursts_two_probes",
    "PoissonBayesDecoder",
    "preprocess_moser_data",
    "smooth_and_zscore",
    "sort_units",
]
