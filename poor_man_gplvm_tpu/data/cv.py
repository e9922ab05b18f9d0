"""Blocked cross-validation splits and dataset container.

Equivalent of reference root core.py:1522-1609 (Hardcastle-style
blocked CV: the test fold takes a 1/k_CV slice out of each of n_blocks
contiguous blocks, so train/test interleave across the session).
"""

from __future__ import annotations

import numpy as np

__all__ = ["cv_split", "DecoderDataset"]


def cv_split(data, k, k_CV=10, n_blocks=10):
    """Split data (time-leading) into train/test for fold k of k_CV, plus the
    within-split indices where new contiguous blocks begin
    (reference core.py:1522-1580)."""
    data = np.asarray(data)
    block_size = len(data) // n_blocks
    mask_test = np.zeros(len(data), dtype=bool)
    for block in range(n_blocks):
        i_start = int((block + k / k_CV) * block_size)
        i_stop = int(i_start + block_size // k_CV)
        mask_test[i_start:i_stop] = True
    mask_train = ~mask_test

    data_test = data[mask_test]
    data_train = data[mask_train]

    train_switch_indices = [0]
    test_switch_indices = [0]
    train_count = test_count = 0
    for i in range(len(data) - 1):
        if mask_train[i]:
            train_count += 1
        if mask_test[i]:
            test_count += 1
        if not mask_train[i] and mask_train[i + 1]:
            train_switch_indices.append(train_count)
        if not mask_test[i] and mask_test[i + 1]:
            test_switch_indices.append(test_count)

    return (
        data_train, data_test,
        np.unique(train_switch_indices), np.unique(test_switch_indices),
    )


class DecoderDataset:
    """(N, T) features + (T,) discrete targets with blocked-CV splitting
    (reference core.py:1582-1609)."""

    def __init__(self, X, Y):
        X, Y = np.asarray(X), np.asarray(Y)
        if X.ndim != 2:
            raise ValueError("X must have shape (N, T)")
        if Y.ndim != 1:
            raise ValueError("Y must have shape (T,)")
        if X.shape[1] != Y.shape[0]:
            raise ValueError("X.shape[1] must equal Y.shape[0]")
        self.X = X
        self.Y = Y

    def split(self, k, k_CV=10, n_blocks=10):
        """Returns ((X_train, Y_train), (X_test, Y_test), train_switch_ind,
        test_switch_ind)."""
        X_train, X_test, train_sw, test_sw = cv_split(
            self.X.T, k, k_CV, n_blocks
        )
        Y_train, Y_test, _, _ = cv_split(self.Y, k, k_CV, n_blocks)
        return (X_train.T, Y_train.T), (X_test.T, Y_test.T), train_sw, test_sw
