"""Evaluation metrics: per-class average precision and ROC-AUC (port of
passt_tpu/train/metrics.py; numpy, copied).

The reference computes sklearn ``average_precision_score`` /
``roc_auc_score`` with ``average=None`` on the CPU and reports the class
mean (reference: ex_audioset.py:256-264). sklearn is the ground truth here
too; a vectorized NumPy implementation is provided (and cross-tested against
sklearn) for hosts without it and for large-eval speed — it computes all
classes at once instead of sklearn's per-class Python loop.
"""

from __future__ import annotations

import numpy as np


def average_precision(targets: np.ndarray, scores: np.ndarray) -> np.ndarray:
    """Per-class AP, sklearn-equivalent (step-wise integral of the PR curve
    with threshold-grouped ties). targets/scores: [N, C]. Returns [C]
    (NaN for classes with no positives)."""
    targets = np.asarray(targets, dtype=np.float64)
    scores = np.asarray(scores, dtype=np.float64)
    n, c = scores.shape
    order = np.argsort(-scores, axis=0, kind="stable")
    s_sorted = np.take_along_axis(scores, order, axis=0)
    t_sorted = np.take_along_axis(targets, order, axis=0)

    tp = np.cumsum(t_sorted, axis=0)
    fp = np.cumsum(1.0 - t_sorted, axis=0)
    n_pos = tp[-1]

    precision = tp / np.maximum(tp + fp, 1e-12)
    recall = tp / np.maximum(n_pos[None, :], 1e-12)

    # Tie handling: only the last row of each equal-score run is a threshold
    # point; mask the others out of the sum.
    is_last_of_run = np.ones_like(s_sorted, dtype=bool)
    is_last_of_run[:-1] = s_sorted[:-1] != s_sorted[1:]

    recall_prev = np.vstack([np.zeros((1, c)), recall[:-1]])
    # recall_prev must also be taken at threshold granularity: recall at the
    # previous *threshold*, i.e. forward-fill over runs.
    idx = np.where(is_last_of_run, np.arange(n)[:, None], -1)
    last_idx = np.maximum.accumulate(idx, axis=0)
    prev_thresh_idx = np.vstack([np.full((1, c), -1, dtype=np.int64), last_idx[:-1]])
    rec_at = np.where(prev_thresh_idx >= 0,
                      np.take_along_axis(recall, np.maximum(prev_thresh_idx, 0), axis=0),
                      0.0)

    delta = np.where(is_last_of_run, recall - rec_at, 0.0)
    ap = np.sum(delta * precision, axis=0)
    return np.where(n_pos > 0, ap, np.nan)


def roc_auc(targets: np.ndarray, scores: np.ndarray) -> np.ndarray:
    """Per-class ROC-AUC via the rank-sum (Mann–Whitney U) formulation with
    midranks for ties. Returns [C] (NaN where undefined)."""
    targets = np.asarray(targets, dtype=np.float64)
    scores = np.asarray(scores, dtype=np.float64)
    n, c = scores.shape
    out = np.full(c, np.nan)
    for j in range(c):
        t = targets[:, j]
        s = scores[:, j]
        n_pos = t.sum()
        n_neg = n - n_pos
        if n_pos == 0 or n_neg == 0:
            continue
        order = np.argsort(s, kind="mergesort")
        ranks = np.empty(n)
        s_sorted = s[order]
        # midranks
        i = 0
        while i < n:
            k = i
            while k + 1 < n and s_sorted[k + 1] == s_sorted[i]:
                k += 1
            ranks[order[i : k + 1]] = 0.5 * (i + k) + 1.0
            i = k + 1
        out[j] = (ranks[t > 0.5].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg)
    return out


def masked_mean_average_precision(
    targets: np.ndarray, scores: np.ndarray, mask: np.ndarray
) -> float:
    """Class-mean AP where each class only counts samples whose label was
    observed (the OpenMIC protocol: the reference passes
    ``sample_weight=y_mask[:, i]`` per class, ex_openmic.py validation)."""
    targets = np.asarray(targets, dtype=np.float64)
    scores = np.asarray(scores, dtype=np.float64)
    mask = np.asarray(mask) > 0.5
    aps = []
    for j in range(scores.shape[1]):
        m = mask[:, j]
        t, s = targets[m, j], scores[m, j]
        if t.size == 0:
            # no observed samples at all: sklearn with an all-zero
            # sample_weight yields nan, which the reference's plain
            # .mean() propagates — reproduce, don't hide
            aps.append(float("nan"))
        elif t.sum() == 0:
            # observed samples but no positives: sklearn scores the class
            # 0.0 and the reference INCLUDES it in the macro mean
            # (ex_openmic.py:241-252 runs average_precision_score for
            # every class with sample_weight=y_mask[:, i] and takes
            # .mean()); skipping it would inflate the reported mAP on
            # subsampled/smoke eval sets
            aps.append(0.0)
        else:
            aps.append(float(average_precision(t[:, None], s[:, None])[0]))
    return float(np.mean(aps)) if aps else float("nan")


def masked_roc_auc(
    targets: np.ndarray, scores: np.ndarray, mask: np.ndarray
) -> float:
    """Class-mean ROC AUC counting only observed labels per class (the
    OpenMIC protocol twin of :func:`masked_mean_average_precision`; the
    reference weights ``roc_auc_score`` by ``y_mask[:, i]`` the same way,
    ex_openmic.py validation)."""
    targets = np.asarray(targets, dtype=np.float64)
    scores = np.asarray(scores, dtype=np.float64)
    mask = np.asarray(mask) > 0.5
    aucs = []
    for j in range(scores.shape[1]):
        m = mask[:, j]
        t, s = targets[m, j], scores[m, j]
        if t.size == 0 or t.sum() == 0 or t.sum() == t.size:
            continue  # AUC undefined without both classes present
        aucs.append(float(roc_auc(t[:, None], s[:, None])[0]))
    return float(np.mean(aucs)) if aucs else float("nan")


def mean_average_precision(targets: np.ndarray, scores: np.ndarray, use_sklearn: bool = True) -> float:
    """Class-mean AP — the reference's headline 'ap'/'allap' metric
    (ex_audioset.py:256-258, 278-282)."""
    if use_sklearn:
        try:
            import warnings as _warnings

            from sklearn import metrics as skm

            with _warnings.catch_warnings():
                # Classes without positives are expected on subsampled /
                # synthetic eval sets; sklearn warns per class per call.
                _warnings.filterwarnings(
                    "ignore", message="No positive class found in y_true"
                )
                ap = skm.average_precision_score(targets, scores, average=None)
            return float(np.mean(ap))
        except Exception:
            pass
    # sklearn convention (the reference's): a class with no positive
    # examples contributes AP 0.0 to the macro mean. average_precision
    # returns NaN there; nanmean would EXCLUDE such classes and inflate
    # the fallback's ap relative to the sklearn path on the same inputs.
    return float(np.mean(np.nan_to_num(average_precision(targets, scores), nan=0.0)))
