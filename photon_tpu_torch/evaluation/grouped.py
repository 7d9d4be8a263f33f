"""Per-entity (sharded) metrics by sorted-segment operations, scatter-free
(port of `photon_tpu/evaluation/grouped.py`).

Reference parity: com.linkedin.photon.ml.evaluation.{ShardedAUCEvaluator,
ShardedPrecisionAtKEvaluator} — a metric per entity id (a query, a user)
averaged over the entities. One stable sort by (group, score) computes
every group's metric at once on the scores' device: per-group sums are
cumulative-sum differences (`data.matrix.sorted_segment_sum`), and the
segmented minima and maxima these metrics need are over monotone
sequences (cumulative sums, positions), so they are gathers at the
segment bounds. Nothing adds through an index or a scatter, so a metric
gives the same bits on every run. The elements a combining scatter would
have taken are counted on ``eval.scatter_elems_saved`` (`telemetry`).

Groups are dense int ids in [0, num_groups); rows of weight 0 are
padding. A group where the metric is undefined (a single class for AUC,
no positive for AUPR, empty for P@K) is NaN and left out of the mean, as
in the reference.
"""
from __future__ import annotations

import torch

from photon_tpu_torch import telemetry
from photon_tpu_torch.data.matrix import sorted_segment_sum

F32 = torch.float32


def _as(x, dtype, device) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(x)
    return x.to(device=device, dtype=dtype)


def _inputs(scores, labels, weights, groups=None):
    """(scores, labels, weights, groups) on the scores' device: f32, and
    int64 ids (None stays None)."""
    s = scores if isinstance(scores, torch.Tensor) else torch.as_tensor(
        scores)
    s = s.to(F32)
    dev = s.device
    return (s, _as(labels, F32, dev), _as(weights, F32, dev),
            None if groups is None else _as(groups, torch.int64, dev))


def _sort_by_group_then_key(groups, key):
    """Stable order: by group, then by ``key`` ascending within it."""
    order1 = torch.argsort(key, stable=True)
    order2 = torch.argsort(groups[order1], stable=True)
    return order1[order2]


def _mean_over_valid(per_group, valid):
    """Unweighted mean over the valid groups; NaN when none is."""
    n_valid = torch.sum(valid.to(F32))
    total = torch.sum(torch.where(valid, per_group,
                                  torch.zeros_like(per_group)))
    return torch.where(n_valid > 0.0, total / torch.clamp(n_valid, min=1.0),
                       torch.full_like(total, float("nan")))


def _bounds(sorted_ids, num_segments: int):
    """Segment bounds of SORTED ids: segment s spans
    bounds[s]:bounds[s + 1] (empty segments collapse)."""
    return torch.searchsorted(sorted_ids, torch.arange(
        num_segments + 1, dtype=sorted_ids.dtype, device=sorted_ids.device))


def _first_of_segment(x, bounds, n: int):
    """x at each segment's FIRST row (the segmented min of a
    nondecreasing x); an empty segment reads a clamped neighbour, which
    no caller uses."""
    return x[torch.clamp(bounds[:-1], max=n - 1)]


def _last_of_segment(x, bounds):
    """x at each segment's LAST row (the segmented max of a
    nondecreasing x)."""
    return x[torch.clamp(bounds[1:] - 1, min=0)]


def _count_saved(*segment_input_lengths) -> None:
    telemetry.count("eval.scatter_elems_saved",
                    int(sum(segment_input_lengths)))


def _tie_ids(s, g):
    """Ids of the runs of equal (group, score) in sorted order."""
    new_tie = torch.ones(s.shape, dtype=torch.bool, device=s.device)
    new_tie[1:] = (s[1:] != s[:-1]) | (g[1:] != g[:-1])
    return torch.cumsum(new_tie.to(torch.int64), dim=0) - 1


def _valid_ratio(num, den, valid):
    nan = torch.full_like(num, float("nan"))
    return torch.where(valid, num / torch.where(valid, den,
                                                torch.ones_like(den)), nan)


def _grouped_auc(scores, labels, weights, groups, num_groups: int):
    scores, labels, weights, groups = _inputs(scores, labels, weights,
                                              groups)
    n = int(scores.shape[0])
    order = _sort_by_group_then_key(groups, scores)
    s, y, w, g = scores[order], labels[order], weights[order], groups[order]
    wpos = w * y
    wneg = w * (1.0 - y)
    tid = _tie_ids(s, g)
    cneg = torch.cumsum(wneg, dim=0)
    tb = _bounds(tid, n)
    gb = _bounds(g, num_groups)
    neg_in_tie = sorted_segment_sum(wneg, tid, n)
    # cneg is nondecreasing: its max over a tie is the tie's LAST row, the
    # min of (cneg - wneg) over a group its FIRST row
    tie_cum_end = _last_of_segment(cneg, tb)
    group_cum_before = _first_of_segment(cneg - wneg, gb, n)
    neg_below_in_group = (tie_cum_end[tid] - neg_in_tie[tid]
                          - group_cum_before[g])
    contrib = wpos * (neg_below_in_group + 0.5 * neg_in_tie[tid])
    wp_g = sorted_segment_sum(wpos, g, num_groups)
    wn_g = sorted_segment_sum(wneg, g, num_groups)
    num_g = sorted_segment_sum(contrib, g, num_groups)
    valid = (wp_g > 0.0) & (wn_g > 0.0)
    per_group = _valid_ratio(num_g, wp_g * wn_g, valid)
    return per_group, valid, _mean_over_valid(per_group, valid)


def grouped_auc(scores, labels, weights, groups, num_groups: int):
    """(per_group_auc, valid_mask, mean_over_valid), tensors on the
    scores' device.

    per_group_auc[g] is group g's weighted tie-aware AUC (NaN where the
    group lacks a class); the mean is over valid groups, unweighted, as
    the reference averages per-entity AUCs."""
    n = int(torch.as_tensor(scores).shape[0])
    _count_saved(n, n, n, n, n, n)  # 4 segment sums + tie max + group min
    return _grouped_auc(scores, labels, weights, groups, num_groups)


def _grouped_aupr(scores, labels, weights, groups, num_groups: int):
    scores, labels, weights, groups = _inputs(scores, labels, weights,
                                              groups)
    n = int(scores.shape[0])
    # descending score within a group: every prefix is "predicted
    # positive at this threshold"
    order = _sort_by_group_then_key(groups, -scores)
    s, y, w, g = scores[order], labels[order], weights[order], groups[order]
    wpos = w * y
    wneg = w * (1.0 - y)
    tid = _tie_ids(s, g)
    cpos = torch.cumsum(wpos, dim=0)
    cneg = torch.cumsum(wneg, dim=0)
    tb = _bounds(tid, n)
    gb = _bounds(g, num_groups)
    # a tied block is one threshold: cumulative weights at its END, minus
    # the group's cumulative before its first row
    pos_tie_end = _last_of_segment(cpos, tb)
    neg_tie_end = _last_of_segment(cneg, tb)
    pos_before_g = _first_of_segment(cpos - wpos, gb, n)
    neg_before_g = _first_of_segment(cneg - wneg, gb, n)
    tp = pos_tie_end[tid] - pos_before_g[g]
    fp = neg_tie_end[tid] - neg_before_g[g]
    denom = tp + fp
    precision = tp / torch.where(denom > 0.0, denom, torch.ones_like(denom))
    # Σ ΔR·P = Σ_rows (wpos_i / P_g) · precision(tie of i)
    ap_num = sorted_segment_sum(wpos * precision, g, num_groups)
    p_g = sorted_segment_sum(wpos, g, num_groups)
    valid = p_g > 0.0
    per_group = _valid_ratio(ap_num, p_g, valid)
    return per_group, valid, _mean_over_valid(per_group, valid)


def grouped_aupr(scores, labels, weights, groups, num_groups: int):
    """(per_group_aupr, valid_mask, mean_over_valid).

    Weighted, tie-aware area under the precision–recall curve in the
    step-wise (average-precision) form: AP = Σ_t (R_t − R_{t−1}) · P_t
    over distinct thresholds, descending, a tied block one threshold. NaN
    where a group has no positive weight."""
    n = int(torch.as_tensor(scores).shape[0])
    _count_saved(n, n, n, n, n, n)  # 2 sums + 2 tie maxes + 2 group mins
    return _grouped_aupr(scores, labels, weights, groups, num_groups)


def _grouped_precision_at_k(scores, labels, weights, groups,
                            num_groups: int, k: int):
    scores, labels, weights, groups = _inputs(scores, labels, weights,
                                              groups)
    n = int(scores.shape[0])
    real = weights > 0.0
    # ascending: best first, padding last
    key = torch.where(real, -scores, torch.full_like(scores, float("inf")))
    order = _sort_by_group_then_key(groups, key)
    y, g, real_s = labels[order], groups[order], real[order]
    idx = torch.arange(n, device=scores.device)
    # idx increases, so a group's first row IS its segmented min
    group_first = _first_of_segment(idx, _bounds(g, num_groups), n)
    pos_in_group = idx - group_first[g]
    maskf = ((pos_in_group < k) & real_s).to(F32)
    hits = sorted_segment_sum(y * maskf, g, num_groups)
    considered = sorted_segment_sum(maskf, g, num_groups)
    valid = considered > 0.0
    per_group = _valid_ratio(hits, considered, valid)
    return per_group, valid, _mean_over_valid(per_group, valid)


def grouped_precision_at_k(scores, labels, weights, groups,
                           num_groups: int, k: int):
    """(per_group_p_at_k, valid_mask, mean_over_valid).

    The top k rows of each group by score; precision = positives among
    them over the number considered (min(k, group size)). Labels count
    unweighted; weight 0 marks padding (see `metrics.precision_at_k`)."""
    n = int(torch.as_tensor(scores).shape[0])
    _count_saved(n, n, n)  # 2 segment sums + 1 group min
    return _grouped_precision_at_k(scores, labels, weights, groups,
                                   num_groups, int(k))
