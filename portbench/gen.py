"""The one generator of the benchmark's data: padded COO rows, labels from a
planted logistic model, all drawn from ``--seed`` on the given device.

A configuration file (``configs/<name>.json``) describes a data set by its
published shape and a few assumed distributions; nothing here knows a data
set by name. The generator reads these keys of it:

- ``rows``: the rows this card holds (the published count, or the card's
  share of it, listed under ``reduced``); ``features``: the published
  feature count. The intercept is one more column, the last
  (``features``), in every row.
- ``fields``: each field owns a disjoint block of ``vocab`` feature ids, in
  list order, and draws its ids by rank from a Zipf law of ``zipf`` over
  its block (rank 0 is the block's first id). A field gives every row
  ``per_row`` ids: a number, or an object for a width that varies by row
  (``mean``, ``gamma_shape``, ``min``, ``max``): the widths are the
  quantiles of a gamma law (Wilson-Hilferty's cube of a normal) at
  stratified points, clipped and then adjusted to sum to ``mean x rows``
  rounded, so every seed deals the same multiset of widths, only to other
  rows.
- ``value``: every stored value (1.0: binary features). A repeated id in a
  row is stored twice.
- ``planted``: ``sigma`` (the spread of each feature's true weight) and
  ``bias`` (the true intercept); each label is Bernoulli(sigmoid(margin)).

Rows are padded to the widest row with (index 0, value 0), the layout
`photon_tpu_torch.data.matrix.SparseRows` takes.
"""
from __future__ import annotations

import dataclasses
import math

import torch

# draws made at once: bounds the scratch of the inverse-CDF sampling
_CHUNK = 1 << 24


@dataclasses.dataclass
class Problem:
    """One generated data set: (n, k) padded COO and (n,) labels."""

    indices: torch.Tensor  # (n, k) int32, padded with 0
    values: torch.Tensor   # (n, k) float32, padded with 0.0
    labels: torch.Tensor   # (n,) float32 in {0, 1}
    n_features: int        # published features + the intercept column


def seed_generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from any whole number (taken modulo
    2**63, so large and negative seeds are fine)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def field_widths(spec, rows: int) -> torch.Tensor:
    """(rows,) int64 ids per row for one field's ``per_row`` spec, in
    stratified order (ascending): a fixed count, or gamma quantiles at
    (i + 0.5) / rows, clipped to [min, max] and adjusted to sum to
    ``mean x rows``."""
    if isinstance(spec, int):
        return torch.full((rows,), spec, dtype=torch.int64)
    kappa, mean = float(spec["gamma_shape"]), float(spec["mean"])
    p = (torch.arange(rows, dtype=torch.float64) + 0.5) / rows
    z = torch.special.ndtri(p)
    c = 1.0 / (9.0 * kappa)
    x = mean * torch.clamp(1.0 - c + z * math.sqrt(c), min=0.0) ** 3
    w = torch.clamp(torch.round(x), spec["min"], spec["max"]).to(torch.int64)
    gap = round(mean * rows) - int(w.sum())
    # spread the remainder one id a row over the middle of the order, where
    # no clip binds, so the multiset's sum is exactly mean x rows
    step = 1 if gap > 0 else -1
    while gap:
        k = min(abs(gap), rows // 2)
        lo = rows // 4
        w[lo:lo + k] += step
        gap -= step * k
    return torch.clamp(w, spec["min"], spec["max"])


def _zipf_cdf(vocab: int, exponent: float, device) -> torch.Tensor:
    r = torch.arange(1, vocab + 1, dtype=torch.float64, device=device)
    cdf = torch.cumsum(r.pow(-exponent), 0)
    return cdf / cdf[-1]


def _draw(cdf: torch.Tensor, count: int, g: torch.Generator) -> torch.Tensor:
    """``count`` ranks (int64) by inverse-CDF sampling."""
    out = torch.empty(count, dtype=torch.int64, device=cdf.device)
    for lo in range(0, count, _CHUNK):
        hi = min(count, lo + _CHUNK)
        u = torch.rand(hi - lo, dtype=torch.float64, device=cdf.device,
                       generator=g)
        out[lo:hi] = torch.clamp(torch.searchsorted(cdf, u), max=len(cdf) - 1)
    return out


def generate(data: dict, seed: int, device) -> Problem:
    """The data set that the configuration ``data`` describes, drawn from
    ``seed`` on ``device``."""
    dev = torch.device(device)
    g = seed_generator(seed, dev)
    n, d = int(data["rows"]), int(data["features"])
    fields = data["fields"]
    if sum(int(f["vocab"]) for f in fields) > d:
        raise ValueError("the fields' vocabularies exceed the features")
    widths = [field_widths(f["per_row"], n) for f in fields]
    # deal each field's width multiset to the rows in a seeded order
    widths = [w.to(dev)[torch.randperm(n, device=dev, generator=g)]
              if not isinstance(f["per_row"], int) else w.to(dev)
              for f, w in zip(fields, widths)]
    row_w = torch.stack(widths).sum(0)
    k = int(row_w.max()) + 1  # + the intercept
    ind = torch.zeros((n, k), dtype=torch.int32, device=dev)
    start = torch.zeros(n, dtype=torch.int64, device=dev)
    slot = torch.arange(k, device=dev)[None, :]
    base = 0
    for f, w in zip(fields, widths):
        cdf = _zipf_cdf(int(f["vocab"]), float(f["zipf"]), dev)
        ids = _draw(cdf, int(w.sum()), g) + base
        mask = (slot >= start[:, None]) & (slot < (start + w)[:, None])
        ind[mask] = ids.to(torch.int32)  # row-major: each row's draws in turn
        start += w
        base += int(f["vocab"])
        del cdf, ids, mask
    live = slot <= start[:, None]
    ind.scatter_(1, start[:, None], d)  # the intercept, after the fields
    val = torch.where(live, float(data["value"]), 0.0).to(torch.float32)
    del live
    planted = data["planted"]
    w_true = torch.randn(d + 1, dtype=torch.float32, device=dev,
                         generator=g) * float(planted["sigma"])
    w_true[d] = float(planted["bias"])
    margin = torch.empty(n, dtype=torch.float32, device=dev)
    rows = max(1, _CHUNK // k)
    for lo in range(0, n, rows):
        hi = min(n, lo + rows)
        margin[lo:hi] = (w_true[ind[lo:hi].long()] * val[lo:hi]).sum(1)
    u = torch.rand(n, dtype=torch.float32, device=dev, generator=g)
    y = (u < torch.sigmoid(margin)).to(torch.float32)
    return Problem(ind, val, y, d + 1)
