"""Feature bags → per-shard design matrices.

Reference parity: com.linkedin.photon.ml.data.avro's NameAndTermFeatureBags
pipeline and FeatureShardConfiguration: each training record carries one or
more *feature bags* (lists of NameTermValue records); a *feature shard* merges
one or more bags into a single design-matrix column space, optionally
appending an intercept. GAME coordinates each train on one shard.

The port's copy of `photon_tpu/data/feature_bags.py`: the builder emits
either a dense (n, d) f32 numpy array (small d) or a numpy-backed
padded-COO `SparseRows` (fixed nnz-per-row k), both on the host —
`GameData.to_device` is the one move to the device. The intercept, when
requested, is the LAST column (see `data.index_map`), which is what the
optimizer's intercept reg-mask assumes.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import numpy as np

from photon_tpu_torch.data.index_map import (INTERCEPT_KEY, IndexMap,
                                             feature_key)
from photon_tpu_torch.data.matrix import SparseRows, from_scipy_csr

Matrix = np.ndarray | SparseRows


class NameTermValue(NamedTuple):
    """Reference: the NameTermValueAvro record (name, term, value)."""

    name: str
    term: str
    value: float


@dataclasses.dataclass(frozen=True)
class FeatureShardConfig:
    """Reference: FeatureShardConfiguration (bags to merge + intercept flag)."""

    bags: Sequence[str]
    has_intercept: bool = True
    # densify when the merged space is at most this wide; else SparseRows
    dense_threshold: int = 1024

    @classmethod
    def coerce(cls, v) -> "FeatureShardConfig":
        """Accept an instance or its JSON-config dict form (the ONE place
        the dict schema is interpreted — every driver's __post_init__ goes
        through here)."""
        if isinstance(v, cls):
            return v
        return cls(
            bags=tuple(v["bags"]),
            has_intercept=v.get("has_intercept", True),
            dense_threshold=v.get("dense_threshold", 1024),
        )


def build_index_map(
    records: Sequence[dict],
    config: FeatureShardConfig,
    existing: Optional[IndexMap] = None,
) -> IndexMap:
    """One pass over records assigning ids to every (name, term) in the
    shard's bags (reference: DefaultIndexMapLoader / FeatureIndexingJob)."""
    imap = existing if existing is not None else IndexMap()
    for rec in records:
        for bag in config.bags:
            for ntv in rec.get(bag, ()):  # absent bag = no features
                imap.index_of(feature_key(ntv.name, ntv.term))
    if config.has_intercept:
        imap.index_of(INTERCEPT_KEY)
    return imap.freeze()


def build_design_matrix(
    records: Sequence[dict],
    config: FeatureShardConfig,
    imap: IndexMap,
    k: Optional[int] = None,
) -> Matrix:
    """Records → design matrix in the shard's column space.

    Unindexed features (NULL_ID) are dropped, matching the reference's
    scoring-time behavior for features outside the index map. Duplicate
    (name, term) entries within a row are summed.
    """
    n, d = len(records), imap.n_features
    rows: list = []
    cols: list = []
    vals: list = []
    for i, rec in enumerate(records):
        for bag in config.bags:
            for ntv in rec.get(bag, ()):
                j = imap.get(feature_key(ntv.name, ntv.term))
                if j != IndexMap.NULL_ID:
                    rows.append(i)
                    cols.append(j)
                    vals.append(float(ntv.value))
        if config.has_intercept:
            rows.append(i)
            cols.append(imap.intercept_id)
            vals.append(1.0)
    return coo_to_matrix(np.asarray(rows, np.int64),
                         np.asarray(cols, np.int64),
                         np.asarray(vals, np.float32),
                         n, d, config.dense_threshold, k=k)


def coo_to_matrix(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                  n: int, d: int, dense_threshold: int,
                  k: Optional[int] = None) -> Matrix:
    """COO triples → dense (n, d) numpy or numpy-backed padded-COO
    SparseRows (duplicates summed), both on the host. Shared by the
    one-shot reader and the chunk stream."""
    if d <= dense_threshold:
        X = np.zeros((n, d), np.float32)
        np.add.at(X, (rows, cols), vals)
        return X

    import scipy.sparse as sp

    csr = sp.csr_matrix((vals, (rows, cols)), shape=(n, d))
    csr.sum_duplicates()
    return from_scipy_csr(csr, k=k)


def build_shard(
    records: Sequence[dict],
    config: FeatureShardConfig,
    imap: Optional[IndexMap] = None,
    k: Optional[int] = None,
) -> tuple[Matrix, IndexMap]:
    """Index-map build (unless given) + design-matrix build in one call."""
    if imap is None:
        imap = build_index_map(records, config)
    return build_design_matrix(records, config, imap, k=k), imap
