"""Random-effect feature-space projectors (port of
`photon_tpu/game/projector.py`; numpy, as the reference).

Reference parity: com.linkedin.photon.ml.projector.* — each random-effect
model trains in a REDUCED feature space (IndexMapProjection: the entity's
own active features only; RandomProjection: a shared Gaussian projection
matrix) and its coefficients project back to the full space afterwards
(RandomEffectModelInProjectedSpace.toRandomEffectModel).

Projection is applied when the entity-bucketed blocks are built, so every
projected block is a small DENSE (E, m, p) block and p is padded to a
bucket-wide power of two.

- ``IndexMapProjection``: per entity, the sorted list of features active in
  its rows; padding columns are all-zero (their coefficients stay 0 from a
  zero start), and an intercept column is pinned LAST so the
  intercept-last regularization convention survives projection. Solves in
  projected space equal full-space solves.
- ``RandomProjection``: one shared (d, p) Gaussian matrix, intercept kept
  aside. Back-projected coefficients w_full = P·w_proj score identically to
  projected-space scoring because x·(P w) = (Pᵀx)·w.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np


class ProjectorType(enum.Enum):
    """Reference: projector.ProjectorType (INDEX_MAP, RANDOM)."""

    INDEX_MAP = "index_map"
    RANDOM = "random"


@dataclasses.dataclass(frozen=True)
class ProjectionConfig:
    """Per-random-effect projection spec (hashable: used in dataset cache keys).

    ``projected_dim`` is required for RANDOM and ignored for INDEX_MAP (whose
    per-bucket dim is data-determined).
    """

    projector: ProjectorType
    projected_dim: Optional[int] = None
    seed: int = 0

    def __post_init__(self):
        if self.projector is ProjectorType.RANDOM and not self.projected_dim:
            raise ValueError("RANDOM projection requires projected_dim")


@dataclasses.dataclass(frozen=True)
class BlockProjection:
    """Per-bucket index-map projection data.

    proj_idx[e, j] = global feature index behind projected column j of entity
    e; proj_mask marks real columns (0 = padding, whose gathered values are
    zeroed so the padded coefficient stays at 0). Layout per entity:
    [sorted non-intercept active features, padding…, intercept last] when
    ``intercept_index`` is set, else [sorted active features, padding…].
    """

    proj_idx: np.ndarray  # (E, p) int64
    proj_mask: np.ndarray  # (E, p) float32
    intercept_index: Optional[int] = None  # global intercept feature id

    @property
    def dim(self) -> int:
        return int(self.proj_idx.shape[1])


def build_index_map_projection(
    active_sets: list,
    intercept_index: Optional[int],
    floor: int = 2,
) -> BlockProjection:
    """Build a bucket's projection from per-entity active feature sets.

    ``active_sets``: one sorted 1-D int array per entity (global feature ids,
    excluding the intercept). When ``intercept_index`` is given it is pinned
    to the LAST projected column of every entity, preserving the
    intercept-last convention that ``make_objective`` relies on.
    """
    from photon_tpu_torch.data.matrix import next_pow2

    E = len(active_sets)
    extra = 1 if intercept_index is not None else 0
    width = max((len(s) for s in active_sets), default=0) + extra
    p = next_pow2(max(width, 1), floor)
    proj_idx = np.zeros((E, p), np.int64)
    proj_mask = np.zeros((E, p), np.float32)
    for e, s in enumerate(active_sets):
        k = len(s)
        proj_idx[e, :k] = s
        proj_mask[e, :k] = 1.0
        if intercept_index is not None:
            proj_idx[e, -1] = intercept_index
            proj_mask[e, -1] = 1.0
    return BlockProjection(proj_idx, proj_mask, intercept_index)


def project_dense_block(Xb: np.ndarray, proj: BlockProjection) -> np.ndarray:
    """(E, m, d) → (E, m, p): per-entity column gather, padding zeroed."""
    idx = proj.proj_idx[:, None, :]  # (E, 1, p)
    out = np.take_along_axis(Xb, np.broadcast_to(idx, Xb.shape[:2] + (proj.dim,)), axis=2)
    return (out * proj.proj_mask[:, None, :]).astype(np.float32)


def project_sparse_block(
    ind: np.ndarray, val: np.ndarray, proj: BlockProjection
) -> np.ndarray:
    """Padded-COO (E, m, k) → dense (E, m, p) in each entity's projected space.

    Scatter-add each nonzero into its projected column (duplicate feature
    slots within a row accumulate, matching SparseRows matvec semantics).
    """
    E, m, k = ind.shape
    p = proj.dim
    icpt = proj.intercept_index
    # local position of each nonzero's global feature in its entity's layout:
    # sorted non-intercept actives first, intercept (if any) pinned at p-1
    local = np.empty((E, m, k), np.int64)
    keep = np.empty((E, m, k), bool)
    for e in range(E):
        nact = int(proj.proj_mask[e].sum()) - (1 if icpt is not None else 0)
        row = proj.proj_idx[e, :nact]  # sorted ascending by construction
        flat = ind[e].reshape(-1)
        if nact:
            loc = np.clip(np.searchsorted(row, flat), 0, nact - 1)
            hit = row[loc] == flat
        else:
            loc = np.zeros(m * k, np.int64)
            hit = np.zeros(m * k, bool)
        is_icpt = (flat == icpt) if icpt is not None else np.zeros(m * k, bool)
        local[e] = np.where(is_icpt, p - 1, np.where(hit, loc, 0)).reshape(m, k)
        keep[e] = (hit | is_icpt).reshape(m, k)
    out = np.zeros((E, m, p), np.float32)
    np.add.at(
        out,
        (
            np.arange(E)[:, None, None],
            np.arange(m)[None, :, None],
            local,
        ),
        # nonzeros outside the active set exist only as zero-valued padding
        # slots; ``keep`` zeroes them so they cannot pollute column 0
        val * keep,
    )
    return out * proj.proj_mask[:, None, :]


def gather_rows(full: np.ndarray, proj: BlockProjection) -> np.ndarray:
    """Project per-entity full-space row vectors (E, d) → (E, p)."""
    E = full.shape[0]
    out = full[np.arange(E)[:, None], proj.proj_idx]
    return (out * proj.proj_mask).astype(np.float32)


def scatter_rows_into(
    full: np.ndarray, rows: np.ndarray, entity_index: np.ndarray, proj: BlockProjection
) -> None:
    """Scatter projected per-entity vectors (E, p) back into full[(ents), d].

    Exact inverse of ``gather_rows`` on valid columns; padding contributes 0
    (mask) even where proj_idx repeats a real index.
    """
    full[entity_index] = 0.0
    np.add.at(
        full,
        (np.asarray(entity_index)[:, None], proj.proj_idx),
        rows * proj.proj_mask,
    )


@dataclasses.dataclass(frozen=True)
class RandomProjector:
    """Shared Gaussian projection (reference: projector.RandomProjection).

    ``matrix``: (d_feat, p_feat) with N(0, 1/p_feat) entries so projected dot
    products are unbiased estimates of full-space ones. When
    ``keep_intercept``, the LAST input column bypasses the matrix and maps to
    the LAST output column (so the intercept-last convention survives).
    """

    matrix: np.ndarray
    keep_intercept: bool
    dim_in: int
    dim_out: int

    @staticmethod
    def build(
        dim_in: int, projected_dim: int, keep_intercept: bool, seed: int = 0
    ) -> "RandomProjector":
        d_feat = dim_in - 1 if keep_intercept else dim_in
        p_feat = projected_dim - 1 if keep_intercept else projected_dim
        if p_feat <= 0 or d_feat <= 0:
            raise ValueError("projected_dim too small for this shard")
        rng = np.random.default_rng(seed)
        P = rng.normal(0.0, 1.0 / np.sqrt(p_feat), size=(d_feat, p_feat))
        return RandomProjector(P.astype(np.float32), keep_intercept, dim_in, projected_dim)

    def project_rows(self, rows: np.ndarray) -> np.ndarray:
        """(…, d) feature rows → (…, p) projected rows."""
        rows = np.asarray(rows, np.float32)
        if self.keep_intercept:
            feat = rows[..., :-1] @ self.matrix
            return np.concatenate([feat, rows[..., -1:]], axis=-1)
        return rows @ self.matrix

    def project_coeffs(self, w_full: np.ndarray) -> np.ndarray:
        """Full-space coefficients (…, d) → projected space (…, p)
        (reference: ProjectionMatrix.projectCoefficients).

        Uses (p/d)·Pᵀ — the expectation of the pseudo-inverse (PᵀP)⁻¹Pᵀ for
        N(0, 1/p) entries — so project_coeffs(back_project(w)) ≈ w and warm
        starts round-trip across coordinate-descent sweeps without the
        (d/p)-fold blow-up the raw adjoint would cause."""
        w_full = np.asarray(w_full, np.float32)
        if self.keep_intercept:
            scale = (self.dim_out - 1) / (self.dim_in - 1)
            feat = scale * (w_full[..., :-1] @ self.matrix)
            return np.concatenate([feat, w_full[..., -1:]], axis=-1)
        return (self.dim_out / self.dim_in) * (w_full @ self.matrix)

    def project_sparse_rows(self, ind: np.ndarray, val: np.ndarray) -> np.ndarray:
        """Padded-COO rows (…, k) → dense projected rows (…, p) WITHOUT
        densifying the full-space rows (d may be millions). Chunked so the
        (chunk, k, p) gather stays bounded."""
        ind = np.asarray(ind)
        val = np.asarray(val, np.float32)
        lead = ind.shape[:-1]
        k = ind.shape[-1]
        ind2 = ind.reshape(-1, k)
        val2 = val.reshape(-1, k)
        n = ind2.shape[0]
        p = self.dim_out
        out = np.empty((n, p), np.float32)
        p_feat = p - 1 if self.keep_intercept else p
        chunk = max(1, (1 << 22) // max(k * p_feat, 1))
        for lo in range(0, n, chunk):
            hi = min(lo + chunk, n)
            i, v = ind2[lo:hi], val2[lo:hi]
            if self.keep_intercept:
                is_icpt = i == self.dim_in - 1
                vf = np.where(is_icpt, 0.0, v)
                idx = np.minimum(i, self.dim_in - 2)
                out[lo:hi, :-1] = np.einsum("nk,nkp->np", vf, self.matrix[idx])
                out[lo:hi, -1] = (v * is_icpt).sum(-1)
            else:
                out[lo:hi] = np.einsum("nk,nkp->np", v, self.matrix[i])
        return out.reshape(lead + (p,))

    def back_project(self, w_proj: np.ndarray) -> np.ndarray:
        """(…, p) projected coefficients → (…, d) full-space coefficients.

        x·back_project(w) == project_rows(x)·w exactly, so scoring with the
        back-projected model reproduces projected-space scoring.
        """
        w_proj = np.asarray(w_proj, np.float32)
        if self.keep_intercept:
            feat = w_proj[..., :-1] @ self.matrix.T
            return np.concatenate([feat, w_proj[..., -1:]], axis=-1)
        return w_proj @ self.matrix.T
