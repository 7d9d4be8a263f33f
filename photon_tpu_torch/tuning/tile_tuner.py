"""Work-item tile autotuner for the tiled blocked-ELL forms (port of
`photon_tpu/tuning/tile_tuner.py`).

The tiled kernels (`kernels/blocked_ell.py`: `tail_matvec_tiled`,
`bucket_rmatvec_tiled`, rows 3 and 5 of `PERF.md`'s kernel table) run one
launch per bucket over work items of at most T rows (a width bucket) or T
columns (an occurrence bucket), one CUDA block each. The right T is a
fact of the card — it trades blocks launched against threads idle in a
short item — so it is measured, not guessed, once per (card, kind,
width):

- `autotune_tiles(X, w, r, cache_dir=...)` runs every candidate tile
  through the real tiled kernels on a representative layout, times each
  (best of ``repeats``; attributed to the profiling ledger under
  ``kernels.tile/<kind>`` when one is active) and keeps the fastest per
  (kind, width).
- Winners persist as one JSON file per card in ``cache_dir``, written
  through `checkpoint.store.commit_bytes` (atomic and durable). A warm
  call — or a fresh process given the same ``cache_dir`` — reloads the
  file and measures NOTHING (``kernels.tile_cache_hits`` counts each
  reuse, ``kernels.tile_measures`` each live measurement). A corrupt or
  foreign file counts as a cold cache.
- `tile_for(kind, width, device)` is the dispatch-time lookup the tiled
  wrappers make (`kernels.blocked_ell.resolve_tiles`): the memoized
  winner, else `DEFAULT_TILE`. It never measures; an untuned process runs
  the default, and ``PHOTON_TPU_TORCH_KERNELS_TILE``
  (`kernels.tile_override`) beats both.

Differences from the reference:

- The memo and the file are keyed by the card — its name
  (`torch.cuda.get_device_name`) and compute capability, ``"cpu"`` for
  CPU tensors — not by a JAX backend, so one card's winner is never
  served on another.
- The unit is the port's: rows per tail-matvec item or columns per
  rmatvec item, a power of two, clamped to what one 256-thread block
  takes (`kernels.blocked_ell.clamp_tile`). `DEFAULT_TILE` (1,024 =
  256 threads × 4 rows, the most any bucket's item holds) clamps to
  every bucket's whole-block item, so an untuned process runs exactly the
  fused forms' items. The reference's (64, 128, 256, 512) are TPU sublane
  row tiles.
- On the card each candidate is timed under ``kernels.scope("on")``, the
  stream synchronized around each repeat; on the CPU (no kernel) the
  plain versions run and the timing only exercises the cache.

Every tile gives the same bits: a row or a column is summed by the same
threads in the same order whatever item holds it.
"""
from __future__ import annotations

import functools
import json
import os
import re
import threading
import time
from typing import Optional

import torch

__all__ = ["CANDIDATE_TILES", "DEFAULT_TILE", "tile_for", "autotune_tiles",
           "tile_cache_path", "reset_memo"]

CANDIDATE_TILES = (64, 128, 256, 512, 1024)
DEFAULT_TILE = 1024
_FORMAT = "photon_tpu_torch-kernel-tiles-v1"

# (card key, kind, width) -> winning tile. Process-local; seeded by
# autotune_tiles (from the cache file or a measurement), read by tile_for
# at every tiled call.
_MEMO: dict = {}
_memo_lock = threading.Lock()


def reset_memo() -> None:
    """Drop the in-memory winners (a fresh process, for tests)."""
    with _memo_lock:
        _MEMO.clear()


@functools.lru_cache(maxsize=None)
def _card_key(index: int) -> str:
    major, minor = torch.cuda.get_device_capability(index)
    return f"{torch.cuda.get_device_name(index)} sm_{major}{minor}"


def device_key(device=None) -> str:
    """The card a winner belongs to: ``"<name> sm_<cc>"`` for a CUDA
    device (None: the current one when a GPU is present), ``"cpu"`` for
    the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            return "cpu"
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return _card_key(index)


def tile_for(kind: str, width: int, device=None) -> int:
    """The tile the tiled form of ``kind`` (``"tail_matvec"`` or
    ``"bucket_rmatvec"``) runs for buckets of ``width`` on ``device``: the
    autotuned winner when one is memoized for that card, else
    `DEFAULT_TILE`. A lookup only — dispatch never measures (the env pin
    is applied by the caller, `kernels.blocked_ell.resolve_tiles`)."""
    key = (device_key(device), kind, int(width))
    with _memo_lock:
        return int(_MEMO.get(key, DEFAULT_TILE))


def tiles_for(kind: str, widths, device=None):
    """`tile_for` of every width at once, for one call of a tiled form:
    None when no winner is memoized at all (an untuned process, where
    every bucket runs `DEFAULT_TILE`), so that call looks nothing up."""
    with _memo_lock:
        if not _MEMO:
            return None
    key = device_key(device)
    with _memo_lock:
        return tuple(int(_MEMO.get((key, kind, int(w)), DEFAULT_TILE))
                     for w in widths)


def tile_cache_path(cache_dir: str, device=None) -> str:
    """Where the winners for ``device``'s card live: one JSON file per
    card in ``cache_dir``."""
    slug = re.sub(r"[^A-Za-z0-9]+", "-", device_key(device)).strip("-")
    return os.path.join(cache_dir, f"kernel-tiles-{slug}.json")


def _load_cache(cache_dir: str, device) -> dict:
    path = tile_cache_path(cache_dir, device)
    if not os.path.exists(path):
        return {}
    try:
        with open(path, "r") as f:
            doc = json.load(f)
        if (doc.get("format") != _FORMAT
                or doc.get("device") != device_key(device)):
            return {}  # another port's or another card's file: cold
        return {str(k): int(v) for k, v in doc["tiles"].items()}
    except (OSError, ValueError, KeyError, TypeError, AttributeError):
        return {}  # unreadable cache == cold cache (re-measure, rewrite)


def _persist_cache(cache_dir: str, device, tiles: dict) -> None:
    from photon_tpu_torch.checkpoint.store import commit_bytes

    doc = {"format": _FORMAT, "device": device_key(device),
           "torch": torch.__version__,
           "tiles": {k: int(v) for k, v in sorted(tiles.items())}}
    os.makedirs(cache_dir, exist_ok=True)
    commit_bytes(tile_cache_path(cache_dir, device),
                 json.dumps(doc, indent=1).encode())


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _measure_candidate(X, w, r, kind: str, width: int, tile: int,
                       repeats: int) -> float:
    """Best-of-``repeats`` wall seconds of the tiled form of ``kind`` with
    ``tile`` planted for (card, kind, width) — every other bucket keeps
    its current tile, so candidates differ in exactly one coordinate."""
    from photon_tpu_torch import kernels as K
    from photon_tpu_torch import profiling
    from photon_tpu_torch.kernels import blocked_ell as KB

    device = (w if kind == "tail_matvec" else r).device
    key = (device_key(device), kind, int(width))
    with _memo_lock:
        prev = _MEMO.get(key)
        _MEMO[key] = int(tile)
    try:
        if kind == "tail_matvec":
            fn = lambda: KB.tail_matvec_tiled(X, w)      # noqa: E731
        else:
            fn = lambda: KB.bucket_rmatvec_tiled(X, r)   # noqa: E731
        with K.scope(K.device_mode(device)):
            fn()  # builds this tile set's plan
            _sync(device)
            best = float("inf")
            for _ in range(max(int(repeats), 1)):
                t0 = time.perf_counter()
                fn()
                _sync(device)
                dt = time.perf_counter() - t0
                profiling.attribute(f"kernels.tile/{kind}",
                                    f"w{width}:T{tile}", dt)
                best = min(best, dt)
        return best
    finally:
        with _memo_lock:
            if prev is None:
                _MEMO.pop(key, None)
            else:
                _MEMO[key] = prev


def autotune_tiles(X, w, r, cache_dir: Optional[str] = None,
                   candidates: tuple = CANDIDATE_TILES,
                   repeats: int = 2) -> dict:
    """Measure the candidate tiles for every bucket of ``X``'s tiled forms
    on ``w``'s card; memoize and persist the winners.

    ``X`` is a representative `BlockedEllRows` (bucket WIDTHS are the
    key, so any layout sharing the production widths tunes for it) on
    the card; ``w`` the (d,) permuted coefficient vector of its tail
    matvec, ``r`` the (n,) cotangent of its rmatvec. With ``cache_dir`` a
    previous run's winners reload and a key already covered is not
    measured again — the warm path is one file read. Returns
    ``{"kind:width": tile}`` for the keys this layout exercises."""
    from photon_tpu_torch import telemetry

    device = w.device
    dkey = device_key(device)
    keys = [("tail_matvec", int(v.shape[-1])) for v in X.ell_vals]
    keys += [("bucket_rmatvec", int(v.shape[-1])) for v in X.bucket_vals]
    keys = list(dict.fromkeys(keys))
    cached = _load_cache(cache_dir, device) if cache_dir is not None else {}
    out: dict = {}
    measured = False
    for kind, width in keys:
        ck = f"{kind}:{width}"
        if ck in cached:
            out[ck] = int(cached[ck])
            telemetry.count("kernels.tile_cache_hits")
        else:
            best_dt, best_tile = float("inf"), DEFAULT_TILE
            for tile in candidates:
                dt = _measure_candidate(X, w, r, kind, width, tile,
                                        repeats)
                telemetry.count("kernels.tile_measures")
                if dt < best_dt:
                    best_dt, best_tile = dt, int(tile)
            out[ck] = best_tile
            cached[ck] = best_tile
            measured = True
        with _memo_lock:
            _MEMO[(dkey, kind, width)] = out[ck]
    if cache_dir is not None and measured:
        _persist_cache(cache_dir, device, cached)
    return out
