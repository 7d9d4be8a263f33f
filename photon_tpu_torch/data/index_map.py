"""Feature/entity index maps: keys → dense ids (port of
`photon_tpu/data/index_map.py`: the in-memory `IndexMap` and
`PalDBIndexMap` over the native mmap'd store).

Key format and the TSV file format are the reference's, so a map saved by
either package loads in the other.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Iterable, Optional

import numpy as np

DELIMITER = "\x01"
INTERCEPT_KEY = "(INTERCEPT)"
_HEADER = "#photon_tpu-indexmap"


def feature_key(name: str, term: str = "") -> str:
    """Reference: Utils.getFeatureKey(name, term)."""
    return f"{name}{DELIMITER}{term}" if term else name


@dataclasses.dataclass
class IndexMap:
    """Mutable-until-frozen key → id map.

    While unfrozen, ``index_of`` assigns fresh ids on first sight; after
    ``freeze()`` unseen keys return NULL_ID = -1. The intercept key is
    always the last column."""

    key_to_id: dict = dataclasses.field(default_factory=dict)
    frozen: bool = False
    has_intercept: bool = False

    NULL_ID = -1

    def __len__(self) -> int:
        return len(self.key_to_id) + (1 if self.has_intercept else 0)

    @property
    def n_features(self) -> int:
        return len(self)

    @property
    def intercept_id(self) -> Optional[int]:
        return len(self) - 1 if self.has_intercept else None

    def index_of(self, key: str) -> int:
        if key == INTERCEPT_KEY:
            if not self.has_intercept:
                if self.frozen:
                    return self.NULL_ID
                # photon: unguarded(decode workers only ever see FROZEN maps — index_of on a frozen map is read-only; growth happens on the single-threaded scan path before any pool exists)
                self.has_intercept = True
            return self.intercept_id
        idx = self.key_to_id.get(key)
        if idx is None:
            if self.frozen:
                return self.NULL_ID
            idx = len(self.key_to_id)
            # photon: unguarded(decode workers only ever see FROZEN maps — index_of on a frozen map is read-only; growth happens on the single-threaded scan path before any pool exists)
            self.key_to_id[key] = idx
        return idx

    def get(self, key: str) -> int:
        """Lookup without inserting, -1 when absent."""
        if key == INTERCEPT_KEY:
            return self.intercept_id if self.has_intercept else self.NULL_ID
        return self.key_to_id.get(key, self.NULL_ID)

    def freeze(self) -> "IndexMap":
        # photon: unguarded(freeze is the scan-completion step, called once before the decode pool spins up; workers never un-freeze)
        self.frozen = True
        return self

    def build(self, keys: Iterable[str]) -> "IndexMap":
        for k in keys:
            self.index_of(k)
        return self

    def key_of(self, idx: int) -> str:
        """Reverse lookup (reference: IndexMap.getFeatureName)."""
        if self.has_intercept and idx == self.intercept_id:
            return INTERCEPT_KEY
        for k, v in self.key_to_id.items():
            if v == idx:
                return k
        raise KeyError(idx)

    def keys_in_order(self) -> list:
        """All keys in column order (intercept last)."""
        out = [None] * len(self.key_to_id)
        for k, v in self.key_to_id.items():
            out[v] = k
        if self.has_intercept:
            out.append(INTERCEPT_KEY)
        return out

    # ------------------------------------------------------------------ IO
    # TSV: a header line, then one "key<TAB>id" line per key, with the
    # \x01 delimiter escaped as "\\x01".
    def save(self, path) -> None:
        p = Path(path)
        with p.open("w", encoding="utf-8") as f:
            f.write(f"{_HEADER}\t{len(self)}\t{int(self.has_intercept)}\n")
            for k, v in sorted(self.key_to_id.items(), key=lambda kv: kv[1]):
                escaped = k.replace(DELIMITER, "\\x01")
                f.write(f"{escaped}\t{v}\n")

    @staticmethod
    def load(path) -> "IndexMap":
        p = Path(path)
        with p.open("r", encoding="utf-8") as f:
            header = f.readline().rstrip("\n").split("\t")
            if not header or header[0] != _HEADER:
                raise ValueError(f"{p}: not a photon_tpu index map")
            has_intercept = bool(int(header[2]))
            key_to_id = {}
            for line in f:
                k, v = line.rstrip("\n").rsplit("\t", 1)
                key_to_id[k.replace("\\x01", DELIMITER)] = int(v)
        return IndexMap(key_to_id, frozen=True, has_intercept=has_intercept)


class PalDBIndexMap:
    """Frozen feature index map over the native mmap'd C++ hash store.

    Reference parity: com.linkedin.photon.ml.index.PalDBIndexMap — the
    offline store the reference maps at training/scoring time for feature
    spaces too large for a JVM hash map. Same interface subset as a frozen
    IndexMap (get / n_features / intercept_id / keys_in_order), plus
    ``lookup_batch`` for vectorized key resolution. Binary save/load is
    mmap-based: opening a 10M-key store touches no Python per key.
    """

    def __init__(self, store, has_intercept: bool):
        self._store = store
        self.has_intercept = has_intercept
        self.frozen = True

    NULL_ID = IndexMap.NULL_ID

    # --------------------------------------------------------- construction
    @classmethod
    def build(cls, imap: "IndexMap") -> "PalDBIndexMap":
        """Freeze an in-memory IndexMap into a native store."""
        from photon_tpu_torch import native

        keys = imap.keys_in_order()
        if imap.has_intercept:
            keys = keys[:-1]
        return cls(native.NativeIndexStore.from_keys(keys),
                   imap.has_intercept)

    def __len__(self) -> int:
        return len(self._store) + (1 if self.has_intercept else 0)

    @property
    def n_features(self) -> int:
        return len(self)

    @property
    def intercept_id(self) -> Optional[int]:
        return len(self) - 1 if self.has_intercept else None

    def get(self, key: str) -> int:
        if key == INTERCEPT_KEY:
            return self.intercept_id if self.has_intercept else self.NULL_ID
        return self._store.get(key)

    index_of = get  # frozen: lookups never insert

    def lookup_batch(self, keys) -> np.ndarray:
        keys = list(keys)  # materialize: generators must survive two passes
        ids = self._store.lookup_batch(keys)
        if self.has_intercept:
            ids = np.where(
                np.asarray([k == INTERCEPT_KEY for k in keys]),
                np.int32(self.intercept_id), ids)
        return ids

    def keys_in_order(self) -> list:
        out = self._store.keys_in_order()
        if self.has_intercept:
            out.append(INTERCEPT_KEY)
        return out

    def to_index_map(self) -> IndexMap:
        keys = self._store.keys_in_order()
        return IndexMap({k: i for i, k in enumerate(keys)}, frozen=True,
                        has_intercept=self.has_intercept)

    # -------------------------------------------------------------------- IO
    # Binary pair: <path> is the native store; <path>.meta carries the
    # intercept flag.
    def save(self, path) -> None:
        self._store.save(path)
        Path(str(path) + ".meta").write_text(
            f"#photon_tpu-paldb\t{int(self.has_intercept)}\n")

    @classmethod
    def open(cls, path) -> "PalDBIndexMap":
        from photon_tpu_torch import native

        meta = Path(str(path) + ".meta").read_text().rstrip("\n").split("\t")
        if meta[0] != "#photon_tpu-paldb":
            raise ValueError(f"{path}: not a photon_tpu PalDB index map")
        return cls(native.NativeIndexStore.open(path), bool(int(meta[1])))
