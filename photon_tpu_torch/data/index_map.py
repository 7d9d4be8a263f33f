"""Feature/entity index maps: keys → dense ids (port of the in-memory part
of `photon_tpu/data/index_map.py`; the native mmap store waits for the
`native/` port).

Key format and the TSV file format are the reference's, so a map saved by
either package loads in the other.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Iterable, Optional

DELIMITER = "\x01"
INTERCEPT_KEY = "(INTERCEPT)"
_HEADER = "#photon_tpu-indexmap"


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
                self.has_intercept = True
            return self.intercept_id
        idx = self.key_to_id.get(key)
        if idx is None:
            if self.frozen:
                return self.NULL_ID
            idx = len(self.key_to_id)
            self.key_to_id[key] = idx
        return idx

    def get(self, key: str) -> int:
        """Lookup without inserting, -1 when absent."""
        if key == INTERCEPT_KEY:
            return self.intercept_id if self.has_intercept else self.NULL_ID
        return self.key_to_id.get(key, self.NULL_ID)

    def freeze(self) -> "IndexMap":
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
