"""ctypes bindings for the C++ native runtime (`src/photon_native.cc`, the
port's own copy of the reference's source): the columnar Avro block
decoder, the open-addressing feature-index store (the PalDB analog) and
raw snappy.

The library is host code, not a device kernel: ``g++ -O3 -shared -fPIC
-std=c++17`` builds it on first use into ``native/_build/`` beside this
file, with a plain C ABI (no pybind11, no PyTorch headers), in a second
or two. The ingest plane's spawn workers import this module at the same
time, so the build runs under an exclusive file lock, writes a temporary
name and moves the finished library into place with ``os.replace``: no
process ever loads a half-written library.

``available()`` gates every fast path. ``get_lib()`` returns None when
the toolchain is missing or the build fails, and ``build_error()`` then
says why (the compiler's stderr); the callers decide whether that is a
fallback (``use_native=None``) or an error (``use_native=True``).
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parent
_SRC = _HERE / "src" / "photon_native.cc"
_LIB_PATH = _HERE / "_build" / "libphoton_native.so"

_lock = threading.Lock()
_lib = None
_tried = False
_error = None


def _fresh() -> bool:
    return (_LIB_PATH.exists()
            and _LIB_PATH.stat().st_mtime >= _SRC.stat().st_mtime)


def _compile() -> None:
    """Build the library under an exclusive lock on ``_build/.lock``: the
    first process in builds into a temporary name and ``os.replace``s it
    onto ``_LIB_PATH``; the others wait on the lock and find it fresh.
    Raises with the compiler's stderr on failure."""
    import fcntl

    _LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
    with open(_LIB_PATH.parent / ".lock", "a") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        try:
            if _fresh():
                return
            tmp = _LIB_PATH.with_name(
                f"{_LIB_PATH.name}.tmp.{os.getpid()}")
            cmd = ["g++", "-O3", "-shared", "-fPIC",
                   "-std=c++17", str(_SRC), "-o", str(tmp)]
            try:
                res = subprocess.run(cmd, capture_output=True, text=True,
                                     timeout=300)
            except (OSError, subprocess.SubprocessError) as e:
                raise RuntimeError(f"{' '.join(cmd)}: {e}") from e
            if res.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"{' '.join(cmd)} exited {res.returncode}:\n"
                    f"{res.stderr.strip()}")
            os.replace(tmp, _LIB_PATH)
        finally:
            fcntl.flock(lk, fcntl.LOCK_UN)


def _bind(lib) -> None:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    f32p = ctypes.POINTER(ctypes.c_float)
    f64p = ctypes.POINTER(ctypes.c_double)
    vp = ctypes.c_void_p

    lib.ph_store_create.restype = vp
    lib.ph_store_create.argtypes = [ctypes.c_uint64]
    lib.ph_store_close.argtypes = [vp]
    lib.ph_store_size.restype = ctypes.c_uint64
    lib.ph_store_size.argtypes = [vp]
    lib.ph_store_get.restype = ctypes.c_int32
    lib.ph_store_get.argtypes = [vp, u8p, ctypes.c_uint32]
    lib.ph_store_insert.restype = ctypes.c_int32
    lib.ph_store_insert.argtypes = [vp, u8p, ctypes.c_uint32]
    lib.ph_store_lookup_batch.argtypes = [vp, u8p, u64p, ctypes.c_uint64, i32p]
    lib.ph_store_insert_batch.argtypes = [vp, u8p, u64p, ctypes.c_uint64, i32p]
    lib.ph_store_dump.restype = ctypes.c_uint64
    lib.ph_store_dump.argtypes = [vp, ctypes.POINTER(ctypes.c_uint32), u8p]
    lib.ph_store_save.restype = ctypes.c_int32
    lib.ph_store_save.argtypes = [vp, ctypes.c_char_p]
    lib.ph_store_open.restype = vp
    lib.ph_store_open.argtypes = [ctypes.c_char_p]

    lib.ph_decode_block.restype = vp
    lib.ph_decode_block.argtypes = [
        u8p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64,
        i32p, i32p, ctypes.c_int32, i32p, ctypes.c_int32, i32p, i32p,
        ctypes.POINTER(vp), ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        i32p, i32p, i32p, i32p]
    lib.ph_decoded_ok.restype = ctypes.c_int32
    lib.ph_decoded_ok.argtypes = [vp]
    lib.ph_decoded_scalars.argtypes = [vp, ctypes.c_int32, f64p, u8p]
    lib.ph_decoded_coo_size.restype = ctypes.c_uint64
    lib.ph_decoded_coo_size.argtypes = [vp, ctypes.c_int32]
    lib.ph_decoded_coo.argtypes = [vp, ctypes.c_int32, i64p, i32p, f32p]
    lib.ph_decoded_entity_arena_size.restype = ctypes.c_uint64
    lib.ph_decoded_entity_arena_size.argtypes = [vp, ctypes.c_int32]
    lib.ph_decoded_entity.argtypes = [vp, ctypes.c_int32, u8p, u64p]
    lib.ph_decoded_free.argtypes = [vp]

    lib.ph_snappy_length.restype = ctypes.c_int64
    lib.ph_snappy_length.argtypes = [u8p, ctypes.c_uint64]
    lib.ph_snappy_uncompress.restype = ctypes.c_int32
    lib.ph_snappy_uncompress.argtypes = [u8p, ctypes.c_uint64, u8p,
                                         ctypes.c_uint64]


def get_lib():
    """The loaded library, built on first use; None if it cannot be built
    or loaded (`build_error` says why). The outcome is memoized per
    process."""
    global _lib, _tried, _error
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            if not _fresh():
                # photon: allow(blocking_under_lock, the first-use compile MUST serialize under _lock — two threads racing g++ onto the same .so is the actual bug; hold time is bounded by the compile timeout and later callers hit the memoized fast path)
                _compile()
            lib = ctypes.CDLL(str(_LIB_PATH))
            _bind(lib)
            _lib = lib
        except Exception as e:  # noqa: BLE001 — reported by build_error
            _lib, _error = None, f"{type(e).__name__}: {e}"
        return _lib


def build_error():
    """Why the library is unavailable (the compiler's stderr, a load
    error), or None."""
    get_lib()
    return _error


def available() -> bool:
    return get_lib() is not None


def require_lib():
    """The library, or RuntimeError carrying `build_error()` — the
    ``use_native=True`` contract: a forced native path never falls back."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError(
            f"photon_tpu_torch.native is unavailable: {_error}")
    return lib


def _as_u8p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def snappy_uncompress(data: bytes) -> bytes:
    """Raw snappy block decompression through the C++ runtime (the ingest
    hot path; `data.snappy` is the pure-Python twin)."""
    lib = require_lib()
    src = np.frombuffer(data, np.uint8)
    n = int(lib.ph_snappy_length(_as_u8p(src), ctypes.c_uint64(len(data))))
    if n < 0:
        raise ValueError("snappy: malformed length varint")
    dst = np.empty(n, np.uint8)
    rc = int(lib.ph_snappy_uncompress(
        _as_u8p(src), ctypes.c_uint64(len(data)), _as_u8p(dst),
        ctypes.c_uint64(n)))
    if rc != 0:
        raise ValueError(f"snappy: malformed block (code {rc})")
    return dst.tobytes()


def pack_keys(keys) -> tuple[np.ndarray, np.ndarray]:
    """utf-8 key list -> (blob, (n+1) u64 offsets) for the batch calls."""
    encoded = [k.encode("utf-8") if isinstance(k, str) else bytes(k)
               for k in keys]
    offsets = np.zeros(len(encoded) + 1, np.uint64)
    offsets[1:] = np.cumsum([len(e) for e in encoded], dtype=np.uint64)
    blob = np.frombuffer(b"".join(encoded), np.uint8).copy() if encoded \
        else np.zeros(0, np.uint8)
    return blob, offsets


class NativeIndexStore:
    """C++ open-addressing feature-index store (PalDBIndexMap analog)."""

    def __init__(self, handle=None, capacity_hint: int = 1024):
        self._lib = require_lib()
        self._h = handle if handle is not None else \
            self._lib.ph_store_create(ctypes.c_uint64(capacity_hint))
        if not self._h:
            raise RuntimeError("ph_store_create/open failed")

    # ------------------------------------------------------------- lifecycle
    def close(self) -> None:
        if self._h:
            self._lib.ph_store_close(self._h)
            self._h = None

    def __del__(self):  # best effort
        try:
            self.close()
        except Exception:  # noqa: BLE001
            pass

    def __len__(self) -> int:
        return int(self._lib.ph_store_size(self._h))

    # ------------------------------------------------------------------- ops
    def insert(self, key: str) -> int:
        k = key.encode("utf-8")
        buf = (ctypes.c_uint8 * len(k)).from_buffer_copy(k)
        return int(self._lib.ph_store_insert(self._h, buf, len(k)))

    def get(self, key: str) -> int:
        k = key.encode("utf-8")
        if not k:
            return -1
        buf = (ctypes.c_uint8 * len(k)).from_buffer_copy(k)
        return int(self._lib.ph_store_get(self._h, buf, len(k)))

    def _batch(self, keys, fn) -> np.ndarray:
        blob, offsets = pack_keys(keys)
        out = np.empty(len(keys), np.int32)
        fn(self._h, _as_u8p(blob),
           offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
           ctypes.c_uint64(len(keys)),
           out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return out

    def lookup_batch(self, keys) -> np.ndarray:
        return self._batch(keys, self._lib.ph_store_lookup_batch)

    def insert_batch(self, keys) -> np.ndarray:
        return self._batch(keys, self._lib.ph_store_insert_batch)

    def keys_in_order(self) -> list[str]:
        n = len(self)
        lens = np.zeros(n, np.uint32)
        total = int(self._lib.ph_store_dump(
            self._h, lens.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            None))
        blob = np.zeros(max(total, 1), np.uint8)
        self._lib.ph_store_dump(
            self._h, lens.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            _as_u8p(blob))
        out, off = [], 0
        raw = blob.tobytes()
        for ln in lens:
            out.append(raw[off:off + int(ln)].decode("utf-8"))
            off += int(ln)
        return out

    # -------------------------------------------------------------------- IO
    def save(self, path) -> None:
        if self._lib.ph_store_save(self._h, str(path).encode()) != 0:
            raise OSError(f"cannot save index store to {path}")

    @classmethod
    def open(cls, path) -> "NativeIndexStore":
        lib = require_lib()
        h = lib.ph_store_open(str(path).encode())
        if not h:
            raise OSError(f"cannot open index store at {path}")
        return cls(handle=h)

    @classmethod
    def from_keys(cls, keys) -> "NativeIndexStore":
        s = cls(capacity_hint=max(len(keys), 64))
        s.insert_batch(list(keys))
        return s


class DecodedBlock:
    """Columnar outputs of one decoded Avro block (see ph_decode_block)."""

    def __init__(self, lib, handle, count, n_stores, n_entities):
        self._lib, self._h = lib, handle
        self.count, self.n_stores, self.n_entities = count, n_stores, n_entities

    @property
    def ok(self) -> bool:
        return bool(self._lib.ph_decoded_ok(self._h))

    def scalars(self, k: int) -> tuple[np.ndarray, np.ndarray]:
        out = np.empty(self.count, np.float64)
        mask = np.empty(self.count, np.uint8)
        self._lib.ph_decoded_scalars(
            self._h, k, out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            _as_u8p(mask))
        return out, mask.astype(bool)

    def coo(self, store_i: int):
        m = int(self._lib.ph_decoded_coo_size(self._h, store_i))
        rows = np.empty(m, np.int64)
        cols = np.empty(m, np.int32)
        vals = np.empty(m, np.float32)
        if m:
            self._lib.ph_decoded_coo(
                self._h, store_i,
                rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                vals.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        return rows, cols, vals

    _NULL_LEN = np.uint64(0xFFFFFFFFFFFFFFFF)  # null union branch sentinel

    def entities(self, e: int) -> np.ndarray:
        """Entity-id column: str per record, None where the field was null
        (a legitimately empty string stays '')."""
        size = int(self._lib.ph_decoded_entity_arena_size(self._h, e))
        arena = np.zeros(max(size, 1), np.uint8)
        offsets = np.zeros(2 * self.count, np.uint64)
        self._lib.ph_decoded_entity(
            self._h, e, _as_u8p(arena),
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)))
        raw = arena.tobytes()
        out = np.empty(self.count, object)
        for i in range(self.count):
            ln = offsets[2 * i + 1]
            out[i] = None if ln == self._NULL_LEN else \
                raw[int(offsets[2 * i]):int(offsets[2 * i]) + int(ln)
                    ].decode("utf-8")
        return out

    def entity_column(self, e: int) -> tuple[np.ndarray, np.ndarray]:
        """Entity-id column as (numpy str array, null mask): the values of
        `entities` with "" at the nulls, decoded in one vectorized pass
        (a per-record loop when an id holds a NUL byte, which a fixed-
        width bytes array would strip)."""
        size = int(self._lib.ph_decoded_entity_arena_size(self._h, e))
        arena = np.zeros(max(size, 1), np.uint8)
        offsets = np.zeros(2 * self.count, np.uint64)
        self._lib.ph_decoded_entity(
            self._h, e, _as_u8p(arena),
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)))
        lens = offsets[1::2]
        null = lens == self._NULL_LEN
        if (arena[:size] == 0).any():
            col = self.entities(e)
            return (np.asarray(["" if v is None else v for v in col],
                               dtype=np.str_), null)
        lens = np.where(null, 0, lens).astype(np.int64)
        width = max(int(lens.max()) if self.count else 0, 1)
        mat = np.zeros((self.count, width), np.uint8)
        starts = offsets[0::2].astype(np.int64)
        intra = np.arange(int(lens.sum()), dtype=np.int64) - np.repeat(
            np.cumsum(lens) - lens, lens)
        rows = np.repeat(np.arange(self.count, dtype=np.int64), lens)
        mat[rows, intra] = arena[np.repeat(starts, lens) + intra]
        col = np.char.decode(mat.view(f"S{width}").reshape(self.count),
                             "utf-8")
        return np.asarray(col, dtype=np.str_), null

    def free(self) -> None:
        if self._h:
            self._lib.ph_decoded_free(self._h)
            self._h = None

    def __del__(self):
        try:
            self.free()
        except Exception:  # noqa: BLE001
            pass


def decode_block(payload: bytes, count: int, row0: int, plan,
                 stores, build_mode: bool) -> DecodedBlock:
    """Run the C++ decoder on one decompressed block payload.

    plan: (ops i32[], aux i32[], ntv_value_kind i32[n_bags],
           store_bag_off i32[n_stores+1], store_bag_idx i32[], n_entities,
           sk_prog i32[], sk_off i32[], bt_flat i32[], bt_off i32[])
    — store s consumes bags store_bag_idx[store_bag_off[s]:
    store_bag_off[s+1]] in that order (the shard config's bag order, which
    fixes feature-id assignment order in build mode); sk_prog/sk_off is
    the skip-program table for generic-skip ops (op 7); bt_flat/bt_off are
    the union branch tables for the scalar/entity union ops (11/12).
    stores: list of NativeIndexStore (column spaces, one per shard).
    """
    lib = require_lib()
    (ops, aux, vkind, sb_off, sb_idx, n_entities, sk_prog, sk_off,
     bt_flat, bt_off) = plan
    n_bags = len(vkind)
    pay = np.frombuffer(payload, np.uint8)
    store_arr = (ctypes.c_void_p * max(len(stores), 1))(
        *[s._h for s in stores])
    # keep the contiguous arrays alive across the call
    arrs = [np.ascontiguousarray(a, np.int32)
            for a in (ops, aux, vkind, sb_off, sb_idx, sk_prog, sk_off,
                      bt_flat, bt_off)]

    def i32(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))

    h = lib.ph_decode_block(
        _as_u8p(pay), ctypes.c_uint64(len(payload)), ctypes.c_uint64(count),
        ctypes.c_uint64(row0), i32(arrs[0]), i32(arrs[1]), len(ops),
        i32(arrs[2]), n_bags, i32(arrs[3]), i32(arrs[4]),
        store_arr, len(stores), n_entities, 1 if build_mode else 0,
        i32(arrs[5]), i32(arrs[6]), i32(arrs[7]), i32(arrs[8]))
    return DecodedBlock(lib, h, count, len(stores), n_entities)
