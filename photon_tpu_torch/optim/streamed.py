"""Streamed (out-of-device-memory) solvers: L-BFGS and OWL-QN whose every
objective evaluation sums over chunks streamed through the device, on one
device or row-sharded over a mesh (port of `photon_tpu/optim/streamed.py`:
`_History`, `_host_wolfe`, `_cubic_min_host`, `_convergence_host`,
`_MeshStream`, `minimize_lbfgs_streamed`, `minimize_owlqn_streamed`).

Reference parity: com.linkedin.photon.ml.function.glm.
DistributedGLMLossFunction drives Breeze L-BFGS/OWL-QN with one
`RDD.treeAggregate` per evaluation; the dataset never lives in one
executor's memory. Here it lives on the host as a `data.dataset.
ChunkedBatch`, each evaluation streams the chunks through the device
(`DeviceChunkRing`: a side stream keeps two chunks in flight, within a
pass and into the next) and sums the `Objective.chunk_*_partials` in f32
on the device, in chunk order, so the device holds a couple of chunks
plus solver state.

The math and the stop rules are the reference's:

- The outer loop runs on the host; the direction, the history push and
  the partials are device work (`two_loop` is the port's own), and the
  convergence test mirrors `optim.lbfgs._convergence` term for term.
- L-BFGS's line search rides per-chunk margins cached on the HOST: the
  gradient pass leaves z, the direction pass dz, each copied from the
  device asynchronously into pinned buffers and read once the pass has
  closed (a copy per chunk that blocked the host would serialize upload
  and compute). A Wolfe trial uploads 16 bytes a row of (z, dz) and the
  labels and weights (8 more), never the features; the first trial rides
  the direction pass, so an iteration that accepts α = 1 costs exactly
  two feature streams. The chain z += α·dz runs in numpy and is
  refreshed from w every `_Z_REFRESH` iterations.
- OWL-QN's orthant projection breaks the margin's linearity, so its
  backtracking ladder is priced `ladder_lanes` candidates per chunk
  visit (`chunk_value_partials_many`: one lane pass, the blocked-ELL
  kernels at K lanes on a ladder); the first rung that passes is the
  resident solver's sequential halving, since each rung's Armijo test is
  memoryless.

Elastic runs: both solvers are host loops, so their full state is
host-visible at every iteration boundary — the crash-consistency cut.
Under a `checkpoint` session each boundary reports the iterate, the
gradient, the curvature history with its cursor, L-BFGS's per-chunk
margin caches (bit for bit through ``.npy``, never re-derived on
resume), the histories, the flags and the evaluation counts, then lets
the cadence decide whether to snapshot; a resumed solve rehydrates that
state, skips the initial pass, and replays the rest bit for bit on the
same card and chunking. Each objective evaluation hits the
``evaluation`` fault site (`_eval_tick`). The session is the switch:
session-less, each touch point is one ``current() is None`` branch.

Attribution: with a `profiling` ledger armed, every pass is a measured
region of its chunk program (``streamed.`` or ``streamed_mesh.``
+ ``chunk_init`` / ``chunk_dz_phi`` / ``chunk_phi`` / ``chunk_grad`` /
``chunk_value_many``) under its phase (``lbfgs/init``,
``lbfgs/direction``, ``lbfgs/linesearch``, ``lbfgs/gradient``,
``owlqn/value_grad``, ``owlqn/ladder``), each closing at the host
read-back the pass already makes, and each program is priced at first
sight (`profiling.model.chunk_cost`, probed for its first-call load and
plan). Disarmed, each is one global load and one branch.

MESH MODE (``mesh=``): every chunk streams row-sharded over the local
slots (`data.dataset.MeshChunkRing`: one upload ring per slot, onto the
slot's device), the chunk partials stay per slot (one per local slot,
summed in chunk order on the slot's device), the margin caches live on
the host in local-slot layout, and each evaluation closes with ONE
reduction over the mesh (`parallel.mesh.psum`) — the same bits at every
process count. A snapshot keys the margin caches by slot
(``z<i>@s<slot>``), so it restores at any process count.

TRON is absent (each CG step would stream the whole dataset), as in the
reference.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from photon_tpu_torch import checkpoint as _ckpt
from photon_tpu_torch import kernels as K
from photon_tpu_torch import profiling, telemetry
from photon_tpu_torch.optim.lbfgs import _Z_REFRESH, two_loop
from photon_tpu_torch.optim.linesearch import C1, C2
from photon_tpu_torch.optim.owlqn import pseudo_gradient
from photon_tpu_torch.optim.tracker import OptResult
from photon_tpu_torch.parallel.mesh import Mesh, SlotParts

__all__ = ["minimize_lbfgs_streamed", "minimize_owlqn_streamed"]

_F32_EPS = float(np.finfo(np.float32).eps)


def _floats(*ts) -> list:
    """Device scalars as Python floats, from one device-to-host copy."""
    return torch.stack([t.reshape(()).to(torch.float32)
                        for t in ts]).tolist()


def _note(program: str, X, args, lanes: int = 1, rows=None) -> None:
    """The ledger's static cost of a chunk program, at its first sight
    under an armed ledger (priced from chunk matrix ``X``, or ``rows`` for
    the feature-free φ trial), probed for its first call's library load
    and plan."""
    if profiling.needs_note(program):
        name = program.split(".", 1)[1]
        profiling.note_program(
            program, profiling.chunk_cost(name, X, rows=rows, lanes=lanes),
            args=args, layout=X)


class _SingleDeviceStream:
    """The one-device regime: chunks stream through the ring onto the
    solve's device; per-chunk margin caches are rows of (n_chunks,
    chunk_rows) host f32 tensors, pinned on a GPU."""

    prog = "streamed."

    def __init__(self, data, device, prefetch=2):
        self.data, self.device = data, device
        self.ring = data.device_ring(device=device, prefetch=prefetch)
        self._cuda = device.type == "cuda"

    def note(self, name, b, *args, lanes=1):
        """`_note` for chunk program ``name`` at device chunk ``b``."""
        _note(self.prog + name, b.X, args + (b,), lanes)

    def note_phi(self, z_row, a):
        _note(self.prog + "chunk_phi", None, (z_row, a),
              rows=self.data.chunk_rows)

    def host_margins(self) -> torch.Tensor:
        return torch.empty((self.data.n_chunks, self.data.chunk_rows),
                           dtype=torch.float32, pin_memory=self._cuda)

    def iter_chunks(self):
        return self.ring.stream_pass()

    def _up(self, row: torch.Tensor) -> torch.Tensor:
        return row.to(self.device, non_blocking=True)

    def sync(self) -> None:
        """Wait for the compute stream: the host margin copies of a pass
        have landed."""
        if self._cuda:
            torch.cuda.current_stream(self.device).synchronize()

    def chunk_init(self, obj, w, b, z_row):
        """Partials of chunk ``b`` at w; its margin copied into ``z_row``."""
        z, parts = obj.chunk_value_grad_partials(w, b)
        z_row.copy_(z, non_blocking=True)
        return parts

    def chunk_grad(self, obj, z_row, b):
        return obj.chunk_partials_at_margin(self._up(z_row), b)

    def chunk_dz_phi(self, obj, p, z_row, a, b, dz_row):
        """φ partials of chunk ``b`` at step ``a``; its direction margin
        copied into ``dz_row``."""
        dz = obj.direction_margin(p, b)
        dz_row.copy_(dz, non_blocking=True)
        return obj.chunk_phi_partials(self._up(z_row), dz, a, b.y,
                                      b.weights)

    def chunk_phi(self, obj, i, z_row, dz_row, a):
        """φ partials of chunk ``i`` from its cached margins: (z, dz) and
        the chunk's labels and weights upload, no features."""
        y, weights = map(self._up, self.ring.host_columns(i)[:2])
        return obj.chunk_phi_partials(self._up(z_row), self._up(dz_row), a,
                                      y, weights)

    def chunk_value_many(self, obj, W, b):
        return (obj.chunk_value_partials_many(W, b),)

    def chunk_grad_at(self, obj, w, b):
        """Partials of chunk ``b`` at w (no margin cached)."""
        return obj.chunk_value_grad_partials(w, b)[1]

    def finish(self, obj, w, acc):
        """(f, g) at w from the summed partials."""
        return obj.finish_value_grad(w, acc)

    def totals(self, acc) -> tuple:
        return acc


def _obj_on(obj, dev, cache: dict):
    """``obj`` with its tensors on ``dev`` (once per device)."""
    import dataclasses

    got = cache.get(dev)
    if got is None:
        got = cache[dev] = dataclasses.replace(obj, **{
            f.name: getattr(obj, f.name).to(dev)
            for f in dataclasses.fields(obj)
            if isinstance(getattr(obj, f.name), torch.Tensor)})
    return got


class _MeshStream:
    """The mesh regime: every chunk row-sharded over the local slots
    (`MeshChunkRing`), partials one per local slot on the slot's device,
    per-chunk margin caches as rows of (n_chunks, n_local_slots · s)
    host f32 tensors (local-slot layout, pinned on a GPU), and each
    evaluation closed by the mesh's one reduction."""

    prog = "streamed_mesh."

    def __init__(self, data, mesh: Mesh, prefetch=2):
        self.data, self.mesh = data, mesh
        self.ring = data.device_ring(mesh=mesh, prefetch=prefetch)
        self.s = data.mesh_chunk_rows(mesh) // mesh.n_slots
        self.devs = mesh.slot_devices
        self._cuda = mesh.home.type == "cuda"
        self._objs: dict = {}

    def host_margins(self) -> torch.Tensor:
        return torch.empty((self.data.n_chunks, self.mesh.n_local * self.s),
                           dtype=torch.float32, pin_memory=self._cuda)

    def note(self, name, bs, *args, lanes=1):
        """`_note` for chunk program ``name``, priced per device on the
        first slot's share of mesh chunk ``bs``."""
        _note(self.prog + name, bs[0].X, args + (bs[0],), lanes)

    def note_phi(self, z_row, a):
        _note(self.prog + "chunk_phi", None, (self._row(z_row, 0), a),
              rows=self.s)

    def iter_chunks(self):
        return self.ring.stream_pass()

    def sync(self) -> None:
        if self._cuda:
            for dev in set(self.devs):
                torch.cuda.current_stream(dev).synchronize()

    def _slots(self, obj, *vecs):
        """(k, slot device, obj there, each of ``vecs`` there) per local
        slot (a vector copied once per device)."""
        on: dict = {}
        for k, dev in enumerate(self.devs):
            if dev not in on:
                on[dev] = [v.to(dev) for v in vecs]
            yield (k, dev, _obj_on(obj, dev, self._objs)) + tuple(on[dev])

    def _row(self, row, k):
        return row[k * self.s:(k + 1) * self.s]

    def chunk_init(self, obj, w, bs, z_row):
        parts = SlotParts()
        for k, dev, o, wk in self._slots(obj, w):
            z, p = o.chunk_value_grad_partials(wk, bs[k])
            self._row(z_row, k).copy_(z, non_blocking=True)
            parts.append(p)
        return parts

    def chunk_grad(self, obj, z_row, bs):
        return SlotParts(
            o.chunk_partials_at_margin(
                self._row(z_row, k).to(dev, non_blocking=True), bs[k])
            for k, dev, o in self._slots(obj))

    def chunk_dz_phi(self, obj, p, z_row, a, bs, dz_row):
        parts = SlotParts()
        for k, dev, o, pk in self._slots(obj, p):
            b = bs[k]
            dz = o.direction_margin(pk, b)
            self._row(dz_row, k).copy_(dz, non_blocking=True)
            parts.append(o.chunk_phi_partials(
                self._row(z_row, k).to(dev, non_blocking=True), dz, a, b.y,
                b.weights))
        return parts

    def chunk_phi(self, obj, i, z_row, dz_row, a):
        parts = SlotParts()
        for k, dev, o in self._slots(obj):
            y, weights = (t.to(dev, non_blocking=True)
                          for t in self.ring.host_columns(k, i)[:2])
            parts.append(o.chunk_phi_partials(
                self._row(z_row, k).to(dev, non_blocking=True),
                self._row(dz_row, k).to(dev, non_blocking=True), a, y,
                weights))
        return parts

    def chunk_grad_at(self, obj, w, bs):
        return SlotParts(o.chunk_value_grad_partials(wk, bs[k])[1]
                         for k, dev, o, wk in self._slots(obj, w))

    def chunk_value_many(self, obj, W, bs):
        return SlotParts((o.chunk_value_partials_many(Wk, bs[k]),)
                         for k, dev, o, Wk in self._slots(obj, W))

    def finish(self, obj, w, acc):
        return obj.finish_value_grad(w, self.mesh.psum(acc))

    def totals(self, acc) -> tuple:
        return self.mesh.psum(acc)


def _backend(data, mesh, prefetch, device):
    if mesh is not None:
        if not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a parallel.mesh.Mesh, got "
                            f"{type(mesh).__name__}")
        return _MeshStream(data, mesh, prefetch)
    return _SingleDeviceStream(data, device, prefetch)


class _History:
    """The circular (s, y) history: device buffers, host bookkeeping.
    `push` applies `optim.lbfgs`'s curvature gate (one read-back)."""

    def __init__(self, m: int, d: int, device):
        self.S = torch.zeros((m, d), dtype=torch.float32, device=device)
        self.Y = torch.zeros((m, d), dtype=torch.float32, device=device)
        self.rho = torch.zeros((m,), dtype=torch.float32, device=device)
        self.m, self.idx, self.count = m, 0, 0
        self.sy, self.yy = 0.0, 0.0
        self.device = device

    def push(self, s, y) -> None:
        sy, yy = _floats(torch.dot(s, y), torch.dot(y, y))
        if not sy > 1e-10 * max(yy, 1e-20):
            return  # curvature condition failed: skip, keep newest stats
        self.S[self.idx] = s
        self.Y[self.idx] = y
        self.rho[self.idx] = float(np.float32(1.0) / np.maximum(
            np.float32(sy), np.float32(1e-20)))
        self.idx = (self.idx + 1) % self.m
        self.count = min(self.count + 1, self.m)
        self.sy, self.yy = sy, yy

    def args(self) -> tuple:
        def t(v):
            return torch.tensor(np.float32(v), device=self.device)

        return (self.S, self.Y, self.rho, self.idx, self.count, t(self.sy),
                t(self.yy))


# ---------------------------------------------------------- host line search
def _sign(x: float) -> float:
    return 0.0 if x == 0.0 else math.copysign(1.0, x)


def _cubic_min_host(a_lo, f_lo, d_lo, a_hi, f_hi, d_hi) -> float:
    """Scalar port of `optim.linesearch._cubic_min` (same safeguards)."""
    span = a_hi - a_lo
    d1 = d_lo + d_hi - 3.0 * (f_lo - f_hi) / (1.0 if span == 0.0 else -span)
    disc = d1 * d1 - d_lo * d_hi
    d2 = _sign(span) * math.sqrt(max(disc, 0.0))
    denom = d_hi - d_lo + 2.0 * d2
    a_c = a_hi - span * (d_hi + d2 - d1) / (1.0 if denom == 0.0 else denom)
    lo_m = a_lo + 0.1 * span
    hi_m = a_hi - 0.1 * span
    inside = ((lo_m <= a_c <= hi_m) if span > 0.0
              else (hi_m <= a_c <= lo_m))
    ok = disc >= 0.0 and denom != 0.0 and math.isfinite(a_c) and inside
    return a_c if ok else 0.5 * (a_lo + a_hi)


def _host_wolfe(phi, f0: float, dphi0: float, a_init: float,
                max_evals: int, first=None):
    """Host port of `optim.linesearch.wolfe_line_search`: the same
    bracket + zoom state machine, one streamed ``phi`` evaluation per
    step, stopping at the first trial that satisfies the strong Wolfe
    conditions. ``first`` is (f, dphi) at ``a_init`` already summed
    during the direction pass. Returns (alpha, f_alpha, ok, trials)."""
    phase, i = 0, 0
    a, a_prev, f_prev, d_prev = a_init, 0.0, f0, dphi0
    a_lo, f_lo, d_lo = 0.0, f0, dphi0
    a_hi = f_hi = d_hi = math.inf
    a_star, f_star = 0.0, f0
    done = False

    def armijo(a_, f_):
        return f_ <= f0 + C1 * a_ * dphi0

    while not done and i < max_evals:
        f, d = first if (first is not None and i == 0) else phi(a)
        f, d = float(f), float(d)
        bad = math.isnan(f) or math.isinf(f)

        if phase == 0:  # bracketing (N&W Alg 3.5)
            to_zoom_hi = bad or not armijo(a, f) or (i > 0 and f >= f_prev)
            wolfe_ok = not to_zoom_hi and abs(d) <= -C2 * dphi0
            to_zoom_rev = (not to_zoom_hi and not wolfe_ok and d >= 0.0)
            expand = not (to_zoom_hi or wolfe_ok or to_zoom_rev)
            n_phase = 1 if (to_zoom_hi or to_zoom_rev) else 0
            n_lo = ((a_prev, f_prev, d_prev) if to_zoom_hi else (a, f, d))
            n_hi = ((a, f, d) if to_zoom_hi else (a_prev, f_prev, d_prev))
        else:  # zoom (Alg 3.6); `a` is the trial point inside [lo, hi]
            shrink_hi = bad or not armijo(a, f) or f >= f_lo
            wolfe_ok = not shrink_hi and abs(d) <= -C2 * dphi0
            flip = not shrink_hi and d * (a_hi - a_lo) >= 0.0
            expand, n_phase = False, 1
            n_lo = (a_lo, f_lo, d_lo) if shrink_hi else (a, f, d)
            n_hi = ((a, f, d) if shrink_hi
                    else ((a_lo, f_lo, d_lo) if flip else (a_hi, f_hi, d_hi)))

        done = wolfe_ok
        a_lo, f_lo, d_lo = n_lo
        a_hi, f_hi, d_hi = n_hi
        interp_a = _cubic_min_host(a_lo, f_lo, d_lo, a_hi, f_hi, d_hi)
        if not (math.isfinite(f_hi) and math.isfinite(d_hi)):
            interp_a = 0.5 * (a_lo + a_hi)
        next_a = 2.0 * a if (phase == 0 and expand) else interp_a

        if done or (armijo(a, f) and f < f_star and not bad):
            a_star, f_star = a, f
        i += 1
        a_prev, f_prev, d_prev = a, f, d
        a, phase = next_a, n_phase

    return a_star, f_star, done or a_star > 0.0, i


def _convergence_host(ok, f_old, f_new, gnorm, g0norm, dphi0,
                      tolerance) -> bool:
    """Host mirror of `optim.lbfgs._convergence` (f32 noise floor)."""
    grad_conv = gnorm <= tolerance * max(1.0, g0norm)
    f_conv = ok and abs(f_old - f_new) <= tolerance * max(
        max(abs(f_old), abs(f_new)), 1e-12)
    noise = 4.0 * _F32_EPS * max(abs(f_old), 1.0)
    precision_limited = (not ok) and abs(dphi0) <= noise
    return grad_conv or f_conv or precision_limited


def _eval_tick(ck, n: int = 1) -> None:
    """One objective evaluation closed: the ``evaluation`` fault site and
    the checkpoint cadence's count. Session-less: one global load and one
    branch."""
    _ckpt.kill_point("evaluation")
    if ck is not None:
        ck.note_evaluations(n)


# ------------------------------------------------- checkpoint (de)hydration
# The layout is the reference's (`photon_tpu/optim/streamed.py`), plus the
# port's evaluation and trial counts, so a resumed result reports the
# uninterrupted run's counts too.
def _pack_stream_state(kind, d, n_chunks, chunk_rows, max_iters, it, f,
                       g0norm, hist, ghist, converged, failed, done, w, g,
                       hist_st, evals, trials, extra=None) -> dict:
    st = {
        "kind": kind, "d": int(d), "n_chunks": int(n_chunks),
        "chunk_rows": int(chunk_rows), "max_iters": int(max_iters),
        "it": int(it), "f": float(f), "g0norm": float(g0norm),
        "hist": hist, "ghist": ghist,
        "converged": bool(converged), "failed": bool(failed),
        "done": bool(done), "w": w, "g": g,
        "S": hist_st.S, "Y": hist_st.Y, "rho": hist_st.rho,
        "h_idx": int(hist_st.idx), "h_count": int(hist_st.count),
        "h_sy": float(hist_st.sy), "h_yy": float(hist_st.yy),
        "evals": int(evals), "trials": int(trials),
    }
    if extra:
        st.update(extra)
    return st


def _validate_stream_state(st: dict, kind: str, d: int, n_chunks: int,
                           chunk_rows: int, max_iters: int) -> None:
    got = (st.get("kind"), int(st.get("d", -1)), int(st.get("n_chunks", -1)),
           int(st.get("chunk_rows", -1)), int(st.get("max_iters", -1)))
    want = (kind, d, n_chunks, chunk_rows, max_iters)
    if got != want:
        raise _ckpt.SnapshotStateError(
            f"streamed-solver snapshot does not fit this solve: snapshot "
            f"(kind, d, n_chunks, chunk_rows, max_iters)={got} vs resuming "
            f"program {want}. Resume must re-run the same problem with the "
            "same chunking and iteration budget.")


def _restore_history(st: dict, history: int, d: int, device) -> _History:
    S, Y, rho = (np.asarray(st["S"]), np.asarray(st["Y"]),
                 np.asarray(st["rho"]))
    if S.shape != (history, d):
        raise _ckpt.SnapshotStateError(
            f"curvature history shape {S.shape} in snapshot vs "
            f"({history}, {d}) in the resuming solve")
    hs = _History(history, d, device)
    hs.S.copy_(torch.from_numpy(np.ascontiguousarray(S, np.float32)))
    hs.Y.copy_(torch.from_numpy(np.ascontiguousarray(Y, np.float32)))
    hs.rho.copy_(torch.from_numpy(np.ascontiguousarray(rho, np.float32)))
    hs.idx, hs.count = int(st["h_idx"]), int(st["h_count"])
    hs.sy, hs.yy = float(st["h_sy"]), float(st["h_yy"])
    return hs


def _restore_z_cache(st: dict, data, z_host: torch.Tensor, mesh) -> None:
    """The per-chunk cached margins out of a snapshot, into the rows of
    ``z_host``: slot-keyed (schema v2, from any number of writing
    processes and any mesh) or a v1 packed vector, re-padded to this
    layout's chunk height (pad rows carry weight 0) and re-sliced to its
    local slots."""
    pad = data.mesh_chunk_rows(mesh) if mesh is not None else data.chunk_rows
    for i in range(data.n_chunks):
        z_host[i].copy_(torch.from_numpy(np.ascontiguousarray(
            _ckpt.unpack_row_slots(st, f"z{i}", mesh, pad,
                                   data.chunk_rows)).reshape(-1)))


def _restore_vector(st: dict, key: str, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(st[key]), np.float32)).to(device)


def _restore_common(st: dict) -> tuple:
    """(hist, ghist, it, converged, failed, done, evals, trials)."""
    return (np.array(st["hist"], np.float32),
            np.array(st["ghist"], np.float32), int(st["it"]),
            bool(st["converged"]), bool(st["failed"]), bool(st["done"]),
            int(st.get("evals", 0)), int(st.get("trials", 0)))


def _result(w, value, gnorm, it, converged, failed, hist, ghist,
            evaluations, trials) -> OptResult:
    dev = w.device

    def t(v, dtype=torch.float32):
        return torch.tensor(v, dtype=dtype, device=dev)

    return OptResult(
        w=w, value=t(np.float32(value)), grad_norm=t(np.float32(gnorm)),
        iterations=int(it), converged=t(bool(converged), torch.bool),
        failed=t(bool(failed), torch.bool),
        loss_history=torch.from_numpy(hist).to(dev),
        grad_norm_history=torch.from_numpy(ghist).to(dev),
        evaluations=int(evaluations), trials=int(trials))


def _acc(acc, parts):
    """Partials summed in chunk order (the first chunk's as they are); a
    mesh's per-slot partials slot by slot."""
    if acc is None:
        return parts
    if isinstance(parts, SlotParts):
        return SlotParts(_acc(a, p) for a, p in zip(acc, parts))
    return tuple(None if a is None else a + b for a, b in zip(acc, parts))


# --------------------------------------------------------- streamed L-BFGS
def minimize_lbfgs_streamed(obj, data, w0: torch.Tensor,
                            max_iters: int = 100, tolerance: float = 1e-7,
                            history: int = 10, max_ls_evals: int = 12,
                            mesh=None, prefetch=2,
                            kernels=None) -> OptResult:
    """L-BFGS whose value and gradient sum over the chunks of ``data`` (a
    `ChunkedBatch`) streamed onto ``w0``'s device: the math and stop rules
    of `optim.lbfgs.minimize_lbfgs_margin`. ``kernels`` scopes the kernel
    mode (`kernels.scope`) over the solve. Telemetry: ``solver.
    feature_streams``, ``solver.evaluations``, ``solver.linesearch_trials``,
    ``solver.iterations``, ``solver.margin_cache.hits`` / ``.refreshes``;
    ``checkpoint.solver_restores`` when it resumed from the current
    `checkpoint` session's snapshot; with a run attached, a
    ``solve.lbfgs_streamed`` span and one ``lbfgs_streamed`` iteration
    event per iteration (and the start's at 0) from the host values the
    loop already holds. ``mesh`` (a `parallel.mesh.Mesh`)
    streams every chunk row-sharded over its slots, one reduction per
    evaluation; ``w0`` then lives on the mesh's home device."""
    with telemetry.span("solve.lbfgs_streamed", mesh=mesh is not None,
                        n_chunks=data.n_chunks), K.scope(kernels):
        return _lbfgs_streamed(obj, data, w0, max_iters, tolerance, history,
                               max_ls_evals, mesh, prefetch)


def _pack_lbfgs_state(d, data, mesh, max_iters, it, f, g0norm, hist,
                      ghist, converged, failed, done, w, g, hist_st, z_host,
                      z_gen, evals, trials) -> dict:
    extra: dict = {}
    for i in range(data.n_chunks):
        local = z_host[i] if mesh is None else z_host[i].view(mesh.n_local,
                                                              -1)
        extra.update(_ckpt.pack_row_slots(local, mesh, data.chunk_rows,
                                          prefix=f"z{i}"))
    extra["z_gen"] = int(z_gen)
    return _pack_stream_state("lbfgs_streamed", d, data.n_chunks,
                              data.chunk_rows, max_iters, it, f, g0norm,
                              hist, ghist, converged, failed, done, w, g,
                              hist_st, evals, trials, extra)


def _lbfgs_streamed(obj, data, w0, max_iters, tolerance, history,
                    max_ls_evals, mesh, prefetch) -> OptResult:
    w = w0 if w0.dtype == torch.float32 else w0.to(torch.float32)
    be = _backend(data, mesh, prefetch, w.device)
    n_chunks = data.n_chunks
    d = int(w.shape[0])
    z_host, dz_host = be.host_margins(), be.host_margins()
    ck = _ckpt.current()
    st = ck.restore("lbfgs_streamed") if ck is not None else None
    z_gen = 0
    if st is not None:
        # ---- resume: the iteration-boundary state rehydrates and the
        # initial pass is skipped (the margins come from the snapshot)
        _validate_stream_state(st, "lbfgs_streamed", d, n_chunks,
                               data.chunk_rows, max_iters)
        w = _restore_vector(st, "w", w.device)
        g = _restore_vector(st, "g", w.device)
        hist_st = _restore_history(st, history, d, w.device)
        _restore_z_cache(st, data, z_host, mesh)
        f, g0norm = float(st["f"]), float(st["g0norm"])
        (hist, ghist, it, converged, failed, done, evals,
         trials) = _restore_common(st)
        z_gen = int(st.get("z_gen", 0))
        telemetry.count("checkpoint.solver_restores")
    else:
        hist_st = _History(history, d, w.device)
        evals = trials = 0

        # ---- initial pass: margins cached per chunk, (f, g) summed
        acc = None
        with profiling.measure(be.prog + "chunk_init", "lbfgs/init",
                               calls=n_chunks):
            for i, b in be.iter_chunks():
                be.note("chunk_init", b, w)
                acc = _acc(acc, be.chunk_init(obj, w, b, z_host[i]))
            f_dev, g = be.finish(obj, w, acc)
            # the host read-back closes the measured pass
            f, g0norm = _floats(f_dev, torch.linalg.vector_norm(g))
            be.sync()
        evals += 1
        telemetry.count("solver.feature_streams")
        telemetry.count("solver.evaluations")
        _eval_tick(ck)
        telemetry.iteration("lbfgs_streamed", 0, f, grad_norm=g0norm)

        hist = np.full(max_iters + 1, np.nan, np.float32)
        ghist = np.full(max_iters + 1, np.nan, np.float32)
        hist[0], ghist[0] = f, g0norm
        it, converged, failed = 0, g0norm <= 1e-14, False
        done = converged
        if ck is not None:
            # the it=0 cut: resuming from here replays a cold start
            ck.update("lbfgs_streamed", _pack_lbfgs_state(
                d, data, mesh, max_iters, it, f, g0norm, hist, ghist,
                converged, failed, done, w, g, hist_st, z_host, z_gen, evals,
                trials))
            ck.maybe_snapshot()
    zn, dzn = z_host.numpy(), dz_host.numpy()
    while not done and it < max_iters:
        p = -two_loop(g, *hist_st.args())
        dphi0_t = torch.dot(p, g)
        bad = dphi0_t >= 0.0
        p = torch.where(bad, -g, p)
        dphi0_t = torch.where(bad, -torch.dot(g, g), dphi0_t)
        c0, c1r, c2r = obj.ray_reg_coeffs(w, p)
        dphi0, pnorm, c0, c1r, c2r = _floats(
            dphi0_t, torch.linalg.vector_norm(p), c0, c1r, c2r)
        a_init = 1.0 if hist_st.count > 0 else 1.0 / max(pnorm, 1.0)

        def reg_ray(a):  # the regularizer's exact quadratic along the ray
            return c0 + a * (c1r + 0.5 * a * c2r), c1r + a * c2r

        # ---- direction pass (feature stream 1 of 2): dz per chunk, the
        # first Wolfe trial's φ(a_init) partials riding along
        a32 = float(np.float32(a_init))
        phis = None
        with profiling.measure(be.prog + "chunk_dz_phi", "lbfgs/direction",
                               calls=n_chunks):
            for i, b in be.iter_chunks():
                be.note("chunk_dz_phi", b, p, z_host[i], a32)
                phis = _acc(phis, be.chunk_dz_phi(obj, p, z_host[i], a32, b,
                                                  dz_host[i]))
            wl0, wd0 = _floats(*be.totals(phis))
            be.sync()
        rv, rd = reg_ray(a_init)
        first_eval = (wl0 + rv, wd0 + rd)
        evals += 1
        telemetry.count("solver.feature_streams")
        telemetry.count("solver.evaluations")
        _eval_tick(ck)

        def phi(a):
            """A trial from the cached margins: no features stream."""
            nonlocal evals
            evals += 1
            telemetry.count("solver.evaluations")
            telemetry.count("solver.margin_cache.hits")
            a32 = float(np.float32(a))
            acc_phi = None
            with profiling.measure(be.prog + "chunk_phi",
                                   "lbfgs/linesearch", calls=n_chunks):
                be.note_phi(z_host[0], a32)
                for i in range(n_chunks):
                    acc_phi = _acc(acc_phi, be.chunk_phi(obj, i, z_host[i],
                                                         dz_host[i], a32))
                wl, wd = _floats(*be.totals(acc_phi))
            _eval_tick(ck)
            rv, rd = reg_ray(a)
            return wl + rv, wd + rd

        alpha, f_star, ok, n_trials = _host_wolfe(phi, f, dphi0, a_init,
                                                  max_ls_evals,
                                                  first=first_eval)
        trials += n_trials
        telemetry.count("solver.linesearch_trials", n_trials)

        if ok:
            a32 = np.float32(alpha)
            w_new = w + float(a32) * p
            zn += a32 * dzn  # the host margin chain: z += α·dz
            refresh = max_iters >= _Z_REFRESH and (it + 1) % _Z_REFRESH == 0
            # ---- gradient pass (feature stream 2 of 2)
            evals += 1
            telemetry.count("solver.feature_streams")
            telemetry.count("solver.evaluations")
            if refresh:
                telemetry.count("solver.margin_cache.refreshes")
                z_gen += 1
            acc = None
            grad_prog = "chunk_init" if refresh else "chunk_grad"
            with profiling.measure(be.prog + grad_prog, "lbfgs/gradient",
                                   calls=n_chunks):
                for i, b in be.iter_chunks():
                    if refresh:  # re-anchor the chained margin on w
                        parts = be.chunk_init(obj, w_new, b, z_host[i])
                    else:
                        be.note("chunk_grad", b, z_host[i])
                        parts = be.chunk_grad(obj, z_host[i], b)
                    acc = _acc(acc, parts)
                _, g_new = be.finish(obj, w_new, acc)
                _eval_tick(ck)
                # the history's curvature read-back closes the pass
                hist_st.push(w_new - w, g_new - g)
                be.sync()
            f_new = f_star  # the accepted trial's value, as the resident
            # margin solver keeps it
        else:
            w_new, g_new, f_new = w, g, f

        (gnorm,) = _floats(torch.linalg.vector_norm(g_new))
        converged = _convergence_host(ok, f, f_new, gnorm, g0norm, dphi0,
                                      tolerance)
        failed = failed or (not ok and not converged)
        it += 1
        hist[it], ghist[it] = f_new, gnorm
        telemetry.count("solver.iterations")
        telemetry.iteration("lbfgs_streamed", it, f_new, grad_norm=gnorm,
                            step=(alpha if ok else 0.0), trials=n_trials)
        w, g, f = w_new, g_new, f_new
        done = converged or not ok
        if ck is not None:
            # the iteration boundary: the crash-consistency cut
            ck.update("lbfgs_streamed", _pack_lbfgs_state(
                d, data, mesh, max_iters, it, f, g0norm, hist, ghist,
                converged, failed, done, w, g, hist_st, z_host, z_gen, evals,
                trials))
            ck.maybe_snapshot()

    (gnorm,) = _floats(torch.linalg.vector_norm(g))
    return _result(w, f, gnorm, it, converged, failed, hist, ghist, evals,
                   trials)


# --------------------------------------------------------- streamed OWL-QN
def minimize_owlqn_streamed(obj, data, w0: torch.Tensor, l1_weight: float,
                            max_iters: int = 100, tolerance: float = 1e-7,
                            history: int = 10, max_ls_evals: int = 20,
                            reg_mask=None, ladder_lanes: int = 8, mesh=None,
                            prefetch=2, kernels=None) -> OptResult:
    """OWL-QN over streamed chunks: the projected backtracking ladder is
    priced ``ladder_lanes`` candidates per chunk stream, so the common
    iteration costs two feature streams (the ladder pass and the accepted
    point's gradient pass). The math and stop rules of `optim.owlqn.
    minimize_owlqn`; ``kernels``, ``mesh`` and the `checkpoint` session as
    in `minimize_lbfgs_streamed` (OWL-QN keeps no margin cache across
    iterations, so its snapshot is the iterate, history and scalars)."""
    with telemetry.span("solve.owlqn_streamed", mesh=mesh is not None,
                        n_chunks=data.n_chunks), K.scope(kernels):
        return _owlqn_streamed(obj, data, w0, l1_weight, max_iters,
                               tolerance, history, max_ls_evals, reg_mask,
                               ladder_lanes, mesh, prefetch)


def _reg_values(obj, W) -> torch.Tensor:
    """The smooth regularizer's value at each column of ``W`` (d, K)."""
    coeff, mu = obj._reg_parts()
    if isinstance(coeff, torch.Tensor):
        coeff = coeff[:, None]
    if isinstance(mu, torch.Tensor):
        mu = mu[:, None]
    dW = W - mu
    rv = 0.5 * torch.sum(coeff * dW * dW, dim=0)
    if obj.prior_full_precision is not None:
        rv = rv + 0.5 * torch.sum(dW * (obj.prior_full_precision @ dW),
                                  dim=0)
    return rv


def _owlqn_streamed(obj, data, w0, l1_weight, max_iters, tolerance, history,
                    max_ls_evals, reg_mask, ladder_lanes, mesh,
                    prefetch) -> OptResult:
    w = w0 if w0.dtype == torch.float32 else w0.to(torch.float32)
    dev = w.device
    be = _backend(data, mesh, prefetch, dev)
    d = int(w.shape[0])
    l1 = float(np.float32(l1_weight))
    mask = (torch.ones((d,), dtype=torch.float32, device=dev)
            if reg_mask is None
            else reg_mask.to(device=dev, dtype=torch.float32))
    c1 = 1e-4  # optim.owlqn's Armijo constant
    ck = _ckpt.current()
    st = ck.restore("owlqn_streamed") if ck is not None else None
    evals = trials = 0

    def l1_term(wv):
        return l1 * torch.sum(mask * torch.abs(wv))

    def pg_norm(wv, gv):
        return torch.linalg.vector_norm(pseudo_gradient(wv, gv, l1, mask))

    def value_grad_pass(w_at):
        """(f, g) at ``w_at`` on the device; the caller's read-back closes
        the pass (and its `value_grad_measured` region)."""
        nonlocal evals
        evals += 1
        telemetry.count("solver.feature_streams")
        telemetry.count("solver.evaluations")
        acc = None
        for _, b in be.iter_chunks():
            be.note("chunk_init", b, w_at)
            acc = _acc(acc, be.chunk_grad_at(obj, w_at, b))
        f_dev, g_at = be.finish(obj, w_at, acc)
        _eval_tick(ck)
        return f_dev, g_at

    def value_grad_measured():
        return profiling.measure(be.prog + "chunk_init", "owlqn/value_grad",
                                 calls=data.n_chunks)

    def pack(it, f, F, pg0norm, hist, ghist, converged, failed, done, w, g,
             hist_st) -> dict:
        return _pack_stream_state(
            "owlqn_streamed", d, data.n_chunks, data.chunk_rows, max_iters,
            it, f, pg0norm, hist, ghist, converged, failed, done, w, g,
            hist_st, evals, trials, {"F": float(F)})

    if st is not None:
        # ---- resume: the iterate, history and scalars rehydrate
        _validate_stream_state(st, "owlqn_streamed", d, data.n_chunks,
                               data.chunk_rows, max_iters)
        w = _restore_vector(st, "w", dev)
        g = _restore_vector(st, "g", dev)
        hist_st = _restore_history(st, history, d, dev)
        f, F, pg0norm = float(st["f"]), float(st["F"]), float(st["g0norm"])
        (hist, ghist, it, converged, failed, done, evals,
         trials) = _restore_common(st)
        telemetry.count("checkpoint.solver_restores")
    else:
        hist_st = _History(history, d, dev)
        with value_grad_measured():
            f_dev, g = value_grad_pass(w)
            f, l1w, pg0norm = _floats(f_dev, l1_term(w), pg_norm(w, g))
        F = f + l1w
        telemetry.iteration("owlqn_streamed", 0, F, grad_norm=pg0norm)
        hist = np.full(max_iters + 1, np.nan, np.float32)
        ghist = np.full(max_iters + 1, np.nan, np.float32)
        hist[0], ghist[0] = F, pg0norm
        it, converged, failed = 0, pg0norm <= 1e-14, False
        done = converged
        if ck is not None:
            ck.update("owlqn_streamed", pack(it, f, F, pg0norm, hist, ghist,
                                             converged, failed, done, w, g,
                                             hist_st))
            ck.maybe_snapshot()
    while not done and it < max_iters:
        pg = pseudo_gradient(w, g, l1, mask)
        p = -two_loop(pg, *hist_st.args())
        p = torch.where(p * pg < 0.0, p, 0.0)
        dphi0_t = torch.dot(p, pg)
        bad = dphi0_t >= 0.0
        p = torch.where(bad, -pg, p)
        dphi0_t = torch.where(bad, -torch.dot(pg, pg), dphi0_t)
        xi = torch.where(w != 0.0, torch.sign(w), torch.sign(-pg))
        dphi0, pnorm = _floats(dphi0_t, torch.linalg.vector_norm(p))
        a0 = 1.0 if hist_st.count > 0 else 1.0 / max(pnorm, 1.0)

        # ---- the ladder: blocks of `ladder_lanes` rungs, each block priced
        # by ONE chunk stream (lane-minor (d, K) candidates)
        ok, w_new = False, None
        n_ls = 0
        while n_ls < max_ls_evals and not ok:
            Kb = min(ladder_lanes, max_ls_evals - n_ls)
            alphas = (a0 * 0.5 ** np.arange(n_ls, n_ls + Kb)).astype(
                np.float32)
            A = torch.from_numpy(alphas).to(dev)
            W = w[:, None] + A[None, :] * p[:, None]
            W = torch.where(W * xi[:, None] > 0.0, W, 0.0)
            dec = pg @ (W - w[:, None])
            l1t = l1 * torch.sum(mask[:, None] * torch.abs(W), dim=0)
            rv = _reg_values(obj, W)
            evals += Kb
            trials += Kb
            telemetry.count("solver.feature_streams")
            telemetry.count("solver.evaluations", Kb)
            telemetry.count("solver.linesearch_trials", Kb)
            acc = None
            with profiling.measure(be.prog + "chunk_value_many",
                                   "owlqn/ladder", calls=data.n_chunks):
                for _, b in be.iter_chunks():
                    be.note("chunk_value_many", b, W, lanes=Kb)
                    acc = _acc(acc, be.chunk_value_many(obj, W.t(), b))
                (vals,) = be.totals(acc)
                host = torch.stack([vals, rv, l1t, dec]).cpu().numpy()
            _eval_tick(ck, Kb)
            vals, rv_h, l1t_h, dec_h = host.astype(np.float64)
            F_cand = vals + rv_h + l1t_h
            for k in range(Kb):  # first passing rung == sequential halving
                if (np.isfinite(F_cand[k]) and dec_h[k] < 0.0
                        and F_cand[k] <= F + c1 * dec_h[k]):
                    ok, w_new = True, W[:, k].contiguous()
                    break
            n_ls += Kb

        if ok:
            with value_grad_measured():  # the gradient stream
                f_dev, g_new = value_grad_pass(w_new)
                hist_st.push(w_new - w, g_new - g)  # smooth-gradient history
                f_new, l1n = _floats(f_dev, l1_term(w_new))
            F_new = f_new + l1n
        else:
            w_new, g_new, f_new, F_new = w, g, f, F

        (pgnorm,) = _floats(pg_norm(w_new, g_new))
        grad_conv = pgnorm <= tolerance * max(1.0, pg0norm)
        f_conv = ok and abs(F - F_new) <= tolerance * max(
            max(abs(F), abs(F_new)), 1e-12)
        noise = 4.0 * _F32_EPS * max(abs(F), 1.0)
        precision_limited = (not ok) and abs(dphi0) <= noise
        converged = grad_conv or f_conv or precision_limited
        failed = failed or (not ok and not converged)
        it += 1
        hist[it], ghist[it] = F_new, pgnorm
        telemetry.count("solver.iterations")
        telemetry.iteration("owlqn_streamed", it, F_new, grad_norm=pgnorm,
                            trials=n_ls)
        w, g, f, F = w_new, g_new, f_new, F_new
        done = converged or not ok
        if ck is not None:
            ck.update("owlqn_streamed", pack(it, f, F, pg0norm, hist, ghist,
                                             converged, failed, done, w, g,
                                             hist_st))
            ck.maybe_snapshot()

    (pgnorm,) = _floats(pg_norm(w, g))
    return _result(w, F, pgnorm, it, converged, failed, hist, ghist, evals,
                   trials)


# ----------------------------------------------------------------- contracts
# The streamed regime's law: a chunk's partials are communication-free
# (one device or each slot of a mesh keeps its own), an evaluation and a
# line-search trial each close with ONE mesh reduction, and the upload
# ring dispatches the chunk program with one argument signature across
# passes.
from photon_tpu_torch.analysis.contracts import register_contract  # noqa: E402
from photon_tpu_torch.analysis.walker import SCATTER_PRIMITIVES  # noqa: E402
from photon_tpu_torch.parallel.mesh import make_mesh  # noqa: E402


def _contract_problem(device, mesh=None, d: int = 6):
    """(obj, w, a host ChunkedBatch of two 16-row chunks per slot)."""
    import numpy as np

    from photon_tpu_torch.data.dataset import chunk_batch, make_batch
    from photon_tpu_torch.ops.losses import TaskType
    from photon_tpu_torch.ops.objective import Objective

    S = mesh.n_slots if mesh is not None else 1
    n = 32 * S
    rng = np.random.default_rng(0)
    batch = make_batch(rng.normal(size=(n, d)).astype(np.float32),
                       (rng.uniform(size=n) < 0.5).astype(np.float32),
                       device="cpu")
    obj = Objective(task=TaskType.LOGISTIC_REGRESSION, l2=0.4)
    home = mesh.home if mesh is not None else torch.device(device)
    w = torch.from_numpy(0.1 * rng.normal(size=d).astype(np.float32))
    return obj, w.to(home), chunk_batch(batch, 16 * S)


def _first_chunk(stream):
    """The stream's first device chunk, with the pass drained."""
    chunks = [b for _, b in stream.iter_chunks()]
    return chunks[0]


@register_contract(
    name="streamed_chunk_init",
    description="one device's streamed chunk-partial program "
                "(chunk_init): margins + (loss, grad) partials, LOCAL "
                "sums only, no host sync",
    collectives={}, tags=("streamed",))
def _contract_streamed_chunk_init(device):
    obj, w, data = _contract_problem(device)
    stream = _SingleDeviceStream(data, torch.device(device))
    b = _first_chunk(stream)
    z = stream.host_margins()[0]
    return ((lambda o, wv, bv: stream.chunk_init(o, wv, bv, z)),
            (obj, w, b))


@register_contract(
    name="streamed_mesh_chunk_init",
    description="the mesh-streamed chunk-partial program on 8 slots: the "
                "partials stay slot-local, ZERO collectives per chunk",
    collectives={}, tags=("mesh-streamed",))
def _contract_streamed_mesh_chunk_init(device):
    mesh = make_mesh(n_devices=8, device=device)
    obj, w, data = _contract_problem(device, mesh)
    stream = _MeshStream(data, mesh)
    bs = _first_chunk(stream)
    z = stream.host_margins()[0]
    return ((lambda o, wv, b: stream.chunk_init(o, wv, b, z)),
            (obj, w, bs))


def _contract_slot_parts(mesh, *shapes):
    import numpy as np

    rng = np.random.default_rng(3)
    return SlotParts(
        tuple(torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(
            mesh.slot_devices[k]) if s is not None else None
            for s in shapes)
        for k in range(mesh.n_local))


@register_contract(
    name="streamed_mesh_finish",
    description="the evaluation close (_MeshStream.finish): value and "
                "gradient partials ride ONE psum — the whole evaluation's "
                "only collective",
    collectives={"psum": 1}, tags=("mesh-streamed",))
def _contract_streamed_mesh_finish(device):
    mesh = make_mesh(n_devices=8, device=device)
    obj, w, data = _contract_problem(device, mesh)
    stream = _MeshStream(data, mesh)
    parts = _contract_slot_parts(mesh, (), (6,), None)
    return ((lambda o, wv, p: stream.finish(o, wv, p)), (obj, w, parts))


@register_contract(
    name="streamed_mesh_blocked_ell_chunk_partials",
    description="a mesh blocked-ELL streamed chunk's partial program "
                "(chunk_blocked_ell(n_shards=8) under _MeshStream): each "
                "slot's ELL/occurrence buckets stay local — ZERO "
                "collectives per chunk, no combining scatter, every bf16 "
                "product accumulating f32",
    collectives={}, forbid=SCATTER_PRIMITIVES, require_f32_accum=True,
    tags=("mesh-streamed", "sparse", "game"))
def _contract_streamed_mesh_blocked_ell_chunk_partials(device):
    import numpy as np

    from photon_tpu_torch.data.dataset import chunk_blocked_ell, make_batch
    from photon_tpu_torch.data.matrix import SparseRows
    from photon_tpu_torch.ops.losses import TaskType
    from photon_tpu_torch.ops.objective import Objective

    mesh = make_mesh(n_devices=8, device=device)
    d, k = 96, 4
    rng = np.random.default_rng(0)
    n = 32 * mesh.n_slots
    sp = SparseRows(rng.integers(0, d, size=(n, k)).astype(np.int32),
                    rng.normal(size=(n, k)).astype(np.float32), d)
    data = chunk_blocked_ell(
        make_batch(sp, (rng.uniform(size=n) < 0.5).astype(np.float32),
                   device="cpu"), n // 2, 16,
        feature_dtype=torch.bfloat16, n_shards=mesh.n_slots)
    stream = _MeshStream(data, mesh)
    bs = _first_chunk(stream)
    z = stream.host_margins()[0]
    obj = Objective(task=TaskType.LOGISTIC_REGRESSION, l2=0.4)
    w = torch.from_numpy(0.1 * rng.normal(size=d).astype(np.float32))
    return ((lambda o, wv, b: stream.chunk_init(o, wv, b, z)),
            (obj, w.to(mesh.home), bs))


@register_contract(
    name="mesh_stream_donated_no_retrace",
    description="the upload ring is signature-stable: rotating the "
                "DeviceChunkRing across two passes (wraparound included) "
                "dispatches the chunk-partial program with ONE argument "
                "signature (the builder drains both passes through the "
                "signature log and raises on divergence), and the "
                "program stays communication-free",
    collectives={}, tags=("streamed",))
def _contract_donated_ring_no_retrace(device):
    from photon_tpu_torch.analysis.rules import TraceSignatureLog

    obj, w, data = _contract_problem(device)
    stream = _SingleDeviceStream(data, torch.device(device))
    log = TraceSignatureLog()
    first = None
    for _ in range(2):  # two passes: the ring wraps across the boundary
        for _, b in stream.iter_chunks():
            log.record("streamed.chunk_init", (obj, w, b))
            first = b if first is None else first
    n_sigs = len(log.signatures("streamed.chunk_init"))
    if n_sigs != 1:
        raise AssertionError(
            f"ring dispatch drifted: {n_sigs} distinct chunk-program "
            "signatures across ring rotations (expected 1)")
    z = stream.host_margins()[0]
    return ((lambda o, wv, bv: stream.chunk_init(o, wv, bv, z)),
            (obj, w, first))


@register_contract(
    name="streamed_mesh_trial_totals",
    description="a line-search trial's (phi, phi') totals "
                "(_MeshStream.totals): trials never multiply the "
                "collective count — ONE psum",
    collectives={"psum": 1}, tags=("mesh-streamed",))
def _contract_streamed_mesh_trial_totals(device):
    mesh = make_mesh(n_devices=8, device=device)
    obj, w, data = _contract_problem(device, mesh)
    stream = _MeshStream(data, mesh)
    parts = _contract_slot_parts(mesh, (), ())
    return (lambda p: stream.totals(p)), (parts,)
