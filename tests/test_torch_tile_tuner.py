"""The tiled blocked-ELL forms' work-item tile and its autotuner
(`kernels.tile_override`, `kernels.blocked_ell.resolve_tiles`,
`tuning.tile_tuner`), against the reference's contract
(`tests/test_kernels.py:418-560`).

- the ``PHOTON_TPU_TORCH_KERNELS_TILE`` knob: a power of two of at least
  32, a malformed value raising with the knob's name;
- at every candidate tile, `tail_plan` and `rmatvec_plan` cover each
  bucket's rows and columns exactly once, at most T (clamped) per item;
  the default tile gives today's plans array for array, and an untuned
  process runs the fused forms' plan in the tiled forms;
- the tiled forms on the kernel path, their launches emulated item by
  item on the CPU (each item's rows or columns summed in slot order, so
  an item that missed or repeated one shows), give the same bits at
  every tile as at the default, and a tile set's plan is built once;
- `autotune_tiles`: a cold call measures candidates × keys and hits
  nothing, a warm call (a fresh memo, the same cache directory) measures
  nothing and hits every key; a corrupt, foreign or other card's file is
  a cold cache; the memo and the file are keyed by the card; each
  measurement is attributed to an armed ledger as ``kernels.tile/<kind>``;
- the reference's `autotune_tiles` / `tile_for` contract on the same
  rows: the same keys, the same counter law, `tile_for` serving the
  winners.
"""
import json
import os

import jax.core
import jax.extend.core

# The JAX package imports `jax.core.ClosedJaxpr`/`Jaxpr`, which jax 0.9
# moved to `jax.extend.core`: alias the missing public names back before
# anything of photon_tpu is imported.
for _name in dir(jax.extend.core):
    if not _name.startswith("_") and not hasattr(jax.core, _name):
        setattr(jax.core, _name, getattr(jax.extend.core, _name))

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from photon_tpu.data import matrix as RM  # noqa: E402

from photon_tpu_torch import kernels as K  # noqa: E402
from photon_tpu_torch import profiling, telemetry  # noqa: E402
from photon_tpu_torch.data import matrix as M  # noqa: E402
from photon_tpu_torch.kernels import blocked_ell as KB  # noqa: E402
from photon_tpu_torch.tuning import tile_tuner as TT  # noqa: E402

CPU = "cpu"
TILES = (32,) + TT.CANDIDATE_TILES


def coo(seed=0, n=4096, d=3000, k=8):
    """Zipf(1.3) padded COO rows: width buckets of hundreds to thousands
    of rows and occurrence buckets of up to hundreds of columns, so every
    candidate tile cuts some bucket into several items."""
    rng = np.random.default_rng(seed)
    ind = ((rng.zipf(1.3, (n, k)) - 1) % d).astype(np.int32)
    val = rng.normal(size=(n, k)).astype(np.float32)
    return ind, val, d


def layout(seed=0, **kw):
    ind, val, d = coo(seed, **kw)
    return M.to_blocked_ell(M.SparseRows(ind, val, d), 32, device=CPU)


@pytest.fixture(autouse=True)
def fresh(monkeypatch):
    """No pinned tile and no memoized winner around each test."""
    monkeypatch.delenv(K.ENV_TILE, raising=False)
    TT.reset_memo()
    yield
    TT.reset_memo()


# -------------------------------------------------------------- the knob
@pytest.mark.parametrize("raw", ["wide", "1.5", "48", "16", "8", "0", "-64"])
def test_a_malformed_tile_pin_raises_naming_the_knob(monkeypatch, raw):
    monkeypatch.setenv(K.ENV_TILE, raw)
    with pytest.raises(ValueError, match=K.ENV_TILE):
        K.tile_override()


@pytest.mark.parametrize("raw", ["32", "64", "1024", "4096"])
def test_a_tile_pin_is_a_power_of_two_of_at_least_32(monkeypatch, raw):
    assert K.tile_override() is None
    monkeypatch.setenv(K.ENV_TILE, raw)
    assert K.tile_override() == int(raw)


# ------------------------------------------------------------- the plans
def _shapes(X):
    return ([tuple(int(s) for s in v.shape) for v in X.ell_vals],
            [tuple(int(s) for s in v.shape) for v in X.bucket_vals])


@pytest.mark.parametrize("tile", TILES)
def test_plans_cover_each_bucket_once_at_every_tile(tile):
    tail_shapes, occ_shapes = _shapes(layout())
    plan = KB.tail_plan(tail_shapes, [tile] * len(tail_shapes))
    for b, (r_b, w_b) in enumerate(tail_shapes):
        items = plan[plan[:, 0] == b]
        cap = KB.clamp_tile(KB.TAIL, w_b, tile)
        assert cap == min(tile, KB.BLOCK * KB.rows_per_thread(w_b))
        assert (items[:, 2] <= cap).all() and (items[:, 2] > 0).all()
        covered = np.concatenate([np.arange(r0, r0 + n)
                                  for _, r0, n in items])
        np.testing.assert_array_equal(covered, np.arange(r_b))
    plan = KB.rmatvec_plan(occ_shapes, [tile] * len(occ_shapes))
    for b, (c_b, k_b) in enumerate(occ_shapes):
        items = plan[plan[:, 0] == b]
        cap = KB.clamp_tile(KB.RMATVEC, k_b, tile)
        tpc = KB.threads_per_column(k_b)
        assert (items[:, 3] == tpc).all()
        assert (items[:, 2] <= cap).all() and (items[:, 2] * tpc
                                               <= KB.BLOCK).all()
        covered = np.concatenate([np.arange(c0, c0 + n)
                                  for _, c0, n, _ in items])
        np.testing.assert_array_equal(covered, np.arange(c_b))


def test_the_default_tile_gives_todays_plans():
    tail_shapes, occ_shapes = _shapes(layout())
    np.testing.assert_array_equal(
        KB.tail_plan(tail_shapes, [TT.DEFAULT_TILE] * len(tail_shapes)),
        KB.tail_plan(tail_shapes))
    np.testing.assert_array_equal(
        KB.rmatvec_plan(occ_shapes, [TT.DEFAULT_TILE] * len(occ_shapes)),
        KB.rmatvec_plan(occ_shapes))
    assert KB.resolve_tiles(KB.TAIL, [w for _, w in tail_shapes], CPU) \
        is None
    assert KB.resolve_tiles(KB.RMATVEC, [k for _, k in occ_shapes], CPU) \
        is None


# ------------------------------------- the tiled forms, emulated per item
def _layout_of(plan):
    for ref, pl in KB._PLANS.values():
        if pl is plan:
            return ref()
    raise AssertionError("no layout owns this plan")


def _ranges(ranges):
    flat, n_ranges, _ = ranges
    vals = list(flat)[:2 * n_ranges.value]
    return list(zip(vals[::2], vals[1::2]))


def _slot_sum(v, g):
    """Σ_k v[:, k]·g[:, k] in f32, one slot after another: a row's sum
    does not depend on the rows summed beside it."""
    if g.dim() == 3:
        v = v[:, :, None]
    acc = torch.zeros_like(g[:, 0])
    for k in range(v.shape[1]):
        acc = acc + v[:, k] * g[:, k]
    return acc


def emulate_tail(name, plan, ranges, w, lanes, out, zero_bytes):
    """The tail kernel item by item: each item's rows of its bucket add
    their dot into ``out`` at their original rows."""
    X = _layout_of(plan)
    if zero_bytes:
        out.zero_()
    wt = w[X.d_sel:X.n_prefix]
    bases = np.cumsum([0] + [int(v.shape[0]) for v in X.ell_vals])
    items = plan.tail_items.cpu().numpy()
    for lo, hi in _ranges(ranges):
        for b, row0, rows in items[lo:hi]:
            pc = X.ell_pcols[b][row0:row0 + rows]
            pv = X.ell_vals[b][row0:row0 + rows]
            dots = _slot_sum(*KB._compute(pv, KB._gather(wt, pc)))
            dest = plan.tail_rows[bases[b] + row0:
                                  bases[b] + row0 + rows].long()
            live = dest >= 0
            out[dest[live]] += dots[live]
    K.count_launch(name, ranges[2])


def emulate_rmatvec(name, plan, ranges, r, lanes, square, out,
                    round_r=True):
    """The rmatvec kernel item by item: each item's columns write their
    sums into their slice of ``out`` (NaN first, so a column no item
    covers shows)."""
    X = _layout_of(plan)
    out.fill_(float("nan"))
    bases = np.cumsum([0] + [int(v.shape[0]) for v in X.bucket_vals])
    items = plan.occ_items.cpu().numpy()
    for lo, hi in _ranges(ranges):
        for b, col0, cols, _ in items[lo:hi]:
            br = X.bucket_rows[b][col0:col0 + cols]
            bv = X.bucket_vals[b][col0:col0 + cols]
            g = KB._gather(r, br)
            if square:
                v = bv.float()
                v, g = v * v, g.float()
            elif round_r:
                v, g = KB._compute(bv, g)
            else:
                v, g = bv.float(), g.float()
            out[bases[b] + col0:bases[b] + col0 + cols] = _slot_sum(v, g)
    K.count_launch(name, ranges[2])


@pytest.fixture
def emulated(monkeypatch):
    monkeypatch.setattr(K, "use_kernel", lambda t: K.mode() != "off")
    monkeypatch.setattr(KB, "_launch_tail", emulate_tail)
    monkeypatch.setattr(KB, "_launch_rmatvec", emulate_rmatvec)


@pytest.mark.parametrize("lanes", [0, 3])
@pytest.mark.parametrize("tile", TILES)
def test_tiled_forms_give_the_same_bits_at_every_tile(emulated, monkeypatch,
                                                      tile, lanes):
    X = layout(1).astype(torch.bfloat16)
    n, d = X.shape
    rng = np.random.default_rng(2)
    sh = (lanes,) if lanes else ()
    w = torch.from_numpy(rng.normal(size=(d,) + sh).astype(np.float32))
    r = torch.from_numpy(rng.normal(size=(n,) + sh).astype(np.float32))
    base = torch.from_numpy(rng.normal(size=(n,) + sh).astype(np.float32))

    def forms():
        return (KB.tail_matvec_tiled(X, w, out=base.clone()),
                KB.bucket_rmatvec_tiled(X, r),
                KB.bucket_rmatvec_tiled(X, r, square=True),
                KB.bucket_rmatvec_tiled(X, r, round_r=False))

    want = forms()
    assert not any(bool(torch.isnan(t).any()) for t in want)
    monkeypatch.setenv(K.ENV_TILE, str(tile))
    K.reset_launch_counts()
    got = forms()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    launches = K.launch_counts()
    assert launches[KB.TAIL_TILED] == len(X.ell_vals)
    assert launches[KB.RMATVEC_TILED] == 3 * len(X.bucket_vals)
    with K.scope("off"):
        plain = (KB.tail_matvec_reference(X, w) + base,
                 KB.bucket_rmatvec_reference(X, r))
    for a, b in zip(got, plain):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_a_tile_set_builds_its_plan_once(emulated, monkeypatch):
    X = layout(3)
    n, d = X.shape
    w, r = torch.ones(d), torch.ones(n)
    KB.tail_matvec_tiled(X, w)
    KB.bucket_rmatvec_tiled(X, r)
    builds = KB.plan_builds()
    # the default tile runs the fused forms' plan: nothing new to build
    KB.tail_matvec(X, w)
    KB.tail_matvec_tiled(X, w)
    assert KB.plan_builds() == builds
    monkeypatch.setenv(K.ENV_TILE, "64")
    KB.tail_matvec_tiled(X, w)
    KB.bucket_rmatvec_tiled(X, r)
    assert KB.plan_builds() == builds + 2  # one per kind's tile set
    KB.tail_matvec_tiled(X, w)
    KB.bucket_rmatvec_tiled(X, r)
    assert KB.plan_builds() == builds + 2
    tiled = KB.layout_plan(X, (KB.resolve_tiles(
        KB.TAIL, [int(v.shape[1]) for v in X.ell_vals], CPU), None))
    assert tiled is not KB.layout_plan(X)
    assert tiled.tail_items.shape[0] > KB.layout_plan(X).tail_items.shape[0]


# ------------------------------------------------------------- the tuner
def _problem(seed=4):
    X = layout(seed, n=512, d=400, k=5)
    n, d = X.shape
    rng = np.random.default_rng(seed)
    return (X, torch.from_numpy(rng.normal(size=d).astype(np.float32)),
            torch.from_numpy(rng.normal(size=n).astype(np.float32)))


def _keys(X) -> set:
    return ({f"tail_matvec:{int(v.shape[1])}" for v in X.ell_vals}
            | {f"bucket_rmatvec:{int(v.shape[1])}" for v in X.bucket_vals})


def _counters() -> tuple:
    c = telemetry.snapshot()["counters"]
    return (c.get("kernels.tile_measures", 0),
            c.get("kernels.tile_cache_hits", 0))


def test_cold_measures_warm_reuses(tmp_path):
    X, w, r = _problem()
    telemetry.reset()
    cold = TT.autotune_tiles(X, w, r, cache_dir=str(tmp_path),
                             candidates=(64, 128), repeats=1)
    assert set(cold) == _keys(X)
    assert _counters() == (2 * len(cold), 0)
    assert os.path.exists(TT.tile_cache_path(str(tmp_path), CPU))
    TT.reset_memo()  # a fresh process, the same cache directory
    telemetry.reset()
    warm = TT.autotune_tiles(X, w, r, cache_dir=str(tmp_path),
                             candidates=(64, 128), repeats=1)
    assert warm == cold
    assert _counters() == (0, len(cold))
    for key, tile in warm.items():
        kind, width = key.split(":")
        assert TT.tile_for(kind, int(width), CPU) == tile
    # a warm call in the same process: still nothing measured
    telemetry.reset()
    assert TT.autotune_tiles(X, w, r, cache_dir=str(tmp_path),
                             candidates=(64, 128)) == cold
    assert _counters() == (0, len(cold))


def test_winners_drive_the_tiled_forms(tmp_path):
    X, w, r = _problem(5)
    won = TT.autotune_tiles(X, w, r, cache_dir=str(tmp_path),
                            candidates=(32, 64), repeats=1)
    widths = [int(v.shape[1]) for v in X.bucket_vals]
    tiles = KB.resolve_tiles(KB.RMATVEC, widths, CPU)
    want = tuple(KB.clamp_tile(KB.RMATVEC, k, won[f"bucket_rmatvec:{k}"])
                 for k in widths)
    whole = all(t == KB.max_tile(KB.RMATVEC, k)
                for t, k in zip(want, widths))
    assert tiles == (None if whole else want)
    assert not whole  # 32 or 64 columns cut some bucket's items


@pytest.mark.parametrize("content", ["garbage", "format", "card", "tiles"])
def test_a_corrupt_or_foreign_cache_is_a_cold_cache(tmp_path, content):
    X, w, r = _problem()
    path = TT.tile_cache_path(str(tmp_path), CPU)
    doc = {"format": "photon_tpu_torch-kernel-tiles-v1", "device": "cpu",
           "tiles": {k: 64 for k in _keys(X)}}
    if content == "format":
        doc["format"] = "photon_tpu-kernel-tiles-v1"  # the reference's
    elif content == "card":
        doc["device"] = "NVIDIA H100 80GB HBM3 sm_90"
    elif content == "tiles":
        doc["tiles"] = ["not", "a", "dict"]
    with open(path, "w") as f:
        f.write("{not json" if content == "garbage" else json.dumps(doc))
    telemetry.reset()
    out = TT.autotune_tiles(X, w, r, cache_dir=str(tmp_path),
                            candidates=(64,), repeats=1)
    assert _counters() == (len(out), 0)
    with open(path) as f:  # rewritten whole, for this card
        assert json.load(f)["device"] == "cpu"


def test_an_untuned_process_runs_the_default():
    assert TT.tile_for("tail_matvec", 16, CPU) == TT.DEFAULT_TILE
    assert TT.tile_for("bucket_rmatvec", 64, CPU) == TT.DEFAULT_TILE
    assert TT.DEFAULT_TILE == KB.BLOCK * KB.TAIL_SLOTS_PER_THREAD
    assert TT.DEFAULT_TILE in TT.CANDIDATE_TILES


def test_the_memo_and_the_file_are_keyed_by_the_card(tmp_path,
                                                     monkeypatch):
    monkeypatch.setattr(TT, "_card_key", lambda i: f"Card{i} sm_90")
    card = torch.device("cuda", 0)
    assert TT.device_key(card) == "Card0 sm_90"
    assert TT.device_key(CPU) == "cpu"
    assert TT.tile_cache_path(str(tmp_path), card) != \
        TT.tile_cache_path(str(tmp_path), CPU)
    with TT._memo_lock:
        TT._MEMO[("Card0 sm_90", "tail_matvec", 4)] = 64
    assert TT.tile_for("tail_matvec", 4, card) == 64
    assert TT.tile_for("tail_matvec", 4, CPU) == TT.DEFAULT_TILE
    assert TT.tile_for("tail_matvec", 4, torch.device("cuda", 1)) == \
        TT.DEFAULT_TILE


def test_each_measurement_is_attributed_to_an_armed_ledger(tmp_path):
    X, w, r = _problem()
    with profiling.ledger("tiles") as led:
        out = TT.autotune_tiles(X, w, r, candidates=(64, 128), repeats=2)
    programs = {p for p, _ in led.attributions}
    assert programs <= {"kernels.tile/tail_matvec",
                        "kernels.tile/bucket_rmatvec"}
    calls = sum(v["calls"] for v in led.attributions.values())
    assert calls == 2 * 2 * len(out)


# --------------------------------------------------- the reference's law
def test_the_reference_tuner_contract_holds_for_the_port(tmp_path):
    """`tests/test_kernels.py::TestTileTuner` on the same rows in both
    packages: the same (kind, width) keys, a cold call measuring
    candidates × keys with no hit, a warm call (a fresh memo, the same
    directory) measuring nothing and hitting every key, and `tile_for`
    serving each winner."""
    from photon_tpu import telemetry as rtelemetry
    from photon_tpu.tuning import tile_tuner as RTT

    ind, val, d = coo(6, n=512, d=400, k=5)
    ref = RM.to_blocked_ell(RM.SparseRows(ind, val, d), 32)
    port = M.to_blocked_ell(M.SparseRows(ind, val, d), 32, device=CPU)
    rng = np.random.default_rng(6)
    w = rng.normal(size=d).astype(np.float32)
    r = rng.normal(size=512).astype(np.float32)
    laws = {}
    for name, tt, count, args in (
            ("ref", RTT, None, (ref, jnp.asarray(w), jnp.asarray(r))),
            ("port", TT, None, (port, torch.from_numpy(w),
                                torch.from_numpy(r)))):
        cache = str(tmp_path / name)
        os.makedirs(cache)
        tt.reset_memo()
        seen = []
        for _ in range(2):
            if name == "ref":
                run = rtelemetry.start_run(f"tiles_{name}")
                try:
                    got = tt.autotune_tiles(*args, cache_dir=cache,
                                            candidates=(64, 128), repeats=1)
                    seen.append((run.counters.get("kernels.tile_measures",
                                                  0),
                                 run.counters.get("kernels.tile_cache_hits",
                                                  0)))
                finally:
                    rtelemetry.finish_run()
            else:
                telemetry.reset()
                got = tt.autotune_tiles(*args, cache_dir=cache,
                                        candidates=(64, 128), repeats=1)
                seen.append(_counters())
            for key, tile in got.items():
                kind, width = key.split(":")
                served = (tt.tile_for(kind, int(width)) if name == "ref"
                          else tt.tile_for(kind, int(width), CPU))
                assert served == tile
            tt.reset_memo()
        laws[name] = (set(got), seen)
    RTT.reset_memo()
    assert laws["port"][0] == laws["ref"][0]
    keys = len(laws["ref"][0])
    assert laws["ref"][1] == laws["port"][1] == [(2 * keys, 0), (0, keys)]
