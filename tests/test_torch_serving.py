"""The port's GAME serving slice against the JAX package, on the CPU.

The same numpy-seeded GAME model (one dense fixed effect, one sparse and
one dense random effect) is built in `photon_tpu`, carried across by
`photon_tpu_torch.convert`, and scored both ways: `matvec`/`score_rows`,
the offline `score_game` sum, and the whole serving path — store →
`ProgramLadder` (f32, bf16 and int8) → `MicroBatchDispatcher` — for both
``output_mean`` settings and across a `reload_coefficients` hot-swap.

Tolerance: f32 scores agree to rtol=1e-6 / atol=1e-6 (the two frameworks
add the same products in another order); quantized blocks are equal bit
for bit (`tests/test_torch_kernels.py`), so the quantized rungs are held
to the same tolerance.
"""
import jax.core
import jax.extend.core

# The JAX package imports `jax.core.ClosedJaxpr`/`Jaxpr`, which jax 0.9
# moved to `jax.extend.core`: alias the missing public names back before
# anything of photon_tpu is imported.
for _name in dir(jax.extend.core):
    if not _name.startswith("_") and not hasattr(jax.core, _name):
        setattr(jax.core, _name, getattr(jax.extend.core, _name))

import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import jax.numpy as jnp  # noqa: E402

from photon_tpu import serving as ref_serving  # noqa: E402
from photon_tpu.data import matrix as ref_matrix  # noqa: E402
from photon_tpu.data.index_map import IndexMap as RefIndexMap  # noqa: E402
from photon_tpu.game import model as ref_model  # noqa: E402
from photon_tpu.game.dataset import GameData as RefGameData  # noqa: E402
from photon_tpu.game.scoring import score_game as ref_score_game  # noqa: E402
from photon_tpu.models.glm import Coefficients as RefCoefficients  # noqa: E402
from photon_tpu.models.glm import GeneralizedLinearModel as RefGLM  # noqa: E402
from photon_tpu.ops.losses import TaskType as RefTaskType  # noqa: E402
from photon_tpu.telemetry.health import QuantileDigest as RefDigest  # noqa: E402

from photon_tpu_torch import serving, telemetry  # noqa: E402
from photon_tpu_torch.convert import game_model_from_arrays  # noqa: E402
from photon_tpu_torch.data.index_map import IndexMap  # noqa: E402
from photon_tpu_torch.data.matrix import SparseRows, matvec  # noqa: E402
from photon_tpu_torch.device import resolve_device  # noqa: E402
from photon_tpu_torch.game.dataset import GameData  # noqa: E402
from photon_tpu_torch.game.model import score_rows  # noqa: E402
from photon_tpu_torch.game.scoring import score_game  # noqa: E402
from photon_tpu_torch.telemetry.health import QuantileDigest  # noqa: E402

TOL = dict(rtol=1e-6, atol=1e-6)
D_FIXED, D_MEMBER, K_MEMBER, D_ITEM = 10, 6, 3, 4
N_MEMBERS, N_ITEMS = 12, 7
CPU = "cpu"


def _ref_game_model(seed=0, task=RefTaskType.LOGISTIC_REGRESSION):
    rng = np.random.default_rng(seed)
    members = np.asarray(sorted(f"m{i:03d}" for i in range(N_MEMBERS)))
    items = np.asarray(sorted(f"i{i:03d}" for i in range(N_ITEMS)))

    def re(name, shard, keys, d):
        return ref_model.RandomEffectModel(
            entity_name=name, feature_shard=shard, task=task,
            coefficients=jnp.asarray(
                rng.normal(size=(len(keys), d)).astype(np.float32)),
            entity_keys=keys,
            key_to_index={k: i for i, k in enumerate(keys.tolist())})

    return ref_model.GameModel({
        "fixed": ref_model.FixedEffectModel(
            RefGLM(RefCoefficients(jnp.asarray(
                rng.normal(size=D_FIXED).astype(np.float32))), task),
            "global"),
        "perMember": re("memberId", "member", members, D_MEMBER),
        "perItem": re("itemId", "item", items, D_ITEM),
    }, task)


def _arrays(m):
    """The reference model's leaves as numpy — what `convert` takes."""
    out = {}
    for name, cm in m.coordinates.items():
        if isinstance(cm, ref_model.FixedEffectModel):
            out[name] = {"type": "fixed", "feature_shard": cm.feature_shard,
                         "means": np.asarray(cm.model.coefficients.means)}
        else:
            out[name] = {"type": "random", "feature_shard": cm.feature_shard,
                         "entity_name": cm.entity_name,
                         "coefficients": np.asarray(cm.coefficients),
                         "entity_keys": np.asarray(cm.entity_keys)}
    return m.task.value, out


def _port_model(ref):
    task, arrays = _arrays(ref)
    return game_model_from_arrays(task, arrays, device=CPU)


def _rows(n, seed=1):
    """n numpy request rows: dense global, ragged sparse member (1..k
    slots), dense item; every 5th member unseen, every 7th item key
    missing."""
    rng = np.random.default_rng(seed)
    xg = rng.normal(size=(n, D_FIXED)).astype(np.float32)
    nnz = rng.integers(1, K_MEMBER + 1, size=n)
    ind = rng.integers(0, D_MEMBER, size=(n, K_MEMBER)).astype(np.int32)
    val = rng.normal(size=(n, K_MEMBER)).astype(np.float32)
    for i in range(n):
        ind[i, nnz[i]:], val[i, nnz[i]:] = 0, 0.0
    xi = rng.normal(size=(n, D_ITEM)).astype(np.float32)
    offs = rng.normal(size=n).astype(np.float32)
    members = [f"zz{i}" if i % 5 == 0 else f"m{i % N_MEMBERS:03d}"
               for i in range(n)]
    items = [None if i % 7 == 0 else f"i{i % N_ITEMS:03d}" for i in range(n)]
    return dict(xg=xg, nnz=nnz, ind=ind, val=val, xi=xi, offs=offs,
                members=members, items=items)


def _requests(mod, r):
    out = []
    for i in range(len(r["offs"])):
        ents = {"memberId": r["members"][i]}
        if r["items"][i] is not None:
            ents["itemId"] = r["items"][i]
        k = r["nnz"][i]
        out.append(mod.ScoreRequest(
            features={"global": r["xg"][i], "item": r["xi"][i],
                      "member": (r["ind"][i, :k], r["val"][i, :k])},
            entities=ents, offset=float(r["offs"][i])))
    return out


def _serve(mod, ladder, reqs):
    disp = mod.MicroBatchDispatcher(ladder, max_delay_us=2000)
    try:
        futs = [disp.submit(q) for q in reqs]
        return np.asarray([f.result(timeout=60) for f in futs], np.float64)
    finally:
        disp.close()


def _ladders(ref, quantize, output_mean):
    kw = dict(floor=8, max_batch=16, sparse_k={"member": K_MEMBER},
              output_mean=output_mean, quantize=quantize, quant_epsilon=0.5)
    rs = ref_serving.CoefficientStore.from_game_model(ref)
    ps = serving.CoefficientStore.from_game_model(_port_model(ref),
                                                  device=CPU)
    return (rs, ref_serving.ProgramLadder(rs, **kw),
            ps, serving.ProgramLadder(ps, **kw))


# ------------------------------------------------------- matvec, score_rows
def test_matvec_and_score_rows_match_reference():
    rng = np.random.default_rng(2)
    X = rng.normal(size=(9, 13)).astype(np.float32)
    w = rng.normal(size=13).astype(np.float32)
    C = rng.normal(size=(9, 13)).astype(np.float32)
    idx = rng.integers(0, 13, size=(9, 4)).astype(np.int32)
    val = rng.normal(size=(9, 4)).astype(np.float32)
    rsp = ref_matrix.SparseRows(jnp.asarray(idx), jnp.asarray(val), 13)
    psp = SparseRows(torch.from_numpy(idx), torch.from_numpy(val), 13)
    Xb = jnp.asarray(X).astype(jnp.bfloat16)
    pairs = [
        (ref_matrix.matvec(jnp.asarray(X), jnp.asarray(w)),
         matvec(torch.from_numpy(X), torch.from_numpy(w))),
        (ref_matrix.matvec(Xb, jnp.asarray(w)),
         matvec(torch.from_numpy(X).to(torch.bfloat16),
                torch.from_numpy(w))),
        (ref_matrix.matvec(rsp, jnp.asarray(w)),
         matvec(psp, torch.from_numpy(w))),
        (ref_model.score_rows(jnp.asarray(X), jnp.asarray(C)),
         score_rows(torch.from_numpy(X), torch.from_numpy(C))),
        (ref_model.score_rows(rsp, jnp.asarray(C)),
         score_rows(psp, torch.from_numpy(C))),
    ]
    for want, got in pairs:
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_next_pow2_matches_reference():
    from photon_tpu_torch.data.matrix import next_pow2

    for x in (0, 1, 2, 3, 8, 9, 100):
        for floor in (1, 2, 8):
            assert next_pow2(x, floor) == ref_matrix.next_pow2(x, floor)


def test_score_game_and_dense_ids_match_reference():
    ref = _ref_game_model(seed=3)
    port = _port_model(ref)
    r = _rows(30, seed=4)
    members = np.asarray(r["members"])
    items = np.asarray([k or "nope" for k in r["items"]])
    np.testing.assert_array_equal(
        port["perMember"].dense_ids(members),
        ref["perMember"].dense_ids(members))
    shards = {"global": r["xg"], "item": r["xi"]}
    want = ref_score_game(ref, RefGameData.build(
        np.zeros(30), {**shards, "member": ref_matrix.SparseRows(
            jnp.asarray(r["ind"]), jnp.asarray(r["val"]), D_MEMBER)},
        {"memberId": members, "itemId": items}, offsets=r["offs"]))
    got = score_game(port, GameData.build(
        np.zeros(30), {**shards, "member": SparseRows(
            r["ind"], r["val"], D_MEMBER)},
        {"memberId": members, "itemId": items}, offsets=r["offs"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ------------------------------------------------------------------- store
def test_store_matches_reference_layout_and_lookups():
    ref = _ref_game_model(seed=5)
    rs = ref_serving.CoefficientStore.from_game_model(ref)
    ps = serving.CoefficientStore.from_game_model(_port_model(ref),
                                                  device=CPU)
    assert ps.order == rs.order and ps.shard_dims() == rs.shard_dims()
    for n in rs.random:
        np.testing.assert_array_equal(ps.random[n].coefficients,
                                      rs.random[n].coefficients)
        assert not ps.random[n].coefficients[-1].any()  # cold-miss row
    keys = ["m003", "nope", "m000", "zz"]
    ids, miss = ps.lookup("perMember", keys)
    rids, rmiss = rs.lookup("perMember", keys)
    np.testing.assert_array_equal(ids, rids)
    assert miss == rmiss == 2
    fixed_ws, re_cs = ps.device_blocks()
    assert fixed_ws["fixed"].device.type == "cpu"
    assert re_cs["perItem"].shape == (N_ITEMS + 1, D_ITEM)


def test_store_save_open_crosses_packages(tmp_path):
    """Either package opens a store the other saved (same on-disk
    format); mmap=True maps the blocks."""
    ref = _ref_game_model(seed=6)
    rs = ref_serving.CoefficientStore.from_game_model(ref)
    ps = serving.CoefficientStore.from_game_model(_port_model(ref),
                                                  device=CPU)
    rs.save(tmp_path / "ref")
    ps.save(tmp_path / "port")
    assert not [f for f in os.listdir(tmp_path / "port") if ".tmp." in f]
    a = serving.CoefficientStore.open(tmp_path / "ref", mmap=True,
                                      device=CPU)
    b = ref_serving.CoefficientStore.open(tmp_path / "port", mmap=True)
    assert a.order == b.order == rs.order and a.task.value == b.task.value
    assert isinstance(a.random["perMember"].coefficients, np.memmap)
    for n in rs.random:
        np.testing.assert_array_equal(a.random[n].coefficients,
                                      b.random[n].coefficients)
    np.testing.assert_array_equal(a.fixed["fixed"].weights,
                                  b.fixed["fixed"].weights)
    np.testing.assert_array_equal(a.lookup("perItem", ["i002", "x"])[0],
                                  b.lookup("perItem", ["i002", "x"])[0])
    with pytest.raises(FileNotFoundError, match="manifest"):
        serving.CoefficientStore.open(tmp_path / "missing", device=CPU)


def test_index_map_tsv_crosses_packages(tmp_path):
    m = IndexMap().build(["a\x01x", "b", "(INTERCEPT)", "c"]).freeze()
    m.save(tmp_path / "p.tsv")
    back = RefIndexMap.load(tmp_path / "p.tsv")
    assert back.keys_in_order() == m.keys_in_order()
    assert IndexMap.load(tmp_path / "p.tsv").get("b") == m.get("b")
    assert m.get("zzz") == IndexMap.NULL_ID and m.intercept_id == 3


# ----------------------------------------------------------- the whole slice
@pytest.mark.parametrize("output_mean", [True, False])
@pytest.mark.parametrize("quantize", [None, "bf16", "int8"])
def test_dispatcher_slice_matches_reference(quantize, output_mean):
    """Same model, same requests through the reference ladder +
    dispatcher and the port's; then a hot-swap to a new model on both."""
    ref = _ref_game_model(seed=7)
    rs, rl, ps, pl = _ladders(ref, quantize, output_mean)
    rl.warmup()
    pl.warmup()
    if quantize:
        assert pl.quant_report["max_abs_diff"] == pytest.approx(
            rl.quant_report["max_abs_diff"], abs=1e-5)
    rows = _rows(37, seed=8)
    want = _serve(ref_serving, rl, _requests(ref_serving, rows))
    got = _serve(serving, pl, _requests(serving, rows))
    np.testing.assert_allclose(got, want, **TOL)
    assert pl.assert_no_retrace() <= len(pl.ladder)

    new = _ref_game_model(seed=9)
    rs.reload_coefficients(ref_serving.CoefficientStore.from_game_model(new))
    ps.reload_coefficients(serving.CoefficientStore.from_game_model(
        _port_model(new), device=CPU))
    want2 = _serve(ref_serving, rl, _requests(ref_serving, rows))
    got2 = _serve(serving, pl, _requests(serving, rows))
    np.testing.assert_allclose(got2, want2, **TOL)
    assert np.abs(got2 - got).max() > 1e-3  # the swap took effect


def test_f32_ladder_equals_offline_score_game():
    """Serving agrees with the offline sum it must match (in the port)."""
    ref = _ref_game_model(seed=10)
    port = _port_model(ref)
    store = serving.CoefficientStore.from_game_model(port, device=CPU)
    ladder = serving.ProgramLadder(store, floor=8, max_batch=16,
                                   sparse_k={"member": K_MEMBER},
                                   output_mean=False)
    rows = _rows(20, seed=11)
    got = _serve(serving, ladder, _requests(serving, rows))
    members = np.asarray(rows["members"])
    items = np.asarray([k or "\x00missing\x00" for k in rows["items"]])
    want = score_game(port, GameData.build(
        np.zeros(20), {"global": rows["xg"], "item": rows["xi"],
                       "member": SparseRows(rows["ind"], rows["val"],
                                            D_MEMBER)},
        {"memberId": members, "itemId": items}, offsets=rows["offs"]))
    np.testing.assert_allclose(got, want.numpy(), **TOL)


def test_hot_swap_under_concurrent_load_is_never_torn():
    """Clients score while another thread swaps between two models: every
    answer is one model's or the other's, never a mix of one model's
    fixed effect with the other's random effects (the store hands out
    one generation atomically; the int8 cache follows it)."""
    models = [_port_model(_ref_game_model(seed=s)) for s in (30, 31)]

    def store(i):
        return serving.CoefficientStore.from_game_model(models[i],
                                                        device=CPU)

    kw = dict(floor=8, max_batch=16, sparse_k={"member": K_MEMBER},
              output_mean=False, quantize="int8", quant_epsilon=0.5)
    reqs = _requests(serving, _rows(48, seed=32))
    want = [_serve(serving, serving.ProgramLadder(store(i), **kw), reqs)
            for i in (0, 1)]
    assert np.abs(want[0] - want[1]).min() > 1e-3
    live = store(0)
    ladder = serving.ProgramLadder(live, **kw)
    ladder.warmup()
    disp = serving.MicroBatchDispatcher(ladder, max_delay_us=100)
    got, errors = [], []
    stop = threading.Event()

    def client():
        try:
            for _ in range(3):
                futs = [(i, disp.submit(q)) for i, q in enumerate(reqs)]
                got.extend((i, f.result(timeout=60)) for i, f in futs)
        except Exception as e:  # reported below
            errors.append(e)

    def swapper():
        i = 0
        while not stop.is_set():
            i ^= 1
            live.reload_coefficients(store(i))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client) for _ in range(8)]
        swap = threading.Thread(target=swapper)
        swap.start()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        stop.set()
        swap.join(timeout=30)
    finally:
        sys.setswitchinterval(old)
        disp.close()
    assert not errors, errors
    assert not swap.is_alive() and not any(t.is_alive() for t in threads)
    assert len(got) == 8 * 3 * len(reqs)
    for i, s in got:
        assert min(abs(s - want[0][i]), abs(s - want[1][i])) <= 1e-5, i


def test_int8_cache_quantizes_the_generation_it_is_keyed_by(monkeypatch):
    """A reload landing between the ladder's read of the store's
    generation and its quantization must not pair the old generation's
    key with the new generation's int8 blocks: the cache quantizes the
    generation it holds (the race that tore answers under concurrent
    hot swaps)."""
    models = [_port_model(_ref_game_model(seed=s)) for s in (30, 31)]
    live = serving.CoefficientStore.from_game_model(models[0], device=CPU)
    ladder = serving.ProgramLadder(live, floor=8, max_batch=16,
                                   sparse_k={"member": K_MEMBER},
                                   quantize="int8")
    old = live.device_blocks()
    live.reload_coefficients(
        serving.CoefficientStore.from_game_model(models[1], device=CPU))
    monkeypatch.setattr(live, "device_blocks", lambda: old)
    fixed_q, re_q = ladder._quant_blocks()
    for n, block in old[0].items():
        q, s = fixed_q[n]
        want_q, want_s = ref_matrix.quantize_blocks(block.numpy())
        np.testing.assert_array_equal(q.numpy(), want_q)
        assert float(s[0]) == float(want_s)
    for n, block in old[1].items():
        np.testing.assert_array_equal(
            re_q[n][0].numpy(), ref_matrix.quantize_blocks(block.numpy())[0])


def test_quantization_refused_on_tiny_epsilon():
    ref = _ref_game_model(seed=12)
    store = serving.CoefficientStore.from_game_model(_port_model(ref),
                                                     device=CPU)
    before = telemetry.snapshot()["counters"].get(
        "serving.quant_refusals", 0)
    ladder = serving.ProgramLadder(store, floor=8, max_batch=8,
                                   sparse_k={"member": K_MEMBER},
                                   quantize="int8", quant_epsilon=1e-9)
    with pytest.raises(serving.QuantizationRefused) as exc:
        ladder.warmup()
    assert exc.value.report["max_abs_diff"] > 1e-9
    assert exc.value.report["mode"] == "int8"
    assert telemetry.snapshot()["counters"][
        "serving.quant_refusals"] == before + 1


# ------------------------------------------------------ dispatcher behavior
def test_dispatcher_counts_cold_misses_and_latency():
    ref = _ref_game_model(seed=13)
    _, _, ps, pl = _ladders(ref, None, True)
    telemetry.reset()
    rows = _rows(25, seed=14)
    disp = serving.MicroBatchDispatcher(pl, max_delay_us=1000)
    scores = [f.result(timeout=60) for f in
              [disp.submit(q) for q in _requests(serving, rows)]]
    disp.close()
    disp.close()  # idempotent
    counters = telemetry.snapshot()["counters"]
    n_miss = (sum(1 for m in rows["members"] if m.startswith("zz"))
              + sum(1 for i in rows["items"] if i is None))
    assert counters["serving.requests"] == 25
    assert counters["serving.cold_misses"] == n_miss
    assert counters["serving.admitted"] == 25
    assert all(0.0 < s < 1.0 for s in scores)
    stats = disp.latency_stats()
    assert stats["n"] == 25 and stats["p50_ms"] <= stats["p99_ms"]
    with pytest.raises(RuntimeError, match="closed"):
        disp.submit(_requests(serving, rows)[0])
    with pytest.raises(ValueError, match="top rung"):
        serving.MicroBatchDispatcher(pl, max_batch=32)


def test_admission_sheds_by_watermark_and_deadline():
    ref = _ref_game_model(seed=15)
    _, _, _, pl = _ladders(ref, None, True)
    req = _requests(serving, _rows(1, seed=16))[0]
    disp = serving.MicroBatchDispatcher(
        pl, policy=serving.AdmissionPolicy(shed_watermark=0))
    shed = disp.submit(req).result(timeout=10)
    disp.close()
    assert isinstance(shed, serving.Shed) and not shed
    assert shed.reason == "watermark"
    disp = serving.MicroBatchDispatcher(
        pl, policy=serving.AdmissionPolicy(deadline_ms=0.0))
    req.deadline_ms = -1.0  # already expired at enqueue
    late = disp.submit(req).result(timeout=10)
    disp.close()
    assert isinstance(late, serving.Shed)
    assert late.reason == "deadline_expired"


def test_collate_rejects_malformed_rows():
    ref = _ref_game_model(seed=17)
    _, _, _, pl = _ladders(ref, None, True)
    rows = _rows(2, seed=18)
    reqs = _requests(serving, rows)
    reqs[1].features["member"] = (np.asarray([0, 1, 2, 3]), np.ones(4))
    with pytest.raises(ValueError, match="sparse_k"):
        serving.collate_rung_args(
            pl, [serving.dispatcher._Pending(q) for q in reqs], 8)
    reqs[1].features["member"] = (np.asarray([D_MEMBER]), np.ones(1))
    with pytest.raises(ValueError, match="outside"):
        serving.collate_rung_args(
            pl, [serving.dispatcher._Pending(q) for q in reqs], 8)


def test_assert_no_retrace_refuses_extra_signatures():
    ref = _ref_game_model(seed=19)
    _, _, _, pl = _ladders(ref, "int8", True)
    pl.warmup()
    for B in (8, 16, 8):
        pl.score_padded(*pl.example_args(B)[:3])
    assert pl.assert_no_retrace() == 2
    with pytest.raises(ValueError, match="not a ladder rung"):
        pl.score_padded(np.zeros(4, np.float32), {}, {})
    pl.signature_log.record("serving.score", (np.zeros(3),))
    pl.signature_log.record("serving.score", (np.zeros(5),))
    with pytest.raises(AssertionError, match="retraced"):
        pl.assert_no_retrace()


def test_quantile_digest_matches_reference():
    v = np.random.default_rng(20).lognormal(13, 1.0, size=500)
    a, b = QuantileDigest(), RefDigest()
    a.add_many(v[:300])
    b.add_many(v[:300])
    for x in v[300:]:
        a.add(x)
        b.add(x)
    assert a.stats_ms() == pytest.approx(b.stats_ms())
    merged = QuantileDigest().merge(a)
    assert merged.n == 500 and merged.quantile(0.5) == a.quantile(0.5)


# -------------------------------------------------------- device policy
def test_entry_points_raise_without_gpu(monkeypatch, tmp_path):
    """No GPU and no device given: every entry point raises instead of
    running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ref = _ref_game_model(seed=21)
    task, arrays = _arrays(ref)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no GPU"):
        game_model_from_arrays(task, arrays)
    port = game_model_from_arrays(task, arrays, device=CPU)
    with pytest.raises(RuntimeError, match="no GPU"):
        serving.CoefficientStore.from_game_model(port)
    serving.CoefficientStore.from_game_model(port, device=CPU).save(
        tmp_path / "s")
    with pytest.raises(RuntimeError, match="no GPU"):
        serving.CoefficientStore.open(tmp_path / "s")
    with pytest.raises(RuntimeError, match="no GPU"):
        resolve_device("cuda:0")


def test_port_imports_neither_jax_nor_the_reference():
    """Every module of photon_tpu_torch, and chip_smoke.py, import with
    no jax and no photon_tpu module loaded (fresh interpreter)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import photon_tpu_torch\n"
        "for m in pkgutil.walk_packages(photon_tpu_torch.__path__,\n"
        "                               'photon_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'photon_tpu'))\n"
        "print(len([m for m in sys.modules\n"
        "           if m.startswith('photon_tpu_torch')]))\n"
        "assert not bad, bad\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    res = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 20
