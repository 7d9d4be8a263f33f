"""The port's data layer under the drivers (`photon_tpu_torch.data`:
`ingest`, `feature_bags`, `validators`, `sampling`, `statistics`,
`streaming`, `model_io`, and `continual.delta.build_manifest`) against the
JAX package's, on GAME Avro written from a numpy seed under ``tmp_path``.

`read_game_data` gives bit-equal labels, weights, offsets and entity ids,
equal index maps, and dense and `SparseRows` shards equal to the
reference's (its Python decoder); a frozen map drops unseen features as
the reference's; the validators raise the same messages; down-sampling
keeps the same rows for the same seed; `FeatureSummary` agrees within
rtol = atol = 1e-6 on dense and sparse shards (both sum in f32, in
other orders) and saves files either
package loads; `build_manifest` gives equal dicts; `iter_game_chunks` and
`scan_ingest` give the reference's chunks and scans; saved models load
across the packages.
"""
import jax.core
import jax.extend.core

# `photon_tpu` imports `jax.core.ClosedJaxpr`/`Jaxpr`, names jax 0.9 moved
# to `jax.extend.core`: alias the missing public names back before
# anything of photon_tpu is imported.
for _name in dir(jax.extend.core):
    if not _name.startswith("_") and not hasattr(jax.core, _name):
        setattr(jax.core, _name, getattr(jax.extend.core, _name))

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from photon_tpu.continual.delta import build_manifest as ref_manifest  # noqa
from photon_tpu.data import feature_bags as RF  # noqa: E402
from photon_tpu.data import ingest as RI  # noqa: E402
from photon_tpu.data import model_io as RMIO  # noqa: E402
from photon_tpu.data import sampling as RSM  # noqa: E402
from photon_tpu.data import streaming as RST  # noqa: E402
from photon_tpu.data import validators as RV  # noqa: E402
from photon_tpu.data.statistics import FeatureSummary as RFS  # noqa: E402
from photon_tpu.ops.losses import TaskType as RTask  # noqa: E402

from photon_tpu_torch.continual.delta import build_manifest  # noqa: E402
from photon_tpu_torch.data import avro_io as PA  # noqa: E402
from photon_tpu_torch.data import feature_bags as PF  # noqa: E402
from photon_tpu_torch.data import ingest as PI  # noqa: E402
from photon_tpu_torch.data import model_io as PMIO  # noqa: E402
from photon_tpu_torch.data import sampling as PSM  # noqa: E402
from photon_tpu_torch.data import streaming as PST  # noqa: E402
from photon_tpu_torch.data import validators as PV  # noqa: E402
from photon_tpu_torch.data.matrix import SparseRows  # noqa: E402
from photon_tpu_torch.data.statistics import FeatureSummary  # noqa: E402
from photon_tpu_torch.ops.losses import TaskType  # noqa: E402

BAGS = ("global", "wide", "puser")
SHARDS = {
    "fixed": {"bags": ["global"], "has_intercept": True},
    "wide": {"bags": ["wide", "global"], "has_intercept": True,
             "dense_threshold": 16},
    "user": {"bags": ["puser"], "has_intercept": False},
}


def game_records(n: int, seed: int) -> list:
    """Records with a dense bag, a wide zipf bag (duplicates, empty rows,
    terms), a per-user bag, null and set offsets/weights, a null uid."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        k = int(rng.integers(0, 6))
        wide = [{"name": f"w{int(j)}", "term": ("t" if j % 3 else ""),
                 "value": float(rng.normal())}
                for j in rng.zipf(1.5, k) % 60]
        out.append({
            "response": float(rng.uniform() < 0.4),
            "offset": None if i % 4 else float(rng.normal() * 0.1),
            "weight": None if i % 5 else float(rng.uniform(0.5, 2.0)),
            "uid": None if i == 3 else f"row{i}",
            "userId": f"u{int(rng.integers(0, 9))}",
            "global": [{"name": "age", "term": "", "value":
                        float(rng.normal())},
                       {"name": "ctr", "term": "7d", "value":
                        float(rng.normal())}],
            "wide": wide,
            "puser": [{"name": "bias", "term": "", "value": 1.0},
                      {"name": "h", "term": "", "value":
                       float(rng.uniform())}],
        })
    return out


def write(path, recs, codec="deflate", block_records=40):
    schema = PI.training_example_schema(feature_bags=BAGS,
                                        entity_fields=("userId",))
    PA.write_avro(path, recs, schema, codec=codec,
                  block_records=block_records)
    return path


def configs():
    p = PI.GameDataConfig(
        shards={k: PF.FeatureShardConfig.coerce(v)
                for k, v in SHARDS.items()}, entity_fields=("userId",))
    r = RI.GameDataConfig(
        shards={k: RF.FeatureShardConfig.coerce(v)
                for k, v in SHARDS.items()}, entity_fields=("userId",))
    return p, r


@pytest.fixture(scope="module")
def avro(tmp_path_factory):
    root = tmp_path_factory.mktemp("ingest")
    return (write(root / "train.avro", game_records(230, 0)),
            write(root / "other.avro", game_records(90, 1),
                  codec="snappy", block_records=25))


def assert_maps_equal(pm, rm):
    assert pm.keys_in_order() == rm.keys_in_order()
    assert pm.key_to_id == rm.key_to_id
    assert (pm.has_intercept, pm.frozen) == (rm.has_intercept, rm.frozen)


def assert_shards_equal(P, R):
    for name, X in P.shards.items():
        RX = R.shards[name]
        if isinstance(X, SparseRows):
            np.testing.assert_array_equal(X.indices, np.asarray(RX.indices))
            np.testing.assert_array_equal(X.values, np.asarray(RX.values))
            assert X.n_features == RX.n_features
        else:
            np.testing.assert_array_equal(X, np.asarray(RX))


def assert_data_equal(P, R):
    for f in ("y", "weights", "offsets"):
        np.testing.assert_array_equal(getattr(P, f),
                                      np.asarray(getattr(R, f)))
    assert P.entity_ids.keys() == R.entity_ids.keys()
    for k in P.entity_ids:
        np.testing.assert_array_equal(P.entity_ids[k],
                                      np.asarray(R.entity_ids[k]))
    assert_shards_equal(P, R)


def test_read_game_data_matches_reference(avro):
    pcfg, rcfg = configs()
    P, pmaps = PI.read_game_data(str(avro[0]), pcfg)
    R, rmaps = RI.read_game_data(str(avro[0]), rcfg, use_native=False)
    assert_data_equal(P, R)
    for k in pmaps:
        assert_maps_equal(pmaps[k], rmaps[k])
    assert isinstance(P.shards["wide"], SparseRows)
    assert isinstance(P.shards["wide"].indices, np.ndarray)
    assert isinstance(P.shards["fixed"], np.ndarray)
    # the scoring side: frozen training maps, unseen features dropped
    P2, _ = PI.read_game_data(str(avro[1]), pcfg, index_maps=pmaps)
    R2, _ = RI.read_game_data(str(avro[1]), rcfg, index_maps=rmaps,
                              use_native=False)
    assert_data_equal(P2, R2)


def test_fixed_sparse_k_and_records_path(avro):
    pcfg, rcfg = configs()
    recs = PA.read_avro(avro[0])
    with pytest.warns(UserWarning, match="truncated|exceed"):
        P, _ = PI.records_to_game_data(recs, pcfg, sparse_k=4)
    with pytest.warns(UserWarning, match="truncated|exceed"):
        R, _ = RI.records_to_game_data(recs, rcfg, sparse_k=4)
    assert P.shards["wide"].indices.shape[1] == 4
    assert_data_equal(P, R)


def test_native_decoder_raises_naming_its_item(avro, monkeypatch,
                                               tmp_path):
    """use_native=True decodes natively (equal to the Python read); with a
    library that cannot build it raises, naming the compiler's error,
    and never falls back."""
    from photon_tpu_torch import native

    pcfg, _ = configs()
    want, wmaps = PI.read_game_data(str(avro[0]), pcfg, use_native=False)
    got, gmaps = PI.read_game_data(str(avro[0]), pcfg, use_native=True)
    assert_data_equal(got, want)
    maps = PST.scan_ingest(str(avro[0]), pcfg).index_maps
    bad = tmp_path / "broken.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SRC", bad)
    monkeypatch.setattr(native, "_LIB_PATH", tmp_path / "_build" / "lib.so")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_error", None)
    with pytest.raises(RuntimeError, match="broken.cc"):
        PI.read_game_data(str(avro[0]), pcfg, use_native=True)
    with pytest.raises(RuntimeError, match="broken.cc"):
        PST.iter_game_chunks(str(avro[0]), pcfg, maps, sparse_k=8,
                             use_native=True)


def test_feature_bags_match_reference(avro):
    recs = PA.read_avro(avro[0])
    for cfg in SHARDS.values():
        pc, rc = (PF.FeatureShardConfig.coerce(cfg),
                  RF.FeatureShardConfig.coerce(cfg))
        pn = [{b: PI.normalize_bag(r.get(b)) for b in pc.bags} for r in recs]
        rn = [{b: RI.normalize_bag(r.get(b)) for b in rc.bags} for r in recs]
        PX, pm = PF.build_shard(pn, pc)
        RX, rm = RF.build_shard(rn, rc)
        assert_maps_equal(pm, rm)
        if isinstance(PX, SparseRows):
            np.testing.assert_array_equal(PX.values, np.asarray(RX.values))
        else:
            np.testing.assert_array_equal(PX, np.asarray(RX))


def bad_data(module, sparse):
    y = np.array([0.0, 1.0, 2.0, np.nan, 1.0], np.float32)
    w = np.array([1.0, -1.0, 1.0, 1.0, np.inf], np.float32)
    o = np.array([0.0, np.nan, 0.0, 0.0, 0.0], np.float32)
    ind = np.zeros((5, 2), np.int32)
    val = np.array([[1.0, 0], [np.nan, 0], [1, 1], [np.inf, 0], [0, 0]],
                   np.float32)
    X = sparse(ind, val, 4)
    return module.GameData(y, w, o, {"s": X, "d": val},
                           {"u": np.array(list("abcde"))})


@pytest.mark.parametrize("mode", ["validate_full", "validate_sample"])
def test_validators_raise_the_same_errors(mode):
    from photon_tpu.data.matrix import SparseRows as RSR
    from photon_tpu.game import dataset as RGD

    import photon_tpu_torch.game.dataset as PGD

    for task in ("LOGISTIC_REGRESSION", "POISSON_REGRESSION",
                 "LINEAR_REGRESSION"):
        errs = []
        for V, T, mod, sp in ((PV, TaskType, PGD, SparseRows),
                              (RV, RTask, RGD, RSR)):
            data = bad_data(mod, sp)
            with pytest.raises(ValueError) as e:
                V.validate_game_data(data, T[task],
                                     V.DataValidationType(mode))
            errs.append(str(e.value))
            with pytest.raises(ValueError) as e:
                V.validate_glm_data(data.y, X=data.shards["s"],
                                    weights=data.weights,
                                    offsets=data.offsets, task=T[task],
                                    mode=V.DataValidationType(mode))
            errs.append(str(e.value))
        assert errs[:2] == errs[2:]
    data = bad_data(PGD, SparseRows)
    PV.validate_game_data(data, TaskType.LOGISTIC_REGRESSION,
                          PV.DataValidationType.DISABLED)


@pytest.mark.parametrize("rate", [0.3, 1.0])
def test_down_sampling_keeps_the_same_rows(rate):
    rng = np.random.default_rng(7)
    y = (rng.uniform(size=500) < 0.3).astype(np.float32)
    w = rng.uniform(0.5, 2, 500).astype(np.float32)
    for seed in (0, 5):
        for a, b in ((PSM.default_down_sample(500, rate, w, seed),
                      RSM.default_down_sample(500, rate, w, seed)),
                     (PSM.binary_down_sample(y, rate, w, seed),
                      RSM.binary_down_sample(y, rate, w, seed))):
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])
        for binary in (False, True):
            np.testing.assert_array_equal(
                PSM.down_sample_weights(y, rate, w, seed, binary=binary),
                RSM.down_sample_weights(y, rate, w, seed, binary=binary))
    with pytest.raises(ValueError, match="rate"):
        PSM.default_down_sample(5, 0.0)


def assert_summary_close(p, r):
    assert p.count == r.count
    for f in ("mean", "variance", "minimum", "maximum", "abs_max",
              "norm_l1", "norm_l2"):
        np.testing.assert_allclose(getattr(p, f), getattr(r, f),
                                   rtol=1e-6, atol=1e-6, err_msg=f)
    np.testing.assert_array_equal(p.num_nonzeros, r.num_nonzeros)


def test_feature_summary_matches_reference(avro, tmp_path):
    pcfg, rcfg = configs()
    P, _ = PI.read_game_data(str(avro[0]), pcfg)
    R, _ = RI.read_game_data(str(avro[0]), rcfg, use_native=False)
    for name in SHARDS:
        p = FeatureSummary.compute(P.shards[name], device="cpu")
        r = RFS.compute(R.shards[name])
        assert_summary_close(p, r)
        assert_summary_close(p, RFS.compute_host(R.shards[name]))
        # tensors are summarized on their own device
        X = P.shards[name]
        Xt = (X.to("cpu") if isinstance(X, SparseRows)
              else torch.from_numpy(X))
        assert_summary_close(FeatureSummary.compute(Xt), p)
        p.save(str(tmp_path / f"{name}.json"))
        assert_summary_close(RFS.load(str(tmp_path / f"{name}.json")), p)
        r.save(str(tmp_path / f"r{name}.json"))
        assert_summary_close(FeatureSummary.load(
            str(tmp_path / f"r{name}.json")), r)
    # a large-mean, small-variance column keeps its variance
    X = (5000.0 + np.random.default_rng(0).normal(0, 0.1, (400, 2))
         ).astype(np.float32)
    assert_summary_close(FeatureSummary.compute(X, device="cpu"),
                         RFS.compute(X))
    with pytest.raises(NotImplementedError, match="item 10"):
        FeatureSummary.compute(X, mesh=object(), device="cpu")


def test_build_manifest_matches_reference(avro):
    pcfg, rcfg = configs()
    P, _ = PI.read_game_data(str(avro[0]), pcfg)
    R, _ = RI.read_game_data(str(avro[0]), rcfg, use_native=False)
    P.weights[::7] = 0.0
    R = R.__class__(R.y, P.weights.copy(), R.offsets, R.shards,
                    R.entity_ids)
    assert build_manifest(P) == ref_manifest(R)
    assert build_manifest(P, ["userId"]) == ref_manifest(R, ["userId"])


@pytest.mark.parametrize("chunk_rows", [30, 64, 1000])
def test_chunks_match_reference(avro, chunk_rows):
    pcfg, rcfg = configs()
    scan = PST.scan_ingest(str(avro[0]), pcfg)
    rscan = RST.scan_ingest(str(avro[0]), rcfg)
    assert scan.block_index == rscan.block_index
    assert scan.n_rows == rscan.n_rows == 230
    for k in scan.index_maps:
        assert_maps_equal(scan.index_maps[k], rscan.index_maps[k])
    assert (PST.scan_row_counts(str(avro[0]))
            == RST.scan_row_counts(str(avro[0])) == [230])
    head = PST.scan_ingest(str(avro[0]), PI.GameDataConfig(shards={}))
    assert head.n_rows == 230 and head.index_maps == {}
    for uniform in (True, False):
        kw = dict(chunk_rows=chunk_rows, sparse_k=8 if uniform else None,
                  uniform_sparse_k=uniform)
        ps, pchunks = PST.iter_game_chunks(str(avro[0]), pcfg,
                                           scan.index_maps,
                                           use_native=False, **kw)
        rs, rchunks = RST.iter_game_chunks(str(avro[0]), rcfg,
                                           rscan.index_maps,
                                           use_native=False, **kw)
        pl, rl = list(pchunks), list(rchunks)
        assert [c.n for c in pl] == [c.n for c in rl]
        for a, b in zip(pl, rl):
            assert_data_equal(a, b)
        assert ps.peak_arena_bytes == rs.peak_arena_bytes


def test_chunks_need_frozen_maps(avro):
    pcfg, _ = configs()
    with pytest.raises(ValueError, match="frozen index maps"):
        PST.iter_game_chunks(str(avro[0]), pcfg, {})


def test_saved_models_load_across_packages(tmp_path):
    from photon_tpu.data.index_map import IndexMap as RIM

    from photon_tpu_torch.convert import game_model_from_arrays
    from photon_tpu_torch.data.index_map import IndexMap

    rng = np.random.default_rng(2)
    fixed = rng.normal(size=5).astype(np.float32)
    fixed[1] = 0.0
    keys = np.array(["a", "b", "c"])
    coeffs = rng.normal(size=(3, 2)).astype(np.float32)
    model = game_model_from_arrays(TaskType.LOGISTIC_REGRESSION, {
        "fixed": {"type": "fixed", "feature_shard": "f", "means": fixed},
        "per_user": {"type": "random", "feature_shard": "u",
                     "entity_name": "userId", "coefficients": coeffs,
                     "entity_keys": keys}}, device="cpu")
    maps = {"fixed": IndexMap().build(["x", "y\x01t", "z", "w"]),
            "per_user": IndexMap().build(["bias", "h"]).freeze()}
    maps["fixed"].index_of("(INTERCEPT)")
    maps["fixed"].freeze()
    PMIO.save_game_model(tmp_path / "p", model, maps,
                         manifest={"version": 1, "n_rows": 3,
                                   "entities": {}})
    rmodel, rmaps = RMIO.load_game_model(tmp_path / "p")
    np.testing.assert_array_equal(
        np.asarray(rmodel["fixed"].model.coefficients.means), fixed)
    np.testing.assert_array_equal(np.asarray(rmodel["per_user"].coefficients),
                                  coeffs)
    assert isinstance(rmaps["fixed"], RIM)
    assert RMIO.load_training_manifest(tmp_path / "p")["n_rows"] == 3
    RMIO.save_game_model(tmp_path / "r", rmodel, rmaps)
    back, bmaps = PMIO.load_game_model(tmp_path / "r", device="cpu")
    assert back.task is TaskType.LOGISTIC_REGRESSION
    np.testing.assert_array_equal(back["fixed"].model.coefficients.means,
                                  fixed)
    np.testing.assert_array_equal(back["per_user"].coefficients, coeffs)
    assert list(back["per_user"].entity_keys) == list(keys)
    assert bmaps["fixed"].keys_in_order() == maps["fixed"].keys_in_order()
    assert PMIO.load_training_manifest(tmp_path / "r") is None
    for name in ("metadata.json", "fixed/feature_index.tsv",
                 "per_user/feature_index.tsv"):
        assert (tmp_path / "p" / name).read_bytes() == \
            (tmp_path / "r" / name).read_bytes()
