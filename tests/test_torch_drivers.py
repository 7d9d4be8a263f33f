"""The port's drivers (`photon_tpu_torch.drivers`: indexing, training,
scoring) against the JAX package's, end to end on one tiny GAME Avro
written from a numpy seed under ``tmp_path`` (the shape of
`tests/test_drivers.py`: a fixed effect on two features plus an
intercept, a per-user bias, 8 users).

Each package runs its indexing driver, its training driver (a 2-point
grid over the fixed effect's L2 weight, validation with AUC and
SHARDED_AUC, ``output_mode="ALL"``, feature summaries) and its scoring
driver once, in one module-scoped fixture each (the port with
``device="cpu"``). Both pick the same grid point; the saved coefficients
agree within rtol 1e-4, atol 1e-5 (`test_torch_game.py`'s ``W_RTOL``/
``W_ATOL``); ``metadata.json``, the ``feature_index.tsv`` files, the
index maps and ``best_model/training_manifest.json`` are byte-equal;
scored records agree (scores within 1e-5, metrics within 1e-6); each
package loads the other's model directory. Also §C9 (the reference's
per-point manifest in ALL mode is a list, the port's is the
`build_manifest` dict), the resume path, and every option that is not
ported raising with its ROADMAP queue A item.
"""
import jax.core
import jax.extend.core

# `photon_tpu` imports `jax.core.ClosedJaxpr`/`Jaxpr`, names jax 0.9 moved
# to `jax.extend.core`: alias the missing public names back before
# anything of photon_tpu is imported.
for _name in dir(jax.extend.core):
    if not _name.startswith("_") and not hasattr(jax.core, _name):
        setattr(jax.core, _name, getattr(jax.extend.core, _name))

import json  # noqa: E402
import os  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from photon_tpu import drivers as RD  # noqa: E402
from photon_tpu.data import model_io as RMIO  # noqa: E402
from photon_tpu.drivers import index as RDI  # noqa: E402

from photon_tpu_torch import drivers as PD  # noqa: E402
from photon_tpu_torch.continual.delta import build_manifest  # noqa: E402
from photon_tpu_torch.data import model_io as PMIO  # noqa: E402
from photon_tpu_torch.data.avro_io import read_avro, write_avro  # noqa
from photon_tpu_torch.data.ingest import (GameDataConfig,  # noqa: E402
                                          read_game_data,
                                          training_example_schema)
from photon_tpu_torch.drivers import index as PDI  # noqa: E402
from photon_tpu_torch.drivers import train as PDT  # noqa: E402

W_RTOL, W_ATOL = 1e-4, 1e-5
SHARDS = {
    "fixedShard": {"bags": ["global"], "has_intercept": True},
    "userShard": {"bags": ["puser"], "has_intercept": False},
}
# Solves stop at a relative progress of 1e-3 (as `test_torch_game.py`'s):
# at the default 1e-7 both packages' f32 solves stop on rounding, one
# iteration apart or 7e-5 apart in a coefficient, so the parity gate
# would be a gate on rounding.
COORDINATES = {
    "fixed": {"feature_shard": "fixedShard", "reg_type": "l2",
              "reg_weight": 0.5, "max_iters": 40, "tolerance": 1e-3,
              "reg_weights": [0.1, 10.0]},
    "perUser": {"feature_shard": "userShard", "entity_name": "userId",
                "reg_type": "l2", "reg_weight": 2.0, "max_iters": 20,
                "tolerance": 1e-3},
}


def write_game_avro(path, n, seed, n_users=8):
    rng = np.random.default_rng(seed)
    user = rng.integers(0, n_users, n)
    age = rng.normal(0, 1, n)
    ctr = rng.normal(0, 1, n)
    u_eff = np.linspace(-1.5, 1.5, n_users)[
        np.argsort(rng.uniform(size=n_users))]
    margin = 1.2 * age - 0.8 * ctr + u_eff[user]
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-margin))).astype(np.float32)
    schema = training_example_schema(feature_bags=("global", "puser"),
                                     entity_fields=("userId",))
    write_avro(path, [{
        "response": float(y[i]), "offset": None,
        "weight": None if i % 7 else 2.0,
        "uid": None if i == 5 else f"row{i}", "userId": f"u{user[i]}",
        "global": [{"name": "age", "term": "", "value": float(age[i])},
                   {"name": "ctr", "term": "7d", "value": float(ctr[i])}],
        "puser": [{"name": "bias", "term": "", "value": 1.0}],
    } for i in range(n)], schema)


def run_pipeline(pkg, root, out, **kw):
    """indexing → training → scoring of ``pkg`` (the reference's drivers
    or the port's) under ``root/out``."""
    index_mod = RDI if pkg is RD else PDI
    ix = index_mod.run_indexing(index_mod.IndexingParams(
        str(root / "train.avro"), str(root / out / "maps"), SHARDS))
    params = pkg.TrainingParams(
        train_path=str(root / "train.avro"),
        validation_path=str(root / "validation.avro"),
        output_dir=str(root / out / "train"), feature_shards=SHARDS,
        coordinates=COORDINATES, entity_fields=["userId"], n_sweeps=2,
        output_mode="ALL", evaluators=["AUC", "SHARDED_AUC"],
        index_map_dir=str(root / out / "maps"),
        summarization_output_dir="summary")
    train = pkg.run_training(params, **kw)
    score = pkg.run_scoring(pkg.ScoringParams(
        model_dir=train.model_dir,
        data_path=str(root / "validation.avro"),
        output_dir=str(root / out / "score"), feature_shards=SHARDS,
        entity_fields=["userId"], evaluators=["AUC", "SHARDED_AUC"],
        chunk_rows=100), **kw)
    return ix, train, score


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    root = tmp_path_factory.mktemp("drivers")
    write_game_avro(root / "train.avro", 600, seed=1)
    write_game_avro(root / "validation.avro", 300, seed=2)
    ref = run_pipeline(RD, root, "ref")
    port = run_pipeline(PD, root, "port", device="cpu")
    return root, ref, port


def reg_weights(r) -> dict:
    return {n: c.optimizer.reg_weight for n, c in r.configs.items()}


def test_same_best_point_and_scores(jobs):
    _, (_, rt, _), (_, pt, _) = jobs
    assert len(pt.results) == len(rt.results) == 2
    assert reg_weights(pt.best) == reg_weights(rt.best)
    for p, r in zip(pt.results, rt.results):
        assert reg_weights(p) == reg_weights(r)
        assert p.validation_score == pytest.approx(r.validation_score,
                                                   abs=1e-6)
    assert pt.validation_metrics.keys() == rt.validation_metrics.keys()
    for k, v in rt.validation_metrics.items():
        assert pt.validation_metrics[k] == pytest.approx(v, abs=1e-6)
    assert set(pt.timings) >= {"read", "validate", "summarize", "train",
                               "save"}


def test_saved_coefficients_agree(jobs):
    root, (_, rt, _), (_, pt, _) = jobs
    for out, pkg in (("ref", RMIO), ("port", PMIO)):
        assert os.path.exists(root / out / "train" / "best_model" /
                              "metadata.json")
    pm, _ = PMIO.load_game_model(pt.model_dir, device="cpu")
    rm, _ = RMIO.load_game_model(rt.model_dir)
    np.testing.assert_allclose(
        pm["fixed"].model.coefficients.means.numpy(),
        np.asarray(rm["fixed"].model.coefficients.means),
        rtol=W_RTOL, atol=W_ATOL)
    np.testing.assert_allclose(pm["perUser"].coefficients.numpy(),
                               np.asarray(rm["perUser"].coefficients),
                               rtol=W_RTOL, atol=W_ATOL)
    assert list(pm["perUser"].entity_keys) == list(rm["perUser"].entity_keys)
    # the in-memory best model is what was saved, bit for bit
    np.testing.assert_array_equal(
        pm["fixed"].model.coefficients.means.numpy(),
        pt.best.model["fixed"].model.coefficients.means.numpy())


def test_files_byte_equal(jobs):
    root, (rix, rt, _), (pix, pt, _) = jobs
    names = ["best_model/metadata.json",
             "best_model/training_manifest.json",
             "best_model/fixed/feature_index.tsv",
             "best_model/perUser/feature_index.tsv"]
    for name in names:
        assert (root / "port" / "train" / name).read_bytes() == \
            (root / "ref" / "train" / name).read_bytes(), name
    assert pix.sizes == rix.sizes and pix.n_records == rix.n_records
    for shard in SHARDS:
        assert (root / "port" / "maps" / f"{shard}.index.tsv").read_bytes() \
            == (root / "ref" / "maps" / f"{shard}.index.tsv").read_bytes()
    for shard in SHARDS:
        p = json.loads((root / "port" / "train" / "summary" /
                        f"{shard}.json").read_text())
        r = json.loads((root / "ref" / "train" / "summary" /
                        f"{shard}.json").read_text())
        assert p.keys() == r.keys() and p["count"] == r["count"]
        for k in p:
            np.testing.assert_allclose(p[k], r[k], rtol=1e-6, atol=1e-6)


def test_scored_records_agree(jobs):
    _, (_, _, rs), (_, _, ps) = jobs
    prec, rrec = read_avro(ps.output_path), read_avro(rs.output_path)
    assert len(prec) == len(rrec) == 300
    for p, r in zip(prec, rrec):
        assert (p["uid"], p["label"]) == (r["uid"], r["label"])
        assert p["predictionScore"] == pytest.approx(r["predictionScore"],
                                                     abs=1e-5)
    assert prec[5]["uid"] is None
    np.testing.assert_array_equal(ps.scores, [p["predictionScore"]
                                              for p in prec])
    assert ps.metrics.keys() == rs.metrics.keys()
    for k, v in rs.metrics.items():
        assert ps.metrics[k] == pytest.approx(v, abs=1e-6)
    assert ps.metric == pytest.approx(rs.metric, abs=1e-6)


def test_each_package_loads_the_others_model(jobs):
    _, (_, rt, _), (_, pt, _) = jobs
    a, amaps = PMIO.load_game_model(rt.model_dir, device="cpu")
    b, _ = RMIO.load_game_model(rt.model_dir)
    np.testing.assert_array_equal(a["perUser"].coefficients.numpy(),
                                  np.asarray(b["perUser"].coefficients))
    np.testing.assert_array_equal(
        a["fixed"].model.coefficients.means.numpy(),
        np.asarray(b["fixed"].model.coefficients.means))
    c, _ = RMIO.load_game_model(pt.model_dir)
    d, _ = PMIO.load_game_model(pt.model_dir, device="cpu")
    np.testing.assert_array_equal(np.asarray(c["perUser"].coefficients),
                                  d["perUser"].coefficients.numpy())
    assert amaps["fixed"].keys_in_order()[-1] == "(INTERCEPT)"


def test_all_mode_point_manifests(jobs):
    """§C9: in ALL mode the reference writes the models.json rows gathered
    so far into each point's training_manifest.json (a list: [] for the
    first point); the port writes the training-row manifest, the dict that
    best_model/ holds."""
    root, (_, rt, _), (_, pt, _) = jobs
    best = json.loads((root / "port" / "train" / "best_model" /
                       "training_manifest.json").read_text())
    data, _ = read_game_data(str(root / "train.avro"), GameDataConfig(
        shards={}, entity_fields=("userId",)))
    assert best == json.loads(json.dumps(build_manifest(data)))
    for out, want in (("ref", list), ("port", dict)):
        rows = json.loads((root / out / "train" / "models" /
                           "models.json").read_text())
        assert len(rows) == 2 and sum(r["best"] for r in rows) == 1
        got = [json.loads(open(os.path.join(r["dir"],
                                            "training_manifest.json")).read())
               for r in rows]
        assert all(isinstance(g, want) for g in got), out
        if want is dict:
            assert got == [best, best]
        else:
            assert got[0] == []
    prow = json.loads((root / "port" / "train" / "models" /
                       "models.json").read_text())
    rrow = json.loads((root / "ref" / "train" / "models" /
                       "models.json").read_text())
    assert [r["reg_weights"] for r in prow] == [r["reg_weights"]
                                                for r in rrow]
    # the same job gives the reference's point signatures and directories
    # (the two runs above differ in their index_map_dir, which is part of
    # the signature)
    from photon_tpu.drivers import train as RDT

    kw = dict(train_path="t.avro", output_dir="o", feature_shards=SHARDS,
              coordinates=COORDINATES, entity_fields=["userId"])
    pp, rp = PD.TrainingParams(**kw), RD.TrainingParams(**kw)
    psig = PDT._point_signatures(PDT._global_signature(pp, False), [
        {n: c.coordinate_config() for n, c in pp.coordinates.items()}])
    rsig = RDT._point_signatures(RDT._global_signature(rp, False), [
        {n: c.coordinate_config() for n, c in rp.coordinates.items()}])
    assert psig == rsig
    assert PDT._sig_dir("m", psig[0]) == RDT._sig_dir("m", rsig[0])


def test_resume_skips_saved_points(jobs, tmp_path):
    root = jobs[0]
    params = dict(
        train_path=str(root / "train.avro"),
        validation_path=str(root / "validation.avro"),
        output_dir=str(tmp_path / "resume"), feature_shards=SHARDS,
        coordinates=COORDINATES, entity_fields=["userId"], n_sweeps=1,
        output_mode="ALL", resume=True)
    first = PD.run_training(PD.TrainingParams(**params), device="cpu")
    assert first.n_resumed == 0
    rows = json.loads((tmp_path / "resume" / "models" /
                       "models.json").read_text())
    assert len(rows) == 2
    again = PD.run_training(PD.TrainingParams(**params), device="cpu")
    assert again.n_resumed == 2
    for a, b in zip(first.results, again.results):
        np.testing.assert_array_equal(
            a.model["fixed"].model.coefficients.means.numpy(),
            b.model["fixed"].model.coefficients.means.numpy())
        assert a.validation_score == pytest.approx(b.validation_score)
    # a point whose directory is gone is trained again, the other loaded
    import shutil

    shutil.rmtree(rows[1]["dir"])
    third = PD.run_training(PD.TrainingParams(**params), device="cpu")
    assert third.n_resumed == 1


@pytest.mark.parametrize("knob,item", [
    ({"checkpoint_dir": "ckpt"}, "item 11"),
    ({"tuning_iters": 2}, "item 11"),
])
def test_unported_options_raise_with_their_item(jobs, tmp_path, knob, item):
    root = jobs[0]
    params = PD.TrainingParams(
        train_path=str(root / "train.avro"), output_dir=str(tmp_path),
        feature_shards=SHARDS, coordinates={"fixed": COORDINATES["fixed"]},
        entity_fields=["userId"], **knob)
    with pytest.raises(NotImplementedError, match=item):
        PD.run_training(params, device="cpu")


def test_mesh_and_default_device(jobs, tmp_path):
    root = jobs[0]
    params = PD.TrainingParams(
        train_path=str(root / "train.avro"), output_dir=str(tmp_path),
        feature_shards=SHARDS, coordinates={"fixed": COORDINATES["fixed"]},
        entity_fields=["userId"], compilation_cache_dir="xla")
    with pytest.raises(NotImplementedError, match="item 10"):
        PD.run_training(params, mesh=object(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            PD.run_training(params)
        with pytest.raises(RuntimeError, match="CUDA"):
            PD.run_scoring(PD.ScoringParams(
                model_dir=str(root / "port" / "train" / "best_model"),
                data_path=str(root / "validation.avro"),
                output_dir=str(tmp_path / "s"), feature_shards=SHARDS))
    out = PD.run_training(params, device="cpu")  # the XLA cache is ignored
    assert len(out.results) == 2


def test_clis(jobs, tmp_path, capsys):
    root = jobs[0]
    cfg = tmp_path / "train.json"
    cfg.write_text(json.dumps({
        "train_path": str(root / "train.avro"),
        "output_dir": str(tmp_path / "out"), "feature_shards": SHARDS,
        "coordinates": {"fixed": {**COORDINATES["fixed"],
                                  "reg_weights": None}},
        "entity_fields": ["userId"], "n_sweeps": 1}))
    PDT.main(["--config", str(cfg), "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["n_models"] == 1 and os.path.isdir(line["model_dir"])
    with pytest.raises(NotImplementedError, match="item 11"):
        PDT.main(["--config", str(cfg), "--device", "cpu",
                  "--checkpoint-dir", "ck"])
    scfg = tmp_path / "score.json"
    scfg.write_text(json.dumps({
        "model_dir": line["model_dir"],
        "data_path": str(root / "validation.avro"),
        "output_dir": str(tmp_path / "scored"),
        "feature_shards": {"fixedShard": SHARDS["fixedShard"]}}))
    from photon_tpu_torch.drivers import score as PDS

    PDS.main(["--config", str(scfg), "--device", "cpu"])
    sline = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sline["n_scored"] == 300 and sline["metric"] > 0.6
    icfg = tmp_path / "index.json"
    icfg.write_text(json.dumps({
        "data_path": str(root / "train.avro"),
        "output_dir": str(tmp_path / "maps"), "feature_shards": SHARDS,
        "min_count": 700}))
    PDI.main(["--config", str(icfg)])
    iline = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert iline["sizes"] == {"fixedShard": 1, "userShard": 0}
    with pytest.raises(FileNotFoundError, match="no map for shard"):
        PDI.load_index_map_dir(str(tmp_path), ["fixedShard"])


def test_timers_logger_telemetry_and_commit(tmp_path, monkeypatch):
    """The helpers the drivers pull in: `Timer`/`PhaseTimers` accumulate
    as the reference's, `photon_logger` adds one file handler per output
    dir and obeys PHOTON_TPU_LOG_LEVEL, the telemetry span/event/memory
    calls record nothing, and `commit_bytes` replaces a file whole."""
    import logging

    from photon_tpu.utils.timing import PhaseTimers as RPT

    from photon_tpu_torch import telemetry
    from photon_tpu_torch.checkpoint.store import commit_bytes
    from photon_tpu_torch.utils.logging import photon_logger
    from photon_tpu_torch.utils.timing import PhaseTimers, Timer

    t = Timer()
    with t:
        pass
    first = t.seconds
    with t:
        pass
    assert t.seconds >= first > 0.0
    with pytest.raises(RuntimeError, match="not running"):
        Timer().stop()
    timers, rtimers = PhaseTimers(span_prefix="train."), RPT()
    for tm in (timers, rtimers):
        with tm("read"):
            pass
        with tm("train"):
            pass
        with tm("read"):
            pass
    assert list(timers.summary()) == list(rtimers.summary()) == ["read",
                                                                 "train"]
    log = photon_logger("photon_tpu_torch.test_drivers", str(tmp_path))
    photon_logger("photon_tpu_torch.test_drivers", str(tmp_path))
    files = [h for h in log.handlers if isinstance(h, logging.FileHandler)]
    assert len(files) == 1 and log.level == logging.INFO
    monkeypatch.setenv("PHOTON_TPU_LOG_LEVEL", "debug")
    assert photon_logger("photon_tpu_torch.test_drivers").level == \
        logging.DEBUG
    with telemetry.span("train.read", rows=3) as sp:
        assert sp is None
    assert telemetry.event("x", a=1) is None
    assert telemetry.sample_device_memory("post_train") is None
    path = tmp_path / "f.json"
    commit_bytes(str(path), b"old")
    commit_bytes(str(path), b"new")
    assert path.read_bytes() == b"new"
    assert sorted(os.listdir(tmp_path)) == sorted(
        ["f.json"] + [h.baseFilename.rsplit("/", 1)[1] for h in files])
    for h in files:
        log.removeHandler(h)
        h.close()


@pytest.mark.parametrize("norm,rate", [
    ("standardization", 0.5), ("scale_with_standard_deviation", None),
    ("scale_with_max_magnitude", 0.5)])
def test_normalization_and_down_sampling_match(jobs, tmp_path, norm, rate):
    """The training driver's normalization (built from the feature
    summaries it writes) and down-sampling (the binary sampler, negatives
    only) give the reference's fixed effect and the same row manifest."""
    root = jobs[0]
    fixed = {k: v for k, v in COORDINATES["fixed"].items()
             if k != "reg_weights"}
    kw = dict(train_path=str(root / "train.avro"), feature_shards=SHARDS,
              coordinates={"fixed": fixed}, entity_fields=["userId"],
              n_sweeps=1, normalization=norm, down_sampling_rate=rate,
              seed=3, summarization_output_dir="summary")
    p = PD.run_training(PD.TrainingParams(output_dir=str(tmp_path / "p"),
                                          **kw), device="cpu")
    r = RD.run_training(RD.TrainingParams(output_dir=str(tmp_path / "r"),
                                          **kw))
    np.testing.assert_allclose(
        p.best.model["fixed"].model.coefficients.means.numpy(),
        np.asarray(r.best.model["fixed"].model.coefficients.means),
        rtol=W_RTOL, atol=W_ATOL)
    pm = json.loads((tmp_path / "p" / "best_model" /
                     "training_manifest.json").read_text())
    rm = json.loads((tmp_path / "r" / "best_model" /
                     "training_manifest.json").read_text())
    assert pm == rm
    assert (pm["n_rows"] == 600) == (rate is None)
