"""The port's training driver in its streamed regimes
(`photon_tpu_torch.drivers.train`: the auto-trip, `_read_streaming`,
`_read_streamed_objective`, the ingest plane's knobs) against its own
in-memory read and the JAX package's driver, on multi-file GAME Avro
written from a numpy seed under ``tmp_path`` (``device="cpu"``).

Held: ``streaming=None`` above ``streaming_threshold_rows`` streams
(and leaves the caller's tri-state alone) and its model equals the
in-memory read's bit for bit, as ``streaming=True`` with 2 ingest
workers and a chunk cache does (twice: a cold build, then a hit that
reads no Avro); chunk-merged statistics feed normalization and the
summaries; down-sampling takes its weight form; the streamed objective
(an explicit ``hbm_budget_bytes`` below the estimate) trips, counts its
GAME composition and agrees with the reference's driver under the same
budget (solves stopped at a relative progress of 1e-3, coefficients
within rtol 1e-4 / atol 1e-5, as `test_torch_drivers.py`); on the CPU
with no budget the auto resolution stays resident; the resume signature
is stable; the CLI takes ``--ingest-workers`` and ``--chunk-cache-dir``;
what is left raises naming its item.
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

from photon_tpu import drivers as RD  # noqa: E402

from photon_tpu_torch import drivers as PD  # noqa: E402
from photon_tpu_torch import telemetry  # noqa: E402
from photon_tpu_torch.data import avro_io as PA  # noqa: E402
from photon_tpu_torch.data.avro_io import write_avro  # noqa: E402
from photon_tpu_torch.data.dataset import ChunkedMatrix  # noqa: E402
from photon_tpu_torch.data.ingest import \
    training_example_schema  # noqa: E402
from photon_tpu_torch.data.statistics import FeatureSummary  # noqa: E402
from photon_tpu_torch.drivers import train as PDT  # noqa: E402
from _reference_native import reference_native  # noqa: E402

# the JAX package's native library, built once across the test processes
reference_native()

W_RTOL, W_ATOL = 1e-4, 1e-5
SHARDS = {
    "fixedShard": {"bags": ["global"], "has_intercept": True},
    "userShard": {"bags": ["puser"], "has_intercept": False},
}
COORDINATES = {
    "fixed": {"feature_shard": "fixedShard", "reg_type": "l2",
              "reg_weight": 0.5, "max_iters": 40, "tolerance": 1e-3},
    "perUser": {"feature_shard": "userShard", "entity_name": "userId",
                "reg_type": "l2", "reg_weight": 2.0, "max_iters": 20,
                "tolerance": 1e-3},
}


def write_parts(root, n_files=3, rows_per_file=220, seed=0):
    """Multi-file GAME input in small container blocks (many chunk
    boundaries); non-unit feature statistics for normalization."""
    rng = np.random.default_rng(seed)
    schema = training_example_schema(feature_bags=("global", "puser"),
                                     entity_fields=("userId",))
    os.makedirs(root, exist_ok=True)
    for fi in range(n_files):
        recs = []
        for i in range(rows_per_file):
            age = float(rng.normal())
            ctr = float(rng.normal(2.0, 3.0))
            u = int(rng.integers(0, 11))
            margin = 1.1 * age - 0.3 * (ctr - 2.0) + 0.2 * (u - 5)
            recs.append({
                "response": float(rng.uniform() < 1 / (1 + np.exp(-margin))),
                "offset": None, "weight": 2.0 if i % 7 == 0 else None,
                "uid": f"r{fi}_{i}", "userId": f"u{u}",
                "global": [{"name": "age", "term": "", "value": age},
                           {"name": "ctr", "term": "", "value": ctr}],
                "puser": [{"name": "bias", "term": "", "value": 1.0}]})
        write_avro(root / f"part-{fi:03d}.avro", recs, schema,
                   block_records=64)
    return root


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    root = tmp_path_factory.mktemp("stream_driver")
    write_parts(root / "train", n_files=3, rows_per_file=220, seed=1)
    write_parts(root / "val", n_files=2, rows_per_file=110, seed=2)
    return root


def params(pkg, root, out, **kw):
    base = dict(train_path=str(root / "train"),
                validation_path=str(root / "val"), output_dir=str(out),
                feature_shards=SHARDS, coordinates=COORDINATES,
                entity_fields=["userId"], n_sweeps=2)
    base.update(kw)
    return pkg.TrainingParams(**base)


def run(root, out, **kw):
    return PD.run_training(params(PD, root, out, **kw), device="cpu")


def coefs(out):
    m = out.best.model.coordinates
    return (m["fixed"].model.coefficients.means.numpy(),
            m["perUser"].coefficients.numpy(),
            list(m["perUser"].entity_keys))


def assert_same_model(a, b):
    assert a.best.validation_score == b.best.validation_score
    (fa, ra, ka), (fb, rb, kb) = coefs(a), coefs(b)
    np.testing.assert_array_equal(fa, fb)
    np.testing.assert_array_equal(ra, rb)
    assert ka == kb


@pytest.fixture(scope="module")
def in_memory(job, tmp_path_factory):
    return run(job, tmp_path_factory.mktemp("mem"), streaming=False)


def test_auto_trip_streams_bit_for_bit(job, in_memory, tmp_path):
    p = params(PD, job, tmp_path / "auto", streaming_threshold_rows=100)
    telemetry.reset()
    out = PD.run_training(p, device="cpu")
    counters = telemetry.snapshot()["counters"]
    assert p.streaming is None  # the caller's tri-state is untouched
    assert counters["ingest.device_chunks"] >= 2
    assert "ingest.python_fallback" not in counters
    assert_same_model(out, in_memory)
    # below the threshold: the in-memory read
    telemetry.reset()
    run(job, tmp_path / "below", streaming_threshold_rows=10 ** 7)
    assert "ingest.device_chunks" not in telemetry.snapshot()["counters"]


def test_ingest_workers_and_chunk_cache(job, in_memory, tmp_path,
                                        monkeypatch):
    PD.run_indexing(PD.IndexingParams(str(job / "train"),
                                      str(tmp_path / "maps"), SHARDS))
    kw = dict(streaming=True, streaming_chunk_rows=128, ingest_workers=2,
              chunk_cache_dir="cache", index_map_dir=str(tmp_path / "maps"))
    telemetry.reset()
    cold = run(job, tmp_path, **kw)
    counters = telemetry.snapshot()["counters"]
    assert counters["ingest.cache_builds"] == 2  # training + validation
    assert counters["ingest.worker_chunks"] >= 4
    assert os.path.isdir(tmp_path / "cache")
    assert_same_model(cold, in_memory)
    # a second run hits the cache: with prebuilt maps it reads the
    # containers' block headers (the row count) and no payload
    walk = PA.AvroContainerReader.walk_blocks

    def headers_only(self, skip_payload=False):
        assert skip_payload, "a cache hit read an Avro payload"
        return walk(self, skip_payload)

    def no_payload(*a, **k):
        raise AssertionError("a cache hit read an Avro payload")

    monkeypatch.setattr(PA.AvroContainerReader, "walk_blocks", headers_only)
    monkeypatch.setattr(PA.AvroContainerReader, "blocks_at", no_payload)
    telemetry.reset()
    hit = run(job, tmp_path, **kw)
    counters = telemetry.snapshot()["counters"]
    assert counters["ingest.cache_hits"] == 2
    assert "ingest.decode_seconds" not in counters
    assert_same_model(hit, in_memory)


def test_streamed_statistics_feed_normalization(job, tmp_path):
    kw = dict(normalization="scale_with_standard_deviation",
              summarization_output_dir="summaries")
    a = run(job, tmp_path / "mem", streaming=False, **kw)
    b = run(job, tmp_path / "str", streaming=True, streaming_chunk_rows=128,
            **kw)
    for shard in SHARDS:
        sa, sb = (FeatureSummary.load(str(tmp_path / d / "summaries" /
                                          f"{shard}.json"))
                  for d in ("mem", "str"))
        assert sa.count == sb.count == 660
        np.testing.assert_allclose(sa.mean, sb.mean, rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(sa.variance, sb.variance, rtol=1e-5,
                                   atol=1e-9)
        np.testing.assert_array_equal(sa.num_nonzeros, sb.num_nonzeros)
    # the factors differ in the last f32 ulps (an f32 device pass against
    # an f64 chunk merge); the solves stop at 1e-3
    np.testing.assert_allclose(coefs(a)[0], coefs(b)[0], rtol=2e-3,
                               atol=1e-4)


def test_weight_form_down_sampling(job, tmp_path):
    a = run(job, tmp_path / "rows", streaming=False, down_sampling_rate=0.6,
            seed=7)
    b = run(job, tmp_path / "weights", streaming=True,
            streaming_chunk_rows=128, down_sampling_rate=0.6, seed=7)
    np.testing.assert_allclose(coefs(a)[0], coefs(b)[0], rtol=2e-3,
                               atol=2e-4)


def test_streamed_objective_against_the_reference(job, tmp_path):
    kw = dict(streamed_objective=None, hbm_budget_bytes=1024,
              objective_chunk_rows=256, streaming_chunk_rows=128)
    telemetry.reset()
    out = run(job, tmp_path / "port", **kw)
    counters = telemetry.snapshot()["counters"]
    assert counters["game_e2e.pod_scale_runs"] == 1
    assert counters["solver.feature_streams"] > 0
    ref = RD.run_training(params(RD, job, tmp_path / "ref", **kw))
    pw, rw = coefs(out), ref.best.model.coordinates
    np.testing.assert_allclose(
        pw[0], np.asarray(rw["fixed"].model.coefficients.means),
        rtol=W_RTOL, atol=W_ATOL)
    np.testing.assert_allclose(pw[1], np.asarray(rw["perUser"].coefficients),
                               rtol=W_RTOL, atol=W_ATOL)
    assert out.best.validation_score == pytest.approx(
        ref.best.validation_score, abs=1e-6)
    # the data the solve took: the fixed shard host-chunked
    data, _, _, n = PDT._read_streamed_objective(
        params(PD, job, tmp_path / "x", **kw), PDT.GameDataConfig(
            shards=params(PD, job, tmp_path).feature_shards,
            entity_fields=("userId",)), PDT.TaskType.LOGISTIC_REGRESSION,
        PDT.DataValidationType("validate_full"),
        PDT.scan_ingest(str(job / "train"), PDT.GameDataConfig(
            shards=params(PD, job, tmp_path).feature_shards)).index_maps,
        660, {"fixedShard"}, "cpu")
    assert isinstance(data.shards["fixedShard"], ChunkedMatrix)
    assert data.shards["fixedShard"].n_chunks == 3 and n == 660
    # on the CPU, with no budget, the auto resolution stays resident
    telemetry.reset()
    run(job, tmp_path / "cpu", streaming=True, streaming_chunk_rows=128)
    snap = telemetry.snapshot()
    assert "game_e2e.pod_scale_runs" not in snap["counters"]
    assert snap["gauges"]["train.dataset_estimate_bytes"] > 0
    assert "train.hbm_budget_bytes" not in snap["gauges"]
    assert PDT._detect_hbm_budget("cpu") is None


def test_resume_signature_stable(job, tmp_path):
    def make():
        return params(PD, job, tmp_path, streaming=True,
                      streaming_chunk_rows=128, output_mode="ALL",
                      resume=True, warm_start=False,
                      coordinates={**COORDINATES, "fixed": {
                          **COORDINATES["fixed"],
                          "reg_weights": [0.1, 1.0]}})

    first = PD.run_training(make(), device="cpu")
    again = PD.run_training(make(), device="cpu")
    assert first.n_resumed == 0
    assert again.n_resumed == len(again.results) == 2
    s_str = PDT._global_signature(make(), True, False)
    assert s_str != PDT._global_signature(make(), False, False)
    assert s_str != PDT._global_signature(make(), True, True)


def test_cli_flags_and_what_still_raises(job, tmp_path, capsys):
    cfg = tmp_path / "train.json"
    cfg.write_text(json.dumps({
        "train_path": str(job / "train"), "output_dir": str(tmp_path / "o"),
        "feature_shards": SHARDS, "entity_fields": ["userId"],
        "coordinates": COORDINATES, "n_sweeps": 1, "streaming": True}))
    telemetry.reset()
    PDT.main(["--config", str(cfg), "--device", "cpu", "--ingest-workers",
              "2", "--chunk-cache-dir", "cc"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert os.path.isdir(line["model_dir"])
    assert os.path.isdir(tmp_path / "o" / "cc")
    assert telemetry.snapshot()["counters"]["ingest.worker_chunks"] > 0
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        PD.run_training(params(PD, job, tmp_path / "m", streaming=True),
                        mesh=object(), device="cpu")
    # the reference tunes under every read regime: the streamed read's
    # GP search picks and scores as the in-memory read's
    tuned = [run(job, tmp_path / f"r{i}", streaming=streaming,
                 tuning_iters=2)
             for i, streaming in enumerate((True, False))]
    assert len(tuned[0].results) == len(tuned[1].results) == 2
    for a, b in zip(*(t.results for t in tuned)):
        assert {n: c.optimizer.reg_weight for n, c in a.configs.items()} \
            == {n: c.optimizer.reg_weight for n, c in b.configs.items()}
        assert a.validation_score == pytest.approx(b.validation_score,
                                                   abs=1e-6)
    with pytest.raises(ValueError, match="exclusively by fixed-effect"):
        run(job, tmp_path / "v", streamed_objective=True, coordinates={
            "perUser": COORDINATES["perUser"]})
