"""GAME scoring driver: saved model + Avro data in → scored Avro out.

Reference parity: com.linkedin.photon.ml.cli.game.scoring.GameScoringDriver —
load a saved GameModel, read scoring data with the model's feature index maps
(so columns line up), sum coordinate scores + offsets, optionally apply the
inverse link, evaluate when labels exist, and write ScoredItemAvro records
(uid, predictionScore).

The port's copy of `photon_tpu/drivers/score.py`
(``python -m photon_tpu_torch.drivers.score --config job.json``, on the
GPU unless ``run_scoring(..., device="cpu")``). The pipeline is CHUNKED
end to end (the reference scores partition by partition and never
collects the dataset): container blocks stream through the native block
decoder (pure Python as its fallback), each chunk is padded
to a quantized height, moved to the device once and scored there, and
appended to the output container via a VECTORIZED ScoredItemAvro block
encoder. The loop is a ONE-CHUNK software pipeline: chunk i's scoring is
queued on the device's stream, chunk i+1 decodes on the host, and only
then is chunk i read back, so host memory stays bounded by ~TWO in-flight
chunks + the accumulated score/label scalars. (The reference's contract
registration of the chunk program is a jaxpr analysis; its torch form
waits for ROADMAP queue A item 11.)
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Sequence

import numpy as np
import torch

from photon_tpu_torch import telemetry
from photon_tpu_torch.data.avro_io import (AvroBlockWriter, scatter_ragged,
                                           varint_bytes)
from photon_tpu_torch.data.feature_bags import FeatureShardConfig
from photon_tpu_torch.data.ingest import GameDataConfig
from photon_tpu_torch.data.matrix import SparseRows, quantize_rows
from photon_tpu_torch.data.model_io import load_game_model
from photon_tpu_torch.data.streaming import iter_game_chunks
from photon_tpu_torch.device import resolve_device
from photon_tpu_torch.evaluation.evaluator import (default_evaluator,
                                                   evaluate_with_entity,
                                                   evaluator_name,
                                                   parse_evaluator)
from photon_tpu_torch.game.dataset import GameData
from photon_tpu_torch.game.model import RandomEffectModel
from photon_tpu_torch.game.scoring import score_game
from photon_tpu_torch.utils.logging import photon_logger
from photon_tpu_torch.utils.timing import PhaseTimers

SCORED_ITEM_SCHEMA = {
    "type": "record",
    "name": "ScoredItemAvro",  # reference: ScoredItemAvro output records
    "fields": [
        {"name": "uid", "type": ["null", "string"], "default": None},
        {"name": "predictionScore", "type": "double"},
        {"name": "label", "type": ["null", "double"], "default": None},
    ],
}

# Chunk heights quantize to this, so chunks come in a handful of shapes
# whatever the container-block boundaries.
_PAD_QUANTUM = 4096


@dataclasses.dataclass
class ScoringParams:
    """Reference: GameScoringDriver's scopt parameter set."""

    model_dir: str
    data_path: str
    output_dir: str
    feature_shards: dict  # shard name -> FeatureShardConfig or dict form
    entity_fields: Sequence[str] = ()
    uid_field: str = "uid"
    response_field: str = "response"
    # raw margin vs mean response (reference: the driver's logistic scores
    # go through the sigmoid for the scored output)
    output_mean: bool = True
    # Evaluators to run when labels are present (reference: evaluatorTypes
    # on the scoring driver too); empty → the task's default. The first one
    # populates ScoringOutput.metric (None if it could not be computed);
    # all land in ScoringOutput.metrics.
    evaluators: Sequence[str] = ()
    # Entity-id column for sharded evaluators; defaults to the model's
    # first random-effect coordinate's entity type — the SAME fallback the
    # training driver's validation evaluators use, so SHARDED_* numbers
    # are comparable between run_training and run_scoring.
    evaluator_entity: Optional[str] = None
    # Rows per streamed chunk (container blocks keep their boundaries, so
    # actual chunk sizes are >= this up to one block more).
    chunk_rows: int = 65536
    # Fixed nnz width for sparse shards (required when a shard exceeds its
    # dense_threshold — chunks must share one padded-COO width).
    sparse_k: Optional[int] = None
    # Output container codec: null | deflate | snappy.
    output_codec: str = "deflate"
    # True forces the native C++ block decoder, False pure Python, None
    # (default) tries native and falls back, logged and counted.
    use_native: Optional[bool] = None
    # The reference's persistent XLA compilation cache: XLA-only, so the
    # port accepts it and logs that it has no effect.
    compilation_cache_dir: Optional[str] = None

    def __post_init__(self):
        self.feature_shards = {
            k: FeatureShardConfig.coerce(v)
            for k, v in self.feature_shards.items()
        }


@dataclasses.dataclass
class ScoringOutput:
    scores: np.ndarray
    output_path: str
    metric: Optional[float] = None  # when labels were present
    metrics: dict = dataclasses.field(default_factory=dict)  # name -> value
    # seconds by phase: "read" (decode and assembly of the chunks),
    # "score" (upload, the scoring queued on the device, the read-back),
    # "write" (encoding and appending the output blocks), "evaluate"
    timings: dict = dataclasses.field(default_factory=dict)


# --------------------------------------------------------------------------
# vectorized ScoredItemAvro block encoding (generic primitives live in
# data.avro_io: varint_bytes / scatter_ragged)
# --------------------------------------------------------------------------


def encode_scored_block(uids, scores, labels, label_mask,
                        uid_mask) -> bytes:
    """One Avro block payload of ScoredItemAvro records, fully vectorized
    (numpy byte scatter; the per-record write_datum loop caps around 10^5
    rec/s).

    uids: (n,) str; rows with uid_mask False write the null union branch.
    labels: (n,) float64; rows with label_mask False write null.
    """
    n = int(scores.shape[0])
    if n == 0:
        return b""
    uid_mask = np.asarray(uid_mask, bool)
    label_mask = np.asarray(label_mask, bool)
    enc = np.char.encode(np.asarray(uids, dtype=np.str_), "utf-8")
    W = max(enc.dtype.itemsize, 1)
    bmat = np.frombuffer(
        enc.tobytes() if enc.dtype.itemsize else b"\x00" * n,
        np.uint8).reshape(n, W)
    ulen = np.char.str_len(enc).astype(np.int64)
    vmat, vlen = varint_bytes(ulen)

    ulen_w = np.where(uid_mask, ulen, 0)
    vlen_w = np.where(uid_mask, vlen, 0)
    lab_w = np.where(label_mask, 8, 0)
    rec_len = 1 + vlen_w + ulen_w + 8 + 1 + lab_w
    off = np.concatenate([[0], np.cumsum(rec_len)[:-1]])
    buf = np.zeros(int(rec_len.sum()), np.uint8)

    buf[off] = np.where(uid_mask, 2, 0)  # union branch: 1 -> zigzag 2
    scatter_ragged(buf, off + 1, vmat, vlen_w)
    scatter_ragged(buf, off + 1 + vlen_w, bmat, ulen_w)
    sc = np.frombuffer(
        np.ascontiguousarray(scores, "<f8").tobytes(), np.uint8).reshape(n, 8)
    pos = off + 1 + vlen_w + ulen_w
    buf[pos[:, None] + np.arange(8)] = sc
    pos_lu = pos + 8
    buf[pos_lu] = np.where(label_mask, 2, 0)
    if label_mask.any():
        lb = np.frombuffer(
            np.ascontiguousarray(np.asarray(labels, "<f8")[label_mask]
                                 ).tobytes(), np.uint8).reshape(-1, 8)
        buf[(pos_lu[label_mask] + 1)[:, None] + np.arange(8)] = lb
    return buf.tobytes()


# --------------------------------------------------------------------------
# chunk padding (quantized heights -> few shapes)
# --------------------------------------------------------------------------


def _pad_chunk(chunk: GameData, H: int) -> GameData:
    """Pad a chunk to H rows: zero features/offsets, weight 0, entity ""
    (the unseen-entity convention — pad rows score the zero coefficient
    row and are sliced off after the device pass)."""
    n = chunk.n
    if H == n:
        return chunk
    p = H - n

    def padv(v):
        return np.concatenate([np.asarray(v), np.zeros(p, np.float32)])

    shards = {}
    for s, X in chunk.shards.items():
        if isinstance(X, SparseRows):
            k = X.indices.shape[1]
            shards[s] = SparseRows(
                np.concatenate([np.asarray(X.indices),
                                np.zeros((p, k), np.int32)]),
                np.concatenate([np.asarray(X.values),
                                np.zeros((p, k), np.float32)]),
                X.n_features)
        else:
            Xn = np.asarray(X)
            shards[s] = np.concatenate(
                [Xn, np.zeros((p, Xn.shape[1]), Xn.dtype)])
    ids = {e: np.concatenate([np.asarray(v, np.str_),
                              np.full(p, "", dtype="U1")])
           for e, v in chunk.entity_ids.items()}
    return GameData(padv(chunk.y), padv(chunk.weights), padv(chunk.offsets),
                    shards, ids)


# --------------------------------------------------------------------------
# driver
# --------------------------------------------------------------------------


def run_scoring(params: ScoringParams, device=None) -> ScoringOutput:
    """Score ``params.data_path`` with the saved model on ``device``
    (default ``cuda``) into ``<output_dir>/scores.avro``."""
    dev = resolve_device(device)
    log = photon_logger("photon_tpu_torch.score", params.output_dir)
    timers = PhaseTimers(span_prefix="score.")
    if params.compilation_cache_dir:
        log.info("compilation_cache_dir=%r has no effect: it is the JAX "
                 "package's XLA cache", params.compilation_cache_dir)

    model, index_maps = load_game_model(params.model_dir, device=dev)

    # Columns must line up with the model: reuse the saved index maps, keyed
    # by the feature shard each coordinate was trained on.
    shard_maps = {}
    for name, cm in model.coordinates.items():
        shard_maps.setdefault(cm.feature_shard, index_maps[name])

    entity_fields = tuple(params.entity_fields)
    if params.uid_field not in entity_fields:
        entity_fields = entity_fields + (params.uid_field,)
    optional = (params.uid_field,)  # ScoredItemAvro.uid is nullable
    cfg = GameDataConfig(
        shards=params.feature_shards,
        entity_fields=entity_fields,
        response_field=params.response_field,
        optional_entity_fields=optional,
        allow_missing_response=True,  # scoring data may be unlabeled
    )

    evals = ([parse_evaluator(s) for s in params.evaluators]
             or [default_evaluator(model.task)])
    need_groups = any(ev.needs_groups for ev in evals)
    # The evaluator entity resolves BEFORE the chunk loop so only that ONE
    # id column accumulates (per-row strings are the heaviest metric input;
    # the other entity columns are never read by evaluate_with_entity).
    eval_entity = params.evaluator_entity
    if eval_entity is None:
        eval_entity = next(
            (cm.entity_name for cm in model.coordinates.values()
             if isinstance(cm, RandomEffectModel)), None)

    os.makedirs(params.output_dir, exist_ok=True)
    out_path = os.path.join(params.output_dir, "scores.avro")

    stream, chunks = iter_game_chunks(
        params.data_path, cfg, shard_maps, chunk_rows=params.chunk_rows,
        sparse_k=params.sparse_k, use_native=params.use_native,
        uniform_sparse_k=False)  # chunks are scored independently

    # accumulated HOST scalars (scores/labels/weights — the bounded part;
    # feature matrices never accumulate). Metric inputs are dropped the
    # moment a missing response makes evaluation impossible — an unlabeled
    # 1B-row run must not hoard per-row strings it will never use.
    margins_acc, scores_acc, y_acc, w_acc = [], [], [], []
    group_cols: dict = (
        {eval_entity: []}
        if need_groups and eval_entity in params.entity_fields else {})
    n_rows = 0
    n_chunks = 0
    with AvroBlockWriter(out_path, SCORED_ITEM_SCHEMA,
                         codec=params.output_codec) as writer:
        # ONE-CHUNK software pipeline: chunk i's scoring is queued on the
        # device's stream, then chunk i+1 decodes on the host while it
        # runs — the blocking read-back of i happens only after i+1's
        # decode. `pending` holds everything host-side for the in-flight
        # chunk.

        def flush(pending) -> None:
            nonlocal group_cols, n_rows, n_chunks
            n_c, uids, uid_present, y_host, w_host, ents_host, mask, \
                margin_dev, out_dev = pending
            with timers("score"):  # the read-back blocks here
                scores_c = out_dev[:n_c].cpu().numpy().astype(np.float64)
                margins_c = margin_dev[:n_c].cpu().numpy()
            with timers("write"):
                writer.write_block(n_c, encode_scored_block(
                    uids, scores_c, np.asarray(y_host, np.float64), mask,
                    uid_present))
            telemetry.count("score.chunks")
            telemetry.count("score.rows", n_c)
            scores_acc.append(scores_c)
            if stream.saw_missing_response:
                margins_acc.clear()
                y_acc.clear()
                w_acc.clear()
                group_cols = {}
            else:
                margins_acc.append(margins_c)
                y_acc.append(y_host)
                w_acc.append(w_host)
                for e in group_cols:
                    group_cols[e].append(ents_host[e])
            n_rows += n_c
            n_chunks += 1

        pending = None
        try:
            while True:
                with timers("read"):
                    chunk = next(chunks, None)
                if chunk is None:
                    break
                n_c = chunk.n
                mask = (stream.last_response_mask
                        if stream.last_response_mask is not None
                        else np.ones(n_c, bool))
                # Null-vs-"" uid fidelity: the decoder's presence mask (a
                # missing uid writes the null union branch; a legitimate
                # empty-STRING uid stays a string — chunk column arrays
                # fold both to "", so the mask is the only witness).
                uid_present = (stream.last_entity_presence or {}).get(
                    params.uid_field)
                if uid_present is None:
                    uid_present = np.ones(n_c, bool)
                H = quantize_rows(n_c, _PAD_QUANTUM)
                # pad-waste rides the serving counter family: offline
                # chunked scoring and the online dispatcher report the
                # same ladder overhead under one name.
                telemetry.count("serving.pad_waste", H - n_c)
                with timers("score"):
                    padded = _pad_chunk(chunk, H)
                    margin_dev = score_game(model, padded.to_device(dev))
                    out_dev = model.mean(margin_dev) if params.output_mean \
                        else margin_dev
                this = (n_c,
                        np.asarray(chunk.entity_ids[params.uid_field]),
                        uid_present,
                        np.asarray(chunk.y), np.asarray(chunk.weights),
                        {e: np.asarray(chunk.entity_ids[e])
                         for e in group_cols},
                        mask, margin_dev, out_dev)
                if pending is not None:
                    # cleared BEFORE flushing: if the flush itself dies
                    # mid-write, the unwind must not re-flush the same
                    # chunk after a partial write_block (duplicate bytes
                    # would corrupt the very file the unwind protects)
                    done, pending = pending, None
                    flush(done)
                pending = this
        except Exception:
            # a decode failure on chunk i+1 must not discard the already-
            # scored in-flight chunk i from the partial output (the file
            # users debug/resume from) — but its flush must never mask
            # the original failure either. Exception, not BaseException: a
            # Ctrl-C must not trigger one more blocking read-back.
            if pending is not None:
                try:
                    flush(pending)
                except Exception as e:
                    log.warning(
                        "unwind flush of the in-flight chunk failed (%s): "
                        "the partial scores.avro is missing its final "
                        "scored chunk", e)
            raise
        if pending is not None:
            flush(pending)

    scores = (np.concatenate(scores_acc) if scores_acc
              else np.zeros(0, np.float64))
    log.info("scored %d rows in %d chunks with %d coordinates -> %s",
             n_rows, n_chunks, len(model.coordinates), out_path)

    metric = None
    metrics: dict = {}
    has_labels = not stream.saw_missing_response and n_rows > 0
    if has_labels:
        with timers("evaluate"):
            # the metric inputs move to the device once; metrics run there
            m, y, w = (torch.from_numpy(np.concatenate(a)).to(dev)
                       for a in (margins_acc, y_acc, w_acc))
            entity_ids = {e: np.concatenate(v)
                          for e, v in group_cols.items()}
            for ev in evals:
                if ev.needs_groups:
                    try:
                        metrics[evaluator_name(ev)] = evaluate_with_entity(
                            ev, m, y, w, entity_ids, eval_entity)
                    except ValueError as e:
                        log.warning("skipping %s: %s (set "
                                    "ScoringParams.evaluator_entity)",
                                    ev.kind.name, e)
                else:
                    metrics[evaluator_name(ev)] = ev.evaluate(m, y, w)
        # the FIRST evaluator's value, not whichever happened to compute
        metric = metrics.get(evaluator_name(evals[0]))
        log.info("metrics on scored data: %s", metrics)

    log.info("timings: %s", timers.summary())
    return ScoringOutput(scores, out_path, metric, metrics,
                         timings=timers.summary())


def main(argv=None) -> None:
    import argparse

    p = argparse.ArgumentParser(
        description="photon-tpu GAME scoring driver (PyTorch port)")
    p.add_argument("--config", required=True, help="JSON ScoringParams file")
    p.add_argument("--device", default=None,
                   help="torch device to score on (default: cuda)")
    args = p.parse_args(argv)
    with open(args.config) as f:
        params = ScoringParams(**json.load(f))
    out = run_scoring(params, device=args.device)
    print(json.dumps({
        "output_path": out.output_path,
        "n_scored": int(out.scores.shape[0]),
        "metric": out.metric,
    }))


if __name__ == "__main__":
    main()


# ----------------------------------------------------------------- contracts
# The scoring driver's per-chunk device program (offsets + fixed-effect
# margin + per-row random-effect gather-dot): the pipeline only overlaps
# host decode with device work if the program itself never waits on the
# host.
from photon_tpu_torch.analysis.contracts import register_contract  # noqa: E402


@register_contract(
    name="driver_scoring_chunk",
    description="the scoring driver's per-chunk device program: offsets + "
                "fixed-effect margin + random-effect rowwise gather-dot, "
                "no collectives, no host syncs, nothing uploaded",
    collectives={}, tags=("game", "driver"))
def _contract_driver_scoring_chunk(device):
    from photon_tpu_torch.data.matrix import matvec
    from photon_tpu_torch.game.model import padded_coeffs, score_rows

    n, d, k, E = 32, 10, 3, 4
    rng = np.random.default_rng(0)
    X = SparseRows(rng.integers(0, d, size=(n, k)).astype(np.int32),
                   rng.normal(size=(n, k)).astype(np.float32),
                   d).to(device)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(device)

    def program(offs, Xs, wf, C, dense_ids):
        return offs + matvec(Xs, wf) + score_rows(
            Xs, padded_coeffs(C, dense_ids))

    return program, (t(rng.normal(size=n)), X, t(rng.normal(size=d)),
                     t(rng.normal(size=(E, d))),
                     t(rng.integers(0, E + 1, size=n), torch.int32))
