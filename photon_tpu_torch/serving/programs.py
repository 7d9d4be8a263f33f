"""Scoring-program ladder: the serving tier's program plane (port of
`photon_tpu/serving/programs.py`).

Requests are padded into a pow2 batch-size ladder (`next_pow2`), and each
rung is one scoring function over fixed argument shapes. The ladder runs
eager PyTorch: there is no ahead-of-time program store yet (a captured
CUDA graph per rung is the planned counterpart). `assert_no_retrace`
still proves every dispatch used one of at most ``len(ladder)`` argument
signatures — the property a per-rung graph capture will rely on.

The scoring math is the offline `game.scoring.score_game` sum: margin =
offsets + Σ fixed matvec + Σ random-effect rowwise gather-dot, in
coordinate order, optionally through the task's inverse link. With
``quantize`` the coefficient arguments are the quantized blocks
(`data.matrix.quantize_blocks`): an int8 rung is ONE launch of the CUDA
kernel in `kernels/serving.py` on the card; a bf16 rung upcasts its
gathered coefficients to f32.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Optional

import numpy as np
import torch

from photon_tpu_torch import telemetry
from photon_tpu_torch.data.matrix import (SparseRows, as_tensor, matvec,
                                          next_pow2, quantize_blocks)
from photon_tpu_torch.game.model import score_rows
from photon_tpu_torch.kernels import serving as KS
from photon_tpu_torch.ops.losses import mean_fn
from photon_tpu_torch.serving.store import CoefficientStore
from photon_tpu_torch.telemetry.run import SignatureLog


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """How one feature shard's request rows batch: ``sparse_k=None`` →
    dense (B, d) blocks; else padded-COO (B, k) index/value pairs."""

    name: str
    d: int
    sparse_k: Optional[int] = None


class QuantizationRefused(RuntimeError):
    """A quantized rung's warmup accuracy gate breached its epsilon: the
    quantized ladder does NOT serve. Carries the measured report."""

    def __init__(self, report: dict):
        super().__init__(
            f"quantized serving rung refused: probe margin max |Δ| "
            f"{report['max_abs_diff']:.6g} over {report['n_probes']} rows "
            f"exceeds epsilon {report['epsilon']:.6g} "
            f"(mode={report['mode']})")
        self.report = report


def _build_score_fn(coords: tuple, task, output_mean: bool,
                    quantize: Optional[str] = None):
    """The per-rung scoring function, closed over STRUCTURE only (names,
    routing, task, quantization mode); every tensor — the coefficient
    blocks included — is an argument, so a hot-swap changes no function.

    coords: ((name, kind, feature_shard), ...) in the GameModel's
    coordinate order, kind ∈ {"fixed", "random"}."""
    mean = mean_fn(task)

    def score(offsets, shards, ids, fixed_ws, re_cs):
        if quantize == "int8":
            margin = KS.int8_margin(coords, offsets, shards, ids, fixed_ws,
                                    re_cs)
        else:
            margin = offsets
            for name, kind, shard in coords:
                if kind == "fixed":
                    w = fixed_ws[name]
                    if quantize == "bf16":
                        w = w.to(torch.float32)
                    margin = margin + matvec(shards[shard], w)
                else:
                    # (E+1, d) flat block: row E is the zero cold-miss row
                    rows = re_cs[name][ids[name].long()]
                    if quantize == "bf16":
                        rows = rows.to(torch.float32)
                    margin = margin + score_rows(shards[shard], rows)
        return mean(margin) if output_mean else margin

    return score


class ProgramLadder:
    """Scoring functions at a pow2 batch-size ladder over one store, on the
    store's device. `score_padded` dispatches a full-rung batch and
    records its argument signature."""

    def __init__(self, store: CoefficientStore, *,
                 max_batch: int = 256, floor: int = 8,
                 sparse_k: Optional[dict] = None,
                 output_mean: bool = True,
                 ladder: Optional[tuple] = None,
                 quantize: Optional[str] = None,
                 quant_epsilon: float = 0.05):
        if quantize not in (None, "int8", "bf16"):
            raise ValueError(
                f"quantize must be None, 'int8' or 'bf16', got {quantize!r}")
        self.quantize = quantize
        self.quant_epsilon = float(quant_epsilon)
        self.quant_report: Optional[dict] = None
        self._qdev = None  # (f32-generation token, quantized device blocks)
        self._qlock = threading.Lock()
        self.store = store
        self.device = store.device
        self.output_mean = bool(output_mean)
        if ladder is None:
            floor = min(next_pow2(floor, 1), next_pow2(max_batch, 1))
            rungs, b = [], floor
            while b < max_batch:
                rungs.append(b)
                b *= 2
            rungs.append(next_pow2(max_batch, 1))
            ladder = tuple(rungs)
        self.ladder = tuple(sorted(set(int(b) for b in ladder)))
        if any(b & (b - 1) or b < 1 for b in self.ladder):
            raise ValueError(f"ladder must be pow2 rungs, got {self.ladder}")
        dims = store.shard_dims()
        sparse_k = dict(sparse_k or {})
        unknown = set(sparse_k) - set(dims)
        if unknown:
            raise ValueError(f"sparse_k names unknown shards: {unknown}")
        self.shard_specs = {
            s: ShardSpec(s, d, sparse_k.get(s)) for s, d in dims.items()}
        self.coords = tuple(
            (name, "fixed", store.fixed[name].feature_shard)
            if name in store.fixed
            else (name, "random", store.random[name].feature_shard)
            for name in store.order)
        self._fn = _build_score_fn(self.coords, store.task, self.output_mean,
                                   quantize=self.quantize)
        if self.quantize is not None:
            # the accuracy gate compares MARGINS (the link function would
            # compress honest deltas near saturation)
            self._gate_f32 = _build_score_fn(self.coords, store.task, False)
            self._gate_quant = _build_score_fn(self.coords, store.task, False,
                                               quantize=self.quantize)
        self.signature_log = SignatureLog()

    # ------------------------------------------------------------ bucketing
    @property
    def max_batch(self) -> int:
        return self.ladder[-1]

    def bucket_for(self, n: int) -> int:
        """Smallest ladder rung ≥ n."""
        if n > self.ladder[-1]:
            raise ValueError(f"batch of {n} exceeds ladder top "
                             f"{self.ladder[-1]}")
        for b in self.ladder:
            if b >= n:
                return b
        raise AssertionError  # unreachable: checked above

    # ------------------------------------------------------------ arguments
    def _quant_blocks(self) -> tuple:
        """(fixed_ws, re_cs) in this ladder's quantized form on the device,
        cached per coefficient GENERATION: a `reload_coefficients` swings
        `device_blocks()` to a new tuple, which invalidates this cache.
        An int8 fixed block's scale is a (1,) f32 tensor."""
        token = self.store.device_blocks()  # ONE generation, atomically
        with self._qlock:
            if self._qdev is not None and self._qdev[0] is token:
                return self._qdev[1]
            dev = self.device

            def quant(block):
                # from the token's own f32 blocks: the store's host blocks
                # may already belong to a newer generation
                q, s = quantize_blocks(block.cpu().numpy(), self.quantize)
                if s is None:
                    return q.to(dev)
                return (torch.from_numpy(q).to(dev),
                        torch.from_numpy(np.atleast_1d(s)).to(dev))

            fixed_ws, re_cs = token
            blocks = ({n: quant(b) for n, b in fixed_ws.items()},
                      {n: quant(b) for n, b in re_cs.items()})
            self._qdev = (token, blocks)
            return blocks

    def _coefficient_args(self) -> tuple:
        return (self.store.device_blocks() if self.quantize is None
                else self._quant_blocks())

    def _upload(self, offsets, shards: dict, ids: dict) -> tuple:
        """Request arguments as tensors on the device; pinned host tensors
        upload asynchronously."""
        dev = self.device
        nb = dev.type == "cuda"
        return (as_tensor(offsets, dev, nb),
                {s: (X.to(dev, nb) if isinstance(X, SparseRows)
                     else as_tensor(X, dev, nb)) for s, X in shards.items()},
                {n: as_tensor(e, dev, nb) for n, e in ids.items()})

    def _quant_gate(self) -> dict:
        """The measured accuracy gate (warmup refuses on breach): margins
        of a deterministic probe batch — every entity cycled through,
        cold-miss row included, N(0,1) rows per shard — through the f32
        and quantized functions; the worst |Δ| must sit within
        ``quant_epsilon``. Same probe as the JAX package's gate."""
        B = self.ladder[0]
        rng = np.random.default_rng(0)
        shards = {}
        for s, spec in self.shard_specs.items():
            if spec.sparse_k is None:
                shards[s] = rng.normal(size=(B, spec.d)).astype(np.float32)
            else:
                shards[s] = SparseRows(
                    rng.integers(0, spec.d, size=(B, spec.sparse_k)).astype(
                        np.int32),
                    rng.normal(size=(B, spec.sparse_k)).astype(np.float32),
                    spec.d)
        ids = {name: (np.arange(B, dtype=np.int64)
                      % (self.store.n_entities(name) + 1)).astype(np.int32)
               for name in self.store.random}
        offsets, shards, ids = self._upload(np.zeros(B, np.float32), shards,
                                            ids)
        fixed_ws, re_cs = self.store.device_blocks()
        m32 = self._gate_f32(offsets, shards, ids, fixed_ws, re_cs)
        qf, qr = self._quant_blocks()
        mq = self._gate_quant(offsets, shards, ids, qf, qr)
        diff = (m32.double() - mq.double()).abs().max().item()
        report = {"mode": self.quantize, "n_probes": int(B),
                  "max_abs_diff": float(diff),
                  "epsilon": self.quant_epsilon}
        self.quant_report = report
        return report

    def example_args(self, bucket: int) -> tuple:
        """Zero-filled arguments at one rung's exact signature, on the
        device (warmup)."""
        B = int(bucket)
        shards = {}
        for s, spec in self.shard_specs.items():
            if spec.sparse_k is None:
                shards[s] = np.zeros((B, spec.d), np.float32)
            else:
                shards[s] = SparseRows(
                    np.zeros((B, spec.sparse_k), np.int32),
                    np.zeros((B, spec.sparse_k), np.float32), spec.d)
        ids = {name: np.full(B, self.store.n_entities(name), np.int32)
               for name in self.store.random}
        fixed_ws, re_cs = self._coefficient_args()
        return self._upload(np.zeros(B, np.float32), shards, ids) + (
            fixed_ws, re_cs)

    # ------------------------------------------------------------- dispatch
    def score_padded(self, offsets, shards: dict, ids: dict):
        """Dispatch one full-rung batch (already padded by the dispatcher;
        numpy arrays or host/device tensors). Returns the (B,) result on
        the device WITHOUT waiting for it — on CUDA the work is queued on
        the caller's current stream."""
        B = int(offsets.shape[0])
        if B not in self.ladder:
            raise ValueError(f"padded batch of {B} is not a ladder rung "
                             f"{self.ladder}")
        offsets, shards, ids = self._upload(offsets, shards, ids)
        fixed_ws, re_cs = self._coefficient_args()
        args = (offsets, shards, ids, fixed_ws, re_cs)
        self.signature_log.record("serving.score", args)
        return self._fn(*args)

    def warmup(self) -> int:
        """Run every rung once (builds the kernel, warms the allocator).
        Returns rungs warmed.

        A QUANTIZED ladder gates first: the measured probe margin delta
        vs the f32 function must sit within ``quant_epsilon``, else
        `QuantizationRefused` (counted on ``serving.quant_refusals``)."""
        if self.quantize is not None:
            report = self._quant_gate()
            if report["max_abs_diff"] > report["epsilon"]:
                telemetry.count("serving.quant_refusals")
                raise QuantizationRefused(report)
        for B in self.ladder:
            self._fn(*self.example_args(B))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return len(self.ladder)

    # ------------------------------------------------------------ assertions
    def assert_no_retrace(self) -> int:
        """Prove every dispatch so far used one of at most ``len(ladder)``
        argument signatures (one per rung). Returns the distinct count."""
        sigs = self.signature_log.signatures("serving.score")
        if len(sigs) > len(self.ladder):
            raise AssertionError(
                f"{len(sigs)} distinct scoring signatures exceed the "
                f"{len(self.ladder)}-rung ladder: serving retraced")
        return len(sigs)


# ----------------------------------------------------------------- contracts
# A serving rung's law: coefficients are arguments, so a rung makes no
# collective, no host sync and no f64, and a coefficient swap moves no
# dispatch signature.
from photon_tpu_torch.analysis.contracts import register_contract  # noqa: E402


def _tiny_store(device, seed: int = 0) -> CoefficientStore:
    """The store the serving contracts share: one dense fixed shard + one
    sparse random-effect shard of 5 entities, seeded values."""
    from photon_tpu_torch.data.index_map import IndexMap
    from photon_tpu_torch.ops.losses import TaskType
    from photon_tpu_torch.serving.store import FixedBlock, RandomBlock

    rng = np.random.default_rng(seed)
    d_f, d_r, E = 12, 6, 5
    coef = rng.normal(size=(E + 1, d_r)).astype(np.float32)
    coef[E] = 0.0
    directory = IndexMap({f"e{i}": i for i in range(E)}, frozen=True)
    return CoefficientStore(
        TaskType.LOGISTIC_REGRESSION, ("fixed", "perEntity"),
        {"fixed": FixedBlock(
            "global", rng.normal(size=d_f).astype(np.float32))},
        {"perEntity": RandomBlock("member", "memberId", coef, directory)},
        device=device)


def _contract_rung_args(ladder: ProgramLadder, B: int, seed: int = 1):
    """Seeded request arguments at rung ``B`` on the ladder's device."""
    rng = np.random.default_rng(seed)
    shards = {}
    for s, spec in ladder.shard_specs.items():
        if spec.sparse_k is None:
            shards[s] = rng.normal(size=(B, spec.d)).astype(np.float32)
        else:
            shards[s] = SparseRows(
                rng.integers(0, spec.d, size=(B, spec.sparse_k)).astype(
                    np.int32),
                rng.normal(size=(B, spec.sparse_k)).astype(np.float32),
                spec.d)
    ids = {name: (np.arange(B) % (ladder.store.n_entities(name) + 1)
                  ).astype(np.int32) for name in ladder.store.random}
    fixed_ws, re_cs = ladder._coefficient_args()
    return ladder._upload(rng.normal(size=B).astype(np.float32), shards,
                          ids) + (fixed_ws, re_cs)


@register_contract(
    name="serving_request_program",
    description="one serving-ladder rung end to end: dense fixed matvec + "
                "sparse random-effect gather-dot + inverse link, "
                "coefficients as arguments — no collectives, no host "
                "syncs, no f64, no upload",
    collectives={}, tags=("serving", "game"))
def _contract_serving_request(device):
    ladder = ProgramLadder(_tiny_store(device), ladder=(8,),
                           sparse_k={"member": 3}, output_mean=True)
    return ladder._fn, _contract_rung_args(ladder, 8)


@register_contract(
    name="serving_quantized_rung_invariance",
    description="one int8 serving rung: the same zero-collective / "
                "zero-sync / no-f64 law as the f32 rungs, and program "
                "INVARIANCE — the builder swaps coefficient values (a "
                "hot-swap's re-quantization) and raises if the rung's "
                "dispatch signature moves",
    collectives={}, tags=("serving", "kernels"))
def _contract_serving_quantized_rung(device):
    ladder = ProgramLadder(_tiny_store(device), ladder=(8,),
                           sparse_k={"member": 3}, output_mean=True,
                           quantize="int8")
    args = _contract_rung_args(ladder, 8)
    log = SignatureLog()
    log.record("serving.quant_rung", args)
    ladder.store.reload_coefficients(_tiny_store(device, seed=2))
    args = _contract_rung_args(ladder, 8)
    log.record("serving.quant_rung", args)
    sigs = log.signatures("serving.quant_rung")
    if len(sigs) != 1:
        raise AssertionError(
            f"quantized rung dispatch drifted across a coefficient "
            f"reload: {len(sigs)} signatures (expected 1)")
    return ladder._fn, args


@register_contract(
    name="serving_request_margin",
    description="the margin-only serving rung (output_mean=False, dense "
                "random-effect shard): the raw-score head obeys the same "
                "zero-collective / zero-sync / no-f64 law",
    collectives={}, tags=("serving",))
def _contract_serving_margin(device):
    ladder = ProgramLadder(_tiny_store(device), ladder=(4,),
                           output_mean=False)
    return ladder._fn, _contract_rung_args(ladder, 4)
