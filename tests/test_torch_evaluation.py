"""The port's evaluation package (`photon_tpu_torch.evaluation`) and its
sorted segment sum against the JAX package's.

On the same numpy-seeded inputs — n of 1, 7 and 513 rows, scores rounded
so that ties form, zero-weight (padding) rows, single-class groups (NaN
in the same places), empty groups, k larger than a group — each metric,
each grouped metric and `sorted_segment_sum` agree with
`photon_tpu.evaluation` within rtol 1e-5, atol 1e-6. Also the
`Evaluator` surface: parse/name round trips over every type, the ``@k``
error, ``better_than`` with None and NaN incumbents, the defaults and
suites per task, and `evaluate_with_entity`'s error. The port runs on
the CPU; nothing in it adds through an index or a scatter.
"""
import jax.core
import jax.extend.core

# `photon_tpu/evaluation/grouped.py` imports `photon_tpu.analysis.walker`,
# which imports `jax.core.ClosedJaxpr`/`Jaxpr`, names jax 0.9 moved to
# `jax.extend.core`: alias the missing public names back before anything
# of photon_tpu is imported.
for _name in dir(jax.extend.core):
    if not _name.startswith("_") and not hasattr(jax.core, _name):
        setattr(jax.core, _name, getattr(jax.extend.core, _name))

import inspect  # noqa: E402
import math  # noqa: E402
import re  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from photon_tpu import evaluation as RE  # noqa: E402
from photon_tpu.data.matrix import sorted_segment_sum as ref_segsum  # noqa
from photon_tpu.evaluation import evaluator as REV  # noqa: E402
from photon_tpu.ops.losses import TaskType as RTask  # noqa: E402

from photon_tpu_torch import evaluation as PE  # noqa: E402
from photon_tpu_torch import telemetry  # noqa: E402
from photon_tpu_torch.data.matrix import sorted_segment_sum  # noqa: E402
from photon_tpu_torch.evaluation import evaluator as PEV  # noqa: E402
from photon_tpu_torch.evaluation import grouped as PG  # noqa: E402
from photon_tpu_torch.ops.losses import TaskType  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)
SIZES = [1, 7, 513]


def case(n: int, seed: int = 0, groups: int = 5):
    """Scores rounded to 0.25 (ties), labels, weights with some zeros
    (padding), and group ids where group 1 is single-class, group 3 is
    empty and group 0 holds one row when n > 1."""
    rng = np.random.default_rng(seed + n)
    s = np.round(rng.normal(size=n) * 4) / 4
    y = (rng.uniform(size=n) < 0.5).astype(np.float32)
    w = rng.uniform(0.2, 2.0, size=n).astype(np.float32)
    w[rng.uniform(size=n) < 0.15] = 0.0
    g = rng.integers(0, groups, size=n)
    g[g == 3] = 4
    if n > 1:
        g[0] = 0
        g[1:][g[1:] == 0] = 2
    y[g == 1] = 1.0
    return (s.astype(np.float32), y, w, g.astype(np.int32), groups)


def _both(x):
    return np.asarray(x, np.float64)


def _close(got, want):
    np.testing.assert_allclose(_both(got.numpy() if isinstance(
        got, torch.Tensor) else got), _both(want), equal_nan=True, **TOL)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", ["auc", "aupr", "rmse", "squared_loss",
                                  "logistic_loss", "poisson_loss",
                                  "smoothed_hinge_loss"])
def test_metric_matches_reference(name, weighted, n):
    s, y, w, _, _ = case(n)
    wt = w if weighted else None
    want = getattr(RE, name)(jnp.asarray(s), jnp.asarray(y),
                             None if wt is None else jnp.asarray(wt))
    got = getattr(PE, name)(torch.from_numpy(s), y, wt)
    assert isinstance(got, torch.Tensor) and got.dim() == 0
    _close(got, np.asarray(want))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("k", [1, 3, 1000])
def test_precision_at_k_matches_reference(n, k):
    s, y, w, _, _ = case(n, seed=1)
    want = RE.precision_at_k(jnp.asarray(s), jnp.asarray(y), k,
                             jnp.asarray(w))
    _close(PE.precision_at_k(torch.from_numpy(s), y, k, w), np.asarray(want))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("name", ["grouped_auc", "grouped_aupr",
                                  "grouped_precision_at_k"])
def test_grouped_metric_matches_reference(name, n):
    s, y, w, g, G = case(n, seed=2)
    extra = (3,) if name == "grouped_precision_at_k" else ()
    want = getattr(RE, name)(jnp.asarray(s), jnp.asarray(y), jnp.asarray(w),
                             jnp.asarray(g), G, *extra)
    got = getattr(PE, name)(torch.from_numpy(s), y, w, g, G, *extra)
    for a, b in zip(got, want):
        if a.dtype == torch.bool:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            _close(a, np.asarray(b))
    if n > 1:  # the single-class group is invalid for AUC, as the empty one
        per = got[0].numpy()
        assert math.isnan(per[3])
        if name == "grouped_auc":
            assert math.isnan(per[1])


def test_grouped_k_beyond_every_group_and_no_valid_group():
    s, y, w, g, G = case(513, seed=3)
    want = RE.grouped_precision_at_k(jnp.asarray(s), jnp.asarray(y),
                                     jnp.asarray(w), jnp.asarray(g), G, 10_000)
    got = PE.grouped_precision_at_k(torch.from_numpy(s), y, w, g, G, 10_000)
    _close(got[0], np.asarray(want[0]))
    # one class everywhere: no group is valid, the mean is NaN
    ones = np.ones_like(y)
    _, valid, mean = PE.grouped_auc(torch.from_numpy(s), ones, w, g, G)
    assert not bool(valid.any()) and math.isnan(float(mean))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("lanes", [None, 3])
def test_sorted_segment_sum_matches_reference(n, lanes):
    rng = np.random.default_rng(n)
    shape = (n,) if lanes is None else (n, lanes)
    data = rng.normal(size=shape).astype(np.float32)
    ids = np.sort(rng.integers(0, 6, size=n)).astype(np.int32)
    want = ref_segsum(jnp.asarray(data), jnp.asarray(ids), 8)
    got = sorted_segment_sum(torch.from_numpy(data), torch.from_numpy(ids), 8)
    assert tuple(got.shape) == tuple(want.shape)
    _close(got, np.asarray(want))


def test_grouped_metrics_are_scatter_free_and_counted():
    src = inspect.getsource(PG) + inspect.getsource(sorted_segment_sum)
    calls = re.findall(r"\.(index_add_?|scatter\w*|index_put_?|bincount)\(",
                       src)
    assert not calls, calls
    telemetry.reset()
    s, y, w, g, G = case(7)
    PE.grouped_auc(torch.from_numpy(s), y, w, g, G)
    PE.grouped_precision_at_k(torch.from_numpy(s), y, w, g, G, 2)
    assert telemetry.snapshot()["counters"]["eval.scatter_elems_saved"] == \
        6 * 7 + 3 * 7


def test_metrics_stay_on_the_scores_device_and_repeat_bit_for_bit():
    s, y, w, g, G = case(513, seed=5)
    st = torch.from_numpy(s)
    a = PE.grouped_auc(st, y, w, g, G)
    b = PE.grouped_auc(st, y, w, g, G)
    for x, z in zip(a, b):
        assert x.device == st.device
        if x.is_floating_point():
            assert torch.equal(x.isnan(), z.isnan())
            x, z = x.nan_to_num(7.0), z.nan_to_num(7.0)
        assert torch.equal(x, z)


# ------------------------------------------------------- the evaluators
ALL_TYPES = list(PEV.EvaluatorType)


@pytest.mark.parametrize("kind", ALL_TYPES, ids=[t.name for t in ALL_TYPES])
def test_parse_and_name_round_trip(kind):
    ev = PEV.Evaluator(kind, k=5)
    name = PEV.evaluator_name(ev)
    assert name == REV.evaluator_name(REV.Evaluator(REV.EvaluatorType[
        kind.name], k=5))
    back = PEV.parse_evaluator(name.lower())
    assert back.kind is kind
    at_k = kind in (PEV.EvaluatorType.PRECISION_AT_K,
                    PEV.EvaluatorType.SHARDED_PRECISION_AT_K)
    assert back.k == (5 if at_k else 10)
    ref = REV.parse_evaluator(name.lower())
    assert ref.kind.name == back.kind.name and ref.k == back.k
    assert ev.higher_is_better == REV.Evaluator(
        REV.EvaluatorType[kind.name]).higher_is_better
    assert ev.needs_groups == REV.Evaluator(
        REV.EvaluatorType[kind.name]).needs_groups


def test_parse_errors_and_shorthands():
    assert PEV.parse_evaluator("precision@3") == PEV.Evaluator(
        PEV.EvaluatorType.PRECISION_AT_K, k=3)
    assert PEV.parse_evaluator(" auc ").kind is PEV.EvaluatorType.AUC
    with pytest.raises(ValueError, match="only applies to the precision"):
        PEV.parse_evaluator("AUC@5")
    with pytest.raises(ValueError, match="unknown evaluator"):
        PEV.parse_evaluator("F1")


@pytest.mark.parametrize("kind", ["AUC", "RMSE"])
def test_better_than_with_missing_and_nan_incumbents(kind):
    pe = PEV.Evaluator(PEV.EvaluatorType[kind])
    re_ = REV.Evaluator(REV.EvaluatorType[kind])
    for a, b in ((0.7, None), (0.7, float("nan")), (0.7, 0.6), (0.6, 0.7),
                 (0.6, 0.6)):
        assert pe.better_than(a, b) == bool(re_.better_than(a, b)), (a, b)


@pytest.mark.parametrize("task", list(TaskType), ids=[t.name for t in
                                                      TaskType])
def test_defaults_and_suites_per_task(task):
    rtask = RTask(task.value)
    assert PEV.default_evaluator(task).kind.name == \
        REV.default_evaluator(rtask).kind.name
    assert [e.kind.name for e in PEV.evaluator_suite(task)] == \
        [e.kind.name for e in REV.evaluator_suite(rtask)]


@pytest.mark.parametrize("kind", ["SHARDED_AUC", "SHARDED_AUPR",
                                  "SHARDED_PRECISION_AT_K", "AUC",
                                  "PRECISION_AT_K", "LOGISTIC_LOSS"])
def test_evaluator_evaluate_matches_reference(kind):
    s, y, w, g, _ = case(513, seed=7)
    raw = np.asarray([f"u{i}" for i in g])
    ids = {"user": raw}
    pe = PEV.Evaluator(PEV.EvaluatorType[kind], k=4)
    re_ = REV.Evaluator(REV.EvaluatorType[kind], k=4)
    if pe.needs_groups:
        got = PEV.evaluate_with_entity(pe, torch.from_numpy(s), y, w, ids,
                                       "user")
        want = REV.evaluate_with_entity(re_, s, y, w, ids, "user")
    else:
        got = pe.evaluate(torch.from_numpy(s), y, w)
        want = re_.evaluate(s, y, w)
    assert isinstance(got, float)
    np.testing.assert_allclose(got, want, **TOL)


def test_evaluate_with_entity_needs_its_column():
    s, y, w, g, _ = case(7)
    ev = PEV.Evaluator(PEV.EvaluatorType.SHARDED_AUC)
    for entity in (None, "item"):
        with pytest.raises(ValueError, match="needs an entity id column"):
            PEV.evaluate_with_entity(ev, s, y, w, {"user": g}, entity)
    with pytest.raises(ValueError, match="requires groups"):
        ev.evaluate(s, y, w)


def test_every_public_name_is_ported():
    assert sorted(PE.__all__) == sorted(RE.__all__)
    for name in RE.__all__:
        assert hasattr(PE, name), name
