"""The port's int8 serving kernel module against the JAX package.

`photon_tpu_torch.kernels.serving.int8_margin_reference` (the plain
PyTorch version of the CUDA kernel, which the CPU path runs) is held
against the Pallas kernel `photon_tpu.kernels.serving.fused_int8_margin`
under ``kernels.scope("on")`` (Pallas interpret mode on the CPU), on the
same numpy-seeded inputs: each of the four branches alone, all four
together, and the cold-miss row. `quantize_blocks` must equal the
reference bit for bit. The CUDA kernel itself runs only on a GPU; it is
held against the same plain version by ``chip_smoke.py``.
"""
import jax.core
import jax.extend.core

# The JAX package imports `jax.core.ClosedJaxpr`/`Jaxpr`, which jax 0.9
# moved to `jax.extend.core`: alias the missing public names back before
# anything of photon_tpu is imported.
for _name in dir(jax.extend.core):
    if not _name.startswith("_") and not hasattr(jax.core, _name):
        setattr(jax.core, _name, getattr(jax.extend.core, _name))

import ctypes  # noqa: E402
import gc  # noqa: E402
import re  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import jax.numpy as jnp  # noqa: E402

from photon_tpu import kernels as RK  # noqa: E402
from photon_tpu.data.matrix import SparseRows as RefSparseRows  # noqa: E402
from photon_tpu.data.matrix import quantize_blocks as ref_quantize  # noqa: E402
from photon_tpu.kernels.serving import fused_int8_margin  # noqa: E402

from photon_tpu_torch import kernels as K  # noqa: E402
from photon_tpu_torch import serving  # noqa: E402
from photon_tpu_torch.convert import game_model_from_arrays  # noqa: E402
from photon_tpu_torch.data.matrix import SparseRows, quantize_blocks  # noqa: E402
from photon_tpu_torch.kernels import serving as KS  # noqa: E402

# f32 margins: the two sides add the same products in another order
# (XLA's dot vs PyTorch's einsum/matmul), so they agree to a few ulp of
# the row's magnitude — the 300-term dense rows are the widest sum.
RTOL, ATOL = 1e-6, 1e-5

BRANCHES = {
    "fixed_dense": [("fixed", False)],
    "fixed_sparse": [("fixed", True)],
    "random_dense": [("random", False)],
    "random_sparse": [("random", True)],
}
BRANCHES["all_four"] = [p for ps in BRANCHES.values() for p in ps]
# more coordinates than one launch takes: the C entry point makes two
TWENTY = BRANCHES["all_four"] * 5


def _case(parts, seed=0, B=16, E=9, cold=False):
    """Numpy rung operands for coordinates ``parts`` = [(kind, sparse)];
    sparse rows end in two padded slots (index 0, value 0). Returns the
    reference's and the port's argument tuples."""
    rng = np.random.default_rng(seed)
    coords, r_sh, p_sh, r_ids, p_ids = [], {}, {}, {}, {}
    r_fw, p_fw, r_re, p_re = {}, {}, {}, {}
    for c, (kind, sparse) in enumerate(parts):
        name, shard = f"c{c}", f"s{c}"
        d = 300 if kind == "fixed" else 12
        if sparse:
            idx = rng.integers(0, d, size=(B, 7)).astype(np.int32)
            val = rng.normal(size=(B, 7)).astype(np.float32)
            idx[:, -2:], val[:, -2:] = 0, 0.0
            r_sh[shard] = RefSparseRows(jnp.asarray(idx), jnp.asarray(val), d)
            p_sh[shard] = SparseRows(torch.from_numpy(idx),
                                     torch.from_numpy(val), d)
        else:
            x = rng.normal(size=(B, d)).astype(np.float32)
            r_sh[shard], p_sh[shard] = jnp.asarray(x), torch.from_numpy(x)
        if kind == "fixed":
            q, s = ref_quantize(rng.normal(size=d).astype(np.float32))
            r_fw[name] = (jnp.asarray(q), s)
            p_fw[name] = (torch.from_numpy(q), torch.tensor([s]))
        else:
            w = rng.normal(size=(E + 1, d)).astype(np.float32)
            w[E] = 0.0  # the cold-miss row
            q, s = ref_quantize(w)
            r_re[name] = (jnp.asarray(q), jnp.asarray(s))
            p_re[name] = (torch.from_numpy(q), torch.from_numpy(s))
            e = (np.full(B, E) if cold
                 else rng.integers(0, E + 1, size=B)).astype(np.int32)
            r_ids[name], p_ids[name] = jnp.asarray(e), torch.from_numpy(e)
        coords.append((name, kind, shard))
    off = rng.normal(size=B).astype(np.float32)
    coords = tuple(coords)
    return ((coords, jnp.asarray(off), r_sh, r_ids, r_fw, r_re),
            (coords, torch.from_numpy(off), p_sh, p_ids, p_fw, p_re))


# ------------------------------------------------------------ quantization
@pytest.mark.parametrize("shape", [(37,), (6, 11), (1, 5)])
def test_quantize_int8_bitwise(shape):
    rng = np.random.default_rng(3)
    block = rng.normal(size=shape).astype(np.float32)
    if len(shape) == 2:
        block[-1] = 0.0  # the cold-miss row takes scale 1.0
    rq, rs = ref_quantize(block, "int8")
    pq, ps = quantize_blocks(block, "int8")
    assert pq.dtype == np.int8 and np.asarray(ps).dtype == np.float32
    np.testing.assert_array_equal(pq, rq)
    np.testing.assert_array_equal(np.asarray(ps).view(np.uint32),
                                  np.asarray(rs).view(np.uint32))
    if len(shape) == 2:
        assert ps[-1] == 1.0 and not pq[-1].any()


@pytest.mark.parametrize("shape", [(37,), (6, 11)])
def test_quantize_bf16_bitwise(shape):
    block = np.random.default_rng(4).normal(size=shape).astype(np.float32)
    rq, rs = ref_quantize(block, "bf16")
    pq, ps = quantize_blocks(block, "bf16")
    assert rs is None and ps is None and pq.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        pq.view(torch.int16).numpy().view(np.uint16),
        np.asarray(rq).view(np.uint16))


def test_quantize_rejects_unknown_mode():
    with pytest.raises(ValueError, match="int8"):
        quantize_blocks(np.zeros(3, np.float32), "int4")


# ------------------------------------------------- rung margin vs the Pallas
@pytest.mark.parametrize("branch", list(BRANCHES))
def test_int8_margin_matches_pallas_kernel(branch):
    ref_args, port_args = _case(BRANCHES[branch], seed=len(branch))
    with RK.scope("on"):
        want = np.asarray(fused_int8_margin(*ref_args))
    got = KS.int8_margin_reference(*port_args)
    assert got.dtype == torch.float32 and got.shape == (16,)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    # on CPU tensors the wrapper runs the plain version, unchanged
    np.testing.assert_array_equal(KS.int8_margin(*port_args).numpy(),
                                  got.numpy())


def test_cold_miss_rows_are_the_fixed_only_margin():
    """Every entity unseen: row E dequantizes to exact zeros on both
    sides, so the margin equals the fixed-only margin bit for bit."""
    ref_args, port_args = _case(BRANCHES["all_four"], seed=5, cold=True)
    coords = port_args[0]
    fixed_only = tuple(c for c in coords if c[1] == "fixed")
    got = KS.int8_margin_reference(*port_args)
    np.testing.assert_array_equal(
        got.numpy(),
        KS.int8_margin_reference(fixed_only, *port_args[1:]).numpy())
    with RK.scope("on"):
        want = np.asarray(fused_int8_margin(*ref_args))
        want_fixed = np.asarray(fused_int8_margin(fixed_only, *ref_args[1:]))
    np.testing.assert_array_equal(want, want_fixed)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


# ------------------------------------------------------------ the mode seam
def test_mode_seam_routes_cpu_tensors():
    _, port_args = _case(BRANCHES["fixed_sparse"])
    want = KS.int8_margin_reference(*port_args)
    for m in ("auto", "off"):
        with K.scope(m):
            np.testing.assert_array_equal(KS.int8_margin(*port_args).numpy(),
                                          want.numpy())
    with K.scope("on"), pytest.raises(RuntimeError, match="CUDA"):
        KS.int8_margin(*port_args)
    assert K.launch_counts().get(KS.KERNEL, 0) == 0


def test_mode_knob_parsing(monkeypatch):
    monkeypatch.setenv(K.ENV_KNOB, "0")
    assert K.mode() == "off"
    with K.scope("on"):
        assert K.mode() == "on"
        with K.scope(None):
            assert K.mode() == "on"
    assert K.mode() == "off"
    monkeypatch.setenv(K.ENV_KNOB, "sometimes")
    with pytest.raises(ValueError, match=K.ENV_KNOB):
        K.mode()


def test_launch_operands_are_checked_before_any_build():
    """The wrapper refuses operands the kernel does not take — before it
    builds or launches anything: a coefficient block when the rung plan
    is built, a request tensor on every call."""
    _, (coords, off, sh, ids, fw, re) = _case(BRANCHES["all_four"])
    bad = dict(re)
    name = next(iter(re))
    bad[name] = (re[name][0].to(torch.int32), re[name][1])
    with pytest.raises(ValueError, match="int8"):
        KS._launch(coords, off, sh, ids, fw, bad)
    strided = torch.stack([off, off], 1)[:, 0]  # (16,), stride 2
    with pytest.raises(ValueError, match="not contiguous"):
        KS._launch(coords, strided, sh, ids, fw, re)
    short = {n: e[:8] for n, e in ids.items()}
    with pytest.raises(ValueError, match="ids"):
        KS._launch(coords, off, sh, short, fw, re)


# -------------------------------------------------------------- rung plan
def _c_struct(name):
    """The (type, field) pairs of ``struct name`` in the CUDA source."""
    body = re.search(r"struct %s \{(.*?)\};" % name, KS.SOURCE.read_text(),
                     re.S).group(1)
    return re.findall(r"^\s*([\w *]+?)\s+(\w+)(?:\[\w+\])?;", body, re.M)


def test_rung_plan_packing_matches_the_c_struct():
    """`CoordDesc` has the C struct's fields in its order, nine 8-byte
    integers (72 B); the kernel's parameter struct (two pointers, two
    ints, kMaxCoords descriptors) stays inside the 4 KB a launch takes."""
    fields = _c_struct("CoordDesc")
    assert [f for _, f in fields] == list(KS._DESC_FIELDS)
    assert {t for t, _ in fields} == {"long long"}
    assert [f for f, _ in KS.CoordDesc._fields_] == list(KS._DESC_FIELDS)
    assert ctypes.sizeof(KS.CoordDesc) == 72
    src = KS.SOURCE.read_text()
    assert int(re.search(r"kMaxCoords = (\d+);", src).group(1)) \
        == KS.MAX_COORDS
    assert [f for _, f in _c_struct("RungParams")] \
        == ["offsets", "out", "batch", "n_coords", "coord"]
    assert "const __grid_constant__ RungParams" in src

    class RungParams(ctypes.Structure):
        _fields_ = [("offsets", ctypes.c_void_p), ("out", ctypes.c_void_p),
                    ("batch", ctypes.c_int), ("n_coords", ctypes.c_int),
                    ("coord", KS.CoordDesc * KS.MAX_COORDS)]

    assert ctypes.sizeof(RungParams) == 1176 <= 4096


def test_rung_plan_holds_the_coefficient_half():
    """Built from CPU tensors: each descriptor's kind, layout, widths and
    q/s addresses; a call's request addresses are written by `_bind`;
    the same tensors give the same plan, new q/s tensors a new one."""
    _, (coords, off, sh, ids, fw, re_) = _case(BRANCHES["all_four"])
    plan = KS.rung_plan(coords, sh, fw, re_)
    descs = [c[0] for c in plan.coords]
    assert plan.launches == 1 and len(descs) == len(coords) == 4
    for desc, (name, kind, shard) in zip(descs, coords):
        q, s = (fw if kind == "fixed" else re_)[name]
        X = sh[shard]
        sparse = isinstance(X, SparseRows)
        assert (desc.kind, desc.sparse, desc.d, desc.k) == (
            int(kind == "random"), int(sparse), q.shape[-1],
            X.indices.shape[1] if sparse else 0)
        assert (desc.q, desc.s) == (q.data_ptr(), s.data_ptr())
    with plan.lock:
        assert KS._bind(plan, off, sh, ids) == 16
    for desc, (name, kind, shard) in zip(descs, coords):
        X = sh[shard]
        if isinstance(X, SparseRows):
            assert (desc.x, desc.idx) == (X.values.data_ptr(),
                                          X.indices.data_ptr())
        else:
            assert desc.x == X.data_ptr()
        assert desc.ids == (ids[name].data_ptr() if kind == "random" else 0)
    assert KS.rung_plan(coords, sh, fw, re_) is plan
    fresh = {n: (q.clone(), s.clone()) for n, (q, s) in fw.items()}
    assert KS.rung_plan(coords, sh, fresh, re_) is not plan


def test_chunks_of_16_coordinates_equal_one_pass_bitwise():
    """A 20-coordinate rung takes two launches, the second starting from
    the first one's margins: in the plain version that chaining is one
    pass bit for bit, and the whole rung matches the Pallas kernel."""
    ref_args, port_args = _case(TWENTY, seed=20)
    coords, off, sh, ids, fw, re_ = port_args
    assert KS.rung_plan(coords, sh, fw, re_).launches == 2
    one = KS.int8_margin_reference(*port_args)
    first = KS.int8_margin_reference(coords[:KS.MAX_COORDS], off, sh, ids,
                                     fw, re_)
    chained = KS.int8_margin_reference(coords[KS.MAX_COORDS:], first, sh,
                                       ids, fw, re_)
    np.testing.assert_array_equal(chained.numpy(), one.numpy())
    with RK.scope("on"):
        want = np.asarray(fused_int8_margin(*ref_args))
    np.testing.assert_allclose(one.numpy(), want, rtol=RTOL, atol=ATOL)


def test_concurrent_calls_bind_their_own_pointers():
    """Calls on one rung plan from many threads (the dispatcher's flushes)
    write their request pointers into the plan's one descriptor array
    under its lock: between a call's bind and its launch, the array holds
    that call's pointers and no other's."""
    _, (coords, off, sh, ids, fw, re_) = _case(BRANCHES["all_four"])
    plan = KS.rung_plan(coords, sh, fw, re_)
    errors, done = [], []

    def worker(i):
        rng = np.random.default_rng(i)
        mine = {s: SparseRows(X.indices.clone(), X.values.clone(), X.shape[1])
                if isinstance(X, SparseRows) else X.clone()
                for s, X in sh.items()}
        my_ids = {n: e.clone() for n, e in ids.items()}
        my_off = off.clone()
        for _ in range(200):
            with plan.lock:
                KS._bind(plan, my_off, mine, my_ids)
                if rng.random() < 0.5:
                    threading.Event().wait(0)  # yield inside the lock
                for desc, name, random, shard, sparse, _, _ in plan.coords:
                    X = mine[shard]
                    want = X.values if sparse else X
                    if desc.x != want.data_ptr() or (
                            random and desc.ids != my_ids[name].data_ptr()):
                        errors.append(i)
        done.append(i)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert sorted(done) == list(range(8)) and not errors


def _store(seed):
    rng = np.random.default_rng(seed)
    model = game_model_from_arrays("logistic", {
        "global": {"type": "fixed", "feature_shard": "g",
                   "means": rng.normal(size=50).astype(np.float32)},
        "perUser": {"type": "random", "feature_shard": "u",
                    "entity_name": "userId",
                    "entity_keys": np.asarray(["a", "b", "c"]),
                    "coefficients": rng.normal(size=(3, 4)).astype(
                        np.float32)},
    }, device="cpu")
    return serving.CoefficientStore.from_game_model(model, device="cpu")


def test_reload_coefficients_gives_the_ladder_a_new_rung_plan():
    """A hot swap brings new int8 q/s tensors: the ladder's next rung plan
    points at them, and the old generation's plan is not reused — it goes
    with the old tensors."""
    live = _store(0)
    ladder = serving.ProgramLadder(live, floor=8, max_batch=8,
                                   sparse_k={"g": 5}, quantize="int8",
                                   quant_epsilon=0.5)
    _, shards, _, fixed_ws, re_cs = ladder.example_args(8)
    plan = KS.rung_plan(ladder.coords, shards, fixed_ws, re_cs)
    assert KS.rung_plan(ladder.coords, shards,
                        *ladder._quant_blocks()) is plan
    live.reload_coefficients(_store(1))
    new_fixed, new_re = ladder._quant_blocks()
    new = KS.rung_plan(ladder.coords, shards, new_fixed, new_re)
    assert new is not plan
    for desc, name, random, *_ in new.coords:
        q, s = (new_re if random else new_fixed)[name]
        assert (desc.q, desc.s) == (q.data_ptr(), s.data_ptr())
    del fixed_ws, re_cs
    gc.collect()
    assert all(p is not plan for _, p in KS._PLANS.values())
    assert KS.rung_plan(ladder.coords, shards, new_fixed, new_re) is new


def test_launch_counts_reset():
    K.reset_launch_counts()
    K.count_launch("x")
    K.count_launch("x")
    assert K.launch_counts() == {"x": 2}
    K.reset_launch_counts()
    assert K.launch_counts() == {}
