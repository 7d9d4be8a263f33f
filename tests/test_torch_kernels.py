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

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import jax.numpy as jnp  # noqa: E402

from photon_tpu import kernels as RK  # noqa: E402
from photon_tpu.data.matrix import SparseRows as RefSparseRows  # noqa: E402
from photon_tpu.data.matrix import quantize_blocks as ref_quantize  # noqa: E402
from photon_tpu.kernels.serving import fused_int8_margin  # noqa: E402

from photon_tpu_torch import kernels as K  # noqa: E402
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
    builds or launches anything."""
    _, (coords, off, sh, ids, fw, re) = _case(BRANCHES["all_four"])
    bad = dict(re)
    name = next(iter(re))
    bad[name] = (re[name][0].to(torch.int32), re[name][1])
    with pytest.raises(ValueError, match="int8"):
        KS._launch(coords, off, sh, ids, fw, bad)
    strided = torch.stack([off, off], 1)[:, 0]  # (16,), stride 2
    with pytest.raises(ValueError, match="not contiguous"):
        KS._launch(coords, strided, sh, ids, fw, re)


def test_launch_counts_reset():
    K.reset_launch_counts()
    K.count_launch("x")
    K.count_launch("x")
    assert K.launch_counts() == {"x": 2}
    K.reset_launch_counts()
    assert K.launch_counts() == {}
