"""The port's package facades and the reference's public functions they
lacked.

Every name the reference's `photon_tpu/__init__.py`,
`photon_tpu/game/__init__.py`, `photon_tpu/utils/__init__.py` and
`photon_tpu/tuning/__init__.py` export imports from the port's
counterpart (one case per name, each the object the port's own module
defines). Each of the five functions the port lacked matches the
reference on numpy-seeded inputs: `game.scoring.predict_mean` on a fitted
GAME model (rtol 1e-4, the score's bound in `tests/test_torch_game.py`),
`data.statistics.summarize_features` (rtol 1e-5), and
`models.glm.logistic_regression` / `linear_regression` /
`poisson_regression` (their means within rtol 1e-6). The rung's
reference name `fused_int8_margin` is the port's `int8_margin`.
"""
import importlib

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

FACADES = ("", ".game", ".utils", ".tuning")


def _names():
    out = []
    for sub in FACADES:
        ref = importlib.import_module("photon_tpu" + sub)
        out += [(sub, name) for name in ref.__all__]
    return out


@pytest.mark.parametrize("sub,name", _names(),
                         ids=[f"photon_tpu{s}.{n}" for s, n in _names()])
def test_every_reference_facade_name_imports_from_the_port(sub, name):
    ref = importlib.import_module("photon_tpu" + sub)
    port = importlib.import_module("photon_tpu_torch" + sub)
    assert name in port.__all__
    got = getattr(port, name)
    want = getattr(ref, name)
    # the port's own object, defined in the module that mirrors the
    # reference's (e.g. photon_tpu.game.model -> photon_tpu_torch.game.model)
    home = getattr(want, "__module__", None)
    if home is not None and callable(want):
        mirror = importlib.import_module(
            home.replace("photon_tpu", "photon_tpu_torch", 1))
        assert getattr(mirror, name) is got
        assert got.__module__.startswith("photon_tpu_torch")
    else:
        assert type(got) is type(want)


def test_the_facades_import_nothing_of_the_reference():
    import sys

    import photon_tpu_torch
    import photon_tpu_torch.game  # noqa: F401
    import photon_tpu_torch.utils  # noqa: F401

    for mod in list(sys.modules.values()):
        name = getattr(mod, "__name__", "")
        if name.startswith("photon_tpu_torch"):
            src = getattr(mod, "__file__", "") or ""
            if src.endswith(".py"):
                text = open(src).read()
                assert "import jax" not in text, name
                assert "from photon_tpu." not in text, name
                assert "import photon_tpu\n" not in text, name
    assert photon_tpu_torch.__version__


# --------------------------------------------------------- the functions
@pytest.mark.parametrize("maker", ["logistic_regression", "linear_regression",
                                   "poisson_regression"])
def test_glm_makers_match_the_reference(maker):
    from photon_tpu.models import glm as RG

    from photon_tpu_torch.models import glm as G

    rng = np.random.default_rng(0)
    w = rng.normal(size=7).astype(np.float32) * 0.3
    v = rng.uniform(0.1, 1.0, size=7).astype(np.float32)
    X = rng.normal(size=(50, 7)).astype(np.float32)
    rm = getattr(RG, maker)(jnp.asarray(w), jnp.asarray(v))
    pm = getattr(G, maker)(w, v)
    assert pm.task.value == rm.task.value
    np.testing.assert_array_equal(pm.coefficients.means.numpy(), w)
    np.testing.assert_array_equal(pm.coefficients.variances.numpy(), v)
    np.testing.assert_allclose(
        pm.predict_mean(torch.from_numpy(X)).numpy(),
        np.asarray(rm.predict_mean(jnp.asarray(X))), rtol=1e-6, atol=1e-7)
    assert getattr(G, maker)(torch.from_numpy(w)).coefficients.variances \
        is None


def test_summarize_features_matches_the_reference():
    from photon_tpu.data import matrix as RM
    from photon_tpu.data.statistics import (
        summarize_features as ref_summarize)

    from photon_tpu_torch.data import matrix as M
    from photon_tpu_torch.data.statistics import summarize_features

    rng = np.random.default_rng(1)
    n, d, k = 300, 20, 4
    ind = rng.integers(0, d, (n, k)).astype(np.int32)
    val = rng.normal(2.0, 1.5, (n, k)).astype(np.float32)
    names = [f"f{j}" for j in range(d)]
    for ref_X, port_X, nm in (
            (RM.SparseRows(ind, val, d), M.SparseRows(ind, val, d), names),
            (rng.normal(size=(n, 6)).astype(np.float32), None, None)):
        if port_X is None:
            port_X = torch.from_numpy(ref_X)
        got = summarize_features(port_X, names=nm, device="cpu")
        want = ref_summarize(ref_X, names=nm)
        assert list(got) == list(want)
        for key in want:
            for stat, value in want[key].items():
                np.testing.assert_allclose(got[key][stat], value, rtol=1e-5,
                                           atol=1e-6, err_msg=f"{key} {stat}")


def test_predict_mean_matches_the_reference():
    import test_torch_game as TG
    from photon_tpu.game.scoring import predict_mean as ref_predict_mean

    from photon_tpu_torch.game import predict_mean

    ref, port = TG.game_pair(TG.raw_game(task="poisson"))
    rest, pest = TG.estimator_pair("poisson", n_sweeps=1)
    (rr,) = rest.fit(ref)
    (pr,) = pest.fit(port)
    got = predict_mean(pr.model, port)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(ref_predict_mean(rr.model, ref)),
                               rtol=1e-4, atol=1e-4)
    assert bool((got > 0).all())


def test_fused_int8_margin_is_the_rung():
    from photon_tpu_torch.kernels import serving

    assert serving.fused_int8_margin is serving.int8_margin
