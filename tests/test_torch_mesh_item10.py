"""The rest of the port's multi-device surface on its in-process 8-slot
CPU mesh, against the JAX package's 8-device CPU mesh where the reference
has the path (`tests/conftest.py` gives the JAX side 8 devices):

- `continual.refresh_game_model(mesh=)` on `test_torch_continual.py`'s
  world (touched lanes padded to a slot multiple, solved slot by slot):
  untouched rows bit for bit, touched rows within rtol 1e-4 / atol 1e-5
  and every stats field equal to the reference's mesh refresh
  (`test_torch_continual._same_refresh`), and bit for bit the port's
  one-device refresh;
- `drivers.run_training(mesh=)` on `test_torch_drivers.py`'s Avro (a
  2-point grid, validation, two sweeps) against the reference driver's
  mesh run: the same best point, coefficients within rtol 1e-4 / atol
  1e-5 (`test_torch_game.py`'s bounds), validation scores within 1e-5;
  the streamed read giving the in-memory read's model bit for bit, the
  streamed objective within the streamed-against-resident bounds (rtol
  5e-3 / atol 1e-3, `tests/test_game_e2e.py:105-160`), and a
  ``checkpoint_dir`` run killed at ``bucket_retire`` rerun to the plain
  run's model bit for bit;
- `parallel.mesh.make_hybrid_mesh`: its (R, D) shape and axis names as
  the reference's (`tests/test_multihost.py:41-46`), its refusal, the
  whole-mesh `psum`, and `train_glm` on the (2, 4) mesh
  bit for bit the flat 8-slot mesh's;
- §C15: NCCL on 2 processes with one card per host passes the check and
  reaches the process group; 2 processes on one card still raise;
- the slot-split guard: 6 slots over 2 processes and 12 over 4 refused
  (by `make_mesh` and by `parallel.launch`, before anything spawns),
  8 over 2, 8 over 4 and 6 over 3 accepted.
"""
import dataclasses
import os

import jax.core
import jax.extend.core

# The JAX package imports `jax.core.ClosedJaxpr`/`Jaxpr`, which jax 0.9
# moved to `jax.extend.core`: alias the missing public names back before
# anything of photon_tpu is imported.
for _name in dir(jax.extend.core):
    if not _name.startswith("_") and not hasattr(jax.core, _name):
        setattr(jax.core, _name, getattr(jax.extend.core, _name))

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import test_torch_continual as TC  # noqa: E402
import test_torch_drivers as TD  # noqa: E402
from photon_tpu import continual as RC  # noqa: E402
from photon_tpu import drivers as RD  # noqa: E402
from photon_tpu.parallel import mesh as RMesh  # noqa: E402

from photon_tpu_torch import checkpoint  # noqa: E402
from photon_tpu_torch import continual as C  # noqa: E402
from photon_tpu_torch import drivers as PD  # noqa: E402
from photon_tpu_torch.data.dataset import make_batch  # noqa: E402
from photon_tpu_torch.data.matrix import SparseRows  # noqa: E402
from photon_tpu_torch.models.training import train_glm  # noqa: E402
from photon_tpu_torch.ops.losses import TaskType  # noqa: E402
from photon_tpu_torch.optim.config import OptimizerConfig  # noqa: E402
from photon_tpu_torch.optim.regularization import l2  # noqa: E402
from photon_tpu_torch.parallel import launch as PL  # noqa: E402
from photon_tpu_torch.parallel import mesh as PM  # noqa: E402
from photon_tpu_torch.parallel import selfcheck as sc  # noqa: E402

CPU = "cpu"
# test_torch_game.py's parity bounds (solves stopped at 1e-3).
W_RTOL, W_ATOL = 1e-4, 1e-5
# The streamed-against-resident GAME bounds (tests/test_game_e2e.py).
STREAMED_TOL = dict(rtol=5e-3, atol=1e-3)


@pytest.fixture(scope="module")
def rmesh():
    return RMesh.make_mesh(devices=jax.devices("cpu"))


@pytest.fixture(scope="module")
def pmesh():
    return PM.make_mesh(n_devices=8, device=CPU)


# ------------------------------------------------------ continual refresh
def test_refresh_on_mesh_matches_reference(rmesh, pmesh):
    world = TC._world()
    ref_res = RC.refresh_game_model(world["ref_prev"], world["ref_drop"],
                                    world["ref_plan"], {"re": TC.CFG_R[0]},
                                    mesh=rmesh)
    res = C.refresh_game_model(world["prev"], world["drop"], world["plan"],
                               {"re": TC.CFG_R[1]}, mesh=pmesh)
    TC._same_refresh(ref_res, res, TC.TOUCHED, world["prev"])
    one = C.refresh_game_model(world["prev"], world["drop"], world["plan"],
                               {"re": TC.CFG_R[1]})
    for a, b in ((res.model["re"].coefficients, one.model["re"].coefficients),
                 (res.model["re"].variances, one.model["re"].variances)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        C.refresh_game_model(world["prev"], world["drop"], world["plan"],
                             {"re": TC.CFG_R[1]}, mesh=object())


# ------------------------------------------------------ the training driver
def _params(pkg, root, out, **kw):
    coords = {**TD.COORDINATES, "fixed": {**TD.COORDINATES["fixed"],
                                          "reg_weights": [0.1, 10.0]}}
    return pkg.TrainingParams(
        train_path=str(root / "train.avro"),
        validation_path=str(root / "validation.avro"),
        output_dir=str(root / out), feature_shards=TD.SHARDS,
        coordinates=coords, entity_fields=["userId"], n_sweeps=2,
        evaluators=["AUC"], **kw)


def _coeffs(model) -> tuple:
    return (np.asarray(model["fixed"].model.coefficients.means),
            np.asarray(model["perUser"].coefficients))


@pytest.fixture(scope="module")
def avro(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_driver")
    TD.write_game_avro(root / "train.avro", 600, seed=1)
    TD.write_game_avro(root / "validation.avro", 300, seed=2)
    return root


def test_run_training_on_mesh_matches_reference(avro, rmesh, pmesh):
    ref = RD.run_training(_params(RD, avro, "ref"), mesh=rmesh)
    port = PD.run_training(_params(PD, avro, "port"), mesh=pmesh)
    assert ({n: c.optimizer.reg_weight for n, c in port.best.configs.items()}
            == {n: c.optimizer.reg_weight
                for n, c in ref.best.configs.items()})
    for got, want in zip(_coeffs(port.best.model), _coeffs(ref.best.model)):
        np.testing.assert_allclose(got, want, rtol=W_RTOL, atol=W_ATOL)
    for p, r in zip(port.results, ref.results):
        np.testing.assert_allclose(p.validation_score, r.validation_score,
                                   rtol=0, atol=1e-5)
    assert os.path.isdir(port.model_dir)
    # the streamed read lands the same rows: the same model, bit for bit
    streamed = PD.run_training(_params(PD, avro, "port_s", streaming=True),
                               mesh=pmesh)
    for got, want in zip(_coeffs(streamed.best.model),
                         _coeffs(port.best.model)):
        np.testing.assert_array_equal(got, want)
    # the streamed objective streams the fixed shard over the slots
    sobj = PD.run_training(_params(PD, avro, "port_o",
                                   streamed_objective=True), mesh=pmesh)
    for got, want in zip(_coeffs(sobj.best.model), _coeffs(port.best.model)):
        np.testing.assert_allclose(got, want, **STREAMED_TOL)


def test_run_training_on_mesh_resumes_from_its_checkpoint(avro, pmesh):
    plain = PD.run_training(_params(PD, avro, "plain"), mesh=pmesh)
    params = _params(PD, avro, "ck", checkpoint_dir="ck",
                     checkpoint_every_evals=1, checkpoint_every_s=None,
                     checkpoint_async=False)
    with checkpoint.fault_plan(checkpoint.FaultPlan.kill_at(
            "bucket_retire", 3)):
        with pytest.raises(checkpoint.InjectedFault):
            PD.run_training(params, mesh=pmesh)
    resumed = PD.run_training(params, mesh=pmesh)
    for got, want in zip(_coeffs(resumed.best.model),
                         _coeffs(plain.best.model)):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        PD.run_training(_params(PD, avro, "x"), mesh=object())


# ------------------------------------------------------ replica x data mesh
def test_hybrid_mesh_shape_axes_and_refusal():
    h = PM.make_hybrid_mesh(2, n_devices=8, device=CPU)
    r = RMesh.make_hybrid_mesh(2, devices=jax.devices("cpu"))
    assert h.axis_names == tuple(r.axis_names) == ("replica", "data")
    assert h.shape == tuple(r.devices.shape) == (2, 4)
    one = PM.make_hybrid_mesh(n_devices=8, device=CPU)  # a replica/process
    assert one.shape == (1, 8)
    with pytest.raises(ValueError, match="do not divide into 3 replicas"):
        PM.make_hybrid_mesh(3, n_devices=8, device=CPU)
    # the whole mesh sums as the flat slot tree
    parts = [(torch.tensor([float(j) + 0.1], dtype=torch.float32),)
             for j in range(8)]
    flat = PM.make_mesh(n_devices=8, device=CPU)
    assert torch.equal(h.psum(parts)[0], flat.psum(parts)[0])


def test_train_glm_on_hybrid_mesh_equals_flat_mesh():
    rng = np.random.default_rng(3)
    n, d, k = 1001, 50, 4
    ind = rng.integers(0, d, size=(n, k)).astype(np.int32)
    val = rng.normal(size=(n, k)).astype(np.float32)
    y = (rng.uniform(size=n) < 0.5).astype(np.float32)
    batch = make_batch(SparseRows(ind, val, d), y, device=CPU)
    cfg = OptimizerConfig(max_iters=15, reg=l2(), reg_weight=1.0)
    out = []
    for mesh in (PM.make_mesh(n_devices=8, device=CPU),
                 PM.make_hybrid_mesh(2, n_devices=8, device=CPU)):
        model, res = train_glm(batch, TaskType.LOGISTIC_REGRESSION, cfg,
                               mesh=mesh)
        out.append((model.coefficients.means.numpy(), res.history()))
    np.testing.assert_array_equal(out[0][0], out[1][0])
    np.testing.assert_array_equal(out[0][1], out[1][1])


# ------------------------------------------------------------ §C15
def test_nccl_counts_this_hosts_processes(monkeypatch):
    """2 processes, one card per host: the check passes and the group
    call is reached (stubbed: no NCCL here); 2 processes sharing this
    host's one card still raise."""
    import torch.distributed as dist

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    formed = []

    def init_process_group(backend, **kw):
        formed.append((backend, kw["world_size"], kw["rank"]))

    monkeypatch.setattr(dist, "init_process_group", init_process_group)
    monkeypatch.setattr(dist, "new_group", lambda **kw: "barriers")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")
    try:
        assert PM.initialize_distributed(
            "127.0.0.1:9", num_processes=2, process_id=1, device="cuda:0")
        assert PM.distributed_client()["backend"] == "nccl"
    finally:
        PM._DIST.clear()
    monkeypatch.delenv("LOCAL_WORLD_SIZE")
    assert formed == [("nccl", 2, 1)]
    for env in ({}, {"LOCAL_WORLD_SIZE": "2"}):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        with pytest.raises(ValueError, match="2 processes on this host's 1 "
                                             "card"):
            PM.initialize_distributed("127.0.0.1:9", num_processes=2,
                                      process_id=0, device="cuda:0")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "3")
    with pytest.raises(ValueError, match="outside 1..2"):
        PM.initialize_distributed("127.0.0.1:9", num_processes=2,
                                  process_id=0, device="cuda:0")
    assert len(formed) == 1 and not PM._DIST


# -------------------------------------------------- the slot-split guard
@pytest.mark.parametrize("slots,procs,ok", [
    (6, 2, False), (12, 4, False), (8, 2, True), (8, 4, True), (6, 3, True),
    (24, 3, True)])
def test_slot_split_guard(monkeypatch, slots, procs, ok):
    """A process's contiguous slots must be a subtree of the reduction's
    pairwise tree: S/P a power of two (for P > 1)."""
    monkeypatch.setitem(PM._DIST, "rank", procs - 1)
    monkeypatch.setitem(PM._DIST, "world", procs)
    monkeypatch.setitem(PM._DIST, "device", torch.device(CPU))
    monkeypatch.setitem(PM._DIST, "backend", "gloo")
    if ok:
        mesh = PM.make_mesh(n_devices=slots, device=CPU)
        assert mesh.local_slots[-1] == slots - 1
        PM.check_slot_split(slots, procs)
        return
    with pytest.raises(ValueError, match="not a power of two.*subtree"):
        PM.make_mesh(n_devices=slots, device=CPU)
    with pytest.raises(ValueError, match="subtree"):
        PL.launch(sc.target_psum_signature, procs, total_devices=slots,
                  device=CPU)
