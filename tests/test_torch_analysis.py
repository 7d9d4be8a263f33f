"""The port's run-time contract engine (`photon_tpu_torch.analysis`) on
torch fixtures: each of the five rules fires on a program that breaks
its law and stays quiet on one that keeps it — an ``index_add_`` under a
scatter ``forbid``, a psum over its budget, a matmul where the matmul
family is forbidden (collective-budget); a ``.item()`` inside an X pass
(transfer-lint), and an off path that syncs where its bare path does not
(even inside the budget); a bf16 ``mm`` with a bf16 output under
``require_f32_accum`` and a float64 leak (dtype-policy); a per-call host
upload (const-bloat); a second call that rebuilds a plan, records a new
signature, or a Python float argument (retrace-hazard). Then the engine:
a duplicate name is refused, a builder that raises is a ``trace-error``
violation, and the CLI's ``--json`` / ``--list`` / ``--only`` exit codes.
"""
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from photon_tpu_torch.analysis import (DOT_GENERAL, SCATTER_PRIMITIVES,
                                       TRANSFER_PRIMITIVES, ContractSpec,
                                       check_contract, check_registry,
                                       register_contract)
from photon_tpu_torch.analysis import contracts as C
from photon_tpu_torch.lint import repo_root

REPO = repo_root()


def _spec(fn, args, **kw) -> ContractSpec:
    return ContractSpec(name="fixture", build=lambda device: (fn, args),
                        **kw)


def _rules(spec) -> list:
    return sorted({v.rule for v in check_contract(spec, device="cpu")})


def _vec(n=64, seed=0, dtype=torch.float32):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=n).astype(np.float32)).to(dtype)


# ---------------------------------------------------- collective-budget

def _xt_r_index_add(r, rows, cols, vals):
    return torch.zeros(16).index_add_(0, cols, vals * r[rows])


def _xt_r_sorted(r, rows, cols, vals):
    order = torch.argsort(cols, stable=True)
    c = torch.cumsum((vals * r[rows])[order], 0)
    ends = torch.searchsorted(cols[order], torch.arange(16), right=True)
    padded = torch.cat([torch.zeros(1), c])
    return padded[ends] - padded[torch.searchsorted(
        cols[order], torch.arange(16))]


def _coo():
    rng = np.random.default_rng(1)
    rows = torch.from_numpy(rng.integers(0, 32, 96))
    cols = torch.from_numpy(rng.integers(0, 16, 96))
    return (_vec(32), rows, cols, _vec(96, 2))


@pytest.mark.parametrize("fn, fires", [(_xt_r_index_add, True),
                                       (_xt_r_sorted, False)])
def test_forbidden_scatter(fn, fires):
    got = _rules(_spec(fn, _coo(), forbid=SCATTER_PRIMITIVES))
    assert got == (["collective-budget"] if fires else [])


def test_both_fixtures_compute_the_same_xt_r():
    args = _coo()
    torch.testing.assert_close(_xt_r_index_add(*args), _xt_r_sorted(*args),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("budget, fires", [({"psum": 1}, False),
                                           ({}, True), ({"psum": 2}, True)])
def test_psum_budget(budget, fires):
    from photon_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(n_devices=4, device="cpu")
    parts = [(torch.ones(3),) for _ in range(mesh.n_local)]
    got = _rules(_spec(lambda p: mesh.psum(p), (parts,),
                       collectives=budget))
    assert got == (["collective-budget"] if fires else [])


@pytest.mark.parametrize("fn, fires", [
    (lambda X, w: X @ w, True),
    (lambda z, w: z * w, False),
])
def test_forbidden_pass_over_x(fn, fires):
    got = _rules(_spec(fn, (torch.ones(8, 8), torch.ones(8)),
                       forbid=DOT_GENERAL))
    assert got == (["collective-budget"] if fires else [])


# ---------------------------------------------------------- transfer-lint

def _pass_with_item(X, w):
    z = X @ w
    return z / float(z.abs().max().item())


def _pass_without_sync(X, w):
    z = X @ w
    return z / z.abs().max()


@pytest.mark.parametrize("fn, budget, fires", [
    (_pass_with_item, 0, True),
    (_pass_with_item, {"cpu": 1, "cuda": 1}, False),
    (_pass_without_sync, 0, False),
])
def test_host_sync_inside_an_x_pass(fn, budget, fires):
    X, w = torch.ones(8, 4), torch.ones(4)
    got = _rules(_spec(fn, (X, w), max_syncs=budget))
    assert got == (["transfer-lint"] if fires else [])


@pytest.mark.parametrize("off, fires", [(_pass_with_item, True),
                                        (_pass_without_sync, False)])
def test_an_off_path_is_held_to_its_bare_path(off, fires):
    # a budget roomy enough for the extra read-back: only the bare
    # path's count on the same arguments shows the sync the off path adds
    X, w = torch.ones(8, 4), torch.ones(4)
    spec = ContractSpec(name="fixture", max_syncs=5,
                        build=lambda device: (off, (X, w),
                                              _pass_without_sync))
    assert _rules(spec) == (["transfer-lint"] if fires else [])
    traced = C.trace_contract(spec, "cpu")
    assert C.summarize(traced)["bare_syncs"] == 0


def test_tolist_counts_and_transfers_forbid_is_the_budget():
    def read_back(t):
        return (t * 2).tolist()

    spec = _spec(read_back, (torch.ones(3),), forbid=TRANSFER_PRIMITIVES)
    assert _rules(spec) == ["transfer-lint"]
    spec = _spec(read_back, (torch.ones(3),), forbid=TRANSFER_PRIMITIVES,
                 max_syncs=1)
    assert _rules(spec) == []


# ----------------------------------------------------------- dtype-policy

@pytest.mark.parametrize("out_dtype, fires", [
    (torch.bfloat16, True), (torch.float32, False)])
def test_bf16_matmul_accumulation(out_dtype, fires):
    def mm(a, b):
        if out_dtype is torch.bfloat16:
            return a @ b
        return a.float() @ b.float()

    a = torch.ones(8, 8, dtype=torch.bfloat16)
    got = _rules(_spec(mm, (a, a.clone()), require_f32_accum=True))
    assert got == (["dtype-policy"] if fires else [])


@pytest.mark.parametrize("fn, fires", [
    (lambda z: (z.double() * 2).sum().float(), True),
    (lambda z: (z * 2).sum(), False),
])
def test_float64_leak(fn, fires):
    assert _rules(_spec(fn, (_vec(),))) == (
        ["dtype-policy"] if fires else [])


def test_bf16_sum_under_f32_accumulation():
    x = torch.ones(64, dtype=torch.bfloat16)
    assert _rules(_spec(lambda t: t.sum(), (x,),
                        require_f32_accum=True)) == ["dtype-policy"]
    assert _rules(_spec(lambda t: t.sum(dtype=torch.float32), (x,),
                        require_f32_accum=True)) == []


# ------------------------------------------------------------ const-bloat

_HOST = np.ones(1 << 19, np.float32)  # 2 MiB of host data


@pytest.mark.parametrize("fn, fires", [
    (lambda w: w + torch.tensor(_HOST), True),
    (lambda w: w + 1.0, False),
])
def test_per_call_host_upload(fn, fires):
    w = torch.zeros(1 << 19)
    assert _rules(_spec(fn, (w,))) == (["const-bloat"] if fires else [])


# --------------------------------------------------------- retrace-hazard

def _layout():
    from photon_tpu_torch.data.matrix import SparseRows, to_blocked_ell

    rng = np.random.default_rng(0)
    ind = rng.integers(0, 40, size=(64, 4)).astype(np.int32)
    val = rng.normal(size=(64, 4)).astype(np.float32)
    return to_blocked_ell(SparseRows(ind, val, 40), 8, device="cpu")


def test_a_second_call_that_rebuilds_a_plan():
    from photon_tpu_torch.kernels.blocked_ell import layout_plan

    X = _layout()
    fresh = _spec(lambda: layout_plan(_layout()), ())
    kept = _spec(lambda: layout_plan(X), ())
    assert _rules(fresh) == ["retrace-hazard"]
    assert _rules(kept) == []


def test_a_second_call_that_adds_a_signature():
    from photon_tpu_torch.telemetry.run import SignatureLog

    log, calls = SignatureLog(), []

    def drifting(w):
        calls.append(1)
        log.record("prog", torch.zeros(len(calls)))
        return w

    def stable(w):
        log.record("stable", torch.zeros(3))
        return w

    assert _rules(_spec(drifting, (_vec(),))) == ["retrace-hazard"]
    assert _rules(_spec(stable, (_vec(),))) == []


def test_a_python_float_argument():
    def scale(w, a):
        return w * a

    assert _rules(_spec(scale, (_vec(), 0.5))) == ["retrace-hazard"]
    assert _rules(_spec(scale, (_vec(), torch.tensor(0.5)))) == []
    assert _rules(_spec(scale, (_vec(), 0.5), allow_weak_args=True)) == []


# ----------------------------------------------------------------- engine

def test_a_duplicate_name_is_refused():
    name = "fixture_duplicate_refusal"
    try:
        register_contract(name)(lambda device: (lambda: None, ()))
        with pytest.raises(ValueError, match="duplicate contract name"):
            register_contract(name)(lambda device: (lambda: None, ()))
    finally:
        C.REGISTRY.pop(name, None)


def test_a_builder_that_raises_is_a_trace_error():
    def broken(device):
        raise RuntimeError("no such layout")

    spec = ContractSpec(name="fixture_broken", build=broken)
    report = check_registry({"fixture_broken": spec}, device="cpu")
    (v,) = report["fixture_broken"]["violations"]
    assert v["rule"] == "trace-error" and "no such layout" in v["message"]


def _cli(*args):
    return subprocess.run([sys.executable, "-m", "photon_tpu_torch.analysis",
                           *args], capture_output=True, text=True,
                          timeout=300, cwd=REPO)


def test_cli_exit_codes():
    listed = _cli("--list")
    assert listed.returncode == 0
    assert len(listed.stdout.strip().splitlines()) == 51
    assert _cli("--only", "no_such_contract", "--device",
                "cpu").returncode == 2
    one = _cli("--json", "--device", "cpu", "--only",
               "resident_value_and_grad", "--only", "mesh_value_and_grad")
    assert one.returncode == 0, one.stderr[-2000:]
    doc = json.loads(one.stdout)
    assert doc["ok"] and doc["n_specs"] == 2 and doc["device"] == "cpu"
    assert doc["specs"]["mesh_value_and_grad"]["collectives"] == {"psum": 1}


def test_cli_refuses_cuda_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: --device cuda runs")
    proc = _cli("--only", "resident_value_and_grad", "--device", "cuda")
    assert proc.returncode != 0 and "no GPU is available" in proc.stderr
