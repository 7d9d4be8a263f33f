"""The port's self-test CLIs on the CPU: each new suite's
``run_selftest(device="cpu")`` passes every check (its ``contracts``
check included), the umbrella ``python -m photon_tpu_torch --selfcheck``
runs two suites, knows all 13 of the reference's suites with none
pending, and every new CLI refuses ``--device cuda`` on a machine with no
GPU (no fallback to the CPU).
"""
import json

import pytest
import torch

from photon_tpu_torch import __main__ as umbrella
from photon_tpu_torch.continual import __main__ as continual_cli
from photon_tpu_torch.game import __main__ as game_cli
from photon_tpu_torch.ingest import __main__ as ingest_cli
from photon_tpu_torch.kernels import __main__ as kernels_cli
from photon_tpu_torch.profiling import __main__ as profiling_cli

NEW_CLIS = {"kernels": kernels_cli, "ingest": ingest_cli,
            "continual": continual_cli, "game": game_cli,
            "profiling": profiling_cli}
CHECKS = {
    "kernels": {"parity", "streamed", "dispatch", "ring", "contracts"},
    "ingest": {"scan", "decode_parity", "cache", "ladder", "prefetch",
               "contracts"},
    "continual": {"delta_plan", "refresh_parity", "refresh_no_retrace",
                  "swap", "contracts"},
    "game": {"streamed_mesh_parity", "blocked_ell_mesh_smoke",
             "beyond_resident_smoke", "contracts"},
    "profiling": {"has_streamed_entries", "entries_have_static_estimates",
                  "utilization_in_unit_interval",
                  "measured_durations_positive", "compile_accounting",
                  "ledger_off_is_free", "contracts"},
}


@pytest.mark.parametrize("name", sorted(NEW_CLIS))
def test_selftest_passes_on_the_cpu(name):
    report = NEW_CLIS[name].run_selftest(device="cpu")
    assert set(report["checks"]) == CHECKS[name]
    failed = {k: v for k, v in report["checks"].items() if not v["ok"]}
    assert not failed and report["ok"]


@pytest.mark.parametrize("name", sorted(NEW_CLIS))
def test_cli_refuses_cuda_without_a_gpu(name):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: --device cuda runs")
    with pytest.raises(RuntimeError, match="no GPU is available"):
        NEW_CLIS[name].main(["--selftest", "--device", "cuda"])


def test_umbrella_runs_two_suites(capsys):
    rc = umbrella.main(["--selfcheck", "--json", "--device", "cpu",
                        "--jobs", "2", "--only", "profiling", "game"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and out["ok"] and out["device"] == "cpu"
    assert list(out["suites"]) == ["profiling", "game"]
    for r in out["suites"].values():
        assert r["rc"] == 0 and json.loads(r["detail"])["ok"]


def test_umbrella_names_the_pending_suites_and_never_counts_them(
        capsys, monkeypatch):
    # every suite of the reference's umbrella is ported: none is pending
    assert umbrella.PENDING == ()
    ported = [name for name, _ in umbrella.SUITES]
    assert len(ported) == 13 == len(set(ported))
    assert {"analysis", "lint", "threads"} <= set(ported)
    with pytest.raises(ValueError, match="not a suite"):
        umbrella.run_selfcheck(only=["no_such_suite"], device="cpu")
    # a failing suite fails the run; the line names no pending suite
    monkeypatch.setattr(umbrella, "run_selfcheck", lambda **kw: {
        "kernels": {"rc": 1, "ok": False, "seconds": 0.1,
                    "detail": "no GPU is available"}})
    assert umbrella.main(["--selfcheck", "--only", "kernels"]) == 1
    line = capsys.readouterr().out
    assert "kernels=FAIL(rc=1)" in line and "0/1 ok" in line
    assert "pending" not in line
    assert umbrella.main(["--selfcheck", "--json", "--only", "kernels"]) == 1
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert not out["ok"] and out["pending"] == []


def test_umbrella_runs_the_source_audits_without_a_device(capsys):
    rc = umbrella.main(["--selfcheck", "--json", "--device", "cpu",
                        "--jobs", "2", "--only", "lint", "threads"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and out["ok"] and out["pending"] == []
    assert list(out["suites"]) == ["lint", "threads"]
    for r in out["suites"].values():
        detail = json.loads(r["detail"])
        assert r["rc"] == 0 and detail["ok"] and detail["n_findings"] == 0
