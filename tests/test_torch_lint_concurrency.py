"""The port's whole-program concurrency auditor (`photon_tpu_torch.lint`
``concurrency`` + ``thread_model``) against the reference's.

Every fixture of the reference's `tests/test_lint_concurrency.py` (lock
order, blocking under a lock, guarded-by, the pinned model, the waiver
forms) runs through both auditors with the same fingerprints
(`_lint_parity`). Then the port's own model: its thread inventory holds
every pinned entry (the serving dispatch and retire threads, the fleet,
the async snapshot writer, the ingest pool, the launcher), its pinned
guarded-by bindings fire when a write drops its lock, and ``--threads
--json`` over the port's tree reports the model ``ok`` with zero
findings.
"""
import json
import subprocess
import sys
import textwrap

import pytest

from _lint_parity import fixture_tests, make_comparing_run_lint

import test_lint_concurrency as REF  # noqa: E402  (the reference's)

from photon_tpu_torch.lint import load_context, repo_root  # noqa: E402
from photon_tpu_torch.lint import run_lint  # noqa: E402
from photon_tpu_torch.lint.concurrency import (  # noqa: E402
    EXPECTED_GUARDS, EXPECTED_THREADS)
from photon_tpu_torch.lint.thread_model import (  # noqa: E402
    build_thread_model)

REPO = repo_root()
CASES = fixture_tests(REF)


@pytest.mark.parametrize("case", [c for _, c in CASES],
                         ids=[i for i, _ in CASES])
def test_reference_fixture_gives_the_same_findings(case, tmp_path,
                                                   monkeypatch):
    log: list = []
    monkeypatch.setattr(REF, "run_lint", make_comparing_run_lint(log))
    case(tmp_path)
    assert log, "the fixture never ran the auditor on its tree"


@pytest.fixture(scope="module")
def model():
    return build_thread_model(load_context(REPO))


def test_the_ports_thread_inventory_is_pinned(model):
    have = {(e.rel, e.label) for e in model.entries}
    for rel, label in EXPECTED_THREADS:
        assert (rel, label) in have, (rel, label)
    roles = {e.label for e in model.entries if e.shares_memory}
    assert {"serving-dispatch", "serving-retire", "photon-ckpt-writer",
            "ReplicaFleet.score"} <= roles
    assert not model.cycles


def test_the_ports_guarded_by_pins_hold(model):
    for rel, attr, lock in EXPECTED_GUARDS:
        full = f"{rel}::{attr}"
        sites = [(fn, w) for fn in model.functions.values()
                 if fn.name != "__init__" for w in fn.writes
                 if w.attr == full]
        assert sites, full
        for fn, w in sites:
            assert lock in model.effective_locks(fn, w.held), (full, fn.qual)


@pytest.mark.parametrize("locked, fires", [(True, False), (False, True)])
def test_a_dropped_store_lock_breaks_the_pin(tmp_path, locked, fires):
    body = ("with self._swap_lock:\n            self._device_blocks = None"
            if locked else "self._device_blocks = None")
    src = textwrap.dedent(f'''\
        import threading

        class CoefficientStore:
            def __init__(self):
                self._swap_lock = threading.Lock()
                self._device_blocks = None

            def reload(self):
                {body}
        ''')
    p = tmp_path / "photon_tpu_torch" / "serving" / "store.py"
    p.parent.mkdir(parents=True)
    p.write_text(src)
    report = run_lint(root=str(tmp_path), only=["concurrency_model"],
                      baseline=set())
    keys = {f.key for f in report["findings"]}
    assert ("guard:CoefficientStore._device_blocks:CoefficientStore.reload"
            in keys) == fires


def test_threads_cli_reports_the_port_clean():
    proc = subprocess.run([sys.executable, "-m", "photon_tpu_torch.lint",
                           "--threads", "--json"], capture_output=True,
                          text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    doc = json.loads(proc.stdout)
    assert doc["ok"] and doc["n_findings"] == 0
    labels = {t["label"] for t in doc["model"]["threads"]}
    assert {label for _, label in EXPECTED_THREADS} <= labels
    assert doc["model"]["lock_cycles"] == []
    dot = subprocess.run([sys.executable, "-m", "photon_tpu_torch.lint",
                          "--threads", "--dot"], capture_output=True,
                         text=True, timeout=120, cwd=REPO)
    assert dot.returncode == 0 and dot.stdout.startswith("digraph")
