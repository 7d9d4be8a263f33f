"""The port's source auditor (`photon_tpu_torch.lint`) against the
reference's (`photon_tpu.lint`).

Every fixture of the reference's `tests/test_lint.py` runs through both
auditors: the same sources laid out once as ``photon_tpu/...`` and once
as ``photon_tpu_torch/...`` give the same ``(rule, path, key, line)``
fingerprints, findings and waived findings alike (`_lint_parity`; the
reference's ``sentinel_coverage``, which needs a benchmark, is the one
rule left out). Then the port's own facts: the three waiver forms, a
reasonless and a stale waiver, the with-block close path and the peak
gauge the port's rules also read, and — the acceptance — the port's own
tree lints clean with an empty ``baseline.json``, through the API and
the ``--json`` CLI.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

from _lint_parity import (fixture_tests, make_comparing_run_lint,
                          port_rel, port_text)

import test_lint as REF  # noqa: E402  (the reference's fixtures)

from photon_tpu_torch.lint import (Finding, load_baseline,  # noqa: E402
                                   repo_root, run_lint)
from photon_tpu_torch.lint.rules import RULES  # noqa: E402

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


def test_every_reference_rule_is_ported_but_the_sentinel():
    from photon_tpu.lint.rules import RULES as REF_RULES

    assert set(REF_RULES) - set(RULES) == {"sentinel_coverage"}
    assert set(RULES) <= set(REF_RULES)
    for name, (_fn, tag, _doc) in RULES.items():
        assert REF_RULES[name][1] == tag, name


# ------------------------------------------------------- the port's tree

def _write(tmp_path, files: dict) -> str:
    base = dict(REF._REGISTRIES)
    base.pop("bench.py")
    base.pop("photon_tpu/profiling/sentinel.py")
    base.update(files)
    for rel, text in base.items():
        p = tmp_path / port_rel(rel)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(port_text(textwrap.dedent(text)))
    return str(tmp_path)


_RAW = '''
def save(path):
    with open(path, "w") as fh:{waiver}
        fh.write("x")
'''


@pytest.mark.parametrize("waiver, waived", [
    ("  # photon: allow(durable_write, a scratch file)", True),
    ("  # photon: rawwrite(a scratch file)", True),
    ("  # lint: rawwrite(a scratch file)", True),
    ("  # photon: allow(guarded_by, the wrong rule)", False),
])
def test_the_three_waiver_forms(tmp_path, waiver, waived):
    root = _write(tmp_path, {"photon_tpu/bad.py": _RAW.format(
        waiver=waiver)})
    report = run_lint(root=root, only=["durable_write"], baseline=set())
    hits = [f for f in report["findings"] if f.rule == "durable_write"]
    assert bool(hits) != waived
    assert bool(report["suppressed"]) == waived


def test_reasonless_and_stale_waivers_are_findings(tmp_path):
    root = _write(tmp_path, {
        "photon_tpu/bad.py": _RAW.format(
            waiver="  # photon: allow(durable_write)"),
        "photon_tpu/fine.py": "X = 1  # photon: allow(durable_write, "
                              "nothing here writes)\n"})
    report = run_lint(root=root, baseline=set())
    keys = {(f.path, f.key) for f in report["findings"]
            if f.rule == "suppression"}
    assert ("photon_tpu_torch/bad.py", "durable_write@3") in keys
    assert ("photon_tpu_torch/fine.py", "stale:durable_write@1") in keys
    # the reasonless waiver waives nothing
    assert [f for f in report["findings"] if f.rule == "durable_write"]


def test_a_with_block_closes_an_executor(tmp_path):
    pool = '''
from concurrent.futures import ThreadPoolExecutor
import concurrent.futures as cf


def run(calls):
    with {ctor}(2) as pool:
        return [f.result() for f in [pool.submit(c) for c in calls]]
'''
    for ctor in ("ThreadPoolExecutor", "cf.ThreadPoolExecutor"):
        root = _write(tmp_path / ctor, {"photon_tpu/p.py": pool.format(
            ctor=ctor)})
        report = run_lint(root=root, only=["spawn_hygiene"], baseline=set())
        assert not report["findings"], ctor
    root = _write(tmp_path / "open", {"photon_tpu/p.py": '''
from concurrent.futures import ThreadPoolExecutor

POOL = ThreadPoolExecutor(2)
'''})
    report = run_lint(root=root, only=["spawn_hygiene"], baseline=set())
    assert [f.key for f in report["findings"]] == ["shutdown"]


def test_peak_gauges_are_registry_names(tmp_path):
    root = _write(tmp_path, {"photon_tpu/peak.py": '''
from photon_tpu import telemetry


def note(n):
    telemetry.gauge_max("ingest.staging_peak_depth", n)
'''})
    report = run_lint(root=root, only=["telemetry_sync"], baseline=set())
    keys = {f.key for f in report["findings"]}
    assert "emit:ingest.staging_peak_depth" in keys


@pytest.mark.parametrize("doc, opened, keys", [
    ("solve.lane.iter", True, set()),
    ("solve.lane.iter", False, {"spanname:solve.lane.iter"}),
    ("solve spans", True, {"spandoc:solve.lane.iter"}),
])
def test_registered_span_names_are_opened_and_documented(tmp_path, doc,
                                                         opened, keys):
    tele = f'''
"""chunk_uploads latency_ {doc}"""
TELEMETRY_REGISTRY = {{
    "counters": ("stream.chunk_uploads",),
    "gauges": ("serving.latency_*",),
    "span_families": ("solve",),
    "spans": ("solve.lane.iter",),
}}
'''
    name = "solve.lane.iter" if opened else "solve.other"
    root = _write(tmp_path, {
        "photon_tpu/telemetry/__init__.py": tele,
        "photon_tpu/loop.py": f'''
from photon_tpu import telemetry


def step():
    with telemetry.span("{name}"):
        pass
'''})
    report = run_lint(root=root, only=["telemetry_sync"], baseline=set())
    assert {f.key for f in report["findings"]} == keys


def test_shipped_baseline_is_empty():
    assert load_baseline() == set()
    path = os.path.join(REPO, "photon_tpu_torch", "lint", "baseline.json")
    with open(path) as fh:
        assert json.load(fh)["findings"] == []


@pytest.fixture(scope="module")
def repo_report():
    return run_lint(root=REPO, baseline=set())


def test_the_ports_tree_lints_clean(repo_report):
    assert [f.text for f in repo_report["findings"]] == []
    assert repo_report["ok"] and repo_report["n_rules"] == len(RULES) + 1
    assert repo_report["n_files"] > 100  # the package and chip_smoke.py


def test_every_waiver_in_the_port_carries_a_reason(repo_report):
    from photon_tpu_torch.lint import load_context

    ctx = load_context(REPO)
    n = 0
    for src in ctx.files.values():
        assert not src.bad_suppressions, src.rel
        for _line, (_kind, _name, reason) in src.suppressions.items():
            assert len(reason) > 10
            n += 1
    assert n == len(repo_report["suppressed"]) > 0


def test_json_cli_reports_the_port_clean():
    proc = subprocess.run([sys.executable, "-m", "photon_tpu_torch.lint",
                           "--json"], capture_output=True, text=True,
                          timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    doc = json.loads(proc.stdout)
    assert doc["ok"] and doc["n_findings"] == 0 and doc["findings"] == []
    assert doc["n_suppressed"] > 0


def test_cli_exit_codes(tmp_path):
    root = _write(tmp_path, {"photon_tpu/bad.py": _RAW.format(waiver="")})
    args = [sys.executable, "-m", "photon_tpu_torch.lint", "--root", root]
    bad = subprocess.run(args + ["--json"], capture_output=True, text=True,
                         timeout=120, cwd=REPO)
    assert bad.returncode == 1 and not json.loads(bad.stdout)["ok"]
    unknown = subprocess.run(args + ["--only", "sentinel_coverage"],
                             capture_output=True, text=True, timeout=120,
                             cwd=REPO)
    assert unknown.returncode == 2


def test_finding_fingerprint():
    f = Finding("durable_write", "a.py", 3, "msg", key="k")
    assert f.fingerprint == ("durable_write", "a.py", "k")
    assert "a.py:3" in f.text
