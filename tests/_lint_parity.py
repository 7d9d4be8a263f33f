"""Shared machinery of the port's source-auditor parity tests
(`test_torch_lint.py`, `test_torch_lint_concurrency.py`): run each of the
reference's lint fixtures through both auditors and compare findings.

Each reference fixture test lays a small tree out under ``tmp_path`` as
``photon_tpu/...`` and calls ``run_lint`` on it. The test patches that
``run_lint`` in the reference test module with `make_comparing_run_lint`,
so each call also lays the same sources out as ``photon_tpu_torch/...``
(module names and paths renamed, ``bench.py`` as ``chip_smoke.py``,
``tests/test_*.py`` as ``tests/test_torch_*.py``, ``benches/*.py``
inside the package) and runs the port's auditor there; the two reports
must carry the same ``(rule, path, key, line)`` fingerprints, renamed,
for findings and for waived findings alike. The reference's report goes back to the fixture
test, whose own assertions then run unchanged.

What differs by design, and is left out of the comparison:

- ``sentinel_coverage``: the port has no benchmark legs to classify
  (ROADMAP queue A item 14), so the rule is not ported;
- ``concurrency_model``'s guarded-by pins on attributes only one package
  pins: the reference's ``CoefficientStore._device`` is the port's
  ``CoefficientStore._device_blocks``, and the port pins more of its own
  shared state (`photon_tpu_torch.lint.concurrency.EXPECTED_GUARDS`).
"""
from __future__ import annotations

import inspect
import os
import re
import shutil

import jax.core
import jax.extend.core

# The JAX package imports `jax.core.ClosedJaxpr`/`Jaxpr`, which jax 0.9
# moved to `jax.extend.core`: alias the missing public names back before
# anything of photon_tpu is imported.
for _name in dir(jax.extend.core):
    if not _name.startswith("_") and not hasattr(jax.core, _name):
        setattr(jax.core, _name, getattr(jax.extend.core, _name))

from photon_tpu.lint import concurrency as ref_concurrency  # noqa: E402
from photon_tpu.lint import repo_root as ref_repo_root  # noqa: E402
from photon_tpu.lint import run_lint as ref_run_lint  # noqa: E402
from photon_tpu_torch.lint import concurrency as port_concurrency  # noqa
from photon_tpu_torch.lint import run_lint as port_run_lint  # noqa: E402

LEFT_OUT = frozenset({"sentinel_coverage"})
_WORD = re.compile(r"\bphoton_tpu\b")
REF_REPO = os.path.abspath(ref_repo_root())


def _pinned(rows) -> set:
    return {attr for _rel, attr, _lock in rows}


# guarded-by pins both auditors hold (the rest is named above)
SHARED_GUARDS = (_pinned(ref_concurrency.EXPECTED_GUARDS)
                 & _pinned(port_concurrency.EXPECTED_GUARDS))


def port_rel(rel: str) -> str:
    """A reference fixture path as the port's tree lays it out."""
    rel = rel.replace(os.sep, "/")
    if rel.startswith("photon_tpu/"):
        return "photon_tpu_torch/" + rel[len("photon_tpu/"):]
    if rel == "bench.py":
        return "chip_smoke.py"
    if rel.startswith("tests/test_"):
        return "tests/test_torch_" + rel[len("tests/test_"):]
    if rel.startswith("benches/"):
        return "photon_tpu_torch/_benches/" + rel[len("benches/"):]
    return rel


def port_text(text: str) -> str:
    return _WORD.sub("photon_tpu_torch", text)


def lay_out_port_tree(root: str, dst: str) -> None:
    """Copy the fixture tree ``root`` to ``dst`` as the port's tree."""
    shutil.rmtree(dst, ignore_errors=True)
    for base, _dirs, names in os.walk(root):
        for n in names:
            src = os.path.join(base, n)
            out = os.path.join(dst, port_rel(os.path.relpath(src, root)))
            os.makedirs(os.path.dirname(out), exist_ok=True)
            with open(src) as fh:
                text = fh.read()
            with open(out, "w") as fh:
                fh.write(port_text(text))


def _compared(f) -> bool:
    if f.rule in LEFT_OUT or any(f"stale:{r}" in f.key for r in LEFT_OUT):
        return False
    if f.rule == "concurrency_model" and f.key.startswith("guard:"):
        return f.key.split(":")[1] in SHARED_GUARDS
    return True


def fingerprints(findings, reference: bool) -> list:
    out = []
    for f in findings:
        if not _compared(f):
            continue
        if reference:
            out.append((f.rule, port_rel(f.path), port_text(f.key), f.line))
        else:
            out.append((f.rule, f.path, f.key, f.line))
    return sorted(out)


def _port_baseline(baseline):
    if baseline is None:
        return None
    return {(rule, port_rel(path), port_text(key))
            for rule, path, key in baseline}


def make_comparing_run_lint(log: list):
    """A ``run_lint`` that runs the reference's auditor, and on a fixture
    tree the port's too, asserting the same fingerprints; it returns the
    reference's report and appends each comparison to ``log``."""

    def run_lint(root=None, only=None, changed=False, baseline=None):
        ref = ref_run_lint(root=root, only=only, changed=changed,
                           baseline=baseline)
        if root is None or os.path.abspath(str(root)) == REF_REPO:
            return ref
        port_only = None
        if only is not None:
            port_only = [r for r in only if r not in LEFT_OUT]
            if not port_only:
                return ref
        dst = os.path.abspath(str(root)).rstrip("/") + "_port"
        lay_out_port_tree(str(root), dst)
        got = port_run_lint(root=dst, only=port_only, changed=changed,
                            baseline=_port_baseline(baseline))
        for key in ("findings", "suppressed"):
            want = fingerprints(ref[key], reference=True)
            have = fingerprints(got[key], reference=False)
            assert have == want, (key, have, want)
        log.append((root, only, len(ref["findings"])))
        return ref

    return run_lint


def fixture_tests(module) -> list:
    """(id, callable taking tmp_path) of every test of ``module`` that
    lays a fixture tree out under ``tmp_path`` and lints it, but those of
    the rule left out."""
    out = []

    def wanted(fn) -> bool:
        params = [p for p in inspect.signature(fn).parameters
                  if p != "self"]
        src = inspect.getsource(fn)
        # (the left-out rule's own fixtures lint with it alone)
        return params == ["tmp_path"] and ("run_rules(" in src
                                           or "run_lint(" in src) \
            and not any(r in src for r in LEFT_OUT)

    for name, obj in sorted(vars(module).items()):
        if name.startswith("test_") and inspect.isfunction(obj) \
                and wanted(obj):
            out.append((f"{module.__name__}::{name}", obj))
        elif name.startswith("Test") and inspect.isclass(obj):
            for mname, meth in sorted(vars(obj).items()):
                if mname.startswith("test_") and inspect.isfunction(meth) \
                        and wanted(meth):
                    out.append((f"{module.__name__}::{name}::{mname}",
                                (lambda c, m: lambda tp: m(c(), tp))(
                                    obj, meth)))
    return out
