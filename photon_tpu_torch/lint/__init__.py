"""Source-level convention auditor (port of `photon_tpu/lint/`): the
host-side law the run-time contracts can't see.

`photon_tpu_torch.analysis` pins the DEVICE-side performance model
(collective budgets, dtype policy, host syncs, rebuilt plans) by running
each hot path under a recorder. This package is its host-side twin: an
AST walk over the port's own source that enforces the operational
conventions the package carries — the commit-bytes-only rule for
durable writes, the fault-site registry, the telemetry name registry,
lock discipline in the threaded spines, the central ``PHOTON_TPU_*``
knob table, contract coverage, spawn/thread hygiene, and
InjectedFault-swallowing ``except`` clauses. One unaudited
``open(..., "w")`` breaks the crash-consistency story without any
program changing; this is the auditor that catches it in the change that
introduces it.

The audited tree is ``photon_tpu_torch/**.py`` plus ``chip_smoke.py``
(the port's on-card driver); orphan checks accept ``tests/test_torch_*.py``
as a reader of record.

Deliberately **import-free of the audited code** (and of torch): rules
read the registries they pin (`checkpoint.faults.FAULT_SITES`,
`telemetry.TELEMETRY_REGISTRY`, `utils.env.KNOB_DOCS`,
`analysis.registry.HOT_PATH_MODULES`) as AST literals, so ``python -m
photon_tpu_torch.lint`` costs a second or two and runs before anything
heavyweight imports.

Waiver syntax: a finding is waived by a trailing comment on its line (or
the line above) — the reason string is MANDATORY in every form; an empty
or missing reason is itself a finding:

- ``photon: allow(<rule>, <reason>)`` — keyed by RULE NAME, works for
  every rule (the shared form new code should use);
- ``photon: <tag>(<reason>)`` — keyed by the rule's suppression tag
  (e.g. ``photon: unguarded(...)`` for ``guarded_by``);
- ``lint: <tag>(<reason>)`` — the legacy tag form, still honored.

``photon:``-form waivers are STALE-CHECKED: on a full run (no ``--only``
filter), a waiver on a line where its rule no longer fires is itself a
finding — waivers can't outlive the hazard they excuse.

The shipped ``baseline.json`` is EMPTY and stays empty: every true
violation gets fixed, not baselined — the file exists so a future
emergency has a documented escape hatch with a visible diff.
"""
from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
import subprocess
from typing import Iterable, Optional

__all__ = [
    "Finding", "SourceFile", "Context", "load_context", "run_lint",
    "repo_root", "load_baseline",
]

# trailing waiver comments; the marker strings are split so these
# regexes (and this comment) never read as live waivers themselves
_SUPPRESS_RE = re.compile(
    r"#\s*lint" r":\s*([a-z_]+)\s*\(\s*(.*?)\s*\)\s*$")
_SUPPRESS_BARE_RE = re.compile(r"#\s*lint" r":\s*([a-z_]+)\s*$")
_PHOTON_ALLOW_RE = re.compile(
    r"#\s*photon" r":\s*allow\s*\(\s*([a-z_]+)\s*"
    r"(?:,\s*(.*?))?\s*\)\s*$")
_PHOTON_TAG_RE = re.compile(
    r"#\s*photon" r":\s*([a-z_]+)\s*\(\s*(.*?)\s*\)\s*$")
_PHOTON_BARE_RE = re.compile(r"#\s*photon" r":\s*([a-z_]+)\s*$")


@dataclasses.dataclass
class Finding:
    """One convention violation. ``key`` is the stable fingerprint piece
    (rule + path + key identifies the finding across line drift — the
    baseline format)."""

    rule: str
    path: str
    line: int
    message: str
    key: str

    @property
    def fingerprint(self) -> tuple:
        return (self.rule, self.path, self.key)

    @property
    def text(self) -> str:
        return f"{self.rule}: {self.path}:{self.line}: {self.message}"

    def to_json(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "key": self.key, "message": self.message}


class SourceFile:
    """One parsed source file: AST + raw lines + suppression comments."""

    def __init__(self, rel: str, text: str):
        self.rel = rel
        self.text = text
        self.lines = text.splitlines()
        self.tree = ast.parse(text)
        # lineno -> (kind, name, reason) where kind is "rule" (photon
        # allow form, name = rule name), "tag" (photon tag form), or
        # "legacy" (lint: tag form, exempt from stale checking); bad
        # entries (empty/missing reason) kept apart
        self.suppressions: dict = {}
        self.bad_suppressions: list = []
        for i, ln in enumerate(self.lines, start=1):
            if "#" not in ln:
                continue
            m = _PHOTON_ALLOW_RE.search(ln)
            if m:
                name, reason = m.group(1), m.group(2)
                if reason:
                    self.suppressions[i] = ("rule", name, reason)
                else:
                    self.bad_suppressions.append((i, name))
                continue
            m = _PHOTON_TAG_RE.search(ln)
            if m:
                tag, reason = m.group(1), m.group(2)
                if reason:
                    self.suppressions[i] = ("tag", tag, reason)
                else:
                    self.bad_suppressions.append((i, tag))
                continue
            m = _PHOTON_BARE_RE.search(ln)
            if m:
                self.bad_suppressions.append((i, m.group(1)))
                continue
            m = _SUPPRESS_RE.search(ln)
            if m:
                tag, reason = m.group(1), m.group(2)
                if reason:
                    self.suppressions[i] = ("legacy", tag, reason)
                else:
                    self.bad_suppressions.append((i, tag))
                continue
            m = _SUPPRESS_BARE_RE.search(ln)
            if m:
                self.bad_suppressions.append((i, m.group(1)))

    def match_waiver(self, line: int, tag: str,
                     rule: Optional[str] = None) -> Optional[int]:
        """The lineno of the waiver covering a finding at ``line`` (same
        line or the line directly above), or None. Tag forms match the
        rule's suppression tag; the ``allow`` form matches the rule
        name."""
        for at in (line, line - 1):
            got = self.suppressions.get(at)
            if not got:
                continue
            kind, name, _reason = got
            if kind == "rule":
                if rule is not None and name == rule:
                    return at
            elif name == tag:
                return at
        return None

    def suppressed(self, line: int, tag: str,
                   rule: Optional[str] = None) -> bool:
        """A finding at ``line`` is waived by a reasoned comment on the
        same line or the line directly above."""
        return self.match_waiver(line, tag, rule) is not None

    # ------------------------------------------------------ AST helpers
    def literal(self, name: str):
        """The literal value of a module-level ``NAME = <literal>``
        assignment (the registry-reading path — no imports)."""
        for node in self.tree.body:
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Name) and t.id == name:
                        return ast.literal_eval(node.value)
            elif isinstance(node, ast.AnnAssign):
                if (isinstance(node.target, ast.Name)
                        and node.target.id == name
                        and node.value is not None):
                    return ast.literal_eval(node.value)
        raise KeyError(f"{self.rel}: no module-level literal {name!r}")

    def literal_line(self, name: str, key: str) -> int:
        """Best-effort line number of ``key`` inside the ``NAME``
        literal's source span (for findings pointing at registry
        entries)."""
        pat = re.compile(r"[\"']" + re.escape(key) + r"[\"']")
        for i, ln in enumerate(self.lines, start=1):
            if pat.search(ln):
                return i
        return 1

    def qualname_at(self, line: int) -> str:
        """Dotted def/class path enclosing ``line`` ('' at module
        level)."""
        best: list = []

        def descend(node, stack):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                      ast.ClassDef)):
                    end = getattr(child, "end_lineno", child.lineno)
                    if child.lineno <= line <= end:
                        trail = stack + [child.name]
                        if len(trail) > len(best):
                            best[:] = trail
                        descend(child, trail)
                else:
                    descend(child, stack)

        descend(self.tree, [])
        return ".".join(best)


def repo_root() -> str:
    """The repository root: the parent of the ``photon_tpu_torch``
    package."""
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def _iter_rel_paths(root: str) -> Iterable[str]:
    pkg = os.path.join(root, "photon_tpu_torch")
    for base, dirs, names in os.walk(pkg):
        dirs[:] = sorted(d for d in dirs if d != "__pycache__")
        for n in sorted(names):
            if n.endswith(".py"):
                yield os.path.relpath(os.path.join(base, n), root)
    if os.path.exists(os.path.join(root, "chip_smoke.py")):
        yield "chip_smoke.py"


class Context:
    """Everything the rules see: parsed files + the repo root. Rules may
    add findings for unparseable files via ``parse_errors``."""

    def __init__(self, root: str, files: dict, parse_errors: list):
        self.root = root
        self.files = files  # rel -> SourceFile
        self.parse_errors = parse_errors  # [(rel, message)]

    def get(self, rel: str) -> Optional[SourceFile]:
        return self.files.get(rel.replace(os.sep, "/"))

    def package_files(self) -> list:
        return [f for rel, f in sorted(self.files.items())
                if rel.startswith("photon_tpu_torch/")]

    def tests_text(self) -> str:
        """Concatenated raw text of tests/test_torch_*.py — for orphan
        checks that accept a test as the knob's reader of record."""
        out = []
        tdir = os.path.join(self.root, "tests")
        if os.path.isdir(tdir):
            for n in sorted(os.listdir(tdir)):
                if n.startswith("test_torch_") and n.endswith(".py"):
                    try:
                        with open(os.path.join(tdir, n)) as fh:
                            out.append(fh.read())
                    except OSError:
                        pass
        return "\n".join(out)


def load_context(root: Optional[str] = None) -> Context:
    root = root or repo_root()
    files: dict = {}
    errors: list = []
    for rel in _iter_rel_paths(root):
        rel = rel.replace(os.sep, "/")
        try:
            with open(os.path.join(root, rel)) as fh:
                text = fh.read()
            files[rel] = SourceFile(rel, text)
        except (OSError, SyntaxError) as e:
            errors.append((rel, f"{type(e).__name__}: {e}"))
    return Context(root, files, errors)


def load_baseline(path: Optional[str] = None) -> set:
    """Fingerprints of baselined findings. Ships EMPTY (see module
    docstring)."""
    path = path or os.path.join(os.path.dirname(__file__), "baseline.json")
    try:
        with open(path) as fh:
            doc = json.load(fh)
    except (OSError, json.JSONDecodeError):
        return set()
    return {(f["rule"], f["path"], f["key"])
            for f in doc.get("findings", [])}


def _changed_files(root: str) -> Optional[set]:
    """Working-tree files changed vs HEAD (--changed); None if git is
    unavailable (the caller degrades to a full run)."""
    try:
        out = subprocess.run(
            ["git", "-C", root, "status", "--porcelain"],
            capture_output=True, text=True, timeout=30)
        if out.returncode != 0:
            return None
    except (OSError, subprocess.TimeoutExpired):
        return None
    changed = set()
    for ln in out.stdout.splitlines():
        part = ln[3:].strip()
        if " -> " in part:
            part = part.split(" -> ", 1)[1]
        changed.add(part.strip('"'))
    return changed


def run_lint(root: Optional[str] = None, only: Optional[list] = None,
             changed: bool = False,
             baseline: Optional[set] = None) -> dict:
    """Run every rule; returns {"findings", "suppressed", "n_files",
    "n_rules", "ok"}. ``only`` filters by rule name; ``changed``
    restricts FINDINGS to files with working-tree changes (rules still
    see the whole repo — cross-file invariants need it)."""
    from photon_tpu_torch.lint import rules as _rules

    ctx = load_context(root)
    baseline = load_baseline() if baseline is None else baseline
    findings: list = []
    suppressed: list = []
    for rel, msg in ctx.parse_errors:
        findings.append(Finding("parse", rel, 1, msg, key="parse"))
    n_rules = 0
    used: dict = {}  # rel -> set of waiver linenos that covered a finding
    for name, (fn, tag, _doc) in _rules.RULES.items():
        if only and name not in only:
            continue
        n_rules += 1
        for f in fn(ctx):
            src = ctx.get(f.path)
            at = (src.match_waiver(f.line, tag, rule=name)
                  if src is not None else None)
            if at is not None:
                suppressed.append(f)
                used.setdefault(f.path, set()).add(at)
            else:
                findings.append(f)
    if not only or "suppression" in only:
        n_rules += 1
        for rel, src in sorted(ctx.files.items()):
            for line, tag in src.bad_suppressions:
                findings.append(Finding(
                    "suppression", rel, line,
                    f"suppression comment for tag {tag!r} has no reason "
                    "string — a reason is mandatory",
                    key=f"{tag}@{line}"))
        if not only:
            # stale-waiver check: photon-form waivers on lines where the
            # named rule no longer fires are themselves findings. Only
            # meaningful on a full run — with a rule filter most waivers
            # would look stale.
            for rel, src in sorted(ctx.files.items()):
                for at, (kind, name, _r) in sorted(
                        src.suppressions.items()):
                    if kind == "legacy" or at in used.get(rel, set()):
                        continue
                    findings.append(Finding(
                        "suppression", rel, at,
                        f"stale waiver: `photon:` comment for {name!r} "
                        "on a line where that rule no longer fires — "
                        "remove the waiver",
                        key=f"stale:{name}@{at}"))
    findings = [f for f in findings if f.fingerprint not in baseline]
    if changed:
        ch = _changed_files(ctx.root)
        if ch is not None:
            findings = [f for f in findings if f.path in ch]
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return {"findings": findings, "suppressed": suppressed,
            "n_files": len(ctx.files), "n_rules": n_rules,
            "ok": not findings}
