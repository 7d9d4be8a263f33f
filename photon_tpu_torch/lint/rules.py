"""The twelve source-level convention rules (port of
`photon_tpu/lint/rules.py`; see the package docstring).

Every rule is ``fn(ctx) -> list[Finding]`` registered in :data:`RULES`
as ``name -> (fn, suppression_tag, one_line_doc)``. Rules read the
registries they pin as AST literals — no imports of the audited package
(or of torch) — so the auditor's verdict cannot depend on import-time
side effects of the code it audits. The four whole-program concurrency
rules (lock order, blocking under a lock, guarded-by, the pinned model)
live in :mod:`photon_tpu_torch.lint.concurrency` and register here.

Left out: the reference's ``sentinel_coverage``. It reads ``bench.py``'s
``legs`` dict and the sentinel's gate patterns; the port has no
benchmark of its own until ROADMAP queue A item 14, so there are no legs
to classify. It comes back with that benchmark.
"""
from __future__ import annotations

import ast
import fnmatch
import re
from typing import Iterable, Optional

from photon_tpu_torch.lint import Context, Finding
from photon_tpu_torch.lint import concurrency as _conc

# --------------------------------------------------------------- helpers


def _dotted(func) -> str:
    """Best-effort dotted name of a call target ('' when dynamic)."""
    parts: list = []
    node = func
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    elif parts:
        parts.append("?")
    return ".".join(reversed(parts))


def _str_const(node) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _fstr_prefix(node) -> Optional[str]:
    """Leading literal text of an f-string (JoinedStr), '' if it starts
    with a placeholder; None for non-f-strings."""
    if not isinstance(node, ast.JoinedStr):
        return None
    if node.values and isinstance(node.values[0], ast.Constant) \
            and isinstance(node.values[0].value, str):
        return node.values[0].value
    return ""


def _calls(tree) -> Iterable[ast.Call]:
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            yield node


def _kw(call: ast.Call, name: str):
    for k in call.keywords:
        if k.arg == name:
            return k.value
    return None


_NAME_RE = re.compile(r"^[a-z0-9_]+(\.[a-z0-9_]+)+$")


# ----------------------------------------------------- 1. durable writes

def durable_write(ctx: Context) -> list:
    """Raw ``open(..., 'w'/'wb'/'x')`` writes are torn-file hazards:
    durable artifacts flow through ``checkpoint.store.commit_bytes`` /
    ``replace_committed`` (tmp + fsync + rename), or carry a reasoned
    ``rawwrite`` suppression. ``checkpoint/store.py`` IS the primitive
    and is exempt; append modes ('a') are truncation-tolerant event logs
    and stay legal."""
    out = []
    for rel, src in sorted(ctx.files.items()):
        if rel == "photon_tpu_torch/checkpoint/store.py":
            continue
        for call in _calls(src.tree):
            if not (isinstance(call.func, ast.Name)
                    and call.func.id == "open"):
                continue
            mode = None
            if len(call.args) >= 2:
                mode = _str_const(call.args[1])
            kw = _kw(call, "mode")
            if kw is not None:
                mode = _str_const(kw)
            if mode is None or not any(c in mode for c in "wx"):
                continue
            where = src.qualname_at(call.lineno) or "<module>"
            out.append(Finding(
                "durable_write", rel, call.lineno,
                f"raw open(..., {mode!r}) in {where} — durable artifacts "
                "must flow through checkpoint.store.commit_bytes / "
                "replace_committed (tmp+fsync+rename); a deliberate "
                "non-durable write needs `lint: rawwrite(<why>)`",
                key=f"{where}:{mode}"))
    return out


# ------------------------------------------------ 2. fault-site registry

def fault_site_registry(ctx: Context) -> list:
    """Every ``kill_point(site)`` / ``retry_io(site=...)`` /
    ``FaultPlan.kill_at(site, ...)`` literal must be a key of
    ``checkpoint.faults.FAULT_SITES`` — and every registered site must
    be hit by at least one program point (no orphan documentation)."""
    faults_rel = "photon_tpu_torch/checkpoint/faults.py"
    reg_src = ctx.get(faults_rel)
    if reg_src is None:
        return [Finding("fault_site_registry", faults_rel, 1,
                        "checkpoint/faults.py not found", key="missing")]
    sites = dict(reg_src.literal("FAULT_SITES"))
    used: dict = {}
    out = []
    for rel, src in sorted(ctx.files.items()):
        for call in _calls(src.tree):
            name = _dotted(call.func)
            lit = None
            if name.endswith(("kill_point", "kill_at")) and call.args:
                lit = _str_const(call.args[0])
            kw = _kw(call, "site")
            if kw is not None:
                lit = _str_const(kw)
            if lit is None:
                continue
            used.setdefault(lit, []).append((rel, call.lineno))
            if lit not in sites:
                out.append(Finding(
                    "fault_site_registry", rel, call.lineno,
                    f"fault site {lit!r} is not declared in "
                    "checkpoint.faults.FAULT_SITES — add it with a doc "
                    "line in the same diff",
                    key=f"undeclared:{lit}"))
    for site in sorted(sites):
        if site not in used:
            out.append(Finding(
                "fault_site_registry", faults_rel,
                reg_src.literal_line("FAULT_SITES", site),
                f"FAULT_SITES entry {site!r} is hit by no kill_point/"
                "retry_io in the package — orphaned documentation",
                key=f"orphan:{site}"))
    return out


# --------------------------------------------------- 3. telemetry sync

def _tele_scope(ctx: Context) -> list:
    out = []
    for rel, src in sorted(ctx.files.items()):
        if not rel.startswith("photon_tpu_torch/"):
            continue
        if rel.endswith("/__main__.py"):
            continue  # selftest CLIs emit scratch names by design
        if rel == "photon_tpu_torch/telemetry/__init__.py":
            continue
        out.append((rel, src))
    return out


def telemetry_sync(ctx: Context) -> list:
    """Three-way sync between emitted counter/gauge/span literals, the
    ``telemetry.TELEMETRY_REGISTRY`` literal, and the telemetry
    docstring: emitted ⊆ registry, registry ⊆ emitted (no orphans), and
    every registry name appears in the docstring."""
    tele_rel = "photon_tpu_torch/telemetry/__init__.py"
    tele = ctx.get(tele_rel)
    if tele is None:
        return [Finding("telemetry_sync", tele_rel, 1,
                        "telemetry/__init__.py not found", key="missing")]
    registry = tele.literal("TELEMETRY_REGISTRY")
    doc = ast.get_docstring(tele.tree) or ""
    counters = tuple(registry.get("counters", ()))
    gauges = tuple(registry.get("gauges", ()))
    families = tuple(registry.get("span_families", ()))
    out = []
    hit: dict = {e: False for e in counters + gauges}
    fam_hit: dict = {f: False for f in families}

    def match(name: str, entries: tuple, prefix: bool) -> bool:
        ok = False
        for e in entries:
            if prefix:  # f-string literal prefix vs entry
                if e.endswith("*") and name.startswith(e[:-1]):
                    hit[e] = ok = True
            elif e == name or (("*" in e) and fnmatch.fnmatch(name, e)):
                hit[e] = ok = True
        return ok

    for rel, src in _tele_scope(ctx):
        in_tele_pkg = rel.startswith("photon_tpu_torch/telemetry/")
        for call in _calls(src.tree):
            name = _dotted(call.func)
            # PhaseTimers(span_prefix="train.") opens dynamic spans:
            # count the prefix's family as used
            pref_kw = _kw(call, "span_prefix")
            if pref_kw is not None:
                lit = _str_const(pref_kw)
                if lit and lit.split(".", 1)[0] in fam_hit:
                    fam_hit[lit.split(".", 1)[0]] = True
            kind = None
            if name in ("telemetry.count", "telemetry.gauge",
                        "telemetry.gauge_max"):
                kind = name.split(".")[1]
            elif in_tele_pkg and name in ("count", "gauge", "gauge_max",
                                          "self.count", "self.gauge",
                                          "self.gauge_max"):
                kind = name.split(".")[-1]
            if kind == "gauge_max":  # the port's peak gauge
                kind = "gauge"
            elif name == "telemetry.span" or (
                    in_tele_pkg and name in ("span", "self.span")):
                kind = "span"
            if kind is None or not call.args:
                continue
            lit = _str_const(call.args[0])
            pref = _fstr_prefix(call.args[0])
            if kind == "span":
                fam = None
                if lit is not None:
                    fam = lit.split(".", 1)[0]
                elif pref:
                    fam = pref.split(".", 1)[0]
                if fam is None:
                    continue
                if fam in fam_hit:
                    fam_hit[fam] = True
                else:
                    out.append(Finding(
                        "telemetry_sync", rel, call.lineno,
                        f"span family {fam!r} is not in "
                        "TELEMETRY_REGISTRY['span_families']",
                        key=f"span:{fam}"))
                continue
            entries = counters if kind == "count" else gauges
            if lit is not None:
                if not _NAME_RE.match(lit):
                    continue  # not a dotted telemetry name (e.g. .count())
                if not match(lit, entries, prefix=False):
                    reg_key = "counters" if kind == "count" else "gauges"
                    out.append(Finding(
                        "telemetry_sync", rel, call.lineno,
                        f"{kind} name {lit!r} is not in "
                        f"TELEMETRY_REGISTRY[{reg_key!r}] — register "
                        "it and list it in the telemetry docstring",
                        key=f"emit:{lit}"))
            elif pref is not None:
                if not match(pref, entries, prefix=True):
                    out.append(Finding(
                        "telemetry_sync", rel, call.lineno,
                        f"dynamic {kind} name with prefix {pref!r} "
                        "matches no glob entry in TELEMETRY_REGISTRY — "
                        "add a '<prefix>*' entry",
                        key=f"emitdyn:{pref}"))
    for e in counters + gauges:
        if not hit[e]:
            out.append(Finding(
                "telemetry_sync", tele_rel,
                tele.literal_line("TELEMETRY_REGISTRY", e),
                f"TELEMETRY_REGISTRY entry {e!r} is emitted nowhere in "
                "the package — orphaned registration",
                key=f"orphan:{e}"))
        short = e.split(".", 1)[1] if "." in e else e
        short = short.rstrip("*").rstrip("._")
        if short and short not in doc:
            out.append(Finding(
                "telemetry_sync", tele_rel,
                tele.literal_line("TELEMETRY_REGISTRY", e),
                f"registry name {e!r} ({short!r}) does not appear in the "
                "telemetry/__init__ docstring — the documented registry "
                "of counter names",
                key=f"doc:{e}"))
    for fam in families:
        if not fam_hit[fam]:
            out.append(Finding(
                "telemetry_sync", tele_rel,
                tele.literal_line("TELEMETRY_REGISTRY", fam),
                f"span family {fam!r} is registered but no span opens "
                "under it", key=f"spanorphan:{fam}"))
    return out


# -------------------------------------------------- 4. lock discipline

_LOCK_CTORS = ("threading.Lock", "threading.RLock", "threading.Condition",
               "Lock", "RLock", "Condition")


def lock_discipline(ctx: Context) -> list:
    """In any class owning a ``threading.Lock``, an instance field
    written BOTH inside and outside ``with self.<lock>`` blocks (outside
    ``__init__``) is a data-race hazard; a deliberate unlocked write
    carries ``lint: unlocked(<why>)``."""
    out = []
    for rel, src in sorted(ctx.files.items()):
        for cls in [n for n in ast.walk(src.tree)
                    if isinstance(n, ast.ClassDef)]:
            # lock attrs: self.X = threading.Lock()/RLock()/Condition()
            locks = set()
            for node in ast.walk(cls):
                if isinstance(node, ast.Assign) \
                        and isinstance(node.value, ast.Call) \
                        and _dotted(node.value.func) in _LOCK_CTORS:
                    for t in node.targets:
                        if isinstance(t, ast.Attribute) \
                                and isinstance(t.value, ast.Name) \
                                and t.value.id == "self":
                            locks.add(t.attr)
            if not locks:
                continue
            writes: dict = {}  # field -> [(line, in_lock, method)]

            def visit(node, in_lock, method):
                if isinstance(node, ast.With):
                    holds = any(
                        isinstance(it.context_expr, ast.Attribute)
                        and isinstance(it.context_expr.value, ast.Name)
                        and it.context_expr.value.id == "self"
                        and it.context_expr.attr in locks
                        for it in node.items)
                    for child in node.body:
                        visit(child, in_lock or holds, method)
                    return
                if isinstance(node, (ast.Assign, ast.AugAssign,
                                     ast.AnnAssign)):
                    targets = (node.targets
                               if isinstance(node, ast.Assign)
                               else [node.target])
                    for t in targets:
                        elts = t.elts if isinstance(
                            t, (ast.Tuple, ast.List)) else [t]
                        for e in elts:
                            if isinstance(e, ast.Attribute) \
                                    and isinstance(e.value, ast.Name) \
                                    and e.value.id == "self" \
                                    and e.attr not in locks:
                                writes.setdefault(e.attr, []).append(
                                    (e.lineno, in_lock, method))
                for child in ast.iter_child_nodes(node):
                    visit(child, in_lock, method)

            for meth in cls.body:
                if isinstance(meth, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)) \
                        and meth.name != "__init__":
                    for stmt in meth.body:
                        visit(stmt, False, meth.name)
            for field, recs in sorted(writes.items()):
                if not (any(r[1] for r in recs)
                        and any(not r[1] for r in recs)):
                    continue
                for line, in_lock, method in recs:
                    if in_lock:
                        continue
                    out.append(Finding(
                        "lock_discipline", rel, line,
                        f"{cls.name}.{field} is written under "
                        f"{'/'.join(sorted(locks))} elsewhere but "
                        f"unlocked here in {method}() — take the lock or "
                        "suppress with `lint: unlocked(<why>)`",
                        key=f"{cls.name}.{field}@{method}"))
    return out


# ---------------------------------------------- 5. env-knob registry

_ENV_READS = ("os.environ.get", "environ.get", "os.getenv",
              "os.environ.setdefault", "environ.setdefault",
              "os.environ.pop", "environ.pop")
_KNOB_RE = re.compile(r"^PHOTON_TPU_[A-Z0-9_]+$")


def env_knob_registry(ctx: Context) -> list:
    """Every ``PHOTON_TPU_*`` knob is declared once in
    ``utils.env.KNOB_DOCS`` and read through ``utils.env.get_raw`` —
    ad-hoc ``os.environ`` reads and undeclared knob literals are
    findings, as is a declared knob nobody reads."""
    env_rel = "photon_tpu_torch/utils/env.py"
    env_src = ctx.get(env_rel)
    if env_src is None:
        return [Finding("env_knob_registry", env_rel, 1,
                        "utils/env.py not found", key="missing")]
    knobs = dict(env_src.literal("KNOB_DOCS"))
    out = []
    referenced: set = set()
    for rel, src in sorted(ctx.files.items()):
        if rel == env_rel:
            continue
        # undeclared knob literals anywhere (incl. dict keys, constants)
        for node in ast.walk(src.tree):
            lit = _str_const(node)
            if lit is None or not _KNOB_RE.match(lit):
                continue
            referenced.add(lit)
            if lit not in knobs:
                out.append(Finding(
                    "env_knob_registry", rel, node.lineno,
                    f"undeclared env knob {lit!r} — declare it in "
                    "photon_tpu_torch.utils.env.KNOB_DOCS with a doc line",
                    key=f"undeclared:{lit}"))
        # ad-hoc environ reads of PHOTON_TPU_* keys
        for call in _calls(src.tree):
            if _dotted(call.func) not in _ENV_READS or not call.args:
                continue
            lit = _str_const(call.args[0])
            if lit is not None and lit.startswith("PHOTON_TPU_"):
                out.append(Finding(
                    "env_knob_registry", rel, call.lineno,
                    f"ad-hoc os.environ read of {lit!r} — go through "
                    "photon_tpu_torch.utils.env.get_raw (single parse site "
                    "per knob)", key=f"read:{lit}"))
        # environ Subscript reads: os.environ["PHOTON_TPU_X"]
        for node in ast.walk(src.tree):
            if isinstance(node, ast.Subscript) \
                    and _dotted(node.value).endswith("environ"):
                lit = _str_const(node.slice)
                if lit is not None and lit.startswith("PHOTON_TPU_"):
                    out.append(Finding(
                        "env_knob_registry", rel, node.lineno,
                        f"ad-hoc os.environ[{lit!r}] access — go through "
                        "photon_tpu_torch.utils.env.get_raw",
                        key=f"sub:{lit}"))
    tests_text = ctx.tests_text()
    for name in sorted(knobs):
        if name not in referenced and name not in tests_text:
            out.append(Finding(
                "env_knob_registry", env_rel,
                env_src.literal_line("KNOB_DOCS", name),
                f"declared knob {name!r} is read nowhere (package or "
                "tests) — orphaned declaration",
                key=f"orphan:{name}"))
    return out


# ------------------------------------------------ 6. contract coverage

def contract_coverage(ctx: Context) -> list:
    """Every ``analysis.registry.HOT_PATH_MODULES`` entry registers ≥1
    ContractSpec, and every module calling ``register_contract`` is
    imported by the registry — a spec outside the registry never
    runs."""
    reg_rel = "photon_tpu_torch/analysis/registry.py"
    reg_src = ctx.get(reg_rel)
    if reg_src is None:
        return [Finding("contract_coverage", reg_rel, 1,
                        "analysis/registry.py not found", key="missing")]
    listed = tuple(reg_src.literal("HOT_PATH_MODULES"))
    out = []
    registering: set = set()
    for rel, src in sorted(ctx.files.items()):
        if not rel.startswith("photon_tpu_torch/") or rel == reg_rel:
            continue
        if rel == "photon_tpu_torch/analysis/contracts.py":
            continue  # defines register_contract; doesn't register specs
        for call in _calls(src.tree):
            if _dotted(call.func).endswith("register_contract"):
                mod = rel[:-3].replace("/", ".")
                if mod.endswith(".__init__"):
                    mod = mod[: -len(".__init__")]
                registering.add(mod)
                if mod not in listed:
                    out.append(Finding(
                        "contract_coverage", rel, call.lineno,
                        f"{mod} registers a ContractSpec but is not in "
                        "analysis.registry.HOT_PATH_MODULES — the spec "
                        "never runs in CI", key=f"unlisted:{mod}"))
                break
    for mod in listed:
        if mod in registering:
            continue
        out.append(Finding(
            "contract_coverage", reg_rel,
            reg_src.literal_line("HOT_PATH_MODULES", mod),
            f"HOT_PATH_MODULES entry {mod} registers no ContractSpec — "
            "either add a spec or drop the entry",
            key=f"specless:{mod}"))
    return out


# --------------------------------------------------- 7. spawn hygiene

def _has_main_guard(src) -> bool:
    for node in src.tree.body:
        if isinstance(node, ast.If) and isinstance(node.test, ast.Compare):
            t = node.test
            names = [n for n in ast.walk(t) if isinstance(n, ast.Name)]
            consts = [_str_const(n) for n in ast.walk(t)]
            if any(n.id == "__name__" for n in names) \
                    and "__main__" in consts:
                return True
    return False


def _toplevel_executes(src) -> bool:
    """Module-level statements beyond imports/defs/assigns/docstring —
    the 'script' smell that makes an unguarded spawn pool re-import and
    re-execute the world on every worker start."""
    for i, node in enumerate(src.tree.body):
        if isinstance(node, (ast.Import, ast.ImportFrom, ast.FunctionDef,
                             ast.AsyncFunctionDef, ast.ClassDef,
                             ast.Assign, ast.AnnAssign, ast.AugAssign)):
            continue
        if isinstance(node, ast.Expr) and _str_const(node.value) is not None:
            continue  # docstring / bare string
        if isinstance(node, ast.If):
            continue  # guards and TYPE_CHECKING blocks
        return True
    return False


def spawn_hygiene(ctx: Context) -> list:
    """The known 1-core-box footguns: spawn-context pools hosted by an
    unguarded script re-execute the world per worker; daemon threads
    with no join/close path leak past shutdown; non-daemon threads never
    joined hang exit. Suppress deliberate cases with
    ``lint: spawn(<why>)``."""
    out = []
    for rel, src in sorted(ctx.files.items()):
        has_spawn_pool = False
        has_executor = False
        executor_line = 0
        for call in _calls(src.tree):
            name = _dotted(call.func)
            if name.endswith(("ProcessPoolExecutor", "ThreadPoolExecutor")):
                has_executor = True
                executor_line = executor_line or call.lineno
                if name.endswith("ProcessPoolExecutor"):
                    has_spawn_pool = True
            if name.endswith("get_context") and call.args \
                    and _str_const(call.args[0]) == "spawn":
                has_spawn_pool = True
        if has_spawn_pool and _toplevel_executes(src) \
                and not _has_main_guard(src):
            out.append(Finding(
                "spawn_hygiene", rel, 1,
                "spawn-context pool in a script without a guarded "
                "`__main__` — every worker start re-executes the module "
                "top level (the 1-core-box footgun)", key="guard"))
        if has_executor and ".shutdown(" not in src.text \
                and not _executor_in_with(src):
            out.append(Finding(
                "spawn_hygiene", rel, executor_line,
                "executor pool created but no .shutdown()/with-block "
                "close path in this file", key="shutdown"))
        for call in _calls(src.tree):
            if not _dotted(call.func).endswith("threading.Thread") \
                    and _dotted(call.func) != "Thread":
                continue
            daemon = _kw(call, "daemon")
            fn_name = src.qualname_at(call.lineno)
            if daemon is not None and isinstance(daemon, ast.Constant) \
                    and daemon.value is True:
                if ".join(" not in src.text:
                    out.append(Finding(
                        "spawn_hygiene", rel, call.lineno,
                        "daemon thread with no join() anywhere in this "
                        "file — add an explicit close/join path",
                        key=f"daemonjoin:{fn_name}"))
            else:
                # non-daemon (or dynamic): must be joined near creation
                enclosing = _enclosing_function_source(src, call.lineno)
                if ".join(" not in enclosing:
                    out.append(Finding(
                        "spawn_hygiene", rel, call.lineno,
                        "non-daemon thread is not joined in its creating "
                        "function — pass daemon= explicitly and provide "
                        "a join/close path", key=f"join:{fn_name}"))
    return out


def _executor_in_with(src) -> bool:
    """A ``with <...>Executor(...)`` block closes its pool on exit (the
    reference matches only the text ``with ProcessPoolExecutor``, so a
    thread pool, or a pool named through its module, read as unclosed)."""
    for node in ast.walk(src.tree):
        if isinstance(node, ast.With):
            for it in node.items:
                e = it.context_expr
                if isinstance(e, ast.Call) and _dotted(e.func).endswith(
                        ("ProcessPoolExecutor", "ThreadPoolExecutor")):
                    return True
    return False


def _enclosing_function_source(src, line: int) -> str:
    for node in ast.walk(src.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            end = getattr(node, "end_lineno", node.lineno)
            if node.lineno <= line <= end:
                return "\n".join(src.lines[node.lineno - 1:end])
    return src.text


# ----------------------------------------------- 8. exception hygiene

_BROAD = {"Exception", "BaseException", "RuntimeError"}


def _handler_names(h: ast.ExceptHandler) -> list:
    if h.type is None:
        return ["<bare>"]
    nodes = h.type.elts if isinstance(h.type, ast.Tuple) else [h.type]
    return [_dotted(n).split(".")[-1] or "<dynamic>" for n in nodes]


_FAULT_CALLS = ("kill_point", "retry_io", "commit_bytes",
                "replace_committed")


def exception_hygiene(ctx: Context) -> list:
    """In fault-covered modules, a broad ``except`` around a fault site
    swallows ``InjectedFault`` — the injected preemption silently
    becomes 'nothing happened' and the kill-matrix tests prove nothing.
    A handler that re-raises, delivers via ``set_exception``, or sits
    behind an ``except InjectedFault: raise`` is exempt; deliberate
    degrade paths carry ``lint: swallow(<why>)``."""
    out = []
    for rel, src in sorted(ctx.files.items()):
        uses_faults = any(
            _dotted(c.func).split(".")[-1] in ("kill_point", "retry_io")
            for c in _calls(src.tree))
        if not uses_faults:
            continue
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.Try):
                continue
            body_calls = {
                _dotted(c.func).split(".")[-1]
                for stmt in node.body for c in _calls(stmt)}
            if not body_calls & set(_FAULT_CALLS):
                continue
            injected_handled = False
            for h in node.handlers:
                names = _handler_names(h)
                if "InjectedFault" in names:
                    injected_handled = True
                    continue
                if not set(names) & _BROAD and "<bare>" not in names:
                    continue
                if injected_handled:
                    continue
                delivers = any(isinstance(n, ast.Raise)
                               for n in ast.walk(h)) or any(
                    _dotted(c.func).endswith("set_exception")
                    for c in _calls(h))
                if delivers:
                    continue
                out.append(Finding(
                    "exception_hygiene", rel, h.lineno,
                    f"broad `except {'/'.join(names)}` around a fault "
                    "site swallows InjectedFault — re-raise it, catch "
                    "narrower, or suppress with `lint: swallow(<why>)`",
                    key=f"{src.qualname_at(h.lineno)}:{h.lineno // 10}"))
    return out


# ----------------------------------------------------------- registry

RULES = {
    "durable_write": (durable_write, "rawwrite",
                      "raw write-mode open() outside the commit "
                      "primitives"),
    "fault_site_registry": (fault_site_registry, "faultsite",
                            "kill/retry site literals <-> FAULT_SITES"),
    "telemetry_sync": (telemetry_sync, "telemetry",
                       "counter/gauge/span names <-> TELEMETRY_REGISTRY "
                       "<-> docstring"),
    "lock_discipline": (lock_discipline, "unlocked",
                        "fields written locked AND unlocked in threaded "
                        "classes"),
    "env_knob_registry": (env_knob_registry, "envknob",
                          "PHOTON_TPU_* knobs declared once, read via "
                          "utils.env"),
    "contract_coverage": (contract_coverage, "contract",
                          "HOT_PATH_MODULES <-> register_contract calls"),
    "spawn_hygiene": (spawn_hygiene, "spawn",
                      "guarded __main__ for spawn pools; join paths for "
                      "threads"),
    "exception_hygiene": (exception_hygiene, "swallow",
                          "broad except clauses that swallow "
                          "InjectedFault"),
    "lock_order": (_conc.lock_order, "lockorder",
                   "cycles in the cross-call lock acquisition graph "
                   "(potential deadlock)"),
    "blocking_under_lock": (_conc.blocking_under_lock, "blocking",
                            "unbounded blocking ops (IO, device sync, "
                            "untimed queue/wait) while holding a lock"),
    "guarded_by": (_conc.guarded_by, "unguarded",
                   "state written from >=2 thread roles without a "
                   "common lock"),
    "concurrency_model": (_conc.concurrency_model, "expectation",
                          "pinned thread inventory + guarded-by "
                          "bindings hold at HEAD"),
}
