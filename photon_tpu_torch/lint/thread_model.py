"""Whole-program thread model (port of `photon_tpu/lint/
thread_model.py`): the repo-wide concurrency facts the per-function rules
can't see.

Built once per lint Context from the same parsed ASTs (no imports of the
audited code), this module answers three questions the
concurrency rules and the ``--threads`` CLI both consume:

1. **Thread inventory** — every thread/process entry point in the repo
   (``threading.Thread(target=...)``, executor ``submit`` targets and
   initializers, spawn-context ``Process(target=...)``) with the call
   graph reachable from each entry. Processes are inventoried but NOT
   treated as sharing memory (spawn context: separate address space).
2. **Lock-order graph** — which locks are acquired while which others
   are held, across call boundaries (``f`` holds L and calls ``g`` that
   takes M ⇒ edge L→M). A cycle is a potential deadlock.
3. **Guarded-by bindings** — for every instance attribute / module
   global written outside ``__init__``, the set of locks definitely held
   at each write (lexically held ∪ locks held at EVERY call path into
   the writing function), plus the set of thread roles that can execute
   the write. State written from ≥2 roles with no common lock is the
   race the guarded_by rule reports.

Resolution is deliberately best-effort and under-approximating: calls
resolve through ``self`` methods, same-module functions, imports,
constructor-typed / annotation-typed attributes and locals. An
unresolvable call contributes no edge — the model never invents
reachability, so its findings point at real paths.
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Optional

__all__ = ["ThreadModel", "build_thread_model"]

_LOCK_CTORS = {"threading.Lock", "threading.RLock", "Lock", "RLock"}
_QUEUE_CTORS = {"queue.Queue", "queue.SimpleQueue", "queue.LifoQueue",
                "queue.PriorityQueue", "Queue", "SimpleQueue"}
_EXEC_SUFFIX = ("ThreadPoolExecutor", "ProcessPoolExecutor")
_SUBPROCESS = {"subprocess.run", "subprocess.call", "subprocess.check_call",
               "subprocess.check_output", "run", "check_call",
               "check_output"}
_MUTATORS = {"append", "extend", "insert", "add", "update", "setdefault",
             "pop", "popitem", "popleft", "appendleft", "remove", "clear",
             "discard"}


def _dotted(func) -> str:
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


def _kw(call: ast.Call, name: str):
    for k in call.keywords:
        if k.arg == name:
            return k.value
    return None


def _str_const(node) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _module_of(rel: str) -> str:
    mod = rel[:-3].replace("/", ".")
    if mod.endswith(".__init__"):
        mod = mod[: -len(".__init__")]
    return mod


def _ann_class_name(ann) -> Optional[str]:
    """Dotted class name out of an annotation, unwrapping Optional[...]"""
    if ann is None:
        return None
    if isinstance(ann, ast.Subscript) \
            and _dotted(ann.value) in ("Optional", "typing.Optional"):
        ann = ann.slice
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        return ann.value  # string annotation: "ProgramLadder"
    name = _dotted(ann)
    return name or None


@dataclasses.dataclass
class ClassInfo:
    key: str            # rel::Name
    rel: str
    module: str
    name: str
    lineno: int
    locks: set = dataclasses.field(default_factory=set)
    queues: set = dataclasses.field(default_factory=set)
    threads: set = dataclasses.field(default_factory=set)
    executors: set = dataclasses.field(default_factory=set)
    attr_types: dict = dataclasses.field(default_factory=dict)  # attr->dotted
    methods: dict = dataclasses.field(default_factory=dict)     # name->fnkey


@dataclasses.dataclass
class CallSite:
    line: int
    held: tuple          # lock ids held lexically at the call
    targets: tuple       # resolved function keys
    dotted: str


@dataclasses.dataclass
class Write:
    attr: str            # "rel::Class.attr" or "rel::<global>.name"
    line: int
    held: tuple


@dataclasses.dataclass
class FunctionInfo:
    key: str             # rel::qual
    rel: str
    module: str
    cls: Optional[str]   # enclosing class name
    qual: str
    name: str
    lineno: int
    node: object = None
    acquired: list = dataclasses.field(default_factory=list)   # (lock, line)
    lexical_edges: list = dataclasses.field(default_factory=list)
    calls: list = dataclasses.field(default_factory=list)      # CallSite
    writes: list = dataclasses.field(default_factory=list)     # Write
    blockers: list = dataclasses.field(default_factory=list)   # (desc,line,held)
    local_defs: dict = dataclasses.field(default_factory=dict)  # name->fnkey

    @property
    def public(self) -> bool:
        n = self.name
        return not n.startswith("_") or (n.startswith("__")
                                         and n.endswith("__"))


@dataclasses.dataclass
class Entry:
    kind: str            # "thread" | "executor" | "process"
    label: str           # thread name literal / prefix / target short name
    rel: str
    line: int
    targets: tuple       # function keys
    created_in: str      # function key of the spawn site
    shares_memory: bool


class ThreadModel:
    """See module docstring. Build with :func:`build_thread_model`."""

    def __init__(self):
        self.functions: dict = {}     # key -> FunctionInfo
        self.classes: dict = {}       # key -> ClassInfo
        self.entries: list = []       # Entry
        self.module_locks: dict = {}  # module -> set of global lock names
        self.lock_edges: dict = {}    # (a, b) -> (rel, line, via)
        self.lock_decls: dict = {}    # lock id -> (rel, line)
        self.cycles: list = []        # [(lock, ...), ...] canonical tuples
        self.reach: dict = {}         # entry index -> frozenset of fn keys
        self.client_reach: frozenset = frozenset()
        self.roles: dict = {}         # fn key -> tuple of role labels
        self.inherited: dict = {}     # fn key -> frozenset of locks
        self.shared: dict = {}        # attr -> {"roles", "locks", "writes"}

    # ------------------------------------------------------------ queries
    def function_roles(self, key: str) -> tuple:
        return self.roles.get(key, ())

    def effective_locks(self, fn: FunctionInfo, held: tuple) -> frozenset:
        return frozenset(held) | self.inherited.get(fn.key, frozenset())

    def thread_names(self) -> set:
        return {e.label for e in self.entries}

    # ---------------------------------------------------------- rendering
    def to_doc(self) -> dict:
        threads = []
        for i, e in enumerate(self.entries):
            threads.append({
                "kind": e.kind, "label": e.label, "created_at":
                f"{e.rel}:{e.line}",
                "targets": [t.split("::", 1)[1] for t in e.targets],
                "reachable_fns": len(self.reach.get(i, ())),
                "shares_memory": e.shares_memory,
            })
        edges = [{"from": a, "to": b, "at": f"{w[0]}:{w[1]}", "via": w[2]}
                 for (a, b), w in sorted(self.lock_edges.items())]
        shared = {}
        for attr, info in sorted(self.shared.items()):
            shared[attr] = {
                "roles": sorted(info["roles"]),
                "locks": sorted(info["locks"]),
                "n_writes": len(info["writes"]),
            }
        return {"threads": threads,
                "locks": sorted(self.lock_decls),
                "lock_edges": edges,
                "lock_cycles": [list(c) for c in self.cycles],
                "guarded_by": shared}

    def render(self) -> str:
        doc = self.to_doc()
        out = [f"thread inventory ({len(doc['threads'])} entries):"]
        for t in doc["threads"]:
            mem = "" if t["shares_memory"] else "  [separate memory]"
            out.append(f"  {t['kind']:<9s} {t['label']:<24s} "
                       f"{t['created_at']:<44s} -> "
                       f"{', '.join(t['targets']) or '?'} "
                       f"({t['reachable_fns']} fns){mem}")
        out.append(f"locks ({len(doc['locks'])}):")
        for lk in doc["locks"]:
            out.append(f"  {lk}")
        out.append(f"lock-order edges ({len(doc['lock_edges'])}):")
        for e in doc["lock_edges"]:
            out.append(f"  {e['from']} -> {e['to']}  (at {e['at']}, "
                       f"{e['via']})")
        if doc["lock_cycles"]:
            out.append("LOCK CYCLES (potential deadlock):")
            for c in doc["lock_cycles"]:
                out.append("  " + " -> ".join(c + [c[0]]))
        out.append(f"guarded-by bindings ({len(doc['guarded_by'])} "
                   "multi-thread attrs):")
        for attr, info in doc["guarded_by"].items():
            locks = "{" + ", ".join(info["locks"]) + "}" if info["locks"] \
                else "UNGUARDED"
            out.append(f"  {attr:<52s} roles={{{', '.join(info['roles'])}}} "
                       f"locks={locks}")
        return "\n".join(out)

    def render_dot(self) -> str:
        out = ["digraph lock_order {", "  rankdir=LR;"]
        for lk in sorted(self.lock_decls):
            out.append(f'  "{lk}";')
        in_cycle = {n for c in self.cycles for n in c}
        for (a, b), w in sorted(self.lock_edges.items()):
            color = ' [color=red]' if a in in_cycle and b in in_cycle else ""
            out.append(f'  "{a}" -> "{b}"{color};  // {w[0]}:{w[1]}')
        out.append("}")
        return "\n".join(out)


# ============================================================== builder

class _Builder:
    def __init__(self, ctx):
        self.ctx = ctx
        self.m = ThreadModel()
        self.imports: dict = {}          # module -> {name: dotted target}
        self.cls_by_dotted: dict = {}    # "mod.Class" -> ClassInfo
        self.fn_by_dotted: dict = {}     # "mod.fn" -> key
        self.global_types: dict = {}     # "mod.name" -> dotted class

    # -------------------------------------------------------- pass 1: index
    def index(self) -> None:
        for rel, src in sorted(self.ctx.files.items()):
            module = _module_of(rel)
            self.imports[module] = self._import_map(src.tree, module)
            self.m.module_locks[module] = set()
            for node in src.tree.body:
                if isinstance(node, ast.Assign) \
                        and isinstance(node.value, ast.Call) \
                        and _dotted(node.value.func) in _LOCK_CTORS:
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            self.m.module_locks[module].add(t.id)
                            self.m.lock_decls[f"{module}.{t.id}"] = (
                                rel, node.lineno)
                if isinstance(node, ast.AnnAssign) \
                        and isinstance(node.target, ast.Name):
                    cname = _ann_class_name(node.annotation)
                    if cname:
                        self.global_types[f"{module}.{node.target.id}"] \
                            = cname
            self._index_scope(rel, module, src.tree, cls=None, prefix="")

    def _index_scope(self, rel, module, node, cls, prefix) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                key = f"{rel}::{child.name}"
                ci = ClassInfo(key=key, rel=rel, module=module,
                               name=child.name, lineno=child.lineno)
                self.m.classes[key] = ci
                self.cls_by_dotted[f"{module}.{child.name}"] = ci
                self._index_scope(rel, module, child, cls=ci,
                                  prefix=f"{prefix}{child.name}.")
                self._scan_class_attrs(ci, child)
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{prefix}{child.name}"
                key = f"{rel}::{qual}"
                fi = FunctionInfo(key=key, rel=rel, module=module,
                                  cls=cls.name if cls else None, qual=qual,
                                  name=child.name, lineno=child.lineno,
                                  node=child)
                self.m.functions[key] = fi
                if cls is not None and "." not in qual.replace(
                        cls.name + ".", "", 1):
                    cls.methods[child.name] = key
                if cls is None and prefix == "":
                    self.fn_by_dotted[f"{module}.{child.name}"] = key
                self._index_scope(rel, module, child, cls=cls,
                                  prefix=f"{qual}.")
            else:
                self._index_scope(rel, module, child, cls, prefix)

    def _import_map(self, tree, module) -> dict:
        out: dict = {}
        pkg_parts = module.split(".")
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    out[a.asname or a.name.split(".")[0]] = \
                        a.name if a.asname else a.name.split(".")[0]
                    if a.asname:
                        out[a.asname] = a.name
            elif isinstance(node, ast.ImportFrom):
                if node.level:
                    base = ".".join(pkg_parts[:len(pkg_parts) - node.level
                                              + 1])
                    src_mod = f"{base}.{node.module}" if node.module \
                        else base
                else:
                    src_mod = node.module or ""
                for a in node.names:
                    if a.name == "*":
                        continue
                    out[a.asname or a.name] = f"{src_mod}.{a.name}"
        return out

    def _scan_class_attrs(self, ci: ClassInfo, cls_node) -> None:
        for meth in cls_node.body:
            if not isinstance(meth, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                continue
            ann_params = {a.arg: _ann_class_name(a.annotation)
                          for a in meth.args.args if a.annotation}
            for node in ast.walk(meth):
                tgt = val = None
                if isinstance(node, ast.Assign) and len(node.targets) == 1:
                    tgt, val = node.targets[0], node.value
                elif isinstance(node, ast.AnnAssign):
                    tgt, val = node.target, node.value
                if not (isinstance(tgt, ast.Attribute)
                        and isinstance(tgt.value, ast.Name)
                        and tgt.value.id == "self"):
                    continue
                attr = tgt.attr
                if isinstance(node, ast.AnnAssign):
                    cname = _ann_class_name(node.annotation)
                    if cname:
                        ci.attr_types[attr] = cname
                if isinstance(val, ast.Call):
                    d = _dotted(val.func)
                    if d in _LOCK_CTORS:
                        ci.locks.add(attr)
                        self.m.lock_decls[
                            f"{ci.module}.{ci.name}.{attr}"] = (
                            ci.rel, node.lineno)
                    elif d in _QUEUE_CTORS:
                        ci.queues.add(attr)
                    elif d.endswith("Thread") and _kw(val, "target"):
                        ci.threads.add(attr)
                    elif d.endswith(_EXEC_SUFFIX):
                        ci.executors.add(attr)
                    else:
                        ci.attr_types.setdefault(attr, d)
                elif isinstance(val, ast.Name) and val.id in ann_params \
                        and ann_params[val.id]:
                    ci.attr_types.setdefault(attr, ann_params[val.id])

    # ------------------------------------------------- symbol resolution
    def _resolve_class(self, module: str, dotted: str) -> \
            Optional[ClassInfo]:
        if not dotted:
            return None
        parts = dotted.split(".")
        imp = self.imports.get(module, {})
        if parts[0] in imp:
            full = ".".join([imp[parts[0]]] + parts[1:])
        else:
            full = f"{module}.{dotted}"
        ci = self.cls_by_dotted.get(full)
        if ci is None and "." not in dotted:
            ci = self.cls_by_dotted.get(f"{module}.{dotted}")
        return ci

    def _resolve_call(self, fn: FunctionInfo, call: ast.Call,
                      local_types: dict) -> tuple:
        """Resolved function keys for one call (possibly empty)."""
        func = call.func
        module = fn.module
        # self.meth(...) / self.attr.meth(...)
        if isinstance(func, ast.Attribute):
            base = func.value
            if isinstance(base, ast.Name) and base.id == "self" and fn.cls:
                ci = self.m.classes.get(f"{fn.rel}::{fn.cls}")
                if ci and func.attr in ci.methods:
                    return (ci.methods[func.attr],)
                return ()
            if isinstance(base, ast.Attribute) \
                    and isinstance(base.value, ast.Name) \
                    and base.value.id == "self" and fn.cls:
                ci = self.m.classes.get(f"{fn.rel}::{fn.cls}")
                tname = ci.attr_types.get(base.attr) if ci else None
                tci = self._resolve_class(module, tname) if tname else None
                if tci and func.attr in tci.methods:
                    return (tci.methods[func.attr],)
                return ()
            if isinstance(base, ast.Name):
                tname = local_types.get(base.id)
                tci = self._resolve_class(module, tname) if tname else None
                if tci and func.attr in tci.methods:
                    return (tci.methods[func.attr],)
        dotted = _dotted(func)
        if not dotted or "?" in dotted:
            return ()
        parts = dotted.split(".")
        imp = self.imports.get(module, {})
        if parts[0] == "self":
            return ()
        if parts[0] in local_types and len(parts) == 2:
            tci = self._resolve_class(module, local_types[parts[0]])
            if tci and parts[1] in tci.methods:
                return (tci.methods[parts[1]],)
            return ()
        if len(parts) == 1:
            if parts[0] in fn.local_defs:
                return (fn.local_defs[parts[0]],)
            hit = self.fn_by_dotted.get(f"{module}.{parts[0]}")
            if hit:
                return (hit,)
        if parts[0] in imp:
            full = ".".join([imp[parts[0]]] + parts[1:])
        else:
            full = f"{module}.{dotted}"
        hit = self.fn_by_dotted.get(full)
        if hit:
            return (hit,)
        ci = self.cls_by_dotted.get(full)
        if ci:  # constructor: __init__ is reachable
            init = ci.methods.get("__init__")
            return (init,) if init else ()
        # mod.Class.method
        head, _, meth = full.rpartition(".")
        ci = self.cls_by_dotted.get(head)
        if ci and meth in ci.methods:
            return (ci.methods[meth],)
        return ()

    def _resolve_lock(self, expr, fn: FunctionInfo) -> Optional[str]:
        if isinstance(expr, ast.Attribute) \
                and isinstance(expr.value, ast.Name) \
                and expr.value.id == "self" and fn.cls:
            ci = self.m.classes.get(f"{fn.rel}::{fn.cls}")
            if ci and expr.attr in ci.locks:
                return f"{fn.module}.{fn.cls}.{expr.attr}"
        if isinstance(expr, ast.Name) \
                and expr.id in self.m.module_locks.get(fn.module, ()):
            return f"{fn.module}.{expr.id}"
        return None

    # --------------------------------------------------- pass 2: bodies
    def scan_bodies(self) -> None:
        for fn in self.m.functions.values():
            self._scan_function(fn)

    def _local_types(self, fn: FunctionInfo) -> dict:
        """var -> dotted class name, from ctor calls, annotated params,
        and typed-global aliasing (flow-insensitive, last wins)."""
        out: dict = {}
        node = fn.node
        for a in list(node.args.args) + list(node.args.kwonlyargs):
            cname = _ann_class_name(a.annotation)
            if cname:
                out[a.arg] = cname
        for n in ast.walk(node):
            if isinstance(n, ast.Assign) and len(n.targets) == 1 \
                    and isinstance(n.targets[0], ast.Name):
                var = n.targets[0].id
                if isinstance(n.value, ast.Call):
                    d = _dotted(n.value.func)
                    if d in _QUEUE_CTORS:
                        out[var] = "@queue"
                    elif d.endswith("Thread") and _kw(n.value, "target"):
                        out[var] = "@thread"
                    elif d.endswith(_EXEC_SUFFIX):
                        out[var] = "@executor:" + (
                            "process" if d.endswith("ProcessPoolExecutor")
                            else "thread")
                    elif self._resolve_class(fn.module, d):
                        out[var] = d
                elif isinstance(n.value, ast.Name):
                    g = self.global_types.get(
                        f"{fn.module}.{n.value.id}")
                    if g:
                        out[var] = g
        return out

    def _scan_function(self, fn: FunctionInfo) -> None:
        node = fn.node
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                fn.local_defs[child.name] = f"{fn.rel}::{fn.qual}." \
                    f"{child.name}"
        local_types = self._local_types(fn)
        globals_decl: set = set()
        for n in ast.walk(node):
            if isinstance(n, ast.Global):
                globals_decl.update(n.names)
        self._visit_body(fn, list(node.body), (), local_types,
                         globals_decl)

    def _visit_body(self, fn, stmts, held, local_types, globals_decl):
        for stmt in stmts:
            self._visit(fn, stmt, held, local_types, globals_decl)

    def _visit(self, fn, node, held, local_types, globals_decl):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return  # nested defs scanned as their own FunctionInfo
        if isinstance(node, ast.With):
            new = list(held)
            for item in node.items:
                lock = self._resolve_lock_expr(item.context_expr, fn)
                if lock is not None:
                    fn.acquired.append((lock, node.lineno))
                    for h in new:
                        if h != lock:
                            fn.lexical_edges.append((h, lock, node.lineno))
                    new.append(lock)
            for item in node.items:
                if isinstance(item.context_expr, ast.Call):
                    self._visit(fn, item.context_expr, held, local_types,
                                globals_decl)
            self._visit_body(fn, node.body, tuple(new), local_types,
                             globals_decl)
            return
        if isinstance(node, ast.Call):
            self._record_call(fn, node, held, local_types, globals_decl)
            for child in ast.iter_child_nodes(node):
                self._visit(fn, child, held, local_types, globals_decl)
            return
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                elts = t.elts if isinstance(t, (ast.Tuple, ast.List)) \
                    else [t]
                for e in elts:
                    self._record_write_target(fn, e, held, globals_decl)
        for child in ast.iter_child_nodes(node):
            self._visit(fn, child, held, local_types, globals_decl)

    def _resolve_lock_expr(self, expr, fn) -> Optional[str]:
        if isinstance(expr, ast.Call):  # e.g. contextlib.suppress(...)
            return None
        return self._resolve_lock(expr, fn)

    def _infra_attr(self, fn, attr: str) -> bool:
        ci = self.m.classes.get(f"{fn.rel}::{fn.cls}") if fn.cls else None
        if ci is None:
            return False
        return attr in ci.locks or attr in ci.queues \
            or attr in ci.threads or attr in ci.executors

    def _record_write_target(self, fn, e, held, globals_decl) -> None:
        if isinstance(e, ast.Attribute) and isinstance(e.value, ast.Name) \
                and e.value.id == "self" and fn.cls:
            if not self._infra_attr(fn, e.attr):
                fn.writes.append(Write(f"{fn.rel}::{fn.cls}.{e.attr}",
                                       e.lineno, held))
        elif isinstance(e, ast.Name) and e.id in globals_decl:
            fn.writes.append(Write(f"{fn.rel}::<global>.{e.id}",
                                   e.lineno, held))
        elif isinstance(e, ast.Subscript):
            v = e.value
            if isinstance(v, ast.Attribute) \
                    and isinstance(v.value, ast.Name) \
                    and v.value.id == "self" and fn.cls \
                    and not self._infra_attr(fn, v.attr):
                fn.writes.append(Write(f"{fn.rel}::{fn.cls}.{v.attr}",
                                       e.lineno, held))
            elif isinstance(v, ast.Name) and v.id in globals_decl:
                fn.writes.append(Write(f"{fn.rel}::<global>.{v.id}",
                                       e.lineno, held))

    # ------------------------------------------------ call-site handling
    def _queue_typed(self, fn, base, local_types) -> bool:
        if isinstance(base, ast.Attribute) \
                and isinstance(base.value, ast.Name) \
                and base.value.id == "self" and fn.cls:
            ci = self.m.classes.get(f"{fn.rel}::{fn.cls}")
            return bool(ci) and base.attr in ci.queues
        if isinstance(base, ast.Name):
            return local_types.get(base.id) == "@queue"
        return False

    def _thread_typed(self, fn, base, local_types) -> bool:
        if isinstance(base, ast.Attribute) \
                and isinstance(base.value, ast.Name) \
                and base.value.id == "self" and fn.cls:
            ci = self.m.classes.get(f"{fn.rel}::{fn.cls}")
            return bool(ci) and base.attr in ci.threads
        if isinstance(base, ast.Name):
            return local_types.get(base.id) == "@thread"
        return False

    def _executor_kind(self, fn, base, local_types) -> Optional[str]:
        if isinstance(base, ast.Attribute) \
                and isinstance(base.value, ast.Name) \
                and base.value.id == "self" and fn.cls:
            ci = self.m.classes.get(f"{fn.rel}::{fn.cls}")
            if ci and base.attr in ci.executors:
                return "thread"
        if isinstance(base, ast.Name):
            t = local_types.get(base.id, "")
            if t.startswith("@executor:"):
                return t.split(":", 1)[1]
        return None

    def _classify_blocking(self, fn, call, dotted,
                           local_types) -> Optional[str]:
        if dotted == "open" or dotted == "io.open":
            return "file IO (open)"
        if dotted.endswith("fsync") or dotted in ("json.dump",):
            return f"file IO ({dotted})"
        if dotted in ("np.save", "np.load", "numpy.save", "numpy.load",
                      "np.savez", "numpy.savez"):
            return f"file IO ({dotted})"
        if dotted in ("time.sleep", "sleep"):
            return "time.sleep"
        if dotted.endswith(("device_get", "cuda.synchronize")):
            return f"{dotted} (device sync)"
        if dotted in _SUBPROCESS and "." in dotted:
            return f"{dotted} (subprocess)"
        if dotted.endswith("retry_io") :
            return "faults.retry_io (sleeps between retries)"
        if not isinstance(call.func, ast.Attribute):
            return None
        base = call.func.value
        meth = call.func.attr
        timeout = _kw(call, "timeout") is not None or (
            len(call.args) >= (2 if meth == "put" else 1)
            and meth in ("put", "get", "wait", "join", "result", "acquire"))
        if meth in ("put", "get") and self._queue_typed(fn, base,
                                                        local_types):
            if not timeout and not (_kw(call, "block") is not None):
                return f"queue.Queue.{meth}() without timeout"
            return None
        if meth == "join" and (self._queue_typed(fn, base, local_types)
                               or (self._thread_typed(fn, base,
                                                      local_types)
                                   and not timeout)):
            return "untimed join()"
        if meth == "wait" and not timeout:
            return "untimed .wait() (Barrier/Event/Future)"
        if meth == "result" and not timeout:
            return "untimed Future.result()"
        return None

    def _record_call(self, fn, call, held, local_types,
                     globals_decl) -> None:
        dotted = _dotted(call.func)
        targets = self._resolve_call(fn, call, local_types)
        fn.calls.append(CallSite(call.lineno, held, targets, dotted))
        desc = self._classify_blocking(fn, call, dotted, local_types)
        if desc is not None:
            fn.blockers.append((desc, call.lineno, held))
        # mutating method on a shared attr counts as a write
        if isinstance(call.func, ast.Attribute) \
                and call.func.attr in _MUTATORS:
            self._record_write_target(fn, call.func.value, held,
                                      globals_decl)
        # `lock.acquire()` contributes ordering edges
        if isinstance(call.func, ast.Attribute) \
                and call.func.attr == "acquire":
            lock = self._resolve_lock(call.func.value, fn)
            if lock is not None:
                fn.acquired.append((lock, call.lineno))
                for h in held:
                    if h != lock:
                        fn.lexical_edges.append((h, lock, call.lineno))
        self._maybe_entry(fn, call, dotted, local_types)

    # ---------------------------------------------------- entry discovery
    def _target_keys(self, fn, expr, local_types) -> tuple:
        if expr is None:
            return ()
        if isinstance(expr, ast.Lambda):
            keys: list = []
            for c in ast.walk(expr.body):
                if isinstance(c, ast.Call):
                    keys.extend(self._resolve_call(fn, c, local_types))
            return tuple(keys)
        fake = ast.Call(func=expr, args=[], keywords=[])
        return self._resolve_call(fn, fake, local_types)

    def _maybe_entry(self, fn, call, dotted, local_types) -> None:
        if dotted.endswith("Thread") and _kw(call, "target") is not None:
            targets = self._target_keys(fn, _kw(call, "target"),
                                        local_types)
            name = _str_const(_kw(call, "name"))
            label = name or (targets[0].split("::", 1)[1].split(".")[-1]
                             if targets else "<thread>")
            self.m.entries.append(Entry("thread", label, fn.rel,
                                        call.lineno, targets, fn.key,
                                        shares_memory=True))
            return
        if (dotted.endswith(".Process") or dotted == "Process") \
                and _kw(call, "target") is not None:
            targets = self._target_keys(fn, _kw(call, "target"),
                                        local_types)
            label = _str_const(_kw(call, "name")) or (
                targets[0].split("::", 1)[1] if targets else "<process>")
            self.m.entries.append(Entry("process", label, fn.rel,
                                        call.lineno, targets, fn.key,
                                        shares_memory=False))
            return
        if dotted.endswith(_EXEC_SUFFIX):
            init = _kw(call, "initializer")
            if init is not None:
                targets = self._target_keys(fn, init, local_types)
                shares = not dotted.endswith("ProcessPoolExecutor")
                self.m.entries.append(Entry(
                    "process" if not shares else "executor",
                    (targets[0].split("::", 1)[1] if targets
                     else "<initializer>"), fn.rel, call.lineno, targets,
                    fn.key, shares_memory=shares))
            return
        if isinstance(call.func, ast.Attribute) \
                and call.func.attr == "submit" and call.args:
            kind = self._executor_kind(fn, call.func.value, local_types)
            if kind is None:
                return
            targets = self._target_keys(fn, call.args[0], local_types)
            label = (targets[0].split("::", 1)[1] if targets
                     else "<submit>")
            self.m.entries.append(Entry(
                "executor" if kind == "thread" else "process", label,
                fn.rel, call.lineno, targets, fn.key,
                shares_memory=kind == "thread"))

    # --------------------------------------------------- pass 3: fixpoints
    def analyze(self) -> None:
        m = self.m
        adj: dict = {k: set() for k in m.functions}
        callers: dict = {k: [] for k in m.functions}
        for fn in m.functions.values():
            for cs in fn.calls:
                for t in cs.targets:
                    if t in adj:
                        adj[fn.key].add(t)
                        callers[t].append((fn.key, cs))

        def bfs(seeds) -> frozenset:
            seen = set(seeds)
            frontier = list(seeds)
            while frontier:
                k = frontier.pop()
                for t in adj.get(k, ()):
                    if t not in seen:
                        seen.add(t)
                        frontier.append(t)
            return frozenset(seen)

        for i, e in enumerate(m.entries):
            m.reach[i] = bfs([t for t in e.targets if t in m.functions])
        client_seeds = [k for k, fn in m.functions.items() if fn.public]
        m.client_reach = bfs(client_seeds)

        entry_targets = {t for e in m.entries for t in e.targets}
        for k, fn in m.functions.items():
            roles: list = []
            if k in m.client_reach and not (
                    k in entry_targets and not fn.public):
                roles.append("caller")
            for i, e in enumerate(m.entries):
                if e.shares_memory and k in m.reach[i] \
                        and e.label not in roles:
                    roles.append(e.label)
            m.roles[k] = tuple(roles)

        # transitive lock acquisitions per function (for cross-call edges)
        acq: dict = {k: {a for a, _ in fn.acquired}
                     for k, fn in m.functions.items()}
        for _ in range(50):
            changed = False
            for k in m.functions:
                for t in adj[k]:
                    extra = acq[t] - acq[k]
                    if extra:
                        acq[k] |= extra
                        changed = True
            if not changed:
                break

        for fn in m.functions.values():
            for a, b, line in fn.lexical_edges:
                m.lock_edges.setdefault(
                    (a, b), (fn.rel, line, f"nested with in {fn.qual}"))
            for cs in fn.calls:
                if not cs.held:
                    continue
                for t in cs.targets:
                    for b in acq.get(t, ()):
                        for a in cs.held:
                            if a != b:
                                m.lock_edges.setdefault(
                                    (a, b),
                                    (fn.rel, cs.line,
                                     f"{fn.qual} -> "
                                     f"{t.split('::', 1)[1]}"))
        self._find_cycles()

        # inherited locks: meet over every resolved call path into fn
        inherited: dict = {k: None for k in m.functions}
        seeds = set(client_seeds) | {t for t in entry_targets
                                     if t in m.functions}
        for k in seeds:
            inherited[k] = frozenset()
        for _ in range(50):
            changed = False
            for k in m.functions:
                if k in seeds:
                    continue
                acc = None
                for ck, cs in callers[k]:
                    base = inherited[ck]
                    if base is None:
                        continue
                    site = frozenset(cs.held) | base
                    acc = site if acc is None else (acc & site)
                if acc is not None and acc != inherited[k]:
                    inherited[k] = acc
                    changed = True
            if not changed:
                break
        m.inherited = {k: (v if v is not None else frozenset())
                       for k, v in inherited.items()}

        # guarded-by: collect write sites per attr (skip __init__)
        per_attr: dict = {}
        for fn in m.functions.values():
            if fn.name == "__init__":
                continue
            eff_base = m.inherited[fn.key]
            for w in fn.writes:
                per_attr.setdefault(w.attr, []).append(
                    (fn, w.line, frozenset(w.held) | eff_base))
        for attr, sites in sorted(per_attr.items()):
            roles: set = set()
            for fn, _line, _locks in sites:
                roles.update(m.roles.get(fn.key, ()))
            if len(roles) < 2:
                continue
            common = None
            for _fn, _line, locks in sites:
                common = locks if common is None else (common & locks)
            m.shared[attr] = {
                "roles": roles, "locks": common or frozenset(),
                "writes": [(fn.key, line, locks)
                           for fn, line, locks in sites]}

    def _find_cycles(self) -> None:
        graph: dict = {}
        for (a, b) in self.m.lock_edges:
            graph.setdefault(a, set()).add(b)
        seen_cycles: set = set()
        color: dict = {}

        def dfs(n, stack):
            color[n] = 1
            stack.append(n)
            for t in graph.get(n, ()):
                if color.get(t, 0) == 1:
                    cyc = tuple(stack[stack.index(t):])
                    lo = min(range(len(cyc)), key=lambda i: cyc[i])
                    canon = cyc[lo:] + cyc[:lo]
                    if canon not in seen_cycles:
                        seen_cycles.add(canon)
                        self.m.cycles.append(canon)
                elif color.get(t, 0) == 0:
                    dfs(t, stack)
            stack.pop()
            color[n] = 2

        for n in sorted(graph):
            if color.get(n, 0) == 0:
                dfs(n, [])

    def build(self) -> ThreadModel:
        self.index()
        self.scan_bodies()
        self.analyze()
        return self.m


def build_thread_model(ctx) -> ThreadModel:
    """Build (and cache on the Context) the repo thread model."""
    cached = getattr(ctx, "_thread_model", None)
    if cached is None:
        cached = _Builder(ctx).build()
        ctx._thread_model = cached
    return cached
