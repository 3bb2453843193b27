"""The static lock-order graph: the lock-graph half of
``deeplearning_tpu/analysis/concurrency.py``.

``lock_order_graph()`` parses every module of the scan (the port's
package by default) with the standard ``ast`` and returns the locks each
one creates, the order in which nested ``with`` blocks and
``acquire()`` / ``release()`` sequences take them in one scope, the
cycles of that order (a potential deadlock) and the sites that start
threads. Every lock is keyed by the ``<path from the checkout root>:<line>``
of its ``threading.Lock()`` / ``RLock()`` creation site, the key that
``analysis/threadsan.py``'s instrumented locks record at runtime, so the
sanitizer seeds its order check from these edges
(``threadsan.seed_static_edges``).

The DLT200-205 rules, ``lint_tree`` and the ratchet come with ROADMAP
Queue 1 item 8d2.
"""

from __future__ import annotations

import ast
import os
from typing import Any, Dict, Iterable, List, Optional, Sequence, Set, Tuple

from .lint import (DEFAULT_SCAN, _Index, _qualname, iter_python_files,
                   repo_root)

__all__ = ["lock_order_graph", "DEFAULT_SCAN"]

# cheap substring gate: a file with no thread or lock vocabulary has no
# lock and starts no thread, so the tree scan parses only the fleet files
_PREFILTER = ("threading", "Thread(", ".spawn(", "Lock(", "_lock")


def _relevant(src: str) -> bool:
    return any(tok in src for tok in _PREFILTER)


# ---------------------------------------------------------- lock model
class _ThreadingAliases:
    """Names that resolve to the threading module / its Lock ctors."""

    def __init__(self, nodes: Iterable[ast.AST]):
        self.modules: Set[str] = set()      # import threading [as t]
        self.lock_ctors: Set[str] = set()   # from threading import Lock
        for node in nodes:
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.name == "threading":
                        self.modules.add(a.asname or a.name)
            elif isinstance(node, ast.ImportFrom):
                if node.module == "threading":
                    for a in node.names:
                        if a.name in ("Lock", "RLock"):
                            self.lock_ctors.add(a.asname or a.name)

    def is_lock_ctor(self, node: ast.AST) -> bool:
        if not isinstance(node, ast.Call):
            return False
        q = _qualname(node.func)
        if q is None:
            return False
        if q in self.lock_ctors:
            return True
        head, _, tail = q.partition(".")
        return head in self.modules and tail in ("Lock", "RLock")


class _Locks:
    """Every lock declared in the file, keyed for the runtime join.

    - ``attrs[class_name][attr]`` = creation line of
      ``self.<attr> = threading.Lock()`` inside that class.
    - ``globals_[name]`` = creation line of a module-level
      ``NAME = threading.Lock()``.
    Lock ids are ``"<path>::<Class>.<attr>"`` / ``"<path>::<name>"``;
    ``line_of`` maps an id back to its creation line.
    """

    def __init__(self, idx: _Index, al: _ThreadingAliases, path: str):
        self.path = path
        self.attrs: Dict[str, Dict[str, int]] = {}
        self.globals_: Dict[str, int] = {}
        self.line_of: Dict[str, int] = {}
        class_of: Dict[ast.AST, str] = {}
        for node in idx.nodes:
            if isinstance(node, ast.ClassDef):
                for sub in ast.walk(node):
                    class_of[sub] = node.name
        for node in idx.nodes:
            if not isinstance(node, ast.Assign):
                continue
            if not al.is_lock_ctor(node.value):
                continue
            line = node.value.lineno
            for t in node.targets:
                if isinstance(t, ast.Attribute) and \
                        isinstance(t.value, ast.Name) and \
                        t.value.id == "self" and node in class_of:
                    cls = class_of[node]
                    self.attrs.setdefault(cls, {})[t.attr] = line
                    self.line_of[f"{path}::{cls}.{t.attr}"] = line
                elif isinstance(t, ast.Name) and node not in class_of:
                    self.globals_[t.id] = line
                    self.line_of[f"{path}::{t.id}"] = line

    def ref(self, expr: ast.AST, class_name: Optional[str]
            ) -> Optional[str]:
        """Lock id for an expression naming a declared lock, else None."""
        if isinstance(expr, ast.Attribute) and \
                isinstance(expr.value, ast.Name) and \
                expr.value.id == "self" and class_name:
            if expr.attr in self.attrs.get(class_name, {}):
                return f"{self.path}::{class_name}.{expr.attr}"
            return None
        if isinstance(expr, ast.Name) and expr.id in self.globals_:
            return f"{self.path}::{expr.id}"
        return None


# ------------------------------------------------------- file analysis
class _Analysis:
    """Shared per-file context for every DLT2xx pass."""

    def __init__(self, tree: ast.Module, path: str):
        self.path = path
        self.idx = _Index(tree)
        self.al = _ThreadingAliases(self.idx.nodes)
        self.locks = _Locks(self.idx, self.al, path)
        self.classes: Dict[str, ast.ClassDef] = {}
        self.methods: Dict[str, Dict[str, ast.AST]] = {}
        self.class_of: Dict[ast.AST, str] = {}
        for node in self.idx.nodes:
            if isinstance(node, ast.ClassDef):
                self.classes[node.name] = node
                meths: Dict[str, ast.AST] = {}
                for st in node.body:
                    if isinstance(st, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)):
                        meths[st.name] = st
                self.methods[node.name] = meths
                for sub in ast.walk(node):
                    self.class_of.setdefault(sub, node.name)
        # lock-order edges (``_lock_edges``): (src, dst, line, func)
        self.edges: List[Tuple[str, str, int, str]] = []

    def enclosing_func(self, node: ast.AST) -> Optional[ast.AST]:
        up = self.idx.parents.get(node)
        while up is not None:
            if isinstance(up, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return up
            up = self.idx.parents.get(up)
        return None

    def enclosing_class(self, node: ast.AST) -> Optional[str]:
        return self.class_of.get(node)

    # ------------------------------------------------- spawn targets
    def thread_calls(self) -> List[Tuple[ast.Call, str]]:
        """Every Thread(...) / spawn(...) call: (call, kind)."""
        out = []
        for call in self.idx.calls:
            q = _qualname(call.func) or ""
            last = q.rsplit(".", 1)[-1]
            if last == "Thread" and (
                    q in ("Thread", "threading.Thread")
                    or any(q == f"{m}.Thread"
                           for m in self.al.modules)):
                out.append((call, "Thread"))
            elif last == "spawn":
                out.append((call, "spawn"))
        return out


def _lock_edges(an: _Analysis) -> None:
    """Populate an.edges: lock-order pairs from with-nesting and
    acquire()/release() sequencing, per function scope."""

    def visit_block(stmts: Sequence[ast.stmt], held: List[str],
                    cls: Optional[str], fname: str) -> None:
        held = list(held)
        for st in stmts:
            held = visit_stmt(st, held, cls, fname)

    def visit_stmt(st: ast.stmt, held: List[str],
                   cls: Optional[str], fname: str) -> List[str]:
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.ClassDef)):
            return held
        if isinstance(st, ast.With):
            acquired = []
            for item in st.items:
                lk = an.locks.ref(item.context_expr, cls)
                if lk:
                    for h in held:
                        if h != lk:
                            an.edges.append((h, lk, st.lineno, fname))
                    acquired.append(lk)
            visit_block(st.body, held + acquired, cls, fname)
            return held
        if isinstance(st, ast.Expr) and isinstance(st.value, ast.Call):
            call = st.value
            if isinstance(call.func, ast.Attribute):
                lk = an.locks.ref(call.func.value, cls)
                if lk is not None:
                    if call.func.attr == "acquire":
                        for h in held:
                            if h != lk:
                                an.edges.append((h, lk, st.lineno,
                                                 fname))
                        return held + [lk]
                    if call.func.attr == "release":
                        return [h for h in held if h != lk]
        for _field, value in ast.iter_fields(st):
            if isinstance(value, list) and value and \
                    isinstance(value[0], ast.stmt):
                visit_block(value, held, cls, fname)
        return held

    visit_block(an.idx.tree.body, [], None, "<module>")
    for fn in an.idx.func_defs:
        cls = an.enclosing_class(fn)
        visit_block(fn.body, [], cls, fn.name)


def _find_cycles(edges: Iterable[Tuple[str, str]]) -> List[List[str]]:
    """Simple cycles in the lock-order graph, each reported once."""
    adj: Dict[str, Set[str]] = {}
    for src, dst in edges:
        adj.setdefault(src, set()).add(dst)
    cycles: List[List[str]] = []
    seen_cycles: Set[Tuple[str, ...]] = set()

    def dfs(node: str, path: List[str], on_path: Set[str],
            done: Set[str]) -> None:
        on_path.add(node)
        path.append(node)
        for nxt in sorted(adj.get(node, ())):
            if nxt in on_path:
                cyc = path[path.index(nxt):]
                # canonical rotation so each cycle dedups
                k = min(range(len(cyc)), key=lambda i: cyc[i])
                canon = tuple(cyc[k:] + cyc[:k])
                if canon not in seen_cycles:
                    seen_cycles.add(canon)
                    cycles.append(list(canon))
            elif nxt not in done:
                dfs(nxt, path, on_path, done)
        on_path.discard(node)
        path.pop()
        done.add(node)

    done: Set[str] = set()
    for node in sorted(adj):
        if node not in done:
            dfs(node, [], set(), done)
    return cycles


def _find_cycles(edges: Iterable[Tuple[str, str]]) -> List[List[str]]:
    """Simple cycles in the lock-order graph, each reported once."""
    adj: Dict[str, Set[str]] = {}
    for src, dst in edges:
        adj.setdefault(src, set()).add(dst)
    cycles: List[List[str]] = []
    seen_cycles: Set[Tuple[str, ...]] = set()

    def dfs(node: str, path: List[str], on_path: Set[str],
            done: Set[str]) -> None:
        on_path.add(node)
        path.append(node)
        for nxt in sorted(adj.get(node, ())):
            if nxt in on_path:
                cyc = path[path.index(nxt):]
                # canonical rotation so each cycle dedups
                k = min(range(len(cyc)), key=lambda i: cyc[i])
                canon = tuple(cyc[k:] + cyc[:k])
                if canon not in seen_cycles:
                    seen_cycles.add(canon)
                    cycles.append(list(canon))
            elif nxt not in done:
                dfs(nxt, path, on_path, done)
        on_path.discard(node)
        path.pop()
        done.add(node)

    done: Set[str] = set()
    for node in sorted(adj):
        if node not in done:
            dfs(node, [], set(), done)
    return cycles


def lock_order_graph(root: Optional[str] = None,
                     scan: Sequence[str] = DEFAULT_SCAN
                     ) -> Dict[str, Any]:
    """The repo-wide static lock-order graph, keyed for the runtime
    join: every node carries the creation file:line that
    ``threadsan.InstrumentedLock`` also records, so the sanitizer can
    seed its order check from these edges."""
    root = root or repo_root()
    locks: Dict[str, Dict[str, Any]] = {}
    edges: List[Dict[str, Any]] = []
    spawns: List[Dict[str, Any]] = []
    edge_seen: Set[Tuple[str, str]] = set()
    for abspath in iter_python_files(root, scan):
        with open(abspath, encoding="utf-8") as f:
            src = f.read()
        if not _relevant(src):
            continue
        rel = os.path.relpath(abspath, root).replace(os.sep, "/")
        try:
            tree = ast.parse(src)
        except SyntaxError:
            continue
        an = _Analysis(tree, rel)
        for lock_id, line in an.locks.line_of.items():
            locks[lock_id] = {"path": rel, "line": line,
                              "name": lock_id.split("::", 1)[-1]}
        for call, kind in an.thread_calls():
            spawns.append({"path": rel, "line": call.lineno,
                           "kind": kind})
        _lock_edges(an)
        for src_id, dst_id, line, func in an.edges:
            if (src_id, dst_id) in edge_seen:
                continue
            edge_seen.add((src_id, dst_id))
            edges.append({"src": src_id, "dst": dst_id,
                          "path": rel, "line": line, "func": func})
    cycles = _find_cycles((e["src"], e["dst"]) for e in edges)
    return {"locks": locks, "edges": edges, "cycles": cycles,
            "spawn_sites": spawns}
