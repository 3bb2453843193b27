"""The AST helpers of ``deeplearning_tpu/analysis/lint.py`` that the lock
graph (``analysis/concurrency.py``) takes: one breadth-first index of a
module, dotted names, keyword lookup, a walk that stays in one scope, the
suppression pragma and the tree walk. Standard library only.

The linter's DLT1xx rules, ``lint_tree`` and the ratchet come with ROADMAP
Queue 1 item 8d2; the default scan is the port's package.
"""

from __future__ import annotations

import ast
import os
import re
from collections import deque
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = ["DEFAULT_SCAN", "repo_root", "iter_python_files"]

# scan roots, relative to the checkout root (tests/ is out by design:
# seeded-violation fixtures live in temporary directories)
DEFAULT_SCAN: Tuple[str, ...] = ("deeplearning_tpu_torch",)

_PRAGMA = re.compile(r"#\s*dltpu:\s*allow\(([^)]*)\)")


def _qualname(node: ast.AST) -> Optional[str]:
    """Dotted name for Name/Attribute chains, else None."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = _qualname(node.value)
        return f"{base}.{node.attr}" if base else None
    return None


class _Index:
    """One breadth-first walk of the module, shared by every pass: every
    node, the calls, the function definitions, the except handlers and
    each node's parent."""

    def __init__(self, tree: ast.Module):
        self.tree = tree
        self.nodes: List[ast.AST] = []
        self.calls: List[ast.Call] = []
        self.func_defs: List[ast.AST] = []
        self.except_handlers: List[ast.ExceptHandler] = []
        self.parents: Dict[ast.AST, ast.AST] = {}
        todo: deque = deque([tree])
        while todo:
            node = todo.popleft()
            self.nodes.append(node)
            if isinstance(node, ast.Call):
                self.calls.append(node)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.func_defs.append(node)
            elif isinstance(node, ast.ExceptHandler):
                self.except_handlers.append(node)
            for child in ast.iter_child_nodes(node):
                self.parents[child] = node
                todo.append(child)


def _call_kw(node: ast.Call, name: str) -> Optional[ast.expr]:
    for kw in node.keywords:
        if kw.arg == name:
            return kw.value
    return None


def _scope_walk(body: Sequence[ast.stmt]) -> Iterable[ast.AST]:
    """Walk a function body without descending into nested function /
    class scopes (their loads/stores execute at a different time)."""
    stack: deque = deque(body)
    while stack:
        node = stack.popleft()
        yield node
        for child in ast.iter_child_nodes(node):
            if not isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef,
                                      ast.Lambda, ast.ClassDef)):
                stack.append(child)


def repo_root() -> str:
    """The checkout root (two levels above this file's package dir)."""
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def iter_python_files(root: str,
                      scan: Sequence[str] = DEFAULT_SCAN
                      ) -> Iterable[str]:
    for entry in scan:
        full = os.path.join(root, entry)
        if os.path.isfile(full):
            yield full
        elif os.path.isdir(full):
            for dirpath, dirnames, filenames in os.walk(full):
                dirnames[:] = [d for d in dirnames
                               if d not in ("__pycache__", ".git",
                                            "runs", ".jax_cache")]
                for fn in sorted(filenames):
                    if fn.endswith(".py"):
                        yield os.path.join(dirpath, fn)
