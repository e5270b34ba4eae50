"""Import-reachability graph: flag library modules nothing can reach.

Builds a static import graph over every module under ``src/`` and walks it
from the public entry points: modules with a ``__main__`` guard (CLIs),
``__main__.py`` files, and every ``repro.*`` module imported by the code
that consumes the library — ``tests/``, ``examples/``, ``benchmarks/``,
and ``scripts/``. A module no root reaches is dead weight (``dead-module``,
warning severity: deletion is a human call, via the baseline or a cleanup
PR).

Dynamic imports (``importlib.import_module``) are invisible to this graph
*by design* — a module only loadable through a computed string has no
statically-verifiable caller, which is exactly the hazard the rule exists
to surface.
"""
from __future__ import annotations

import ast
import os

from .findings import Finding

CONSUMER_DIRS = ("tests", "examples", "benchmarks", "scripts")


def _module_name(path: str, src_root: str) -> str:
    rel = os.path.relpath(path, src_root)
    parts = rel[:-3].split(os.sep)            # strip .py
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def discover_modules(src_root: str) -> dict[str, str]:
    """module name -> file path, for every .py under ``src_root``."""
    mods = {}
    for dirpath, dirnames, filenames in os.walk(src_root):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                path = os.path.join(dirpath, fn)
                mods[_module_name(path, src_root)] = path
    return mods


def _resolve_relative(module: str, is_pkg: bool, level: int,
                      target: str | None) -> str | None:
    parts = module.split(".")
    if not is_pkg:
        parts = parts[:-1]
    drop = level - 1
    if drop > len(parts):
        return None
    base = parts[:len(parts) - drop] if drop else parts
    return ".".join(base + target.split(".")) if target else ".".join(base)


def _imports_of(path: str, module: str, is_pkg: bool):
    """Absolute module names this file imports (best-effort, incl. names
    imported *from* a package, which may themselves be modules)."""
    try:
        with open(path) as fh:
            tree = ast.parse(fh.read(), filename=path)
    except (SyntaxError, OSError):
        return
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = _resolve_relative(module, is_pkg, node.level,
                                         node.module)
            else:
                base = node.module
            if base is None:
                continue
            yield base
            for a in node.names:
                yield f"{base}.{a.name}"


def _closure(name: str, modules: dict) -> list[str]:
    """The module plus every enclosing package that exists."""
    out = []
    parts = name.split(".")
    for i in range(1, len(parts) + 1):
        cand = ".".join(parts[:i])
        if cand in modules:
            out.append(cand)
    return out


def build_graph(src_root: str) -> tuple[dict, dict]:
    """-> (module -> path, module -> set of imported modules)."""
    modules = discover_modules(src_root)
    edges: dict[str, set] = {}
    for name, path in modules.items():
        is_pkg = os.path.basename(path) == "__init__.py"
        deps = set()
        for imp in _imports_of(path, name, is_pkg):
            deps.update(_closure(imp, modules))
        edges[name] = deps - {name}
    return modules, edges


def find_roots(root: str, src_root: str, modules: dict) -> set:
    """Entry points: __main__-guarded modules + consumer-imported ones."""
    roots = set()
    for name, path in modules.items():
        if name.endswith("__main__"):
            roots.add(name)
            continue
        try:
            with open(path) as fh:
                if '__name__ == "__main__"' in fh.read():
                    roots.add(name)
        except OSError:  # pragma: no cover
            pass
    for d in CONSUMER_DIRS:
        dirpath = os.path.join(root, d)
        if not os.path.isdir(dirpath):
            continue
        for dp, dns, fns in os.walk(dirpath):
            dns[:] = [x for x in dns if x != "__pycache__"]
            for fn in sorted(fns):
                if not fn.endswith(".py"):
                    continue
                p = os.path.join(dp, fn)
                for imp in _imports_of(p, "consumer", False):
                    roots.update(_closure(imp, modules))
    return roots


def check_reachability(root: str, src_root: str) -> list[Finding]:
    """``dead-module``: library modules no entry point reaches."""
    modules, edges = build_graph(src_root)
    roots = find_roots(root, src_root, modules)

    reached = set()
    stack = list(roots)
    while stack:
        m = stack.pop()
        if m in reached:
            continue
        reached.add(m)
        # a reachable module implies its enclosing packages run too
        stack.extend(_closure(m, modules))
        stack.extend(edges.get(m, ()))

    out = []
    for name in sorted(set(modules) - reached):
        rel = os.path.relpath(modules[name], root)
        out.append(Finding(
            "dead-module", "warning", rel, 1,
            f"module {name!r} is unreachable from every entry point "
            "(no static import from src/, tests/, examples/, benchmarks/, "
            "or scripts/) — delete it or justify it in the baseline"))
    return out
