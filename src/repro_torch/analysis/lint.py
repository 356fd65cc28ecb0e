"""Layer 2: the port's AST lint over ``src/repro_torch`` (the port of
``repro.analysis.lint``).

Rules (ids in ``findings.RULES``):

  AL01  hot-path reads: inside a function of ``registry.HOT_PATH_FUNCTIONS``
        (nested defs included), no ``.item()``/``.tolist()``/``.cpu()``/
        ``.numpy()``; no ``bool()``/``float()``/``int()``, ``np.*`` call or
        ``if``/``while`` condition that reads an array parameter's values;
        no data-dependent-shape op (``nonzero``, ``masked_select``,
        ``unique``, ``argwhere``, one-argument ``where``,
        ``repeat_interleave`` without ``output_size``, boolean-mask
        indexing).  Each is a host read that stalls the card between two
        launches.  Reading a tensor's metadata (``.shape``, ``.dtype``,
        ``.device``, ``.dim()``, ``.numel()``, ...) reads no device memory
        and is legal, as is a call to a ``registry.COUNTED_READS`` helper in
        the file that defines it (its arguments are still linted): those
        reads are counted, and the window auditor holds the counts.
  AL02  cache discipline: long-lived dict caches (module-level dicts mutated
        by module functions, or dicts installed via ``__dict__``) must be
        ``structs.BoundedCache`` (or visibly bounded via ``popitem``).
  AL03  has no source form here: a CUDA kernel's output stores are not
        Python.  Its intent -- every output element written -- is held on
        the card by launching each kernel into poisoned memory
        (``trace_audit.check_poisoned_output``).
  AL04  no ``tobytes()``-keyed caches without shape/dtype context: inside a
        ``*key*`` function, a ``.tobytes()`` call needs ``.shape`` and a
        dtype component beside it.
  AL05  unused module-level imports.

``lint_paths`` walks real files; ``lint_source`` takes a source string --
the seam the known-bad fixture corpus goes through.
"""

from __future__ import annotations

import ast
import os

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.registry import COUNTED_READS, HOT_PATH_FUNCTIONS

#: constructors the cache rule trusts to be bounded
_BOUNDED_CTORS = {"BoundedCache"}

#: tensor attributes and methods that read metadata, never device memory
_META_ATTRS = {
    "shape", "dtype", "device", "ndim", "is_cuda", "layout", "requires_grad",
    "_version", "is_sparse",
}
_META_METHODS = {
    "dim", "size", "numel", "nelement", "is_contiguous", "element_size",
    "data_ptr", "stride", "storage_offset", "get_device", "is_floating_point",
}
_META_CALLS = {"len", "isinstance", "type", "id"}

#: methods that copy device values to the host
_HOST_READ_METHODS = {"item", "tolist", "cpu", "numpy"}

#: ops whose output shape depends on the values (a host read of a count)
_DATA_DEPENDENT_OPS = {
    "nonzero", "masked_select", "unique", "unique_consecutive", "argwhere",
    "repeat_interleave",
}


def _loc(path: str, node: ast.AST) -> str:
    return f"{path}:{getattr(node, 'lineno', 0)}"


def _call_name(node: ast.expr) -> str:
    """Dotted name of a call target ('torch.where', 'self._any', ...)."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


# -- AL01 ---------------------------------------------------------------------


def _is_counted_call(node: ast.AST, counted: set) -> bool:
    return isinstance(node, ast.Call) and _call_name(node.func) in counted


def _data_reads(node: ast.AST, arrays: set, counted: set) -> set:
    """The array parameters whose *values* ``node`` reads: metadata reads,
    identity tests (``is``/``is not``) and counted-helper calls excluded."""
    if isinstance(node, ast.Attribute) and node.attr in _META_ATTRS:
        return set()
    if isinstance(node, ast.Call):
        if _is_counted_call(node, counted) or _call_name(node.func) in _META_CALLS:
            return set()
        if isinstance(node.func, ast.Attribute) and node.func.attr in _META_METHODS:
            args = [*node.args, *(kw.value for kw in node.keywords)]
            return set().union(*(_data_reads(a, arrays, counted) for a in args))
    if isinstance(node, ast.Compare) and all(
        isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops
    ):
        return set()
    if isinstance(node, ast.Name):
        return {node.id} & arrays
    return set().union(
        *(_data_reads(c, arrays, counted) for c in ast.iter_child_nodes(node))
    )


def _hot_nodes(fn: ast.FunctionDef, counted: set):
    """Every node of ``fn``'s body, nested defs included, except the bodies
    of nested counted helpers."""
    helpers = {c.rpartition(".")[2] for c in counted}
    stack = list(fn.body)
    while stack:
        node = stack.pop()
        if isinstance(node, ast.FunctionDef) and node.name in helpers:
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _is_mask_index(node: ast.expr) -> bool:
    """A subscript index that is a comparison or an inverted mask: a
    boolean-mask gather, whose output length is the mask's count."""
    elts = node.elts if isinstance(node, ast.Tuple) else [node]
    return any(
        isinstance(e, ast.Compare)
        or (isinstance(e, ast.UnaryOp) and isinstance(e.op, ast.Invert))
        for e in elts
    )


def _hot_path_findings(path: str, fn: ast.FunctionDef, arrays: set, counted: set) -> list:
    findings = []
    where = f"hot-path '{fn.name}'"
    for node in _hot_nodes(fn, counted):
        if isinstance(node, ast.Call):
            cname = _call_name(node.func)
            head, _, tail = cname.rpartition(".")
            root = cname.split(".")[0]
            if isinstance(node.func, ast.Attribute) and tail in _HOST_READ_METHODS:
                findings.append(Finding(
                    "AL01", _loc(path, node),
                    f"'.{tail}()' inside {where} is an uncounted host read "
                    "(count it through a registry.COUNTED_READS helper)",
                ))
            if cname in ("float", "int", "bool") and node.args:
                read = _data_reads(node.args[0], arrays, counted)
                if read:
                    findings.append(Finding(
                        "AL01", _loc(path, node),
                        f"{cname}() over the values of '{ast.unparse(node.args[0])}' "
                        f"inside {where} is an uncounted host read",
                    ))
            if root in ("np", "numpy") and head:
                args = [*node.args, *(kw.value for kw in node.keywords)]
                read = set().union(*(_data_reads(a, arrays, counted) for a in args))
                if read:
                    findings.append(Finding(
                        "AL01", _loc(path, node),
                        f"'{cname}' over array parameter(s) {sorted(read)} inside "
                        f"{where} pulls it to the host (an uncounted host read)",
                    ))
            elif tail in _DATA_DEPENDENT_OPS or (tail == "where" and len(node.args) == 1):
                sized = any(kw.arg == "output_size" for kw in node.keywords)
                if not (tail == "repeat_interleave" and sized):
                    findings.append(Finding(
                        "AL01", _loc(path, node),
                        f"data-dependent-shape op '{cname}' inside {where}: its "
                        "output size is a host read of a device count",
                    ))
        if isinstance(node, (ast.If, ast.While, ast.IfExp)):
            read = _data_reads(node.test, arrays, counted)
            if read:
                kind = {ast.If: "if", ast.While: "while", ast.IfExp: "conditional"}[type(node)]
                findings.append(Finding(
                    "AL01", _loc(path, node),
                    f"Python {kind} on the values of '{ast.unparse(node.test)}' "
                    f"inside {where} is an uncounted host read (use torch.where, "
                    "or count the read)",
                ))
        if isinstance(node, ast.Subscript) and _is_mask_index(node.slice):
            findings.append(Finding(
                "AL01", _loc(path, node),
                f"boolean-mask indexing '{ast.unparse(node)}' inside {where}: "
                "its output size is a host read of the mask's count",
            ))
    return findings


def _check_hot_path(path: str, tree: ast.Module, hot_overrides=None) -> list:
    norm = path.replace(os.sep, "/")
    registry = {
        t.name: set(t.array_params)
        for t in HOT_PATH_FUNCTIONS
        if norm.endswith(t.file_suffix)
    }
    for name, params in (hot_overrides or ()):
        registry[name] = set(params)
    counted = {call for suffix, call in COUNTED_READS if norm.endswith(suffix)}
    findings = []
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and node.name in registry:
            findings += _hot_path_findings(path, node, registry[node.name], counted)
    return findings


# -- AL02 ---------------------------------------------------------------------


def _is_dict_ctor(node: ast.expr) -> bool:
    if isinstance(node, ast.Dict):
        return True
    if isinstance(node, ast.Call):
        return _call_name(node.func) in ("dict", "OrderedDict", "defaultdict")
    return False


def _is_empty_dict_seed(node: ast.expr) -> bool:
    """``{}`` / ``dict()`` / ``OrderedDict()`` with no entries -- the cache
    seed shape, as opposed to a literal metadata dict."""
    if isinstance(node, ast.Dict):
        return not node.keys
    if isinstance(node, ast.Call):
        return _call_name(node.func) in ("dict", "OrderedDict", "defaultdict") and not (
            node.args or node.keywords
        )
    return False


def _is_bounded_ctor(node: ast.expr) -> bool:
    return isinstance(node, ast.Call) and _call_name(node.func).split(".")[-1] in _BOUNDED_CTORS


def _check_caches(path: str, tree: ast.Module) -> list:
    findings = []
    # module-level dicts...
    module_dicts = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and isinstance(
            node.targets[0], ast.Name
        ):
            if _is_dict_ctor(node.value):
                module_dicts[node.targets[0].id] = node
    # ...mutated by any function in the module (a long-lived growing cache)
    mutated, bounded = set(), set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Subscript) and isinstance(t.value, ast.Name):
                    mutated.add(t.value.id)
        if isinstance(node, ast.Call):
            cname = _call_name(node.func)
            head, _, tail = cname.rpartition(".")
            if tail == "setdefault" and head in module_dicts:
                mutated.add(head)
            if tail == "popitem":
                bounded.add(head)
    for name, node in module_dicts.items():
        if name in mutated and name not in bounded:
            findings.append(Finding(
                "AL02", _loc(path, node),
                f"module-level dict '{name}' grows without a bound: use "
                "structs.BoundedCache (LRU + coerced keys)",
            ))
    # __dict__-installed side caches: x.__dict__.setdefault('name', {}) or
    # x.__dict__['name'] = {} seeding a plain dict
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            cname = _call_name(node.func)
            if cname.endswith("__dict__.setdefault") and len(node.args) == 2:
                if _is_empty_dict_seed(node.args[1]) and not _is_bounded_ctor(node.args[1]):
                    findings.append(Finding(
                        "AL02", _loc(path, node),
                        "__dict__.setdefault side cache seeds a plain dict: "
                        "instance-lifetime caches must be BoundedCache",
                    ))
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            t = node.targets[0]
            if (
                isinstance(t, ast.Subscript)
                and isinstance(t.value, ast.Attribute)
                and t.value.attr == "__dict__"
                and _is_empty_dict_seed(node.value)
                and not _is_bounded_ctor(node.value)
            ):
                findings.append(Finding(
                    "AL02", _loc(path, node),
                    "__dict__-installed side cache is a plain dict: "
                    "instance-lifetime caches must be BoundedCache",
                ))
    return findings


# -- AL04 ---------------------------------------------------------------------


def _check_bytes_keys(path: str, tree: ast.Module) -> list:
    findings = []
    for fn in ast.walk(tree):
        if not isinstance(fn, ast.FunctionDef) or "key" not in fn.name:
            continue
        if fn.name.startswith("test_"):
            continue  # tests construct aliasing probes on purpose
        has_tobytes = any(
            isinstance(n, ast.Call) and _call_name(n.func).endswith("tobytes")
            for n in ast.walk(fn)
        )
        if not has_tobytes:
            continue
        attrs = {n.attr for n in ast.walk(fn) if isinstance(n, ast.Attribute)}
        if "shape" not in attrs or "dtype" not in attrs:
            findings.append(Finding(
                "AL04", _loc(path, fn),
                f"cache-key function '{fn.name}' keys on tobytes() without "
                "shape/dtype context: different arrays can alias one "
                "buffer (a stale-layout hit)",
            ))
    return findings


# -- AL05 ---------------------------------------------------------------------


def _check_unused_imports(path: str, tree: ast.Module, source: str) -> list:
    if os.path.basename(path) == "__init__.py":
        return []
    lines = source.splitlines()
    imported = {}  # bound name -> node
    for node in tree.body:
        nodes = [node]
        if isinstance(node, ast.Try):
            nodes = node.body
        for n in nodes:
            if isinstance(n, ast.Import):
                for alias in n.names:
                    bound = alias.asname or alias.name.split(".")[0]
                    imported[bound] = n
            elif isinstance(n, ast.ImportFrom) and n.module != "__future__":
                for alias in n.names:
                    if alias.name == "*":
                        continue
                    imported[alias.asname or alias.name] = n
    used = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Name):
            used.add(node.id)
        elif isinstance(node, ast.Attribute):
            root = node
            while isinstance(root, ast.Attribute):
                root = root.value
            if isinstance(root, ast.Name):
                used.add(root.id)
    # names re-exported via __all__ count as used
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
            isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets
        ):
            for el in getattr(node.value, "elts", ()):
                if isinstance(el, ast.Constant):
                    used.add(el.value)
    findings = []
    for name, node in sorted(imported.items()):
        if name in used or name.startswith("_"):
            continue
        line = lines[node.lineno - 1] if node.lineno <= len(lines) else ""
        if "noqa" in line:
            continue
        findings.append(Finding("AL05", _loc(path, node), f"unused import '{name}'"))
    return findings


# -- entry points -------------------------------------------------------------


def lint_source(source: str, path: str, *, hot_overrides=None) -> list:
    """Lint one source string (the fixture seam).  ``hot_overrides`` is an
    iterable of ``(function_name, array_param_names)`` added to the hot-path
    registry for this file."""
    tree = ast.parse(source, filename=path)
    findings = []
    findings += _check_hot_path(path, tree, hot_overrides)
    findings += _check_caches(path, tree)
    findings += _check_bytes_keys(path, tree)
    findings += _check_unused_imports(path, tree, source)
    return findings


def lint_paths(paths) -> list:
    """Lint every ``.py`` file under the given files/directories."""
    files = []
    for p in paths:
        p = str(p)
        if os.path.isdir(p):
            for root, _, names in os.walk(p):
                files += [os.path.join(root, n) for n in names if n.endswith(".py")]
        elif p.endswith(".py"):
            files.append(p)
    findings = []
    for f in sorted(files):
        with open(f, encoding="utf-8") as fh:
            findings += lint_source(fh.read(), os.path.relpath(f))
    return findings
