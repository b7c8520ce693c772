"""R4: REST route table vs OpenAPI generator drift.

``rest/api.py`` declares the dispatch surface in ``_build_router`` as
``r.add(method, pattern, self.handler)`` calls; ``Router.dispatch``
invokes ``handler(req, **pathparams)`` with the ``:name`` captures as
keywords. ``rest/openapi.py`` documents that surface, plus
request-body hints keyed by ``(method, pattern)``. Three drift classes
are caught statically, without importing either module:

* a route whose handler is missing from ``CookApi``, or whose
  ``:name`` path parameters don't match the handler's keyword
  signature after ``(self, req)`` — a guaranteed ``TypeError`` at
  dispatch time;
* duplicate ``(method, pattern)`` registrations (the first always
  wins, so the second is dead);
* a ``_BODY_HINTS`` entry in ``openapi.py`` that references a
  nonexistent route or a schema missing from ``_SCHEMAS`` — silently
  dropped documentation.
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass

from cook_tpu_torch.analysis.core import Finding

_PARAM_RE = re.compile(r":(\w+)")


@dataclass
class Route:
    method: str
    pattern: str
    handler: str
    line: int


def _find_class(tree: ast.Module, name: str) -> ast.ClassDef | None:
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and node.name == name:
            return node
    return None


def _collect_routes(api_tree: ast.Module) -> list[Route]:
    """Every `<anything>.add("METHOD", "/pattern", self.handler)` call
    inside a method named _build_router (anywhere, to survive class
    renames)."""
    routes: list[Route] = []
    for fn in ast.walk(api_tree):
        if not isinstance(fn, ast.FunctionDef) or \
                fn.name != "_build_router":
            continue
        for node in ast.walk(fn):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "add"
                    and len(node.args) == 3):
                continue
            m, p, h = node.args
            if not (isinstance(m, ast.Constant) and isinstance(m.value, str)
                    and isinstance(p, ast.Constant)
                    and isinstance(p.value, str)):
                continue
            if isinstance(h, ast.Attribute) and \
                    isinstance(h.value, ast.Name) and h.value.id == "self":
                handler = h.attr
            elif isinstance(h, ast.Name):
                handler = h.id
            else:
                continue
            routes.append(Route(m.value, p.value, handler, node.lineno))
    return routes


def _handler_signatures(api_tree: ast.Module) -> dict[str, tuple[set, bool]]:
    """method name -> (param names after (self, req), has **kwargs)."""
    cls = _find_class(api_tree, "CookApi")
    scope = cls.body if cls is not None else api_tree.body
    sigs: dict[str, tuple[set, bool]] = {}
    for node in scope:
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        args = node.args
        names = [a.arg for a in args.args] + \
                [a.arg for a in args.kwonlyargs]
        sigs[node.name] = (set(names[2:]), args.kwarg is not None)
    return sigs


def _check_api(routes: list[Route], sigs: dict, api_path: str
               ) -> list[Finding]:
    findings: list[Finding] = []
    seen: dict[tuple[str, str], Route] = {}
    for r in routes:
        key = (r.method, r.pattern)
        if key in seen:
            findings.append(Finding(
                "R4", api_path, r.line, r.handler,
                f"duplicate route {r.method} {r.pattern} (first bound to "
                f"{seen[key].handler} at line {seen[key].line} wins; this "
                "registration is dead)"))
        else:
            seen[key] = r
        params = set(_PARAM_RE.findall(r.pattern))
        if r.handler not in sigs:
            findings.append(Finding(
                "R4", api_path, r.line, r.handler,
                f"route {r.method} {r.pattern} is bound to missing "
                f"handler self.{r.handler}"))
            continue
        sig_params, has_kwargs = sigs[r.handler]
        missing = params - sig_params
        if missing and not has_kwargs:
            findings.append(Finding(
                "R4", api_path, r.line, r.handler,
                f"path params {sorted(missing)} of {r.method} {r.pattern} "
                f"are not accepted by {r.handler}() — dispatch will raise "
                "TypeError"))
        extra = sig_params - params
        if extra:
            findings.append(Finding(
                "R4", api_path, r.line, r.handler,
                f"{r.handler}() requires params {sorted(extra)} that "
                f"{r.method} {r.pattern} never captures"))
    return findings


def _literal(node: ast.AST):
    try:
        return ast.literal_eval(node)
    except (ValueError, SyntaxError):
        return None


def _check_openapi(routes: list[Route], openapi_tree: ast.Module,
                   openapi_path: str) -> list[Finding]:
    findings: list[Finding] = []
    route_keys = {(r.method, r.pattern) for r in routes}
    schemas: set[str] = set()
    hints: list[tuple[tuple, str, int]] = []
    for node in ast.walk(openapi_tree):
        if not isinstance(node, ast.Assign) or \
                not isinstance(node.value, ast.Dict):
            continue
        for t in node.targets:
            if not isinstance(t, ast.Name):
                continue
            if t.id == "_SCHEMAS":
                for k in node.value.keys:
                    if isinstance(k, ast.Constant):
                        schemas.add(k.value)
            elif t.id == "_BODY_HINTS":
                for k, v in zip(node.value.keys, node.value.values):
                    key = _literal(k) if k is not None else None
                    val = _literal(v)
                    if isinstance(key, tuple) and isinstance(val, str):
                        hints.append((key, val, k.lineno))
    for key, schema, line in hints:
        if key not in route_keys:
            findings.append(Finding(
                "R4", openapi_path, line, "_BODY_HINTS",
                f"body hint for {key[0]} {key[1]} has no matching route "
                "in the Router table"))
        if schema not in schemas:
            findings.append(Finding(
                "R4", openapi_path, line, "_BODY_HINTS",
                f"body hint schema {schema!r} is missing from _SCHEMAS"))
    return findings


def check_pair(api_src: str, api_path: str, openapi_src: str,
               openapi_path: str) -> list[Finding]:
    try:
        api_tree = ast.parse(api_src, filename=api_path)
    except SyntaxError as e:
        return [Finding("R0", api_path, e.lineno or 0, "",
                        f"syntax error: {e.msg}")]
    try:
        openapi_tree = ast.parse(openapi_src, filename=openapi_path)
    except SyntaxError as e:
        return [Finding("R0", openapi_path, e.lineno or 0, "",
                        f"syntax error: {e.msg}")]
    routes = _collect_routes(api_tree)
    sigs = _handler_signatures(api_tree)
    findings = _check_api(routes, sigs, api_path)
    findings += _check_openapi(routes, openapi_tree, openapi_path)
    return findings
