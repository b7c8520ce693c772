"""R3: async hygiene — blocking calls inside ``async def`` bodies.

An ``async def`` runs on the event loop; any synchronous wait inside it
stalls every other coroutine on that loop. The rule flags, inside
``async def`` bodies (without descending into nested sync ``def``s,
which may legitimately be shipped to executors):

* ``time.sleep`` — use ``asyncio.sleep``
* synchronous HTTP (``requests.*``, ``urllib.request.*``,
  ``http.client.*``)
* blocking socket construction/connect (``socket.socket``,
  ``socket.create_connection``)
* ``subprocess.run/call/check_*`` — use ``asyncio.create_subprocess_*``
* bare ``open()`` used as a statement/``with`` (file IO on the loop)
* the repo's own blocking REST helper ``json_request`` / the blocking
  ``urlopen``

Import aliases are resolved, so ``import requests as rq`` still trips.
"""
from __future__ import annotations

import ast
from typing import Optional

from cook_tpu_torch.analysis.core import Finding, ModuleInfo

_BLOCKING_CALLS = {
    "time.sleep": "time.sleep blocks the event loop; use asyncio.sleep",
    "socket.create_connection":
        "blocking socket connect on the event loop; use asyncio streams",
    "socket.socket":
        "raw blocking socket inside async def; use asyncio streams",
    "subprocess.run": "subprocess.run blocks the event loop; use "
                      "asyncio.create_subprocess_exec",
    "subprocess.call": "subprocess.call blocks the event loop; use "
                       "asyncio.create_subprocess_exec",
    "subprocess.check_call": "blocking subprocess wait on the event loop",
    "subprocess.check_output": "blocking subprocess wait on the event loop",
    "urllib.request.urlopen":
        "blocking urlopen inside async def; run it in an executor",
}
# any call into these modules is synchronous network IO
_BLOCKING_MODULES = {
    "requests": "synchronous requests.* call blocks the event loop",
    "http.client": "synchronous http.client call blocks the event loop",
}
# repo-native blocking helpers (cook_tpu.rest.client json_request etc.)
_BLOCKING_SUFFIXES = {
    "json_request": "cook_tpu's json_request is synchronous HTTP; "
                    "run it in an executor from async code",
}


def _async_defs(tree: ast.Module):
    for node in ast.walk(tree):
        if isinstance(node, ast.AsyncFunctionDef):
            yield node


def _iter_async_body(fn: ast.AsyncFunctionDef):
    """Walk the async body; do not descend into nested *sync* defs
    (they may be executor targets), but do descend into nested async
    defs' await-reachable structure via their own visit."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _violation(mod: ModuleInfo, node: ast.AST) -> Optional[str]:
    if not isinstance(node, ast.Call):
        return None
    dotted = mod.resolve(node.func)
    if dotted is None:
        return None
    if dotted in _BLOCKING_CALLS:
        return _BLOCKING_CALLS[dotted]
    head = dotted.split(".")[0]
    for prefix, msg in _BLOCKING_MODULES.items():
        if dotted == prefix or dotted.startswith(prefix + "."):
            return msg
    if head in _BLOCKING_MODULES:
        return _BLOCKING_MODULES[head]
    tail = dotted.split(".")[-1]
    if tail in _BLOCKING_SUFFIXES:
        return _BLOCKING_SUFFIXES[tail]
    if dotted == "open":
        return "blocking file open() inside async def; use an executor"
    return None


def check(mod: ModuleInfo) -> list[Finding]:
    findings: list[Finding] = []
    for fn in _async_defs(mod.tree):
        for node in _iter_async_body(fn):
            msg = _violation(mod, node)
            if msg is not None:
                findings.append(Finding(
                    "R3", mod.path, getattr(node, "lineno", fn.lineno),
                    fn.name, msg))
    return findings
