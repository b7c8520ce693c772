"""Machine-readable API self-description (OpenAPI 3.0).

The reference serves swagger docs generated from its compojure-api
route metadata (rest/api.clj:3058-3340 swagger wiring). Here the spec
is generated FROM the live Router table, so it can never drift from
the actual dispatch surface: every route's method/path appears, path
parameters are derived from the ":name" segments, and each operation's
summary/description comes from the bound handler's docstring.

Served at GET /openapi.json (and /swagger-docs for discoverability).
"""
from __future__ import annotations

import re
from typing import Any

# request-body hints for the write endpoints (shape documentation the
# route table alone can't carry; kept deliberately coarse — the full
# job schema lives in docs/api.md)
_BODY_HINTS = {
    ("POST", "/jobs"): "JobSubmission",
    ("POST", "/jobs/bulk"): "JobSubmission",
    ("POST", "/rawscheduler"): "JobSubmission",
    ("POST", "/retry"): "RetryRequest",
    ("POST", "/share"): "LimitUpdate",
    ("POST", "/quota"): "LimitUpdate",
    ("POST", "/agents/status/bulk"): "AgentStatusBulk",
    ("POST", "/federation/migrate"): "PoolMigration",
    ("POST", "/federation/adopt"): "PoolAdoption",
}

_SCHEMAS = {
    "JobSubmission": {
        "type": "object",
        "required": ["jobs"],
        "properties": {
            "jobs": {"type": "array", "items": {
                "type": "object",
                "required": ["command"],
                "properties": {
                    "uuid": {"type": "string"},
                    "command": {"type": "string"},
                    "mem": {"type": "number"},
                    "cpus": {"type": "number"},
                    "gpus": {"type": "number"},
                    "name": {"type": "string"},
                    "priority": {"type": "integer"},
                    "max_retries": {"type": "integer"},
                    "max_runtime": {"type": "integer"},
                    "env": {"type": "object"},
                    "labels": {"type": "object"},
                    "constraints": {"type": "array"},
                    "group": {"type": "string"},
                    "container": {"type": "object"},
                    "uris": {"type": "array"},
                    "checkpoint": {"type": "object"},
                    "ports": {"type": "integer"},
                }}},
            "groups": {"type": "array"},
            "pool": {"type": "string"},
        },
    },
    "RetryRequest": {
        "type": "object",
        "properties": {"jobs": {"type": "array",
                                "items": {"type": "string"}},
                       "retries": {"type": "integer"},
                       "increment": {"type": "integer"}},
    },
    "LimitUpdate": {
        "type": "object",
        "properties": {"user": {"type": "string"},
                       "pool": {"type": "string"},
                       "mem": {"type": "number"},
                       "cpus": {"type": "number"},
                       "gpus": {"type": "number"},
                       "count": {"type": "integer"},
                       "reason": {"type": "string"}},
    },
    "PoolMigration": {
        "type": "object",
        "required": ["pool", "to"],
        "properties": {"pool": {"type": "string"},
                       "to": {"type": "string"},
                       "force": {"type": "boolean"}},
    },
    "PoolAdoption": {
        "type": "object",
        "required": ["pool"],
        "properties": {"pool": {"type": "string"},
                       "from": {"type": "string"},
                       "jobs": {"type": "array"},
                       "groups": {"type": "array"}},
    },
    "AgentStatusBulk": {
        "type": "object",
        "required": ["updates"],
        "properties": {
            "updates": {"type": "array", "items": {
                "type": "object",
                "required": ["task_id"],
                "properties": {
                    "task_id": {"type": "string"},
                    "event": {"type": "string"},
                    "exit_code": {"type": "integer"},
                    "hostname": {"type": "string"},
                    "sandbox": {"type": "string"},
                }}},
        },
    },
}


def build_spec(router, title: str = "cook_tpu scheduler API",
               version: str = "1.0") -> dict[str, Any]:
    """OpenAPI 3.0 document generated from the live route table."""
    paths: dict[str, dict] = {}
    for method, pattern, handler in router.route_table:
        oa_path = re.sub(r":(\w+)", r"{\1}", pattern)
        params = [
            {"name": name, "in": "path", "required": True,
             "schema": {"type": "string"}}
            for name in re.findall(r":(\w+)", pattern)
        ]
        doc = (handler.__doc__ or "").strip()
        summary = doc.split("\n", 1)[0][:120] if doc else \
            f"{method} {pattern}"
        slug = re.sub(r"[^a-zA-Z0-9]+", "_", pattern).strip("_") or "root"
        op: dict[str, Any] = {
            "summary": summary,
            # path slug keeps operationIds unique when one handler
            # serves several routes (OpenAPI 3.0 uniqueness rule)
            "operationId": f"{method.lower()}_{slug}",
            "responses": {"200": {"description": "success"},
                          "4XX": {"description": "client error"},
                          "503": {"description":
                                  "not leader; body carries the leader "
                                  "hint URL"}},
        }
        if doc and "\n" in doc:
            op["description"] = doc
        if params:
            op["parameters"] = params
        hint = _BODY_HINTS.get((method, pattern))
        if hint:
            op["requestBody"] = {"required": True, "content": {
                "application/json": {"schema": {
                    "$ref": f"#/components/schemas/{hint}"}}}}
        elif method in ("POST", "PUT", "DELETE"):
            op["requestBody"] = {"required": False, "content": {
                "application/json": {"schema": {"type": "object"}}}}
        paths.setdefault(oa_path, {})[method.lower()] = op
    return {
        "openapi": "3.0.3",
        "info": {"title": title, "version": version,
                 "description":
                     "Multi-tenant fair-sharing batch scheduler "
                     "(TPU-native Cook). Generated from the live "
                     "route table."},
        "paths": paths,
        "components": {
            "schemas": _SCHEMAS,
            "securitySchemes": {
                "basic": {"type": "http", "scheme": "basic"},
                "userHeader": {"type": "apiKey", "in": "header",
                               "name": "X-Cook-User"},
            }},
    }
