"""Authentication / authorization / impersonation for the REST API.

Equivalents of:
  rest/basic_auth.clj (80)     HTTP basic — username is trusted, any
                               password accepted (dev-mode semantics)
  one-user auth                (components.clj configurable middleware)
  rest/impersonation.clj (91)  X-Cook-Impersonate header, allowed only
                               for configured imposters
  rest/authorization.clj (233) role-based is-authorized?: admins can do
                               anything; users can read/modify their own
                               objects; configurable open mode
  rest/cors.clj (62)           origin allow-list preflight handling

(The reference's SPNEGO/Kerberos authenticator is an enterprise
deployment concern; the scheme registry here is pluggable the same way.)
"""
from __future__ import annotations

import base64
from dataclasses import dataclass, field
from typing import Optional


class AuthError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status
        self.message = message


@dataclass
class AuthConfig:
    # "one-user": every request is `one_user`; "basic": HTTP basic
    # username; "header": trust X-Cook-User (tests/sidecar)
    scheme: str = "one-user"
    one_user: str = "root"
    admins: set = field(default_factory=set)
    # users allowed to impersonate others (impersonation.clj)
    imposters: set = field(default_factory=set)
    # authorization mode: "configfile-admins-auth" (role based) or
    # "open-auth" (everyone may do anything) — authorization.clj:140-233
    authorization: str = "configfile-admins-auth"
    cors_origins: list = field(default_factory=list)
    # shared secret for the machine channel (/agents/*); empty = open
    # (permitted only in dev_mode — config validation refuses it
    # otherwise). agent_token_previous is accepted alongside during a
    # rotation window: set previous=old + token=new, roll the agents,
    # then clear previous.
    agent_token: str = ""
    agent_token_previous: str = ""

    def agent_token_ok(self, presented: str) -> bool:
        import hmac
        # bytes, not str: compare_digest raises on non-ASCII str input,
        # and the header value is attacker-controlled — a weird byte
        # must be a 401, not a TypeError-turned-500
        p = presented.encode("utf-8", "surrogateescape")
        ok = hmac.compare_digest(p, self.agent_token.encode())
        if self.agent_token_previous:
            # no short-circuit: both comparisons always run
            ok_prev = hmac.compare_digest(
                p, self.agent_token_previous.encode())
            ok = ok or ok_prev
        return ok


def authenticate(cfg: AuthConfig, headers: dict) -> str:
    """Resolve the authenticated principal for a request."""
    if cfg.scheme == "one-user":
        user = cfg.one_user
    elif cfg.scheme == "basic":
        raw = headers.get("authorization", "")
        if not raw.lower().startswith("basic "):
            raise AuthError(401, "basic auth required")
        try:
            user = base64.b64decode(raw[6:]).decode().split(":", 1)[0]
        except Exception:
            raise AuthError(401, "malformed basic auth header")
        if not user:
            raise AuthError(401, "empty username")
    elif cfg.scheme == "header":
        user = headers.get("x-cook-user", "")
        if not user:
            raise AuthError(401, "x-cook-user header required")
    else:
        raise AuthError(500, f"unknown auth scheme {cfg.scheme}")

    impersonate = headers.get("x-cook-impersonate", "")
    if impersonate:
        if user not in cfg.imposters:
            raise AuthError(403, f"user {user} may not impersonate")
        return impersonate
    return user


def is_authorized(cfg: AuthConfig, user: str, verb: str,
                  object_owner: Optional[str]) -> bool:
    """Role-based authorization (authorization.clj is-authorized-fn):
    admins do anything; otherwise a user may act on their own objects;
    reads of shared/global objects pass object_owner=None."""
    if cfg.authorization == "open-auth":
        return True
    if user in cfg.admins:
        return True
    if object_owner is None:
        # global/shared object: reads allowed, writes admin-only
        return verb in ("read", "get")
    return user == object_owner


def require_authorized(cfg: AuthConfig, user: str, verb: str,
                       object_owner: Optional[str]) -> None:
    if not is_authorized(cfg, user, verb, object_owner):
        raise AuthError(403, f"user {user} is not authorized to {verb} "
                             f"this object")


def cors_headers(cfg: AuthConfig, origin: Optional[str]) -> dict:
    if origin and (origin in cfg.cors_origins or "*" in cfg.cors_origins):
        return {
            "Access-Control-Allow-Origin": origin,
            "Access-Control-Allow-Credentials": "true",
            "Access-Control-Allow-Headers":
                "Content-Type, Authorization, X-Cook-User, "
                "X-Cook-Impersonate",
        }
    return {}
