"""CLI plugin hooks (cli/cook/plugins.py equivalent).

The reference CLI resolves named plugin functions from the config and
invokes them at fixed extension points (SubCommandPlugin registration,
job-spec preprocessing). Here a config entry

    {"plugins": {"module": "my_site_plugins"}}

names an importable module; at startup its ``register(registry)``
function is called with a PluginRegistry. Plugins attach callables to
the supported hook points:

  submit-job-preprocess   fn(job_spec: dict) -> dict
      runs over every job spec before it is POSTed (both flag-built and
      --raw specs) — the site hook for injecting labels, pools, or
      defaults.
  job-annotate            fn(job: dict) -> None
      runs over every job dict fetched by show/jobs before rendering.
  subcommand:<name>       fn(fed, args) -> int
      adds a whole subcommand (reference SubCommandPlugin); argparse
      wiring is the plugin's own business via register_parser.
"""
from __future__ import annotations

import importlib
import logging
from typing import Callable, Optional

log = logging.getLogger(__name__)


class PluginRegistry:
    def __init__(self):
        self._hooks: dict[str, list[Callable]] = {}
        self._parsers: list[Callable] = []

    def add_hook(self, point: str, fn: Callable) -> None:
        self._hooks.setdefault(point, []).append(fn)

    def register_parser(self, fn: Callable) -> None:
        """fn(subparsers) -> None: add plugin subcommands to argparse."""
        self._parsers.append(fn)

    # -- invocation ----------------------------------------------------
    def preprocess_job(self, spec: dict) -> dict:
        for fn in self._hooks.get("submit-job-preprocess", ()):
            spec = fn(spec) or spec
        return spec

    def annotate_job(self, job: dict) -> None:
        for fn in self._hooks.get("job-annotate", ()):
            try:
                fn(job)
            except Exception:
                log.exception("job-annotate plugin failed")

    def subcommand(self, name: str) -> Optional[Callable]:
        hooks = self._hooks.get(f"subcommand:{name}")
        return hooks[0] if hooks else None

    def wire_parsers(self, subparsers) -> None:
        for fn in self._parsers:
            try:
                fn(subparsers)
            except Exception:
                log.exception("plugin parser registration failed")


def load_plugins(cfg: dict) -> PluginRegistry:
    reg = PluginRegistry()
    module = (cfg.get("plugins") or {}).get("module")
    if module:
        try:
            mod = importlib.import_module(module)
            mod.register(reg)
        except Exception:
            log.exception("failed to load CLI plugin module %s", module)
    return reg
