"""`cs`-style command-line client.

Equivalent of the reference CLI (cli/cook/: cli.py, subcommands/,
querying.py federation, plugins.py).  Subcommands:

  submit   submit job(s)                    (subcommands/submit.py)
  show     show job/instance details        (subcommands/show.py)
  wait     block until jobs complete        (subcommands/wait.py)
  jobs     list your jobs by state/time     (subcommands/jobs.py)
  kill     kill jobs                        (subcommands/kill.py)
  retry    retry failed jobs                (subcommands/jobs.py retry)
  why      why is my job pending            (/unscheduled_jobs)
  usage    show cluster usage               (subcommands/usage.py)
  ls       list a job's sandbox files       (subcommands/ls.py)
  cat      print a sandbox file             (subcommands/cat.py)
  tail     tail a sandbox file              (subcommands/tail.py)
  config   get/set CLI configuration        (subcommands/config.py)

Configuration cascade (cli/README.md): --config flag, ./.cs.json,
~/.cs.json.  Multiple clusters federate: job queries try each cluster
in order until the uuid resolves (cli/cook/querying.py).

Entry point: `python -m cook_tpu_torch.cli <subcommand> ...`.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import urllib.request
from typing import Optional

from cook_tpu_torch.client import JobClient, JobClientError, JobInfo

CONFIG_PATHS = (".cs.json", os.path.expanduser("~/.cs.json"))


def load_config(path: Optional[str] = None) -> dict:
    paths = (path,) if path else CONFIG_PATHS
    for p in paths:
        if p and os.path.exists(p):
            with open(p) as f:
                cfg = json.load(f)
            # plugin modules execute arbitrary code at startup: only an
            # EXPLICIT --config or the home-dir config may name one —
            # a ./.cs.json auto-discovered from an untrusted checkout
            # must not turn `cs jobs` into code execution
            trusted = (path is not None
                       or os.path.abspath(p) == os.path.abspath(
                           CONFIG_PATHS[1]))
            # "metrics" is gated with "plugins": an untrusted checkout's
            # metrics.url/path would silently POST {command, user, ...}
            # to an attacker URL (or append to an arbitrary file) on
            # every cs invocation
            untrusted_keys = [k for k in ("plugins", "metrics")
                              if not trusted and k in cfg]
            if untrusted_keys:
                print(f"warning: ignoring {'/'.join(untrusted_keys)} from "
                      f"auto-discovered {p} (use --config to trust it)",
                      file=sys.stderr)
                cfg = {k: v for k, v in cfg.items()
                       if k not in untrusted_keys}
            return cfg
    return {}


def save_config(cfg: dict, path: Optional[str] = None) -> str:
    p = path or next((p for p in CONFIG_PATHS if os.path.exists(p)),
                     CONFIG_PATHS[1])
    with open(p, "w") as f:
        json.dump(cfg, f, indent=2)
    return p


class Federation:
    """Multi-cluster query fan-out (cli/cook/querying.py)."""

    def __init__(self, cfg: dict, url: Optional[str] = None,
                 user: Optional[str] = None):
        clusters = cfg.get("clusters") or []
        if url:
            clusters = [{"name": "cli", "url": url}]
        if not clusters:
            clusters = [{"name": "local", "url": "http://127.0.0.1:12321"}]
        user = user or cfg.get("user") or os.environ.get("USER", "root")
        self.clients = [(c["name"], JobClient(c["url"], user=user))
                        for c in clusters]

    @property
    def default(self) -> JobClient:
        return self.clients[0][1]

    def find_job(self, uuid: str) -> tuple[str, JobClient, JobInfo]:
        errors = []
        for name, client in self.clients:
            try:
                return name, client, client.query(uuid)
            except (JobClientError, OSError) as e:
                errors.append(f"{name}: {e}")
        raise SystemExit(f"job {uuid} not found on any cluster:\n  " +
                         "\n  ".join(errors))


# ---------------------------------------------------------------------------
def parse_raw_job_spec(raw_text: str, template: dict) -> list[dict]:
    """Raw-JSON job import (subcommands/submit.py parse_raw_job_spec):
    the input is one job object, a list of job objects, or
    {"jobs": [...]}; each is merged OVER the flag-built template (raw
    keys win), so `cs submit --raw --pool x < jobs.json` sets defaults
    the raw specs may override."""
    data = json.loads(raw_text)
    if isinstance(data, dict) and "jobs" in data:
        specs = data["jobs"]
    elif isinstance(data, dict):
        specs = [data]
    elif isinstance(data, list):
        specs = data
    else:
        raise SystemExit("--raw input must be a job object, a list of "
                         "jobs, or {\"jobs\": [...]}")
    out = []
    for spec in specs:
        if not isinstance(spec, dict):
            raise SystemExit("--raw jobs must be JSON objects")
        merged = {**template, **spec}
        if not merged.get("command"):
            raise SystemExit("raw job spec missing 'command'")
        out.append(merged)
    return out


def cmd_submit(fed: Federation, args, plugins=None) -> int:
    command = " ".join(args.command)
    stdin_text = None
    # touch stdin only when it is actually the input source
    needs_stdin = (args.raw == "-") or (not command and not args.raw)
    if needs_stdin:
        try:
            if not sys.stdin.isatty():
                stdin_text = sys.stdin.read().strip()
        except OSError:
            stdin_text = None
    template = {"mem": args.mem, "cpus": args.cpus, "gpus": args.gpus,
                "max_retries": args.max_retries}
    for k, v in (("name", args.name), ("priority", args.priority)):
        if v is not None:
            template[k] = v
    if args.env:
        template["env"] = dict(kv.split("=", 1) for kv in args.env)
    if args.label:
        template["labels"] = dict(kv.split("=", 1) for kv in args.label)
    if args.constraint:
        template["constraints"] = [c.split("=", 1)[0:1] + ["EQUALS"] +
                                   c.split("=", 1)[1:]
                                   for c in args.constraint]
    if args.raw:
        if args.raw == "-":
            raw_text = stdin_text
            if not raw_text:
                raise SystemExit("--raw: no JSON on stdin (pipe a job "
                                 "spec or pass --raw FILE)")
        else:
            try:
                with open(args.raw) as f:
                    raw_text = f.read()
            except OSError as e:
                raise SystemExit(f"--raw: cannot read {args.raw}: {e}")
        try:
            specs = parse_raw_job_spec(raw_text, template)
        except json.JSONDecodeError as e:
            raise SystemExit(f"--raw: malformed JSON: {e}")
    else:
        command = command or stdin_text or ""
        if not command:
            print("no command given", file=sys.stderr)
            return 1
        specs = [{**template, "command": command}]
    if plugins is not None:
        specs = [plugins.preprocess_job(s) for s in specs]
    uuids = fed.default.submit_jobs(specs, pool=args.pool)
    for u in uuids:
        print(u)
    return 0


def _fmt_ms(ms) -> str:
    if not ms:
        return "-"
    return time.strftime("%Y-%m-%d %H:%M:%S", time.localtime(ms / 1000))


def cmd_show(fed: Federation, args) -> int:
    for uuid in args.uuid:
        cluster, _, job = fed.find_job(uuid)
        if args.json:
            print(json.dumps(job.__dict__, default=lambda o: o.__dict__,
                             indent=2))
            continue
        print(f"=== Job: {job.uuid} ({job.name}) ===")
        print(f"Cluster    {cluster}")
        print(f"User       {job.user}")
        print(f"State      {job.state}")
        print(f"Pool       {job.pool or '-'}")
        print(f"Memory     {job.mem} MB")
        print(f"CPUs       {job.cpus}")
        print(f"Priority   {job.priority}")
        print(f"Attempts   {job.max_retries - job.retries_remaining} / "
              f"{job.max_retries}")
        print(f"Submitted  {_fmt_ms(job.submit_time)}")
        print(f"Command    {job.command}")
        for inst in job.instances:
            print(f"  Instance  {inst.task_id}")
            print(f"    Run Time   {_runtime(inst)}")
            print(f"    Host       {inst.hostname}")
            print(f"    Status     {inst.status}"
                  + (f" ({inst.reason_string})" if inst.reason_string
                     else ""))
            if inst.exit_code is not None:
                print(f"    Exit Code  {inst.exit_code}")
            if inst.progress:
                print(f"    Progress   {inst.progress}%"
                      + (f" ({inst.progress_message})"
                         if inst.progress_message else ""))
    return 0


def _runtime(inst) -> str:
    if not inst.start_time:
        return "-"
    end = inst.end_time or time.time() * 1000
    return f"{(end - inst.start_time) / 1000:.1f}s"


def cmd_wait(fed: Federation, args) -> int:
    rc = 0
    for uuid in args.uuid:
        _, client, job = fed.find_job(uuid)
        if not job.completed:
            try:
                job = client.wait_for_job(uuid, timeout=args.timeout)
            except TimeoutError as e:
                print(e, file=sys.stderr)
                rc = 1
                continue
        print(f"{uuid} {job.state}")
        if job.state == "failed":
            rc = 1
    return rc


def cmd_jobs(fed: Federation, args) -> int:
    lookback_ms = int(args.lookback * 3600 * 1000)
    now = int(time.time() * 1000)
    for name, client in fed.clients:
        try:
            jobs = client.list_jobs(user=args.query_user, states=args.state,
                                    start_ms=now - lookback_ms,
                                    limit=args.limit)
        except (JobClientError, OSError) as e:
            print(f"cluster {name}: {e}", file=sys.stderr)
            continue
        for j in jobs:
            print(f"{j.uuid}  {j.state:8s}  {_fmt_ms(j.submit_time)}  "
                  f"{j.name}")
    return 0


def cmd_kill(fed: Federation, args) -> int:
    for uuid in args.uuid:
        _, client, _ = fed.find_job(uuid)
        client.kill(uuid)
        print(f"killed {uuid}")
    return 0


def cmd_retry(fed: Federation, args) -> int:
    for uuid in args.uuid:
        _, client, _ = fed.find_job(uuid)
        client.retry(uuid, retries=args.retries, increment=args.increment)
        print(f"retrying {uuid}")
    return 0


def cmd_why(fed: Federation, args) -> int:
    _, client, _ = fed.find_job(args.uuid)
    for r in client.unscheduled_reasons(args.uuid):
        print(f"- {r['reason']}")
        if r.get("data"):
            print(f"    {json.dumps(r['data'])}")
    return 0


def cmd_usage(fed: Federation, args) -> int:
    for name, client in fed.clients:
        try:
            usage = client.usage(user=args.query_user)
        except (JobClientError, OSError) as e:
            print(f"cluster {name}: {e}", file=sys.stderr)
            continue
        t = usage["total_usage"]
        print(f"=== {name} ===")
        print(f"jobs {t['jobs']}  mem {t['mem']} MB  cpus {t['cpus']}  "
              f"gpus {t['gpus']}")
        for pool, p in usage.get("pools", {}).items():
            pt = p["total_usage"]
            print(f"  pool {pool}: jobs {pt['jobs']} mem {pt['mem']} "
                  f"cpus {pt['cpus']}")
    return 0


# -- sandbox file access (ls/cat/tail via the sidecar file server) ----------
def _sandbox_instance(fed: Federation, uuid: str):
    _, client, job = fed.find_job(uuid)
    insts = job.instances
    if not insts:
        raise SystemExit(f"job {uuid} has no instances")
    inst = insts[-1]
    if not inst.sandbox_directory:
        raise SystemExit(f"instance {inst.task_id} has no sandbox yet")
    return inst


def _file_server_get(inst, path: str, query: dict) -> bytes:
    """Talk to the on-host agent file server (sidecar file_server.py
    equivalent, cook_tpu/agent/file_server.py). Prefers the instance's
    recorded output_url (dynamic agent ports); falls back to the fixed
    sidecar port."""
    from urllib.parse import urlencode
    base = getattr(inst, "output_url", "") or ""
    if not base:
        host = inst.hostname
        port = int(os.environ.get("COOK_FILE_SERVER_PORT", 12322))
        base = f"http://{host}:{port}"
    url = f"{base.rstrip('/')}{path}?{urlencode(query)}"
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.read()


def cmd_ls(fed: Federation, args) -> int:
    inst = _sandbox_instance(fed, args.uuid)
    data = json.loads(_file_server_get(
        inst, "/files/browse", {"path": os.path.join(
            inst.sandbox_directory, args.path or "")}))
    for entry in data:
        print(f"{entry['mode']} {entry['size']:>10} {entry['path']}")
    return 0


def cmd_cat(fed: Federation, args) -> int:
    inst = _sandbox_instance(fed, args.uuid)
    data = _file_server_get(
        inst, "/files/download",
        {"path": os.path.join(inst.sandbox_directory, args.path)})
    sys.stdout.buffer.write(data)
    return 0


def cmd_tail(fed: Federation, args) -> int:
    inst = _sandbox_instance(fed, args.uuid)
    path = os.path.join(inst.sandbox_directory, args.path)
    # read the last `lines` lines via ranged /files/read
    meta = json.loads(_file_server_get(inst, "/files/read",
                                       {"path": path, "offset": -1}))
    size = meta["offset"]
    chunk = min(size, 64 * 1024)
    data = json.loads(_file_server_get(
        inst, "/files/read",
        {"path": path, "offset": size - chunk, "length": chunk}))["data"]
    lines = data.splitlines()[-args.lines:]
    print("\n".join(lines))
    return 0


def cmd_ssh(fed: Federation, args) -> int:
    """exec ssh to the host of the job's latest instance, landing in the
    sandbox directory (subcommands/ssh.py)."""
    _, _, job = fed.find_job(args.uuid)
    insts = sorted(job.instances, key=lambda i: i.start_time or 0)
    if not insts:
        raise SystemExit(f"job {args.uuid} has no instances yet")
    inst = insts[-1]
    if not inst.hostname:
        raise SystemExit(f"instance {inst.task_id} has no host yet")
    argv = ["ssh", "-t", inst.hostname]
    if inst.sandbox_directory:
        argv += [f"cd {inst.sandbox_directory} ; exec $SHELL -l"]
    print(" ".join(argv), file=sys.stderr)
    os.execvp("ssh", argv)


def cmd_config(cfg: dict, args) -> int:
    if args.get:
        val = cfg
        for part in args.get.split("."):
            val = val.get(part, {}) if isinstance(val, dict) else {}
        print(json.dumps(val))
    elif args.set:
        key, value = args.set
        try:
            value = json.loads(value)
        except ValueError:
            pass
        slot = cfg
        parts = key.split(".")
        for part in parts[:-1]:
            slot = slot.setdefault(part, {})
        slot[parts[-1]] = value
        path = save_config(cfg, args.config)
        print(f"wrote {path}")
    else:
        print(json.dumps(cfg, indent=2))
    return 0


# ---------------------------------------------------------------------------
def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="cs",
                                description="cook_tpu scheduler CLI")
    p.add_argument("--config", help="config file (default ./.cs.json, "
                                    "~/.cs.json)")
    p.add_argument("--url", help="scheduler URL (overrides config)")
    p.add_argument("--user", help="username (default $USER)")
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("submit", help="submit a job")
    s.add_argument("command", nargs="*")
    s.add_argument("--mem", type=float, default=128)
    s.add_argument("--cpus", type=float, default=1)
    s.add_argument("--gpus", type=float, default=0)
    s.add_argument("--name", default=None)
    s.add_argument("--priority", type=int, default=None)
    s.add_argument("--max-retries", type=int, default=1)
    s.add_argument("--pool", default=None)
    s.add_argument("--env", action="append", metavar="K=V")
    s.add_argument("--label", action="append", metavar="K=V")
    s.add_argument("--constraint", action="append", metavar="ATTR=VAL")
    s.add_argument("--raw", nargs="?", const="-", default=None,
                   metavar="FILE",
                   help="submit raw JSON job spec(s) from FILE (or "
                        "stdin); flags become defaults the raw keys "
                        "override")

    s = sub.add_parser("show", help="show jobs")
    s.add_argument("uuid", nargs="+")
    s.add_argument("--json", action="store_true")

    s = sub.add_parser("wait", help="wait for jobs to complete")
    s.add_argument("uuid", nargs="+")
    s.add_argument("--timeout", type=float, default=86400)

    s = sub.add_parser("jobs", help="list your jobs")
    s.add_argument("--state", default="waiting+running+completed")
    s.add_argument("--user", dest="query_user", default=None)
    s.add_argument("--lookback", type=float, default=6.0,
                   help="hours to look back")
    s.add_argument("--limit", type=int, default=150)

    s = sub.add_parser("kill", help="kill jobs")
    s.add_argument("uuid", nargs="+")

    s = sub.add_parser("retry", help="retry jobs")
    s.add_argument("uuid", nargs="+")
    s.add_argument("--retries", type=int, default=None)
    s.add_argument("--increment", type=int, default=None)

    s = sub.add_parser("why", help="why is my job pending")
    s.add_argument("uuid")

    s = sub.add_parser("usage", help="show usage")
    s.add_argument("--user", dest="query_user", default=None)

    s = sub.add_parser("ls", help="list sandbox files")
    s.add_argument("uuid")
    s.add_argument("path", nargs="?", default="")

    s = sub.add_parser("cat", help="print a sandbox file")
    s.add_argument("uuid")
    s.add_argument("path")

    s = sub.add_parser("tail", help="tail a sandbox file")
    s.add_argument("uuid")
    s.add_argument("path")
    s.add_argument("--lines", type=int, default=10)

    s = sub.add_parser("ssh", help="ssh to a job's latest instance host")
    s.add_argument("uuid")

    s = sub.add_parser("config", help="get/set configuration")
    s.add_argument("--get", default=None)
    s.add_argument("--set", nargs=2, metavar=("KEY", "VALUE"), default=None)
    return p


def main(argv=None) -> int:
    from cook_tpu_torch.cli.metrics import CliMetrics
    from cook_tpu_torch.cli.plugins import load_plugins

    # config must load before parsing so plugin subcommands can extend
    # the parser (SubCommandPlugin registration)
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--config", default=None)
    pre_args, _ = pre.parse_known_args(argv)
    cfg = load_config(pre_args.config)
    plugins = load_plugins(cfg)
    parser = build_parser()
    sub = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction))
    plugins.wire_parsers(sub)
    args = parser.parse_args(argv)
    metrics = CliMetrics(cfg, user=args.user or os.environ.get("USER", ""))
    metrics.start(args.cmd)
    if args.cmd == "config":
        status = cmd_config(cfg, args)
        metrics.finish(status)
        return status
    fed = Federation(cfg, url=args.url, user=args.user)
    plugin_cmd = plugins.subcommand(args.cmd)
    handler = plugin_cmd or {
        "submit": cmd_submit, "show": cmd_show, "wait": cmd_wait,
        "jobs": cmd_jobs, "kill": cmd_kill, "retry": cmd_retry,
        "why": cmd_why, "usage": cmd_usage, "ls": cmd_ls, "cat": cmd_cat,
        "tail": cmd_tail, "ssh": cmd_ssh,
    }[args.cmd]
    try:
        if handler is cmd_submit:
            status = cmd_submit(fed, args, plugins=plugins)
        else:
            status = handler(fed, args)
    except JobClientError as e:
        print(f"error: {e}", file=sys.stderr)
        status = 1
    metrics.finish(status)
    return status


if __name__ == "__main__":
    raise SystemExit(main())
