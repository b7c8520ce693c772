"""Task executor: run one job command in a sandbox.

Equivalent of the reference executor (executor/cook/executor.py:421
CookExecutor + subprocess.py + io_helper.py + progress.py):

  - launches the command in its own process group (subprocess.py:15) so
    a kill reaps the whole tree;
  - streams stdout/stderr into sandbox files `stdout` / `stderr`;
  - watches output + an optional progress file for progress-regex
    matches, emitting monotonically-sequenced progress updates
    (progress.py:123 ProgressWatcher — first capture group = percent,
    optional second = message);
  - emits heartbeats while the process lives (executor heartbeats,
    mesos/heartbeat.clj consumer side);
  - graceful kill: SIGTERM, grace period, then SIGKILL to the group
    (subprocess.py:203).

Callbacks make it embeddable: backends/local.py runs one Executor per
task in-process; a standalone agent would wrap the same class.
"""
from __future__ import annotations

import os
import re
import signal
import subprocess
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

DEFAULT_PROGRESS_REGEX = r"progress:?\s+(\d+)(?:\s+(.*))?"
MAX_MESSAGE_LENGTH = 512


def fetch_uri(uri: dict, sandbox: str) -> str:
    """Fetch one FetchableURI into the sandbox (the mesos fetcher's
    role for :job/uris — value/extract/executable; cache is accepted
    but a no-op here). file:// and bare paths copy; http(s) downloads.
    Returns the destination path; raises OSError on failure."""
    import shutil
    import tarfile
    import urllib.parse
    import urllib.request
    import zipfile

    if not isinstance(uri, dict):
        raise OSError(f"malformed uri entry {uri!r} (expected an object "
                      "with a 'value' key)")
    value = uri.get("value") or ""
    if not isinstance(value, str) or not value:
        raise OSError("uri without value")
    parsed = urllib.parse.urlparse(value)
    name = os.path.basename(parsed.path or value) or "download"
    dest = os.path.join(sandbox, name)
    try:
        if parsed.scheme in ("http", "https"):
            with urllib.request.urlopen(value, timeout=60) as r, \
                    open(dest, "wb") as f:
                shutil.copyfileobj(r, f)
        else:
            src = parsed.path if parsed.scheme == "file" else value
            shutil.copy(src, dest)
    except Exception as e:
        raise OSError(f"fetch failed for {value}: {e}") from e
    if uri.get("executable"):
        os.chmod(dest, os.stat(dest).st_mode | 0o755)
    if uri.get("extract"):
        # sniff content, not extensions: tarfile handles gz/bz2/xz
        # transparently, and an unextractable archive must FAIL, not
        # silently no-op into a later file-not-found
        try:
            if tarfile.is_tarfile(dest):
                with tarfile.open(dest) as t:
                    t.extractall(sandbox, filter="data")
            elif zipfile.is_zipfile(dest):
                with zipfile.ZipFile(dest) as z:
                    z.extractall(sandbox)
            else:
                raise OSError(f"{name} is not a tar or zip archive")
        except OSError:
            raise
        except Exception as e:
            raise OSError(f"extract failed for {value}: {e}") from e
    return dest


@dataclass
class TaskHandle:
    task_id: str
    sandbox: str
    proc: Optional[subprocess.Popen] = None   # None while fetching uris
    threads: list = field(default_factory=list)
    killed: bool = False
    done: bool = False


class Executor:
    """Runs tasks; reports through callbacks.

    on_status(task_id, event, info): event in {"running", "exited",
    "killed"}; info carries exit_code/sandbox.
    on_progress(task_id, sequence, percent, message)
    on_heartbeat(task_id)
    """

    def __init__(self, sandbox_root: str,
                 on_status: Callable[[str, str, dict], None],
                 on_progress: Optional[Callable] = None,
                 on_heartbeat: Optional[Callable] = None,
                 heartbeat_interval_s: float = 15.0,
                 kill_grace_period_s: float = 2.0):
        self.sandbox_root = sandbox_root
        self.on_status = on_status
        self.on_progress = on_progress or (lambda *a: None)
        self.on_heartbeat = on_heartbeat or (lambda *a: None)
        self.heartbeat_interval_s = heartbeat_interval_s
        self.kill_grace_period_s = kill_grace_period_s
        self.tasks: dict[str, TaskHandle] = {}
        self._lock = threading.Lock()

    # ------------------------------------------------------------------
    def launch(self, task_id: str, command: str,
               env: Optional[dict] = None,
               progress_regex: str = "",
               progress_output_file: str = "",
               uris: Optional[list] = None) -> str:
        """Start the task; returns the sandbox directory.

        uris: [{"value": path-or-url, "extract": bool, "executable":
        bool, "cache": bool}] fetched into the sandbox before the
        command starts. Fetching happens on the task's own thread (the
        mesos fetcher runs async on the agent — a slow download must
        never stall the caller's match loop); a fetch failure emits a
        "fetch_failed" status so the backend can fail the task with
        container-launch-failed."""
        sandbox = os.path.join(self.sandbox_root, task_id)
        os.makedirs(sandbox, exist_ok=True)
        handle = TaskHandle(task_id=task_id, sandbox=sandbox)
        with self._lock:
            self.tasks[task_id] = handle
        t0 = threading.Thread(
            target=self._fetch_and_start,
            args=(handle, command, env, progress_regex,
                  progress_output_file, list(uris or [])),
            daemon=True)
        # register before start(): the thread appends its worker threads
        # to handle.threads, which this assignment would otherwise race
        handle.threads = [t0]
        t0.start()
        return sandbox

    def _fetch_and_start(self, handle: TaskHandle, command, env,
                         progress_regex, progress_output_file,
                         uris) -> None:
        task_id, sandbox = handle.task_id, handle.sandbox
        try:
            for uri in uris:
                if handle.killed:
                    break
                fetch_uri(uri, sandbox)
        except OSError as e:
            with self._lock:
                self.tasks.pop(task_id, None)
            handle.done = True
            self.on_status(task_id, "fetch_failed",
                           {"sandbox": sandbox, "error": str(e)})
            return
        if handle.killed:
            with self._lock:
                self.tasks.pop(task_id, None)
            handle.done = True
            self.on_status(task_id, "killed",
                           {"sandbox": sandbox, "exit_code": None})
            return

        stdout = open(os.path.join(sandbox, "stdout"), "wb")
        stderr = open(os.path.join(sandbox, "stderr"), "wb")
        full_env = {**os.environ, **(env or {}),
                    "COOK_TASK_ID": task_id,
                    "COOK_SANDBOX": sandbox}
        proc = subprocess.Popen(
            ["/bin/sh", "-c", command], cwd=sandbox, env=full_env,
            stdout=stdout, stderr=stderr,
            start_new_session=True)  # own process group
        stdout.close()
        stderr.close()
        handle.proc = proc
        self.on_status(task_id, "running", {"sandbox": sandbox})
        if handle.killed:      # kill arrived during Popen
            self._kill_group(handle)

        watcher_files = [os.path.join(sandbox, "stdout")]
        if progress_output_file:
            watcher_files.append(os.path.join(sandbox, progress_output_file))
        regex = progress_regex or DEFAULT_PROGRESS_REGEX
        t1 = threading.Thread(
            target=self._watch_progress,
            args=(handle, watcher_files, regex), daemon=True)
        t2 = threading.Thread(target=self._heartbeat_loop, args=(handle,),
                              daemon=True)
        t3 = threading.Thread(target=self._reap, args=(handle,), daemon=True)
        for t in (t1, t2, t3):
            t.start()
        handle.threads += [t1, t2, t3]

    def kill(self, task_id: str) -> None:
        """Graceful then forced kill of the whole process group. A task
        still fetching uris is flagged; its launch thread aborts."""
        with self._lock:
            handle = self.tasks.get(task_id)
        if handle is None:
            return
        handle.killed = True
        if handle.proc is not None:
            self._kill_group(handle)

    def _kill_group(self, handle: TaskHandle) -> None:
        try:
            pgid = os.getpgid(handle.proc.pid)
            os.killpg(pgid, signal.SIGTERM)
        except (ProcessLookupError, PermissionError):
            return
        deadline = time.monotonic() + self.kill_grace_period_s
        while time.monotonic() < deadline:
            if handle.proc.poll() is not None:
                return
            time.sleep(0.05)
        try:
            os.killpg(pgid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass

    def alive_task_ids(self) -> set[str]:
        with self._lock:
            return {tid for tid, h in self.tasks.items()
                    if h.proc is None or h.proc.poll() is None}

    # ------------------------------------------------------------------
    def _reap(self, handle: TaskHandle) -> None:
        exit_code = handle.proc.wait()
        with self._lock:
            self.tasks.pop(handle.task_id, None)
        event = "killed" if handle.killed else "exited"
        self.on_status(handle.task_id, event,
                       {"exit_code": exit_code, "sandbox": handle.sandbox})

    def _heartbeat_loop(self, handle: TaskHandle) -> None:
        while handle.proc.poll() is None:
            self.on_heartbeat(handle.task_id)
            time.sleep(self.heartbeat_interval_s)

    def _watch_progress(self, handle: TaskHandle, paths: list[str],
                        regex: str) -> None:
        """tail -f each file, scanning lines for the progress regex
        (ProgressWatcher.tail + match_progress_update)."""
        try:
            pattern = re.compile(regex)
        except re.error:
            return
        offsets = {p: 0 for p in paths}
        sequence = 0
        while True:
            running = handle.proc.poll() is None
            for path in paths:
                try:
                    with open(path, "r", errors="replace") as f:
                        f.seek(offsets[path])
                        while True:
                            line = f.readline()
                            if not line:
                                break
                            if not line.endswith("\n") and running:
                                break  # partial line; retry next tick
                            offsets[path] = f.tell()
                            m = pattern.search(line)
                            if not m:
                                continue
                            try:
                                percent = int(m.group(1))
                            except (ValueError, IndexError):
                                continue
                            if not 0 <= percent <= 100:
                                continue
                            message = ""
                            if m.lastindex and m.lastindex >= 2:
                                message = (m.group(2) or "").strip()
                            if len(message) > MAX_MESSAGE_LENGTH:
                                message = message[:MAX_MESSAGE_LENGTH - 3] \
                                    + "..."
                            sequence += 1
                            self.on_progress(handle.task_id, sequence,
                                             percent, message)
                except OSError:
                    pass
            if not running:
                return
            time.sleep(0.1)
