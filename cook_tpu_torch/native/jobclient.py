"""ctypes binding for the native C++ job client (jobclient.cpp).

The typed second-client role (the reference's Java jobclient,
JobClient.java:97-827) — a self-contained C++ library speaking the REST
wire format over POSIX sockets. This binding exists for tests and for
Python embedders that want the native transport; C++ programs link the
library and use cook::JobClient directly.
"""
from __future__ import annotations

import ctypes
import json
from typing import Optional

from cook_tpu_torch import native as _native

_lib = None
_lib_failed = False


def _load():
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    so = _native.build("jobclient")
    if so is None:
        _lib_failed = True
        return None
    lib = ctypes.CDLL(so)
    lib.cook_client_new.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                    ctypes.c_char_p, ctypes.c_int]
    lib.cook_client_new.restype = ctypes.c_void_p
    lib.cook_client_free.argtypes = [ctypes.c_void_p]
    lib.cook_last_error.argtypes = [ctypes.c_void_p]
    lib.cook_last_error.restype = ctypes.c_char_p
    lib.cook_free_str.argtypes = [ctypes.c_void_p]
    for fn in ("cook_submit_json", "cook_query_json", "cook_job_state",
               "cook_wait_for_job", "cook_submit"):
        getattr(lib, fn).restype = ctypes.c_void_p  # malloc'd char*
    lib.cook_submit_json.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                     ctypes.c_char_p]
    lib.cook_submit.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                ctypes.c_double, ctypes.c_double,
                                ctypes.c_double, ctypes.c_int,
                                ctypes.c_char_p, ctypes.c_char_p]
    lib.cook_query_json.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.cook_job_state.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.cook_wait_for_job.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                      ctypes.c_int, ctypes.c_int]
    lib.cook_kill.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.cook_kill.restype = ctypes.c_int
    lib.cook_retry.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                               ctypes.c_int]
    lib.cook_retry.restype = ctypes.c_int
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


class NativeClientError(RuntimeError):
    pass


class NativeJobClient:
    """Thin typed wrapper over the C ABI."""

    def __init__(self, host: str, port: int, user: str,
                 timeout_ms: int = 30000):
        lib = _load()
        if lib is None:
            raise NativeClientError("native jobclient unavailable "
                                    "(g++ build failed)")
        self._lib = lib
        self._h = lib.cook_client_new(host.encode(), port, user.encode(),
                                      timeout_ms)

    def close(self):
        if self._h:
            self._lib.cook_client_free(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _err(self) -> str:
        return self._lib.cook_last_error(self._h).decode(errors="replace")

    def _take_str(self, raw) -> str:
        if not raw:
            raise NativeClientError(self._err())
        try:
            return ctypes.string_at(raw).decode()
        finally:
            self._lib.cook_free_str(raw)

    def submit(self, command: str, mem: float = 128.0, cpus: float = 1.0,
               gpus: float = 0.0, max_retries: int = 1,
               name: str = "", pool: str = "") -> str:
        return self._take_str(self._lib.cook_submit(
            self._h, command.encode(), mem, cpus, gpus, max_retries,
            name.encode(), pool.encode()))

    def submit_spec(self, spec: dict, pool: str = "") -> str:
        return self._take_str(self._lib.cook_submit_json(
            self._h, json.dumps(spec).encode(), pool.encode()))

    def query(self, uuid: str) -> dict:
        return json.loads(self._take_str(
            self._lib.cook_query_json(self._h, uuid.encode())))

    def job_state(self, uuid: str) -> tuple[str, str]:
        status, state = self._take_str(
            self._lib.cook_job_state(self._h, uuid.encode())).split(" ", 1)
        return status, state

    def kill(self, uuid: str) -> None:
        if self._lib.cook_kill(self._h, uuid.encode()) != 0:
            raise NativeClientError(self._err())

    def retry(self, uuid: str, retries: int) -> None:
        if self._lib.cook_retry(self._h, uuid.encode(), retries) != 0:
            raise NativeClientError(self._err())

    def wait_for_job(self, uuid: str, timeout_ms: int = 300000,
                     poll_ms: int = 1000) -> dict:
        return json.loads(self._take_str(self._lib.cook_wait_for_job(
            self._h, uuid.encode(), timeout_ms, poll_ms)))
