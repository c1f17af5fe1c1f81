"""Run-result cache: the serving tier's IPC backend
(reference: common/cache.py + Redis).

The wire contract is preserved verbatim: a worker publishes under
``<run_id>-results`` / ``<run_id>-finished`` / ``<run_id>-error`` and
the API tier polls those keys (simulation_thread.py:38-61,
graphql_schema.py:263-290).

Backends:
  * MemoryCache — in-process, thread-safe; the default, because unlike
    the reference's process-per-run design our workers are threads
    sharing one device client (see runner.py).
  * ShmCache   — C++ shared-memory hash map via ctypes (cpp/shmcache),
    for multi-process deployments (e.g. several gunicorn-style workers
    on one host) without a Redis dependency.
  * RedisCache — used when REDIS_URL is set and redis-py is installed.
"""
from __future__ import annotations

import os
import pickle
import threading
import time
from typing import Any, Optional


class MemoryCache:
    def __init__(self):
        self._data = {}
        self._lock = threading.Lock()

    def get(self, key: str) -> Any:
        with self._lock:
            ent = self._data.get(key)
            if ent is None:
                return None
            value, expires = ent
            if expires is not None and expires < time.monotonic():
                del self._data[key]
                return None
            return value

    def set(self, key: str, value: Any, timeout: Optional[float] = None) -> None:
        with self._lock:
            expires = time.monotonic() + timeout if timeout else None
            self._data[key] = (value, expires)

    def delete(self, key: str) -> None:
        with self._lock:
            self._data.pop(key, None)


class ShmCache:
    """Shared-memory KV store backed by the native cpp/shmcache library."""

    def __init__(self, name: str = "reina-cache", capacity_mb: int = 256):
        from .shm import ShmKV
        self._kv = ShmKV(name, capacity_mb << 20)

    def get(self, key: str) -> Any:
        raw = self._kv.get(key.encode())
        if raw is None:
            return None
        return pickle.loads(raw)

    def set(self, key: str, value: Any, timeout: Optional[float] = None) -> None:
        self._kv.set(key.encode(), pickle.dumps(value, protocol=4),
                     ttl=timeout or 0.0)

    def delete(self, key: str) -> None:
        self._kv.delete(key.encode())


class RedisCache:
    def __init__(self, url: str):
        import redis
        self._r = redis.Redis.from_url(url)

    def get(self, key: str) -> Any:
        raw = self._r.get(key)
        return pickle.loads(raw) if raw is not None else None

    def set(self, key: str, value: Any, timeout: Optional[float] = None) -> None:
        self._r.set(key, pickle.dumps(value, protocol=4),
                    ex=int(timeout) if timeout else None)

    def delete(self, key: str) -> None:
        self._r.delete(key)


_backend = None


def init_backend(kind: Optional[str] = None):
    """Select the backend: REINA_CACHE=memory|shm|redis (or REDIS_URL)."""
    global _backend
    kind = kind or os.environ.get("REINA_CACHE", "")
    if not kind:
        kind = "redis" if os.environ.get("REDIS_URL") else "memory"
    if kind == "redis":
        _backend = RedisCache(os.environ["REDIS_URL"])
    elif kind == "shm":
        _backend = ShmCache()
    else:
        _backend = MemoryCache()
    return _backend


def backend():
    global _backend
    if _backend is None:
        init_backend()
    return _backend


def get(key: str) -> Any:
    return backend().get(key)


def set(key: str, value: Any, timeout: Optional[float] = None) -> None:  # noqa: A001
    backend().set(key, value, timeout)


def delete(key: str) -> None:
    backend().delete(key)
