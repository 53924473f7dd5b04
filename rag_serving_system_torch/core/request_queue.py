"""Request queues: in-memory and Redis backends.

A copy of `rag_serving_system_tpu/core/request_queue.py`, with its
duck-typed contract:

- `add_request(query, k, max_new_tokens=None) -> request_id`
- `add_request_with_id(request_id, query, k, max_new_tokens=None)` (the
  native HTTP front mints its own ids)
- `get_batch() -> list[{"id", "query", "k", "timestamp"}]` (size-bounded
  by max_batch_size; time-bounded by max_wait_time once one item is held)
- `store_result(request_id, result)`
- `get_result(request_id, timeout) -> result | None` (consume-once)

The Redis wire contract is the JAX package's: list key
`rag_service:requests` with JSON `{id, query, k, timestamp}` items, results
at `rag_service:result:<id>` with a 3600 s TTL.
"""

from __future__ import annotations

import collections
import json
import logging
import queue
import threading
import time
import uuid
from typing import Any, Optional

logger = logging.getLogger(__name__)


class RequestQueue:
    """Thread-safe in-memory FIFO + result store (single-replica mode).
    Results signal waiters through per-request `threading.Event`s."""

    RESULT_TTL_S = 3600  # the Redis backend's SETEX TTL

    def __init__(self, max_batch_size: int = 32, max_wait_time: float = 1.0,
                 polling_interval: float = 0.1, result_ttl_s: float | None = None):
        self.queue: "queue.Queue[dict]" = queue.Queue()
        self._pending_ts: "collections.deque[float]" = collections.deque()
        self.max_batch_size = max_batch_size
        self.max_wait_time = max_wait_time
        self.polling_interval = polling_interval
        self.result_ttl_s = result_ttl_s if result_ttl_s is not None else self.RESULT_TTL_S
        self._lock = threading.Lock()
        self._results: dict[str, tuple[float, Any]] = {}  # id → (stored_at, result)
        self._events: dict[str, threading.Event] = {}
        self._callbacks: dict[str, list] = {}  # id → notification callbacks
        self._stores_since_sweep = 0

    def add_request(self, query: str, k: int = 2,
                    max_new_tokens: int | None = None) -> str:
        return self.add_request_with_id(str(uuid.uuid4()), query, k, max_new_tokens)

    def add_request_with_id(self, request_id: str, query: str, k: int = 2,
                            max_new_tokens: int | None = None) -> str:
        """Enqueue under a caller-assigned id (the native front's, minted on
        its epoll thread)."""
        ts = time.time()
        # enqueue timestamps, so oldest_wait_time() can peek; appended before
        # put so a racing consumer always finds one to pop
        self._pending_ts.append(ts)
        item = {"id": request_id, "query": query, "k": k, "timestamp": ts}
        if max_new_tokens is not None:
            item["max_new_tokens"] = max_new_tokens
        self.queue.put(item)
        return request_id

    def get_batch(self) -> list:
        """Blocks up to max_wait_time once an item is held; returns as soon as
        the batch is full. Empty list if nothing arrived."""
        batch: list[dict] = []
        start = time.time()
        while len(batch) < self.max_batch_size:
            elapsed = time.time() - start
            if elapsed >= self.max_wait_time and batch:
                break
            try:
                item = self.queue.get(timeout=max(0.05, self.max_wait_time - elapsed))
                batch.append(item)
                self.queue.task_done()
                try:
                    self._pending_ts.popleft()
                except IndexError:
                    pass
            except queue.Empty:
                break
        return batch

    def _sweep_expired_locked(self) -> None:
        """Drop results abandoned by clients (the Redis TTL's counterpart);
        runs every 256 stores."""
        cutoff = time.time() - self.result_ttl_s
        expired = [rid for rid, (ts, _) in self._results.items() if ts < cutoff]
        for rid in expired:
            del self._results[rid]

    def store_result(self, request_id: str, result: Any) -> None:
        with self._lock:
            self._results[request_id] = (time.time(), result)
            ev = self._events.pop(request_id, None)
            cbs = self._callbacks.pop(request_id, ())
            self._stores_since_sweep += 1
            if self._stores_since_sweep >= 256:
                self._stores_since_sweep = 0
                self._sweep_expired_locked()
        if ev is not None:
            ev.set()
        for cb in cbs:  # outside the lock: callbacks may do arbitrary work
            try:
                cb()
            except Exception:  # a dead waiter must not break delivery to others
                logger.exception("result callback failed for %s", request_id)

    def _pop_locked(self, request_id: str) -> Optional[Any]:
        entry = self._results.pop(request_id, None)
        return entry[1] if entry is not None else None

    def get_result(self, request_id: str, timeout: float = 30) -> Optional[Any]:
        with self._lock:
            if request_id in self._results:
                return self._pop_locked(request_id)
            if timeout <= 0:
                return None
            ev = self._events.setdefault(request_id, threading.Event())
        if not ev.wait(timeout):
            with self._lock:
                # drop the event of a request nobody will answer
                if self._events.get(request_id) is ev and request_id not in self._results:
                    self._events.pop(request_id, None)
                return self._pop_locked(request_id)
        with self._lock:
            return self._pop_locked(request_id)

    # The HTTP long-poll's notification: the callback consumes nothing; the
    # waiter pops the result with get_result(id, timeout=0) when notified.

    def add_result_callback(self, request_id: str, cb) -> Optional[Any]:
        """Pop and return the result if it is stored; else register `cb`, to
        be called from the processor thread when it is, and return None."""
        with self._lock:
            if request_id in self._results:
                return self._pop_locked(request_id)
            self._callbacks.setdefault(request_id, []).append(cb)
            return None

    def cancel_result_callback(self, request_id: str, cb) -> None:
        with self._lock:
            lst = self._callbacks.get(request_id)
            if lst is not None:
                try:
                    lst.remove(cb)
                except ValueError:
                    pass
                if not lst:
                    del self._callbacks[request_id]

    def queue_size(self) -> int:
        return self.queue.qsize()

    def oldest_wait_time(self) -> float:
        """Wait of the oldest queued request (a metrics gauge, approximate
        under concurrent dequeue)."""
        try:
            return max(0.0, time.time() - self._pending_ts[0])
        except IndexError:
            return 0.0


class RedisRequestQueue:
    """Redis-backed distributed queue (multi-replica mode), on the JAX
    package's keys and payloads."""

    QUEUE_KEY = "rag_service:requests"
    RESULT_PREFIX = "rag_service:result:"
    RESULT_TTL_S = 3600

    def __init__(self, redis_url: str = "redis://localhost:6379/0",
                 max_batch_size: int = 32, max_wait_time: float = 1.0,
                 polling_interval: float = 0.1, client=None):
        if client is not None:
            self.redis = client  # injection point for tests
        else:
            # redis-py when installed, else the port's RESP client
            from rag_serving_system_torch.utils.resp import client_from_url
            self.redis = client_from_url(redis_url)
        self.max_batch_size = max_batch_size
        self.max_wait_time = max_wait_time
        self.polling_interval = polling_interval

    def add_request(self, query: str, k: int = 2,
                    max_new_tokens: int | None = None) -> str:
        return self.add_request_with_id(str(uuid.uuid4()), query, k, max_new_tokens)

    def add_request_with_id(self, request_id: str, query: str, k: int = 2,
                            max_new_tokens: int | None = None) -> str:
        item = {"id": request_id, "query": query, "k": k, "timestamp": time.time()}
        if max_new_tokens is not None:
            item["max_new_tokens"] = max_new_tokens  # absent by default
        self.redis.rpush(self.QUEUE_KEY, json.dumps(item))
        return request_id

    def get_batch(self) -> list:
        batch: list[dict] = []
        start = time.time()
        while len(batch) < self.max_batch_size:
            if time.time() - start >= self.max_wait_time and batch:
                break
            # everything already queued, in one round trip
            want = self.max_batch_size - len(batch)
            pipe = self.redis.pipeline()
            for _ in range(want):
                pipe.lpop(self.QUEUE_KEY)
            got = [g for g in pipe.execute() if g]
            batch.extend(json.loads(g) for g in got)
            if len(batch) >= self.max_batch_size:
                break
            if not got:
                if batch:
                    break
                item = self.redis.blpop(self.QUEUE_KEY, timeout=0.1)
                if item:
                    batch.append(json.loads(item[1]))
                elif time.time() - start >= self.max_wait_time:
                    break
        return batch

    def store_result(self, request_id: str, result: Any) -> None:
        self.redis.setex(self.RESULT_PREFIX + request_id, self.RESULT_TTL_S,
                         json.dumps(result))

    def get_result(self, request_id: str, timeout: float = 30) -> Optional[Any]:
        key = self.RESULT_PREFIX + request_id
        start = time.time()
        while True:
            raw = self.redis.get(key)
            if raw:
                self.redis.delete(key)
                return json.loads(raw)
            if time.time() - start >= timeout:
                return None
            time.sleep(self.polling_interval)

    def queue_size(self) -> int:
        return int(self.redis.llen(self.QUEUE_KEY))

    def oldest_wait_time(self) -> float:
        oldest = self.redis.lindex(self.QUEUE_KEY, 0)
        if not oldest:
            return 0.0
        try:
            ts = json.loads(oldest).get("timestamp")
            return max(0.0, time.time() - ts) if ts else 0.0
        except Exception:
            return 0.0


def make_queue(settings) -> "RequestQueue | RedisRequestQueue":
    """Redis iff REDIS_URL is set, else in memory."""
    kwargs = dict(max_batch_size=settings.max_batch_size,
                  max_wait_time=settings.max_wait_time,
                  polling_interval=min(settings.polling_interval, 0.1))
    if settings.redis_url:
        return RedisRequestQueue(settings.redis_url, **kwargs)
    return RequestQueue(**kwargs)
