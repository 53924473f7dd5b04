"""HTTP surface on aiohttp.

A copy of `rag_serving_system_tpu/api/endpoints.py`. When the native C++
front (`api/native_front.py`) serves beside it, its counters appear in
/metrics (`rag_native_front`) and /stats (`native_front`):

- POST /rag                → {"request_id", "status": "processing"}
                             (?wait=SECONDS returns the completed result)
- GET  /rag/result/{id}    → {"status": "processing"} | {"status": "complete", "result": ...}
- GET  /health             → {"status": "healthy"}
- GET  /metrics            → Prometheus text
- GET  /stats              → queue, batch and stage counters as JSON

Malformed bodies get HTTP 422 with the validation errors.
"""

from __future__ import annotations

import asyncio
import os
import threading
from concurrent.futures import ThreadPoolExecutor

from aiohttp import web
from prometheus_client import CollectorRegistry, Counter, Gauge, generate_latest
from pydantic import ValidationError

from rag_serving_system_torch.api.models import QueryRequest


def create_api(request_queue, processor=None, engine=None,
               max_queue_size: int = 0) -> web.Application:
    """max_queue_size > 0 enables backpressure: POST /rag returns 503 once the
    queue holds that many requests."""
    app = web.Application()
    registry = CollectorRegistry()
    queue_size_g = Gauge("rag_queue_size", "Number of requests in queue",
                         registry=registry)
    queue_wait_g = Gauge("rag_queue_wait_time", "Oldest-request wait time (seconds)",
                         registry=registry)
    batch_seconds_g = Gauge("rag_last_batch_seconds", "Wall time of the last batch",
                            registry=registry)
    requests_total_c = Counter("rag_requests_total", "Requests accepted",
                               registry=registry)
    rejected_total_c = Counter("rag_requests_rejected_total",
                               "Requests rejected by backpressure",
                               registry=registry)
    stage_g = Gauge("rag_stage_seconds", "Mean seconds per pipeline stage",
                    ["stage"], registry=registry)
    # the native front counts its accepts and rejects in C (its requests
    # never touch the counters above): exported at scrape time
    front_g = Gauge("rag_native_front", "Native front counters",
                    ["counter"], registry=registry)
    front = getattr(request_queue, "_front", None)   # FrontQueue proxy

    async def rag_endpoint(request: web.Request) -> web.Response:
        try:
            payload = QueryRequest.model_validate(await request.json())
        except (ValidationError, ValueError) as e:
            detail = e.errors() if isinstance(e, ValidationError) else str(e)
            return web.json_response({"detail": detail}, status=422)
        if max_queue_size and request_queue.queue_size() >= max_queue_size:
            rejected_total_c.inc()
            return web.json_response(
                {"detail": "queue full", "status": "rejected"}, status=503)
        request_id = request_queue.add_request(payload.query, payload.k,
                                               payload.max_new_tokens)
        requests_total_c.inc()
        # POST /rag?wait=SECONDS holds the connection and returns the
        # completed result in the same exchange; wait=0 (the default) keeps
        # the submit-then-poll protocol
        try:
            wait = min(float(request.query.get("wait", 0)), 30.0)
        except ValueError:
            wait = 0.0
        if wait > 0:
            result = await _await_result(request_id, wait)
            if result is not None:
                return web.json_response(
                    {"request_id": request_id, "status": "complete",
                     "result": result})
        return web.json_response({"request_id": request_id, "status": "processing"})

    # in-memory backend: push notification, no thread held per waiter
    supports_push = hasattr(request_queue, "add_result_callback")
    # Redis get_result holds a thread per poll: a wide pool of its own, and
    # long waits capped below its size (beyond the cap a wait degrades to a
    # quick poll)
    poll_pool = None if supports_push else ThreadPoolExecutor(
        max_workers=256, thread_name_prefix="result-poll")
    long_wait_gate = None if supports_push else asyncio.Semaphore(192)

    async def _await_result(request_id: str, timeout: float):
        if supports_push:
            loop = asyncio.get_running_loop()
            fut: asyncio.Future = loop.create_future()
            # runs on the processor thread: hop back to the event loop
            cb = lambda: loop.call_soon_threadsafe(  # noqa: E731
                lambda: fut.done() or fut.set_result(True))
            result = request_queue.add_result_callback(request_id, cb)
            if result is None:
                try:
                    await asyncio.wait_for(fut, timeout)
                except asyncio.TimeoutError:
                    pass
                finally:
                    # needed on timeout and on client-disconnect cancellation
                    request_queue.cancel_result_callback(request_id, cb)
                result = request_queue.get_result(request_id, timeout=0)
            return result
        if timeout > 0.5:
            if long_wait_gate.locked():
                timeout = 0.1
            else:
                async with long_wait_gate:
                    return await asyncio.get_event_loop().run_in_executor(
                        poll_pool,
                        lambda: request_queue.get_result(request_id, timeout))
        return await asyncio.get_event_loop().run_in_executor(
            poll_pool, lambda: request_queue.get_result(request_id, timeout))

    async def get_result(request: web.Request) -> web.Response:
        request_id = request.match_info["request_id"]
        # optional server-side long-poll (?timeout=SECONDS, capped at 30)
        try:
            timeout = min(float(request.query.get("timeout", 0.1)), 30.0)
        except ValueError:
            timeout = 0.1
        result = await _await_result(request_id, timeout)
        if result is None:
            return web.json_response({"status": "processing"})
        return web.json_response({"status": "complete", "result": result})

    async def health_check(_: web.Request) -> web.Response:
        return web.json_response({"status": "healthy"})

    async def metrics(_: web.Request) -> web.Response:
        queue_size_g.set(request_queue.queue_size())
        queue_wait_g.set(request_queue.oldest_wait_time())
        if processor is not None:
            batch_seconds_g.set(processor.last_batch_seconds)
        if engine is not None:
            for stage, s in engine.timer.summary().items():
                stage_g.labels(stage=stage).set(s["mean_s"])
        if front is not None:
            for name, v in front.stats().items():
                if name != "port":
                    front_g.labels(counter=name).set(v)
        return web.Response(body=generate_latest(registry),
                            content_type="text/plain")

    async def stats(_: web.Request) -> web.Response:
        body = {
            "queue_size": request_queue.queue_size(),
            "queue_wait_s": request_queue.oldest_wait_time(),
        }
        if processor is not None:
            body["batches_processed"] = processor.batches_processed
            body["requests_processed"] = processor.requests_processed
            body["last_batch_seconds"] = processor.last_batch_seconds
            # pipeline depth: batches prepared by the stage-1 workers that
            # await generation, and generated batches that await the
            # finalize worker
            body["ready_backlog"] = processor.ready_backlog
            body["finalize_backlog"] = processor.finalize_backlog
        if engine is not None:
            body["stages"] = engine.timer.summary()
            qstats = engine.query_cache_stats()
            if qstats is not None:
                body["query_cache"] = qstats
            if engine.prefix_cache is not None:
                body["prefix_cache"] = engine.prefix_cache.stats()
            if getattr(engine, "decode_pool", None) is not None:
                body["decode_pool"] = engine.decode_pool.stats()
        if front is not None:
            body["native_front"] = front.stats()
        return web.json_response(body)

    app.router.add_post("/rag", rag_endpoint)
    app.router.add_get("/rag/result/{request_id}", get_result)
    app.router.add_get("/health", health_check)
    app.router.add_get("/metrics", metrics)
    app.router.add_get("/stats", stats)
    return app


def run_app(app: web.Application, host: str, port: int,
            access_log: bool = False, reuse_port: bool = False) -> None:
    """Blocking server run. Per-request access logging is off unless
    access_log or ACCESS_LOG=1 asks for it; `reuse_port` (SO_REUSEPORT) lets
    several processes share one port."""
    kw = dict(print=None, reuse_port=reuse_port or None)
    if not access_log and os.environ.get("ACCESS_LOG", "0") not in ("1", "true"):
        kw["access_log"] = None
    web.run_app(app, host=host, port=port, **kw)


class ServerThread:
    """Run the aiohttp app on a background thread (tests, embedding)."""

    def __init__(self, app: web.Application, host: str = "127.0.0.1", port: int = 0):
        self.app = app
        self.host = host
        self.port = port
        self._loop = asyncio.new_event_loop()
        self._started = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self) -> None:
        asyncio.set_event_loop(self._loop)
        runner = web.AppRunner(self.app)
        self._loop.run_until_complete(runner.setup())
        site = web.TCPSite(runner, self.host, self.port)
        self._loop.run_until_complete(site.start())
        self.port = runner.addresses[0][1]  # the bound port when port=0
        self._started.set()
        self._loop.run_forever()

    def start(self) -> "ServerThread":
        self._thread.start()
        self._started.wait(timeout=30)
        return self

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def stop(self) -> None:
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(timeout=10)
