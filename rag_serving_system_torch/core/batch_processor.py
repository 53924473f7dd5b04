"""Background batch processor: drains the queue, runs the engine, stores
results.

The driving contract of `rag_serving_system_tpu/core/batch_processor.py`
(that module imports the JAX engine): `get_batch` → `engine.prepare` →
`engine.generate_tokens` → `engine.finalize_tokens` → `store_result`, with
every request of a failed batch answered {"error", "status": "failed"}, and
the stats attributes the HTTP surface reads. Simpler: one prefetch worker
runs stage 1 (embed, retrieve, prompt build) for the next batch while this
thread generates the current one, and results are stored synchronously.
With DECODE_MODE=continuous the engine has a decode pool: stage 2 then
stages the batch and hands it to `pool.submit`, and each request's result is
stored by the pool's thread as that request completes.
"""

from __future__ import annotations

import logging
import queue
import threading
import time

logger = logging.getLogger(__name__)


class BatchProcessor(threading.Thread):
    def __init__(self, request_queue, engine, polling_interval: float = 0.3):
        super().__init__(daemon=True)
        self.request_queue = request_queue
        self.engine = engine
        self.polling_interval = polling_interval
        self.running = False
        # one prepared batch waits while the current one generates
        self._ready: "queue.Queue[tuple]" = queue.Queue(maxsize=1)
        self._stage1_busy = False
        self._stage2_busy = False
        self._prefetcher: threading.Thread | None = None
        # read by api/endpoints.py (/stats, /metrics)
        self.batches_processed = 0
        self.requests_processed = 0
        self.last_batch_seconds = 0.0

    @property
    def ready_backlog(self) -> int:
        """Batches prepared by stage 1, awaiting generation."""
        return self._ready.qsize()

    def _fail(self, batch: list, err: Exception) -> None:
        for req in batch:
            try:
                self.request_queue.store_result(
                    req["id"], {"error": str(err), "status": "failed"})
            except Exception:
                logger.exception("error storing failure for %s", req["id"])

    def _prefetch_loop(self) -> None:
        """Stage 1: form a batch and prepare its prompts."""
        while self.running:
            try:
                batch = self.request_queue.get_batch()
            except Exception:  # e.g. Redis down: keep polling
                logger.exception("get_batch failed")
                batch = []
            if not batch:
                time.sleep(self.polling_interval)
                continue
            self._stage1_busy = True
            try:
                prompts = self.engine.prepare(
                    [req["query"] for req in batch],
                    [req.get("k", 2) for req in batch],
                    [req.get("max_new_tokens") for req in batch])
                item = (batch, prompts)
                while self.running:
                    try:
                        self._ready.put(item, timeout=self.polling_interval)
                        break
                    except queue.Full:
                        continue
                else:
                    self._fail(batch, RuntimeError("processor stopped"))
            except Exception as e:
                logger.exception("stage-1 error; failing batch")
                self._fail(batch, e)
            finally:
                self._stage1_busy = False

    def _submit_to_pool(self, pool, batch: list, prompts: list) -> None:
        """Continuous mode's stage 2: stage the prompts here (the pool's
        thread is left the device work), hand the batch to the pool and
        return; `deliver` stores each result as its request completes."""
        t0 = time.time()
        left = {"n": len(batch)}

        def deliver(rid, res):
            try:
                self.request_queue.store_result(rid, res)
            except Exception:
                logger.exception("error storing result for %s", rid)
            self.requests_processed += 1
            left["n"] -= 1
            if left["n"] == 0:
                self.batches_processed += 1
                self.last_batch_seconds = time.time() - t0

        try:
            staged = self.engine.stage_prompts(prompts)
        except Exception as e:
            logger.exception("staging error for batch of %d", len(batch))
            self._fail(batch, e)
            return
        pool.submit([req["id"] for req in batch], prompts, deliver, staged=staged)

    def _generate_and_store(self, batch: list, prompts: list) -> None:
        """Stage 2: generate, detokenize and store one batch's results."""
        pool = getattr(self.engine, "decode_pool", None)
        if pool is not None:
            self._submit_to_pool(pool, batch, prompts)
            return
        t0 = time.time()
        try:
            with self.engine.timer.stage("generate"):
                answers = self.engine.finalize_tokens(
                    self.engine.generate_tokens(prompts))
        except Exception as e:
            logger.exception("stage-2 error for batch of %d", len(batch))
            self._fail(batch, e)
            answers = None
        if answers is not None:
            for req, ans in zip(batch, answers):
                try:
                    self.request_queue.store_result(req["id"], {"result": ans})
                except Exception:
                    logger.exception("error storing result for %s", req["id"])
        self.last_batch_seconds = time.time() - t0
        self.batches_processed += 1
        self.requests_processed += len(batch)
        logger.info("processed batch of %d in %.3fs", len(batch),
                    self.last_batch_seconds)

    def run(self) -> None:
        self.running = True
        pool = getattr(self.engine, "decode_pool", None)
        if pool is not None and not pool._running:
            pool.start()
        self._prefetcher = threading.Thread(target=self._prefetch_loop, daemon=True)
        self._prefetcher.start()
        logger.info("BatchProcessor started (decode=%s).",
                    "continuous" if pool is not None else "fixed")
        while self.running:
            try:
                batch, prompts = self._ready.get(timeout=self.polling_interval)
            except queue.Empty:
                continue
            self._stage2_busy = True
            try:
                self._generate_and_store(batch, prompts)
            finally:
                self._stage2_busy = False
                self._ready.task_done()
        logger.info("BatchProcessor stopped.")

    def stop(self, drain_timeout: float = 0.0) -> None:
        """Stop both loops. With drain_timeout > 0, first wait up to that long
        for dequeued work (the batch in stage 1, the prepared one, the one
        generating and whatever the decode pool holds) to be answered.
        Requests still in the queue stay there."""
        deadline = time.time() + drain_timeout
        while time.time() < deadline and (
                self._stage1_busy or self._stage2_busy
                or self._ready.unfinished_tasks > 0):
            time.sleep(0.02)
        pool = getattr(self.engine, "decode_pool", None)
        if pool is not None:
            pool.stop(drain_timeout=max(0.0, deadline - time.time())
                      if drain_timeout > 0 else 0.0)
        self.running = False
        if self._prefetcher is not None:
            self._prefetcher.join(timeout=2.0 + self.polling_interval)
