"""Background batch processor: drains the queue, runs the engine, stores
results.

Counterpart of `rag_serving_system_tpu/core/batch_processor.py` (that module
imports the JAX engine), with its constructor, settings and pipeline:

- stage 1 (`PREFETCH_WORKERS` threads): `get_batch` → `engine.prepare`
  (embed, retrieve, prompt build), and with `STAGE_PROMPTS=1` also
  `engine.stage_prompts`. When the queue holds a second full batch, both are
  prepared together and regrouped by (generation budget, prompt length), so
  that short prompts share a small bucket;
- stage 2 (this thread): `engine.generate_tokens` for one prepared batch;
- stage 3 (`FINALIZE_ASYNC=1`, one thread): `engine.finalize_tokens` (the
  token copy to the host and detokenizing) and `store_result`, at most
  `FINALIZE_DEPTH` batches behind stage 2.

`prefetch=False` is the serial mode: one thread, `engine.process` a batch.
Every request of a failed batch is answered {"error", "status": "failed"}.
With DECODE_MODE=continuous the engine has a decode pool: stage 2 then
stages the batch and hands it to `pool.submit`, and each request's result is
stored by the pool's thread as that request completes.

What the stages can overlap on one CUDA device: `generate_tokens` returns
only when decode has finished (the decode loop reads `done.all()` on the
host every step), so the finalize worker hides the token copy, detokenizing
and the store, not device time. The stage-1 workers send their encoder and
top-k launches onto the same stream from their own threads and take the
interpreter lock from the decode loop while they do.

The engine's stage timer (`utils/timing.py`) gets each dequeued request's
`queue_wait` (its enqueue timestamp to the dequeue; an item without one is
not timed) and the `generate` and `finalize` spans. A batch is numbered
once (`StageTimer.number`), where stage 1 dequeues it, and the number goes
with it to staging, generation and finalize, so that its spans on every
thread carry it; a stage-1 batch that is split into several stage-2 groups
gives each group a number of its own.
"""

from __future__ import annotations

import contextlib
import logging
import os
import queue
import threading
import time

logger = logging.getLogger(__name__)

# Stage-1 workers when PREFETCH_WORKERS is unset. The JAX package defaults to
# 2; on an H100 one worker served a burst of 64 requests in 0.80-0.96 s and
# two in 0.92-2.01 s (chip_smoke.py, serve_pipeline): stage 1 is a small share
# of a batch there, and two workers that drain one burst together each end up
# with a partial batch, which get_batch holds for MAX_WAIT_TIME.
DEFAULT_PREFETCH_WORKERS = 1


class BatchProcessor(threading.Thread):
    def __init__(self, request_queue, engine, polling_interval: float = 0.3,
                 prefetch: bool = True, length_aware: bool = True):
        super().__init__(daemon=True, name="stage-2")
        self.request_queue = request_queue
        self.engine = engine
        self.polling_interval = polling_interval
        self.prefetch = prefetch
        self.length_aware = length_aware
        # STAGE_PROMPTS=1 tokenizes and places prompt batches on the device
        # on the stage-1 thread instead of inside generate_tokens
        self.stage_on_prefetch = os.environ.get("STAGE_PROMPTS", "0") == "1"
        self.running = False
        self._busy = False            # stage 2 is executing
        self._stage1_count = 0        # stage-1 workers holding dequeued batches
        self._stage1_lock = threading.Lock()
        # concurrent get_batch calls can split the queue into partial
        # batches; the engine serves any size up to its largest bucket
        self.prefetch_workers = max(1, int(os.environ.get(
            "PREFETCH_WORKERS", str(DEFAULT_PREFETCH_WORKERS)))) if prefetch else 0
        # prepared batches between stage 1 and stage 2: 0 is unbounded, else
        # at least one slot a worker so that they do not wait on each other
        depth = int(os.environ.get("READY_DEPTH", "1"))
        self._ready: "queue.Queue[tuple]" = queue.Queue(
            maxsize=0 if depth == 0 else max(depth, self.prefetch_workers))
        self._pending = None          # deferred (batch, token handle, batch number)
        # the bounded queue is the pipeline's backpressure: at most
        # FINALIZE_DEPTH generated batches await their delivery
        self.finalize_async = os.environ.get("FINALIZE_ASYNC", "1") == "1"
        self._finalize_q: "queue.Queue[tuple]" = queue.Queue(
            maxsize=max(1, int(os.environ.get("FINALIZE_DEPTH", "2"))))
        self._prefetchers: list[threading.Thread] = []
        self._finalizer: threading.Thread | None = None
        # read by api/endpoints.py (/stats, /metrics)
        self.batches_processed = 0
        self.requests_processed = 0
        self.last_batch_seconds = 0.0

    @property
    def ready_backlog(self) -> int:
        """Batches prepared by stage 1, awaiting generation."""
        return self._ready.qsize()

    @property
    def finalize_backlog(self) -> int:
        """Generated batches awaiting the finalize worker (async mode)."""
        return self._finalize_q.qsize()

    def _fail(self, batch: list, err: Exception) -> None:
        """Answer every request of `batch` with the error; a result store
        that is down as well must not take the calling thread with it."""
        for req in batch:
            try:
                self.request_queue.store_result(
                    req["id"], {"error": str(err), "status": "failed"})
            except Exception:
                logger.exception("error storing failure for %s", req["id"])

    def _timed(self, stage: str):
        """The engine's stage timer (read by /stats), where it has one."""
        timer = getattr(self.engine, "timer", None)
        return timer.stage(stage) if timer is not None else contextlib.nullcontext()

    def _number(self, batch: list) -> int | None:
        """A new batch number for `batch` (None without a timer)."""
        timer = getattr(self.engine, "timer", None)
        return timer.number([req["id"] for req in batch]) if timer is not None else None

    def _numbered(self, number: int | None):
        """Tag the spans this thread records in the block with `number`."""
        timer = getattr(self.engine, "timer", None)
        if timer is None or number is None:
            return contextlib.nullcontext()
        return timer.batch(number)

    def _dequeued(self, batch: list) -> list:
        """Time each request's wait in the queue (`queue_wait`), now that it
        is dequeued."""
        timer = getattr(self.engine, "timer", None)
        if timer is not None:
            now = time.time_ns()
            for req in batch:
                ts = req.get("timestamp")
                if ts:
                    start = int(ts * 1e9)
                    timer.add("queue_wait", (now - start) * 1e-9, start_ns=start, id=req["id"])
        return batch

    def _store(self, batch: list, results: list) -> None:
        for req, res in zip(batch, results):
            try:
                self.request_queue.store_result(req["id"], res)
            except Exception:
                logger.exception("error storing result for %s", req["id"])

    def _put_ready(self, item: tuple) -> None:
        """Hand a prepared batch to stage 2; the queue is bounded, so this
        waits while stage 2 is behind. A processor that stops meanwhile
        fails the batch rather than leave its requests unanswered."""
        while self.running:
            try:
                self._ready.put(item, timeout=self.polling_interval)
                return
            except queue.Full:
                continue
        self._fail(item[0], RuntimeError("processor stopped"))

    def _prefetch_loop(self) -> None:
        """Stage 1: form the next batch and prepare its prompts while stage 2
        generates the current one.

        Length-aware regrouping: a prompt's length is dominated by its
        retrieved contexts (unknown until stage 1), and prefill pads every
        row to the batch's longest. When the queue is deep enough for two
        batches, both are prepared together and their prompts repartitioned
        by (budget, length). Reordering stays inside this two-batch window,
        so no request starves."""
        while self.running:
            try:
                batch = self._dequeued(self.request_queue.get_batch())
            except Exception:  # e.g. Redis down: keep polling
                logger.exception("get_batch failed")
                batch = []
            if not batch:
                time.sleep(self.polling_interval)
                continue
            with self._stage1_lock:
                self._stage1_count += 1
            try:
                cap = getattr(self.request_queue, "max_batch_size", len(batch))
                if (self.length_aware and len(batch) == cap
                        and self.request_queue.queue_size() >= cap):
                    batch += self._dequeued(self.request_queue.get_batch())
                number = self._number(batch)
                with self._numbered(number):
                    prompts = self.engine.prepare(
                        [req["query"] for req in batch],
                        [req.get("k", 2) for req in batch],
                        [req.get("max_new_tokens") for req in batch])
                stage = (getattr(self.engine, "stage_prompts", None)
                         if self.stage_on_prefetch else None)
                if len(batch) > cap:
                    # PromptSpec.sort_len is the SUFFIX length where the
                    # prefix cache holds the context. Budget first: the fixed
                    # decode runs max(batch budgets) steps a batch; with
                    # uniform budgets (the default) this is the length sort
                    cap_mnt = getattr(getattr(self.engine, "settings", None),
                                      "max_new_tokens", 1 << 30)

                    def _key(i):
                        b = getattr(prompts[i], "gen_budget", None)
                        return (cap_mnt if b is None else b,
                                getattr(prompts[i], "sort_len", len(prompts[i])))

                    order = sorted(range(len(batch)), key=_key)
                    groups = [order[lo:lo + cap] for lo in range(0, len(order), cap)]
                else:
                    groups = [range(len(batch))]
                for n_done, grp in enumerate(groups):
                    gb, gp = [batch[i] for i in grp], [prompts[i] for i in grp]
                    try:
                        num = number if len(groups) == 1 else self._number(gb)
                        with self._numbered(num):
                            staged = stage(gp) if stage else None
                        self._put_ready((gb, gp, staged, num))
                    except Exception:
                        # the groups already handed on are stage 2's: fail
                        # only this one and those after it
                        batch = [batch[i] for g in groups[n_done:] for i in g]
                        raise
            except Exception as e:
                logger.exception("stage-1 error; failing batch")
                self._fail(batch, e)
            finally:
                with self._stage1_lock:
                    self._stage1_count -= 1

    def _finalize_loop(self) -> None:
        """Stage 3: copy tokens to the host, detokenize, store.

        Exits only on the sentinel that `run` puts after its loop, never on a
        timing race, so a batch generated while the processor stops is still
        delivered; and every exception stays in here (also one from the
        error path, whose result store may be down): a dead finalize worker
        would block stage 2 on the bounded put."""
        while True:
            item = self._finalize_q.get()
            try:
                if item is None:
                    return
                batch, handle, t0, number = item
                self._finalize_and_store(batch, handle, number)
                # generation start → delivered, of this batch (the /stats gauge)
                self.last_batch_seconds = time.time() - t0
                self.batches_processed += 1
                self.requests_processed += len(batch)
            except Exception:
                logger.exception("finalize worker error; batch dropped")
            finally:
                self._finalize_q.task_done()

    def run(self) -> None:
        self.running = True
        pool = getattr(self.engine, "decode_pool", None)
        if pool is not None and not pool._running:
            pool.start()
        logger.info("BatchProcessor started (prefetch=%s, workers=%d, "
                    "finalize_async=%s, decode=%s).", self.prefetch,
                    self.prefetch_workers, self.finalize_async,
                    "continuous" if pool is not None else "fixed")
        if self.prefetch:
            for i in range(self.prefetch_workers):
                t = threading.Thread(target=self._prefetch_loop, daemon=True,
                                     name=f"stage-1-{i}")
                t.start()
                self._prefetchers.append(t)
            if self.finalize_async:
                self._finalizer = threading.Thread(target=self._finalize_loop,
                                                   daemon=True, name="finalize")
                self._finalizer.start()
        while self.running:
            try:
                t0 = time.time()
                if self.prefetch:
                    try:
                        batch, prompts, staged, number = self._ready.get(
                            timeout=self.polling_interval)
                    except queue.Empty:
                        # idle: deliver a deferred batch now, so that latency
                        # at low traffic is bounded by the polling interval
                        self._flush_pending()
                        continue
                    self._busy = True
                    try:
                        self._generate_and_store(batch, prompts, staged, number)
                    finally:
                        self._ready.task_done()   # pairs with put(): drain accounting
                else:
                    batch = self._dequeued(self.request_queue.get_batch())
                    if not batch:
                        time.sleep(self.polling_interval)
                        continue
                    self._busy = True
                    self._process_batch(batch)
                self._busy = False
                if self.prefetch and (pool is not None or self.finalize_async):
                    # delivered batches are counted where they are delivered:
                    # by the pool's callback or by the finalize worker
                    logger.info("generated batch of %d in %.3fs", len(batch),
                                time.time() - t0)
                else:
                    self.last_batch_seconds = time.time() - t0
                    self.batches_processed += 1
                    self.requests_processed += len(batch)
                    logger.info("processed batch of %d in %.3fs", len(batch),
                                self.last_batch_seconds)
            except Exception:  # keep serving no matter what
                self._busy = False
                logger.exception("batch loop error")
                time.sleep(self.polling_interval)
        if self._finalizer is not None:
            # the sentinel follows the last put (both on this thread): the
            # worker drains every generated batch, then exits
            self._finalize_q.put(None)
        self._flush_pending()  # the last deferred batch
        logger.info("BatchProcessor stopped.")

    def _submit_to_pool(self, pool, batch: list, prompts: list, staged=None) -> None:
        """Continuous mode's stage 2: stage the prompts here unless stage 1
        did (the pool's thread is left the device work), hand the batch to
        the pool and return; `deliver` stores each result as its request
        completes."""
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

        if staged is None:
            try:
                staged = self.engine.stage_prompts(prompts)
            except Exception as e:
                logger.exception("staging error for batch of %d", len(batch))
                self._fail(batch, e)
                return
        pool.submit([req["id"] for req in batch], prompts, deliver, staged=staged)

    def _generate_and_store(self, batch: list, prompts: list, staged=None,
                            number: int | None = None) -> None:
        """Stage 2: generate this batch, then hand its tokens to the finalize
        worker (async mode), or deliver the PREVIOUS batch's results and keep
        this one's deferred (sync mode)."""
        pool = getattr(self.engine, "decode_pool", None)
        if pool is not None:
            self._submit_to_pool(pool, batch, prompts, staged)
            return
        try:
            t0 = time.time()
            with self._numbered(number), self._timed("generate"):
                handle = self.engine.generate_tokens(prompts, staged=staged)
            if self.finalize_async:
                # waits only while FINALIZE_DEPTH batches are undelivered
                self._finalize_q.put((batch, handle, t0, number))
                return
            pending, self._pending = self._pending, (batch, handle, number)
            if pending is not None:
                self._finalize_and_store(*pending)
        except Exception as e:
            logger.exception("stage-2 error for batch of %d", len(batch))
            self._fail(batch, e)
            if self.finalize_async:
                # this batch never reaches the finalize worker, but its
                # (error) results were delivered: count it here
                self.batches_processed += 1
                self.requests_processed += len(batch)

    def _finalize_and_store(self, batch: list, handle, number: int | None = None) -> None:
        try:
            with self._numbered(number), self._timed("finalize"):
                answers = self.engine.finalize_tokens(handle)
        except Exception as e:
            logger.exception("finalize error for batch of %d", len(batch))
            self._fail(batch, e)
            return
        self._store(batch, [{"result": ans} for ans in answers])

    def _flush_pending(self) -> None:
        pending, self._pending = self._pending, None
        if pending is not None:
            self._finalize_and_store(*pending)

    def _process_batch(self, batch: list) -> None:
        """The serial mode's whole pipeline for one batch."""
        try:
            with self._numbered(self._number(batch)):
                results = self.engine.process(
                    [req["query"] for req in batch],
                    [req.get("k", 2) for req in batch],
                    [req.get("max_new_tokens") for req in batch])
        except Exception as e:
            logger.exception("error processing batch of %d", len(batch))
            self._fail(batch, e)
            return
        self._store(batch, results)

    def stop(self, drain_timeout: float = 0.0) -> None:
        """Stop the loops. With drain_timeout > 0, first wait up to that long
        for dequeued work (the batches in stage 1, the prepared ones, the one
        generating, those awaiting delivery and whatever the decode pool
        holds) to be answered. Requests still in the queue stay there: under
        Redis they outlive a restart."""
        deadline = time.time() + drain_timeout
        while time.time() < deadline and (
                self._busy or self._stage1_count > 0
                or self._ready.unfinished_tasks > 0
                or self._finalize_q.unfinished_tasks > 0):
            time.sleep(0.02)
        pool = getattr(self.engine, "decode_pool", None)
        if pool is not None:
            pool.stop(drain_timeout=max(0.0, deadline - time.time())
                      if drain_timeout > 0 else 0.0)
        self.running = False
        # generated batches are always delivered (the finalize worker exits
        # only on run()'s sentinel): give them a bounded window here, so that
        # their results exist when stop() returns
        deadline = time.time() + 5.0
        while (time.time() < deadline and self.is_alive()
               and self._finalize_q.unfinished_tasks > 0):
            time.sleep(0.02)
        # join the stage-1 workers, so that the caller may tear down what
        # backs the request queue without a worker's last poll meeting it
        for t in self._prefetchers:
            t.join(timeout=2.0 + self.polling_interval)
        # run() flushes the deferred batch at its exit; where the thread
        # never ran (or has ended), deliver it here
        if not self.is_alive():
            self._flush_pending()
