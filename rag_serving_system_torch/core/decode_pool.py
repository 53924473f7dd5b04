"""Continuous (in-flight) batching: a persistent slot pool for decode
(DECODE_MODE=continuous).

Counterpart of `rag_serving_system_tpu/core/decode_pool.py`. The fixed
`generate` decodes a batch until EVERY row has finished;
here finished rows free their slot at once and new requests take it without
waiting for the rest of a batch to drain:

- `DecodePool` owns a ring K/V pool (L, S, W, Hk, D) and per-slot scalars on
  the engine's device. S slots and the window W are fixed at engine start.
- Prompts prefill through the engine's routes (`engine.prefill_rows`: padded,
  over the prefix-KV cache, or packed) AHEAD of slot availability, then enter
  free slots right-aligned at the ring cursor in WAVES sized to whatever
  slots are free: a batch never waits for a half-empty pool, and the pool
  may be smaller than a batch bucket.
- The worker thread dispatches `chunk` steps a call (`qwen2.decode_chunk`,
  no host read inside) and reads each (chunk, S) token block one dispatch
  BEHIND. On a CUDA device a block is copied to pinned host memory right
  after its chunk was enqueued, with an event behind the copy; the worker
  waits on that event only after it has enqueued the next chunk, so the
  device always has a chunk queued while the host does its bookkeeping. (A
  plain `.cpu()` on the older block would be ordered after the newest chunk
  on the stream and so wait for it.)

Ring safety: an insert with T prompt columns is made only while T + the
batch's largest budget <= W; an active slot advances one column a step, so
its oldest column cannot be lapped before it finishes. A slot's tokens lie
at arbitrary ring columns: attention masks by the per-slot `valid` bitmap
and RoPE is baked into K at the write.

One thread owns the pool's device work and its bookkeeping, so the
bookkeeping needs no lock. `submit` returns at once; results are delivered
per request through the callback as each completes.

Under the engine's mesh the slot axis goes over "data": data group g holds
slots [g * S / dp, (g + 1) * S / dp), and each of its model positions holds
their ring K/V for its own KV heads (the fixed path's cache split) and its
own copy of the per-slot scalars. A chunk runs `decode_chunk` on every
position in lockstep (`parallel/tp.py`); an insert copies each row's K/V
from the prefill's part to the positions of the slot's data group. The
token blocks are gathered to the lead device, so the host's bookkeeping is
the one-device pool's.
"""

from __future__ import annotations

import logging
import os
import queue
import threading
import time
from typing import Callable, List

import numpy as np
import torch

from rag_serving_system_torch.models.qwen2 import decode_chunk, eos_id_set, token_is_eos
from rag_serving_system_torch.parallel.tp import run_positions

logger = logging.getLogger(__name__)


@torch.inference_mode()
def _insert_rows(pool_k, pool_v, valid, last_tok, next_pos, active, remaining,
                 rows_k, rows_v, mask, tok0, rows, slots, cursor: int, budgets,
                 eos_ids) -> None:
    """Write the prefilled rows `rows` ((n,) int64 row indices of a batch)
    into the pool slots `slots` ((n,) int64), right-aligned at the ring
    cursor: prompt position j (of T) lands at ring column (cursor - T + j)
    mod W, so the slot's next decode write (at `cursor`) continues its
    sequence. In place.

    Only the wave's rows are indexed: the host knows them, so no row
    "drops" and no out-of-range slot id ever reaches an indexed write. The
    slot's whole `valid` row is rewritten, which retires whatever K/V a
    previous tenant left outside the T prompt columns. `next_pos` is the
    row's count of real tokens, prefix included; `remaining` starts at the
    row's own budget less the first token; a row is born inactive at a
    budget of 1 or a stop token first."""
    w = valid.shape[1]
    t = rows_k.shape[2]
    dev = valid.device
    cols = (torch.arange(t, device=dev) + (cursor - t)) % w
    at = (slice(None), slots[:, None], cols[None, :])
    pool_k[at] = rows_k[:, rows].to(pool_k.dtype)
    pool_v[at] = rows_v[:, rows].to(pool_v.dtype)
    m = mask[rows]
    vrow = torch.zeros((len(rows), w), dtype=torch.bool, device=dev)
    vrow[:, cols] = m.bool()
    valid[slots] = vrow
    t0 = tok0[rows]
    bud = budgets[rows]
    last_tok[slots] = t0
    next_pos[slots] = m.to(torch.int32).sum(dim=-1, dtype=torch.int32)
    active[slots] = (bud > 1) & ~token_is_eos(t0, eos_ids)
    remaining[slots] = bud - 1


class _HostCopy:
    """A device tensor on its way to the host: on a CUDA device a copy into
    pinned memory with an event behind it, enqueued now and waited for at
    `numpy()`; a CPU tensor as it is."""
    __slots__ = ("_host", "_event")

    def __init__(self, t: torch.Tensor):
        if t.is_cuda:
            self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(t.device))
        else:
            self._host, self._event = t, None

    def numpy(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
            self._event = None
        return self._host.numpy()


class _Slot:
    __slots__ = ("request_id", "tokens", "deliver", "open", "t0", "budget")

    def __init__(self, request_id, deliver, t0, budget):
        self.request_id = request_id
        self.tokens: List[int] = []
        self.deliver = deliver
        self.open = True
        self.t0 = t0
        self.budget = budget   # this request's own max_new_tokens


class _RowSet:
    """A prefilled batch whose rows enter the pool in waves as slots free.
    The device tensors stay batch-shaped; each wave is one `_insert_rows`
    call on its own rows. `tok0` is already on its way to the host."""
    __slots__ = ("k", "v", "mask", "tok0", "tok0_host", "bud_dev", "metas",
                 "next", "n")

    def __init__(self, k, v, mask, tok0, bud_dev, metas, n):
        self.k, self.v, self.mask, self.tok0 = k, v, mask, tok0
        self.tok0_host = _HostCopy(tok0)
        self.bud_dev = bud_dev
        self.metas = metas       # row index -> _Slot, rows [0, n)
        self.next = 0            # first row not yet inserted
        self.n = n


class DecodePool:
    """Host orchestrator of continuous batching for one engine."""

    def __init__(self, engine, slots: int, window: int, chunk: int):
        cfg = engine.dec_cfg
        self.engine = engine
        self.cfg = cfg
        self.slots = slots
        self.window = window
        self.chunk = chunk
        self.eos_ids = eos_id_set(cfg)
        self.max_new_tokens = engine.settings.max_new_tokens
        if self.max_new_tokens > window:
            raise ValueError(
                f"DECODE_WINDOW={window} cannot hold max_new_tokens="
                f"{self.max_new_tokens}")
        self.mesh = mesh = engine.mesh
        dp = mesh.shape["data"]
        if slots % dp:
            raise ValueError(f"DECODE_SLOTS={slots} must be a multiple of the mesh "
                             f"data axis {dp}")
        self.group_slots = s_ = slots // dp
        self._generator = engine._position_generators(
            int(engine.settings.max_new_tokens) * 7919 + slots)
        # (pool_k, pool_v, valid, last_tok, next_pos, active, remaining) of
        # each position, `decode_chunk`'s state arguments in order
        shape = (cfg.num_layers, s_, window, engine._dec.cfg.num_kv_heads, cfg.head_dim)
        self._states = {}
        for at in engine._positions():
            dev = mesh.device(*at)
            self._states[at] = [
                torch.zeros(shape, dtype=engine.dtype, device=dev),
                torch.zeros(shape, dtype=engine.dtype, device=dev),
                torch.zeros((s_, window), dtype=torch.bool, device=dev),
                torch.full((s_,), cfg.pad_token_id, dtype=torch.int32, device=dev),
                torch.zeros((s_,), dtype=torch.int32, device=dev),
                torch.zeros((s_,), dtype=torch.bool, device=dev),
                torch.zeros((s_,), dtype=torch.int32, device=dev)]
        (self.pool_k, self.pool_v, self.valid, self.last_tok, self.next_pos,
         self.active, self.remaining) = self._states[(0, 0)]
        self.cursor = 0

        self._free = list(range(slots))
        self._meta: dict[int, _Slot] = {}
        self._tok0_pending: list[tuple] = []   # (slot_by_row, snapshot, _RowSet)
        self._chunk_pending: list = []          # (_HostCopy of (chunk, S), snapshot)
        self._pending_inserts: list = []        # staged submissions, not yet prefilled
        self._pending_rows: list[_RowSet] = []  # prefilled, awaiting slot waves
        # how many prefilled row sets may wait for slots (each holds a
        # batch-shaped (L, B, T, Hk, D) K/V pair on the device)
        self._prefill_ahead = max(1, int(os.environ.get("DECODE_PREFILL_AHEAD", "1")))
        # bounded: `submit` blocks past this depth, which keeps the caller
        # from staging unbounded device tensors ahead of the pool
        self._submit_q: "queue.Queue[tuple]" = queue.Queue(
            maxsize=max(2, int(os.environ.get("DECODE_SUBMIT_DEPTH", "4"))))
        self._running = False
        self._thread: threading.Thread | None = None
        self._idle = threading.Event()
        self._idle.set()
        # submissions made and taken, under a lock with the idle flag: the
        # worker may not declare the pool idle between a caller's clearing
        # of the flag and its put
        self._idle_lock = threading.Lock()
        self._submitted = 0
        self._taken = 0
        self.steps = 0
        self.completed = 0
        self.inserted = 0
        self.tokens_emitted = 0   # real tokens read from DECODE blocks
        self.tokens_prefill = 0   # first tokens (sampled by the prefill)
        logger.info("decode pool: %d slots x window %d, chunk %d (%s K/V, %.0f MB "
                    "over %d positions)", slots, window, chunk, engine.dtype,
                    sum(2 * st[0].numel() * st[0].element_size()
                        for st in self._states.values()) / 2**20, len(self._states))

    # -- public API ------------------------------------------------------

    def submit(self, request_ids: list, prompts: list,
               deliver: Callable[[str, dict], None], staged=None) -> None:
        """Queue a prepared batch for prefill and insert. `deliver(request_id,
        result_dict)` fires once per request as it completes."""
        with self._idle_lock:
            self._submitted += 1
            self._idle.clear()
        self._submit_q.put((request_ids, prompts, staged, deliver, time.time()))

    def start(self) -> None:
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="decode-pool")
        self._thread.start()

    def stop(self, drain_timeout: float = 0.0) -> None:
        if drain_timeout > 0:
            self.wait_idle(drain_timeout)
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=10.0)

    def wait_idle(self, timeout: float) -> bool:
        """True once no submission, insert or active slot remains."""
        return self._idle.wait(timeout)

    def stats(self) -> dict:
        return {"slots": self.slots, "free": len(self._free),
                "window": self.window, "chunk": self.chunk,
                "steps": self.steps, "inserted": self.inserted,
                "completed": self.completed,
                "tokens_emitted": self.tokens_emitted,
                "tokens_prefill": self.tokens_prefill,
                # the share of DECODE slot-steps that produced a real token
                # (1.0 = no slot ever stepped for nothing); first tokens
                # come from the prefill and count on neither side
                "occupancy": round(self.tokens_emitted
                                   / max(1, self.steps * self.slots), 4),
                "pending_rows": sum(st.n - st.next for st in self._pending_rows),
                "pending_submits": self._submit_q.qsize()}

    # -- worker ----------------------------------------------------------

    def _loop(self) -> None:
        poll = 0.002
        while self._running:
            try:
                did = self._drain_submissions()
                busy = self._dispatch_chunk()
                # read one dispatch behind: the block waited for here was
                # produced before the chunk just enqueued
                self._consume(1 if busy else 0)
                if not (did or busy or self._chunk_pending
                        or self._tok0_pending or self._pending_rows
                        or self._pending_inserts):
                    with self._idle_lock:
                        if self._taken == self._submitted:
                            self._idle.set()
                    time.sleep(poll)
            except Exception:
                logger.exception("decode-pool loop error")
                self._fail_all("decode pool internal error")
                time.sleep(0.1)
        # deliver whatever is in flight before exiting
        try:
            self._consume(0)
        except Exception:
            logger.exception("decode-pool drain error")

    @staticmethod
    def _fail(request_ids, deliver, msg: str) -> None:
        for rid in request_ids:
            try:
                deliver(rid, {"error": msg, "status": "failed"})
            except Exception:
                logger.exception("decode-pool failure delivery failed for %s", rid)

    def _drain_submissions(self) -> bool:
        """Stage, prefill and wave-insert pending batches. Staging and
        prefill run AHEAD of slot availability (bounded), so when
        completions free slots the rows are on the device, ready for a cheap
        indexed write."""
        # at most a couple of submissions ahead in staged form: pulling
        # eagerly would defeat the bounded submit queue
        while len(self._pending_inserts) < 2 and not self._submit_q.empty():
            request_ids, prompts, staged, deliver, t0 = self._submit_q.get_nowait()
            self._taken += 1
            if staged is None:
                try:
                    staged = self.engine.stage_prompts(prompts)
                except Exception as e:
                    logger.exception("staging failed; failing batch")
                    self._fail(request_ids, deliver, str(e))
                    continue
            self._pending_inserts.append((request_ids, staged, deliver, t0))
        did = False
        while (self._pending_inserts
               and len(self._pending_rows) < self._prefill_ahead):
            request_ids, staged, deliver, t0 = self._pending_inserts.pop(0)
            try:
                self._prefill_batch(request_ids, staged, deliver, t0)
                did = True
            except Exception as e:
                logger.exception("prefill failed; failing batch")
                self._fail(request_ids, deliver, str(e))
        while self._insert_wave():
            did = True
        return did

    def _staged_kv_len(self, staged) -> int:
        """The prompt-K/V length T the staged batch will occupy in the pool."""
        if staged[0] == "packed":
            return self.engine.packed_p
        ids, metas = staged[1], staged[5]
        t = ids.shape[1]
        if metas is not None and any(m is not None for m in metas):
            t += self.engine.prefix_cache.pool_len
        return t

    def _prefill_batch(self, request_ids, staged, deliver, t0) -> None:
        engine = self.engine
        # gate on the batch's own largest budget, not the engine-wide cap: a
        # long-prompt batch of small budgets still fits the ring. Pad rows
        # carry the cap but are born done, so only the n valid rows count.
        n_valid = staged[4]
        bud_dev, bud_host = staged[-1]
        batch_budget = int(max(bud_host[:max(1, n_valid)]))
        if self._staged_kv_len(staged) + batch_budget > self.window:
            # a bucket the ring cannot hold: the FIXED path for this batch
            # (the same staged tensors), which blocks the pool's loop for
            # one batch; the cost of an undersized DECODE_WINDOW
            logger.warning(
                "staged KV %d + batch max budget %d exceeds window %d; "
                "falling back to fixed decode for this batch",
                self._staged_kv_len(staged), batch_budget, self.window)
            handle = engine.generate_tokens(staged=staged)
            for rid, ans in zip(request_ids, engine.finalize_tokens(handle)):
                deliver(rid, {"result": ans})
            self.completed += len(request_ids)
            return
        tok0, k, v, mask, n = engine.prefill_rows(staged, self._generator)
        metas = [_Slot(request_ids[i], deliver, t0, bud_host[i]) for i in range(n)]
        self._pending_rows.append(_RowSet(k, v, mask, tok0, bud_dev, metas, n))

    def _insert_wave(self) -> bool:
        """Insert up to len(free) rows of the head prefilled row set with one
        `_insert_rows` call. True if any row entered."""
        if not self._pending_rows or not self._free:
            return False
        st = self._pending_rows[0]
        take = min(len(self._free), st.n - st.next)
        if take <= 0:
            return False
        rows = list(range(st.next, st.next + take))
        slots = [self._free.pop() for _ in rows]
        self._insert(st, rows, slots)
        # the snapshot binds row index -> _Slot OBJECT: by the time tok0 is
        # read, the slot id may already host a successor request
        snapshot = {}
        slot_by_row = {}
        for r, s in zip(rows, slots):
            m = st.metas[r]
            self._meta[s] = m
            snapshot[r] = m
            slot_by_row[r] = s
        self._tok0_pending.append((slot_by_row, snapshot, st))
        st.next += take
        self.inserted += take
        if st.next >= st.n:
            self._pending_rows.pop(0)
        return True

    def _insert(self, st: "_RowSet", rows: list, slots: list) -> None:
        """`_insert_rows` on every position of each data group that owns
        some of `slots`, its K/V from the prefill's part for the position's
        heads. Where the row set lies on another device than the position,
        the group's rows are copied there first."""
        per = self.group_slots
        for g in sorted({s // per for s in slots}):
            mine = [(r, s - g * per) for r, s in zip(rows, slots) if s // per == g]
            for m in range(self.mesh.shape["model"]):
                dev = self.mesh.device(g, m)
                part = self.engine._prefix_part(m)
                src = (st.k[part], st.v[part], st.mask, st.tok0, st.bud_dev)
                idx = torch.as_tensor([r for r, _ in mine], dtype=torch.int64, device=dev)
                if any(t.device != dev for t in src):
                    src = tuple(t.index_select(int(i < 2), idx.to(t.device)).to(dev)
                                for i, t in enumerate(src))
                    idx = torch.arange(len(mine), dtype=torch.int64, device=dev)
                k, v, mask, tok0, bud = src
                _insert_rows(*self._states[(g, m)], k, v, mask, tok0, idx,
                             torch.as_tensor([s for _, s in mine], dtype=torch.int64,
                                             device=dev),
                             self.cursor, bud, self.eos_ids)

    def _dispatch_chunk(self) -> bool:
        """One decode_chunk call when any slot might be live. The host's
        `_meta` (slots not yet delivered) over-approximates the device's
        `active` by at most the reading lag, so a couple of chunks that
        decode nothing at a tail are the cost of never reading eagerly."""
        if not self._meta:
            return False
        s = self.engine.settings
        kw = dict(chunk=self.chunk, do_sample=s.do_sample, dtype=self.engine.dtype,
                  eos_bias=s.eos_bias)
        dec = self.engine._dec
        res = run_positions(
            self.mesh, dec, lambda g, m: decode_chunk(
                dec.params[g][m], dec.cfg, *self._states[(g, m)], self.cursor,
                self._generator[(g, m)], **kw), range(self.mesh.shape["data"]))
        self.cursor = res[(0, 0)][-2]
        # the groups' (chunk, S / dp) blocks side by side: slot order
        toks = self.engine._gathered(
            [res[(g, 0)][-1] for g in range(self.mesh.shape["data"])], dim=1)
        # snapshot slot -> _Slot at DISPATCH time: this block's tokens belong
        # to these request objects even if a slot is freed and reused before
        # the block is read (the successor's tokens ride later blocks)
        snapshot = {sl: m for sl, m in self._meta.items() if m.open}
        self._chunk_pending.append((_HostCopy(toks), snapshot))
        self.steps += self.chunk
        return True

    def _consume(self, lag: int) -> None:
        """Read pending token blocks down to `lag` outstanding, apply the
        EOS and budget bookkeeping, deliver completed requests, free slots.
        First tokens drain fully first (a request's tok0 precedes every
        chunk block dispatched after its insert; blocks dispatched BEFORE
        its insert do not contain it: snapshots bind tokens to request
        objects, not slot ids)."""
        while self._tok0_pending:
            slot_by_row, snapshot, st = self._tok0_pending.pop(0)
            tok0 = st.tok0_host.numpy()     # one (B,) copy a batch, shared by its waves
            for i, m in snapshot.items():
                self._note_token(slot_by_row[i], m, int(tok0[i]), from_prefill=True)
        while len(self._chunk_pending) > lag:
            block, snapshot = self._chunk_pending.pop(0)
            toks = block.numpy()                             # (chunk, S)
            for step in range(toks.shape[0]):
                row = toks[step]
                for s, m in snapshot.items():
                    if m.open:
                        self._note_token(s, m, int(row[s]))

    def _note_token(self, slot: int, m: _Slot, tok: int,
                    from_prefill: bool = False) -> None:
        if not m.open:
            return
        if tok != self.cfg.pad_token_id and tok not in self.eos_ids:
            m.tokens.append(tok)
            # tok0 comes from the PREFILL, not a decode slot-step: it must
            # not count toward the decode occupancy
            if from_prefill:
                self.tokens_prefill += 1
            else:
                self.tokens_emitted += 1
        done = tok in self.eos_ids or len(m.tokens) >= m.budget
        # a pad emission means the device already deactivated this slot
        if tok == self.cfg.pad_token_id:
            done = True
        if done:
            m.open = False
            self._finish(slot, m)

    def _finish(self, slot: int, m: _Slot) -> None:
        if self._meta.get(slot) is m:
            self._meta.pop(slot)
            self._free.append(slot)
        self.completed += 1
        try:
            text = self.engine.dec_tok.decode(m.tokens)
            m.deliver(m.request_id, {"result": text})
        except Exception:
            logger.exception("decode-pool delivery failed for %s", m.request_id)

    def _fail_all(self, msg: str) -> None:
        """Fail every request the pool holds, wherever it waits: in a slot,
        prefilled, staged or still queued."""
        for slot in list(self._meta):
            m = self._meta.pop(slot)
            self._free.append(slot)
            self._fail([m.request_id], m.deliver, msg)
        self._tok0_pending.clear()
        self._chunk_pending.clear()
        # rows before `next` were in _meta and failed above
        rowsets, self._pending_rows = self._pending_rows, []
        for st in rowsets:
            for m in st.metas[st.next:]:
                self._fail([m.request_id], m.deliver, msg)
        pending, self._pending_inserts = self._pending_inserts, []
        for request_ids, _staged, deliver, _t0 in pending:
            self._fail(request_ids, deliver, msg)
        while True:
            try:
                request_ids, _p, _s, deliver, _t0 = self._submit_q.get_nowait()
            except queue.Empty:
                break
            self._taken += 1
            self._fail(request_ids, deliver, msg)
