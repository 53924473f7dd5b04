"""Exact prefix-KV cache: content-addressed reuse of context K/V across
requests.

Counterpart of `rag_serving_system_tpu/core/prefix_cache.py`. The RAG prompt
is "Context:\\n{docs}\\n\\nQuestion: {q}..." and retrieval is deterministic,
so the (usually long) context prefix repeats whenever queries repeat or share
retrieved documents:

- entries are whole context prefixes, keyed by the retrieved documents'
  identity and VERIFIED against the exact token ids: a hit is bit-exact by
  construction;
- payloads live in ONE device tensor (2 + slots, L, 2, POOL_LEN, Hk, D).
  Row 0 is a permanent zeros row for batch rows without a prefix and row 1 a
  scratch row, so data slots keep their numbers as the pool grows. A batch's
  rows are one `index_select`, an insert one in-place `index_copy_`;
- `generate(prefix_kv=...)` prefills only the suffix (question and answer
  cue) and attends over [prefix | suffix | generated];
- the engine de-duplicates a batch's misses and computes them in one
  `compute_prefix_kv` call.

The pool grows lazily, doubling its slots up to the byte budget (a new
tensor and a copy); past that, LRU slot reuse.

Under a mesh with a split attention block (engine.py, `parallel/tp.py`) the
value pool is held per model position: part m holds position m's KV heads
only, on every device of that model position (replicated over "data"). One
LRU index and one slot numbering serve every part; an insert writes each
part's rows into each of its copies, a gather reads one part on one device.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import Hashable, Optional, Tuple

import torch


@dataclass
class PrefixEntry:
    tokens: Tuple[int, ...]   # exact token ids this entry caches
    slot: int                 # row index into the device pool(s)


class PrefixKVCache:
    """Host-side LRU index over a device-resident slot pool.

    Thread-safe: lookups may run on the prefetch thread while inserts run on
    the generating thread. A hit requires the stored token ids to equal the
    request's prefix tokens; the key (the retrieved documents) is only a
    fast index.

    `entry_shape` is the per-entry payload shape (L, 2, POOL_LEN, Hk, D).
    With `int8=True` two pools are kept: int8 values and f32 per-(token,
    head) scales (see models.qwen2.quantize_prefix_kv)."""

    # data slots start past the two permanent rows (0 zeros, 1 scratch) so
    # slot indices stay valid as the pool grows
    _RESERVED_ROWS = 2
    zero_slot = 0      # permanent all-zeros row: rows without a prefix
    scratch_slot = 1   # insert target for pad rows

    def __init__(self, pool_len: int, entry_bytes: int, budget_mb: int = 2048,
                 min_tokens: int = 16, entry_shape: tuple | None = None,
                 dtype=None, int8: bool = False, min_slots: int = 0,
                 initial_slots: int = 16, adaptive: bool = True,
                 window: int = 512, low_hit_rate: float = 0.25,
                 probe_every: int = 8, device: str | torch.device = "cpu",
                 parts: int = 1, placements=None):
        self.pool_len = int(pool_len)
        self.entry_bytes = int(entry_bytes)
        self.capacity = max(1, (budget_mb * (1 << 20)) // max(1, entry_bytes))
        # cap the entry count too: with small payloads (tiny models) the
        # byte budget alone would admit millions of slots
        self.capacity = min(self.capacity,
                            int(os.environ.get("PREFIX_MAX_ENTRIES", "4096")))
        # one batch can protect up to 2 x max_batch slots (its hits and its
        # own fresh inserts); the engine passes min_slots = 2 * max_batch + 1
        # so a victim always exists, past the byte budget if need be
        self.capacity = max(self.capacity, min_slots)
        self.min_tokens = min_tokens
        self.int8 = int8
        self._entries: "OrderedDict[Hashable, PrefixEntry]" = OrderedDict()
        # lazy pool: a small slot chunk first, doubled on demand up to the
        # capacity; LRU reuse begins only once the full budget is live
        self.n_slots = min(self.capacity, max(1, initial_slots))
        self._free: list[int] = list(range(
            self._RESERVED_ROWS, self._RESERVED_ROWS + self.n_slots))
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.bypassed = 0  # rows that skipped the prefix path entirely
        self.grows = 0
        # adaptive bypass: a thrashing workload (cyclic access over a working
        # set larger than the capacity) pays the miss path for no reuse. A
        # rolling hit-rate window detects it; the engine then skips the
        # prefix path except on every `probe_every`-th batch, so the cache
        # re-engages once the workload becomes cacheable again
        self.adaptive = adaptive
        self._window = int(window)
        self._win_hits: "deque[bool]" = deque(maxlen=self._window)
        self._low_hit_rate = float(low_hit_rate)
        self._probe_every = max(2, int(probe_every))
        self._batch_no = 0
        self.bypass_mode = False
        self.probes = 0
        self.device = torch.device(device)
        # (part, device) of every copy of the value pool: `parts` slices of
        # the KV heads, each on the devices that read it
        self.placements = [(p, torch.device(d)) for p, d in
                           (placements or [(0, self.device)])]
        self._pools: dict = {}
        self._pool_scales: dict = {}
        if entry_shape is not None:
            ll, two, pl, hk, d = entry_shape
            self.entry_shape = tuple(entry_shape)
            self.scale_shape = (ll, two, pl, hk, 1)
            part_shape = (ll, two, pl, hk // parts, d)
            n = self._RESERVED_ROWS + self.n_slots
            for at in self.placements:
                self._pools[at] = torch.zeros((n,) + part_shape, device=at[1],
                                              dtype=torch.int8 if int8 else dtype)
                if int8:
                    self._pool_scales[at] = torch.ones(
                        (n,) + part_shape[:-1] + (1,), dtype=torch.float32, device=at[1])

    @property
    def _pool(self):
        """The first placement's value pool (the only one on one device)."""
        return self._pools.get(self.placements[0])

    @property
    def _pool_scale(self):
        """The first placement's int8 scales, None in compute storage."""
        return self._pool_scales.get(self.placements[0])

    @staticmethod
    def _grown(pool: torch.Tensor, rows: int, fill: int) -> torch.Tensor:
        out = torch.full((rows,) + pool.shape[1:], fill, dtype=pool.dtype,
                         device=pool.device)
        out[:pool.shape[0]] = pool
        return out

    def _grow_locked(self) -> None:
        """Double the slot count (up to the capacity): a larger pool, a copy
        of the live rows, a longer free list. Both pools exist only for the
        copy."""
        new_n = min(self.capacity, max(self.n_slots * 2, 1))
        if new_n <= self.n_slots:
            raise RuntimeError("_grow_locked called at full capacity")
        rows = self._RESERVED_ROWS + new_n
        for at in self._pools:
            self._pools[at] = self._grown(self._pools[at], rows, 0)
        for at in self._pool_scales:
            self._pool_scales[at] = self._grown(self._pool_scales[at], rows, 1)
        self._free.extend(range(self._RESERVED_ROWS + self.n_slots, rows))
        self.n_slots = new_n
        self.grows += 1

    def get(self, key: Hashable, tokens: Tuple[int, ...]) -> Optional[PrefixEntry]:
        with self._lock:
            e = self._entries.get(key)
            if e is not None and e.tokens == tokens:
                self._entries.move_to_end(key)
                self.hits += 1
                self._win_hits.append(True)
                return e
            self.misses += 1
            self._win_hits.append(False)
            return None

    def should_attempt(self) -> bool:
        """The per-batch adaptive gate, asked before prompts are split at the
        prefix boundary. False when the rolling hit rate says the workload is
        thrashing, except on probe batches. Never flips to bypass until the
        window has filled once (cold-start misses are warming, not thrash)."""
        if not self.adaptive:
            return True
        with self._lock:
            self._batch_no += 1
            if len(self._win_hits) >= self._window:
                rate = sum(self._win_hits) / len(self._win_hits)
                self.bypass_mode = rate < self._low_hit_rate
            if not self.bypass_mode:
                return True
            if self._batch_no % self._probe_every == 0:
                self.probes += 1
                return True
            return False

    def _alloc_slot_locked(self, protected: set) -> int:
        if self._free:
            return self._free.pop()
        if self.n_slots < self.capacity:
            self._grow_locked()
            return self._free.pop()
        # LRU reuse, skipping slots the CURRENT batch references (its hits
        # and its own fresh inserts): the batch's gather is enqueued AFTER this
        # insert, so overwriting a protected slot would hand a row another
        # context's K/V. Skipped victims are re-marked most recently used.
        # min_slots guarantees a victim exists.
        for key in list(self._entries):
            if self._entries[key].slot in protected:
                self._entries.move_to_end(key)
                continue
            return self._entries.pop(key).slot
        raise RuntimeError(
            "prefix cache has no evictable slot (capacity too small for "
            "one batch: min_slots should prevent this)")

    def put_batch(self, keys: list, tokens_list: list, kv_rows,
                  protected: set | None = None) -> dict:
        """Insert a batch of freshly computed entries with one `index_copy_`
        a pool copy. `kv_rows` is (M, *entry_shape) (or a (values, scales)
        pair in int8 mode), or with several parts a list of them, part by
        part; the first len(keys) rows are valid, any further rows go to
        the scratch slot. `protected` holds slots the current batch's gather
        will read (its cache hits). Returns {key: PrefixEntry}."""
        protected = set(protected or ())
        with self._lock:
            entries = {}
            slots = []
            for key, toks in zip(keys, tokens_list):
                old = self._entries.get(key)
                if old is not None and old.slot not in protected:
                    # re-insert over a stale entry (a token-split variant):
                    # recycle its slot instead of leaking it
                    self._free.append(old.slot)
                slot = self._alloc_slot_locked(protected)
                protected.add(slot)
                e = PrefixEntry(tokens=tuple(toks), slot=slot)
                self._entries[key] = e
                self._entries.move_to_end(key)
                entries[key] = e
                slots.append(slot)
            # Reusing an evicted slot is safe against batches already under way:
            # gather, insert and prefill are all enqueued on one CUDA stream
            # from the generating thread, so a gather enqueued before this
            # insert reads the old contents. The lock covers the write
            # because growth swaps self._pool.
            by_part = kv_rows if isinstance(kv_rows, list) else [kv_rows]
            m = (by_part[0][0] if self.int8 else by_part[0]).shape[0]
            slots = slots + [self.scratch_slot] * (m - len(slots))
            for at, pool in self._pools.items():
                rows = by_part[at[0]]
                idx = torch.as_tensor(slots, dtype=torch.long, device=at[1])
                if self.int8:
                    vals, scales = rows
                    pool.index_copy_(0, idx, vals.to(at[1], pool.dtype))
                    self._pool_scales[at].index_copy_(0, idx, scales.to(at[1], torch.float32))
                else:
                    pool.index_copy_(0, idx, rows.to(at[1], pool.dtype))
        return entries

    def gather(self, slots: list, part: int = 0, device=None):
        """(B,) slot list → (B, *entry_shape) device gather (values, or a
        (values, scales) pair in int8 mode) of one part's copy on `device`
        (the cache's own device by default). Use `zero_slot` for rows
        without a prefix."""
        at = (part, self.device if device is None else torch.device(device))
        idx = torch.as_tensor(slots, dtype=torch.long, device=at[1])
        with self._lock:   # against the pool swap of a growth
            if self.int8:
                return (self._pools[at].index_select(0, idx),
                        self._pool_scales[at].index_select(0, idx))
            return self._pools[at].index_select(0, idx)

    def note_bypass(self) -> None:
        """Count a row that skipped the prefix path."""
        with self._lock:
            self.bypassed += 1

    def clear(self, reset_counts: bool = False) -> None:
        """Drop every entry; the pool keeps its size, so the next lookups all
        miss. Serving never calls this: it is for a measurement's cold start
        (the counters keep their values) and, with `reset_counts`, for the
        end of the engine's warm-up (hits, misses, bypassed rows and the
        rolling window start again from nothing)."""
        with self._lock:
            self._entries.clear()
            self._free = list(range(self._RESERVED_ROWS,
                                    self._RESERVED_ROWS + self.n_slots))
            if reset_counts:
                self.hits = self.misses = self.bypassed = self.probes = 0
                self._batch_no = 0
                self.bypass_mode = False
                self._win_hits.clear()

    def __len__(self) -> int:
        return len(self._entries)

    def stats(self) -> dict:
        with self._lock:
            lookups = self.hits + self.misses
            rows = self._RESERVED_ROWS + self.n_slots
            return {
                "entries": len(self._entries),
                "capacity": self.capacity,
                "slots": self.n_slots,
                "grows": self.grows,
                "bytes": len(self._entries) * self.entry_bytes,
                "pool_reserved_bytes": rows * self.entry_bytes,
                "hits": self.hits,
                "misses": self.misses,
                "bypassed": self.bypassed,
                "hit_rate": (self.hits / lookups) if lookups else 0.0,
                "rolling_hit_rate": (sum(self._win_hits) / len(self._win_hits)
                                     if self._win_hits else None),
                "bypass_mode": self.bypass_mode,
                "probes": self.probes,
            }


class PromptSpec(str):
    """A prompt string that carries its cacheable-prefix split.

    Subclassing `str` keeps every consumer working (tokenizers encode it,
    `len()` orders it, tests compare it) while the engine's staging reads the
    extra fields."""

    prefix_text: str
    cache_key: Hashable
    sort_len: int
    gen_budget: int | None

    def __new__(cls, text: str, prefix_text: str = "", cache_key=None,
                gen_budget=None):
        s = super().__new__(cls, text)
        s.prefix_text = prefix_text
        s.cache_key = cache_key
        # length-aware regrouping orders by what sets the prefill bucket:
        # the SUFFIX (the prefix is cached K/V)
        s.sort_len = max(len(text) - len(prefix_text), 0)
        # the request's max_new_tokens (None = the engine's); rides the
        # prompt so budgets stay row-aligned
        s.gen_budget = gen_budget
        return s


def split_prefix_tokens(full_tokens: list, prefix_tokens: list,
                        max_len: int) -> int:
    """Longest m <= max_len with full_tokens[:m] == prefix_tokens[:m].

    A BPE tokenizer can merge across the prefix/suffix string boundary, so
    the last tokens of the separately tokenized prefix may differ from the
    full prompt's: trim until they agree. The cached prefill only needs
    *some* token-aligned split point."""
    m = min(len(prefix_tokens), len(full_tokens), max_len)
    while m > 0 and full_tokens[m - 1] != prefix_tokens[m - 1]:
        m -= 1
    # the trimmed region must match element-wise, not just at the last index
    while m > 0 and full_tokens[:m] != prefix_tokens[:m]:
        m -= 1
    return m
