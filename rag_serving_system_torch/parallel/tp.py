"""Tensor parallelism over the mesh's "model" axis, Megatron style.

Counterpart of `rag_serving_system_tpu/parallel/tp.py:26-104`, with its
leaf-name rules:

- column parallel (`_COL`: qkv_w, ff_w1, gu_w) and their biases (`_COL_BIAS`:
  qkv_b, ff_b1): each model position holds a slice of the OUTPUT columns;
- row parallel (`_ROW`: o_w, ff_w2, down_w): a slice of the INPUT rows, and
  the positions' partial products are summed after the matmul (one
  all-reduce after the attention output product and one after the MLP down
  product, a layer); the row-parallel biases (o_b, ff_b2) are added once,
  after the sum;
- everything else (embeddings, norms, the LM head) is replicated.

GSPMD may re-shard an activation after a split; this port cannot, so a
block's column and row splits must cover the same units:

- `qkv_w` / `qkv_b` split q, k and v each by WHOLE HEADS (position m holds
  query heads m*Hq/tp.. and the KV heads they read), and `o_w`'s rows follow
  the query heads. A contiguous split of the fused matrix would hand
  position 0 all of q and part of k;
- `gu_w` splits gate and up each into the same units, so `silu(g) * u` stays
  local, and `down_w`'s rows follow those units.

Quantized weights (`ops.quant`) as in the JAX rules: a `QuantizedWeight`'s
per-output-channel scale follows a column split and is replicated under a
row split. A `QuantizedWeight4` row weight splits its group axis when the
group count divides by tp; else its packed within-group axis, scales
replicated (the MLP's units are then, in each group, the packed slice's low
and high rows, and gate / up follow them); else the block is replicated.

Where tp does not divide a block (the query or KV head count, the MLP
width, an int4 `o_w`'s group count), the whole block is replicated: every
position computes all of it and no sum follows, so it is counted once.
QWEN2_TINY (Hq=4, Hk=2) replicates its attention at tp = 4 and 8; at full
width tp = 2 splits everything (Qwen2.5-1.5B: Hq=12, Hk=2, I=8960; e5-large:
16 heads, I=4096).

Lockstep. Each model position runs the route's own one-device code (the
forwards of `models/`) with its own slices and local head counts, in a
thread of its own, and the positions TAKE TURNS: `run_positions` starts one
thread a position and hands a turn round them in a fixed ring, one position
of a ring running at a time, from one sum to the next. So the layer loop
walks the positions, without the model code knowing: only `row_parallel` yields. A
position puts its partial into its group's exchange and passes the turn;
when the turn comes back, every other position of the ring has had one, so
its group's partials are all there, and it sums them in position order
(`mesh.all_reduce`): every position holds the same bits. The hidden state,
logits, sampling (generators seeded alike) and EOS decisions are then
computed from identical inputs on every position, so the positions take the
same number of steps; each sum checks that its partials are of its own
round, and the engine that the positions' tokens agree. Two exchange
buffers alternate: the ring guarantees a buffer is read by every position
before it is written again.

Why turns and not free-running threads: decode is host-bound, and PyTorch
releases the interpreter lock inside every op, so free-running position
threads hand the lock to each other at every op: with a barrier a sum and
all positions running at once, an all-hit batch of 32 over a "2,2" mesh on
one H100 took 5.6-7.3 s (`chip_smoke.py` serve_mesh) where one device takes
about 0.3 s. With turns only one thread is runnable, and a turn costs one
lock handoff.

Data groups. Every data group of a call takes its turns in the same ring
(`rings`), one after another, even where each has cards of its own: on four
H100s an all-hit batch of 32 took 0.91-0.99 s over a "4,1" mesh and
1.28-1.55 s over "2,2" with one ring, and 3.19-3.35 s and 1.93-2.13 s with a
ring a data group running at once (`chip_smoke.py` serve_mesh_cards), whose
threads contend for the interpreter lock while decode is host-bound. Data
groups that run at once need a process each (`torch.distributed`).

A position that raises breaks its group: the others raise when their turn
comes; a turn not given back within `TURN_TIMEOUT_S` raises too. Each call
has its own threads and rings, so concurrent calls (stage 1's encode beside
stage 2's generate) never share an exchange. A call on one position (one
device) runs in the caller's thread; outside a position thread, or at
tp = 1, `row_parallel` is the plain product.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable

import torch

from rag_serving_system_torch.ops.quant import QuantizedWeight, QuantizedWeight4
from rag_serving_system_torch.parallel.mesh import Mesh, all_reduce

_COL = {"qkv_w", "ff_w1", "gu_w"}
_ROW = {"o_w", "ff_w2", "down_w"}
_COL_BIAS = {"qkv_b", "ff_b1"}
_ATTN = {"qkv_w", "qkv_b", "o_w"}
TURN_TIMEOUT_S = 900.0


@dataclasses.dataclass
class ShardedModel:
    """One model's parameters over a mesh: position (g, m) runs
    `params[g][m]` (its slices, on its device) with `cfg` (the local head
    counts). `split` says which blocks were split over the model axis."""
    params: list
    cfg: object
    split: dict

    def position_bytes(self) -> list:
        """Parameter bytes each position holds, data-major."""
        from rag_serving_system_torch.ops.quant import weight_bytes

        return [weight_bytes(p) for row in self.params for p in row]


# ---------------------------------------------------------------------------
# the split plan
# ---------------------------------------------------------------------------

def _arange(a: int, b: int) -> torch.Tensor:
    return torch.arange(a, b, dtype=torch.long)


def _attn_units(layers: dict, cfg, tp: int):
    """Per position, (qkv output columns, o_w input rows) by whole heads;
    None where the attention block is replicated."""
    hq = cfg.num_heads
    hk = getattr(cfg, "num_kv_heads", hq)
    d = cfg.head_dim
    o_w = layers["o_w"]
    if tp == 1 or hq % tp or hk % tp or (
            isinstance(o_w, QuantizedWeight4) and o_w.q.shape[-3] % tp):
        return None
    nq, nk = hq // tp * d, hk // tp * d
    plan = []
    for m in range(tp):
        q = _arange(m * nq, (m + 1) * nq)
        k = _arange(hq * d + m * nk, hq * d + (m + 1) * nk)
        v = k + hk * d
        plan.append((torch.cat([q, k, v]), q))
    return plan


def _mlp_units(layers: dict, tp: int):
    """Per position, the MLP units (intermediate indices) it holds, in the
    order its slice of the down product reads them; None where the MLP is
    replicated."""
    down = layers["down_w"] if "down_w" in layers else layers["ff_w2"]
    if tp == 1:
        return None
    if isinstance(down, QuantizedWeight4):
        groups, g2 = down.q.shape[-3], down.q.shape[-2]
        g = 2 * g2
        if groups % tp == 0:
            n = groups // tp * g
            return [_arange(m * n, (m + 1) * n) for m in range(tp)]
        if g2 % tp == 0:
            # packed byte j holds group rows j and j + g/2: a slice of bytes
            # holds those two row ranges of every group
            n = g2 // tp
            out = []
            for m in range(tp):
                j = _arange(m * n, (m + 1) * n)
                out.append(torch.cat([torch.cat([gi * g + j, gi * g + g2 + j])
                                      for gi in range(groups)]))
            return out
        return None
    inner = down.shape[-2] if isinstance(down, torch.Tensor) else down.q.shape[-2]
    if inner % tp:
        return None
    n = inner // tp
    return [_arange(m * n, (m + 1) * n) for m in range(tp)]


def _cols(w, idx: torch.Tensor):
    """Output columns `idx` of a weight or a bias (quantized: values and
    scales alike)."""
    if isinstance(w, (QuantizedWeight, QuantizedWeight4)):
        return type(w)(w.q.index_select(-1, idx.to(w.q.device)),
                       w.scale.index_select(-1, idx.to(w.scale.device)))
    return w.index_select(-1, idx.to(w.device))


def _rows(w, idx: torch.Tensor, tp: int, m: int):
    """Input rows `idx` of a row-parallel weight. An int8 weight keeps its
    per-output scales whole; an int4 weight takes its m-th group slice when
    the group count divides, else its m-th packed-axis slice (scales whole),
    as `_mlp_units` / `_attn_units` planned."""
    if isinstance(w, QuantizedWeight4):
        groups, g2 = w.q.shape[-3], w.q.shape[-2]
        if groups % tp == 0:
            n = groups // tp
            sel = _arange(m * n, (m + 1) * n)
            return QuantizedWeight4(w.q.index_select(-3, sel.to(w.q.device)),
                                    w.scale.index_select(-3, sel.to(w.scale.device)))
        n = g2 // tp
        sel = _arange(m * n, (m + 1) * n)
        return QuantizedWeight4(w.q.index_select(-2, sel.to(w.q.device)), w.scale)
    if isinstance(w, QuantizedWeight):
        return QuantizedWeight(w.q.index_select(-2, idx.to(w.q.device)), w.scale)
    return w.index_select(-2, idx.to(w.device))


def _to(tree, device):
    """A tree's tensors on `device` (no copy for those already there)."""
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (QuantizedWeight, QuantizedWeight4)):
        return type(tree)(*(t.to(device) for t in tree))
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree


def _position_layers(layers: dict, attn, mlp, tp: int, m: int) -> dict:
    """Model position m's stacked layer leaves: its slices of the split
    blocks, the rest whole."""
    out = {}
    for key, w in layers.items():
        if key in _ATTN and attn is not None:
            cols, rows = attn[m]
            out[key] = _rows(w, rows, tp, m) if key in _ROW else _cols(w, cols)
        elif key in _ATTN or mlp is None or not (key in _COL or key in _ROW
                                                  or key in _COL_BIAS):
            out[key] = w
        elif key in _ROW:
            out[key] = _rows(w, mlp[m], tp, m)
        elif key == "gu_w":
            half = (w.shape[-1] if isinstance(w, torch.Tensor) else w.q.shape[-1]) // 2
            out[key] = _cols(w, torch.cat([mlp[m], mlp[m] + half]))
        else:
            out[key] = _cols(w, mlp[m])
    return out


def shard_params(params: dict, mesh: Mesh, cfg) -> ShardedModel:
    """Every mesh position's parameters: its slices of the split blocks and
    the replicated rest, on its own device. `cfg` gives the head structure
    (the fused qkv split needs it); the result's `cfg` carries the local
    head counts (the decoder's; the encoder reads its local heads from its
    qkv width). Positions that share a device and a model index share their
    tensors. Every slice is a tensor of its own, so dropping `params` frees
    the whole matrices."""
    tp = mesh.shape["model"]
    layers = params["layers"]
    attn = _attn_units(layers, cfg, tp)
    mlp = _mlp_units(layers, tp)
    local_cfg = cfg
    if attn is not None and hasattr(cfg, "num_kv_heads"):
        local_cfg = dataclasses.replace(cfg, num_heads=cfg.num_heads // tp,
                                        num_kv_heads=cfg.num_kv_heads // tp)
    sliced = [dict(params, layers=_position_layers(layers, attn, mlp, tp, m))
              for m in range(tp)]
    placed: dict = {}
    grid = []
    for g in range(mesh.shape["data"]):
        row = []
        for m in range(tp):
            key = (m, mesh.device(g, m))
            if key not in placed:
                placed[key] = _to(sliced[m], key[1])
            row.append(placed[key])
        grid.append(row)
    return ShardedModel(params=grid, cfg=local_cfg,
                        split={"attn": attn is not None, "mlp": mlp is not None})


# ---------------------------------------------------------------------------
# lockstep
# ---------------------------------------------------------------------------

_local = threading.local()


class _Turns:
    """The turn of one call's positions: a fixed ring, one lock a position,
    held except while it is that position's turn."""

    def __init__(self, ring: list):
        self.ring = list(ring)
        self._locks = {p: threading.Lock() for p in ring}
        for lock in self._locks.values():
            lock.acquire()
        self._guard = threading.Lock()

    def start(self) -> None:
        self._locks[self.ring[0]].release()

    def wait(self, me) -> None:
        if not self._locks[me].acquire(timeout=TURN_TIMEOUT_S):
            raise TimeoutError(f"mesh position {me}: no turn in {TURN_TIMEOUT_S} s")

    def pass_on(self, me, leave: bool = False) -> None:
        """Give the turn to the next position of the ring; `leave` takes
        this one out of it."""
        with self._guard:
            i = self.ring.index(me)
            if leave:
                self.ring.pop(i)
                nxt = self.ring[i % len(self.ring)] if self.ring else None
            else:
                nxt = self.ring[(i + 1) % len(self.ring)]
        if nxt is not None:
            self._locks[nxt].release()


class _Exchange:
    """One data group's meeting point during one call: two alternating
    buffers of (round, partial), one slot a model position."""

    def __init__(self, tp: int):
        self.buffers = ([None] * tp, [None] * tp)
        self.broken = False


class _Position:
    __slots__ = ("me", "turns", "exchange", "m", "split", "sums")

    def __init__(self, me, turns: _Turns, exchange: _Exchange, split: dict):
        self.me, self.turns, self.exchange, self.split = me, turns, exchange, split
        self.m, self.sums = me[1], 0


def row_parallel(mm: Callable, x: torch.Tensor, w, b, block: str) -> torch.Tensor:
    """`mm(x, w, b)` for a row-parallel weight. In a model position whose
    `block` ("attn" or "mlp") is split: this position's partial `mm(x, w)`,
    summed over the group's positions in position order, then `b`. Anywhere
    else (one device, tp = 1, a replicated block): `mm(x, w, b)` itself."""
    pos = getattr(_local, "position", None)
    if pos is None or not pos.split[block]:
        return mm(x, w, b)
    round_ = pos.sums
    pos.sums += 1
    buf = pos.exchange.buffers[round_ % 2]
    buf[pos.m] = (round_, mm(x, w))
    pos.turns.pass_on(pos.me)
    pos.turns.wait(pos.me)
    if pos.exchange.broken:
        raise threading.BrokenBarrierError(f"a position of data group {pos.me[0]} failed")
    if any(entry is None or entry[0] != round_ for entry in buf):
        raise RuntimeError(f"model positions of data group {pos.me[0]} drifted apart "
                           f"at sum {round_}")
    y = all_reduce([part for _, part in buf], x.device)
    return y if b is None else y + b


def row_groups(mesh: Mesh, b: int) -> list:
    """[(data group, row slice)] of a b-row batch: split evenly over "data"
    when b divides, else the first data group serves the whole batch."""
    dp = mesh.shape["data"]
    if b % dp:
        return [(0, slice(0, b))]
    n = b // dp
    return [(g, slice(g * n, (g + 1) * n)) for g in range(dp)]


def rings(mesh: Mesh, groups) -> list:
    """The turn rings of a call on the data groups `groups` (rings run at
    once): one ring that holds every group (see "Data groups" in the module
    docstring)."""
    return [[(g, m) for g in groups for m in range(mesh.shape["model"])]]


def run_positions(mesh: Mesh, model: ShardedModel, fn: Callable, groups) -> dict:
    """fn(g, m) on every model position of the data groups `groups`, in
    lockstep (see the module docstring), the rings of `rings` at once;
    {(g, m): result}. Raises the first position's error."""
    tp = mesh.shape["model"]
    groups = list(groups)
    if len(groups) == 1 and tp == 1:
        return {(groups[0], 0): fn(groups[0], 0)}
    exchanges = {g: _Exchange(tp) for g in groups}
    results: dict = {}
    errors: list = []

    def body(turns: _Turns, g: int, m: int) -> None:
        me = (g, m)
        try:
            turns.wait(me)
        except TimeoutError as e:
            errors.append(e)
            return
        _local.position = _Position(me, turns, exchanges[g], model.split) if tp > 1 else None
        try:
            results[me] = fn(g, m)
        except BaseException as e:   # noqa: BLE001 - handed to the caller
            errors.append(e)
            exchanges[g].broken = True
        finally:
            _local.position = None
            turns.pass_on(me, leave=True)

    all_turns = [_Turns(ring) for ring in rings(mesh, groups)]
    threads = [threading.Thread(target=body, args=(turns, *t), name=f"mesh-{t[0]}-{t[1]}",
                                daemon=True) for turns in all_turns for t in turns.ring]
    for t in threads:
        t.start()
    for turns in all_turns:
        turns.start()
    for t in threads:
        t.join()
    if errors:
        first = [e for e in errors if not isinstance(e, threading.BrokenBarrierError)]
        raise (first or errors)[0]
    return results
