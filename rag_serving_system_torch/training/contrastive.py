"""Contrastive fine-tuning of the query encoder (InfoNCE, in-batch negatives).

Counterpart of `rag_serving_system_tpu/training/contrastive.py`: the same
loss, batches and loop as plain functions on the port's tensor dicts.
Autograd runs through the plain encoder (`models/e5.py`), and
`torch.optim.AdamW` takes the place of `optax.adamw`, with optax's defaults.
The step updates the parameter tree in place; `train_encoder` trains a copy
on its device, so the caller's tree is left as it was, as the JAX loop
leaves it.

Loss: symmetric InfoNCE over L2-normalised masked-mean embeddings with
temperature tau. Checkpoints are safetensors files of the tree's leaves
under dotted names (`embed.word`, `layers.qkv_w`, ...), each in its own
dtype; the JAX package writes flax msgpack bytes instead, which neither
engine reads.
"""

from __future__ import annotations

import logging
from typing import Iterator

import numpy as np
import torch
import torch.nn.functional as F

from rag_serving_system_torch.device import resolve_device
from rag_serving_system_torch.models.configs import EncoderConfig
from rag_serving_system_torch.models.e5 import encoder_forward, pool
from rag_serving_system_torch.models.weights import (
    map_tree,
    named_leaves,
    read_safetensors,
    write_safetensors,
)

logger = logging.getLogger(__name__)


def _embed(params, cfg, ids, mask, dtype):
    emb = pool(encoder_forward(params, cfg, ids, mask, dtype=dtype), mask, "mean_masked")
    norm = torch.linalg.vector_norm(emb, dim=-1, keepdim=True)
    return emb / torch.clamp(norm, min=1e-6)


def contrastive_loss(params, cfg: EncoderConfig, batch, tau: float = 0.05,
                     dtype=torch.bfloat16):
    """batch = dict(q_ids, q_mask, p_ids, p_mask), all (B, L). Returns
    (loss, in-batch accuracy) as 0-d f32 tensors."""
    q = _embed(params, cfg, batch["q_ids"], batch["q_mask"], dtype)   # (B, H)
    p = _embed(params, cfg, batch["p_ids"], batch["p_mask"], dtype)   # (B, H)
    logits = q @ p.T / tau                                            # (B, B)
    labels = torch.arange(q.shape[0], device=logits.device)
    loss_qp = F.cross_entropy(logits, labels, reduction="none")
    loss_pq = F.cross_entropy(logits.T, labels, reduction="none")
    loss = torch.mean(loss_qp + loss_pq) * 0.5
    # torch.argmax, like jnp.argmax, takes the first of equal maxima
    acc = (torch.argmax(logits, dim=-1) == labels).float().mean()
    return loss, acc


def adamw(params, lr: float) -> torch.optim.AdamW:
    """`torch.optim.AdamW` over every leaf of `params` with optax.adamw's
    defaults: betas (0.9, 0.999), eps 1e-8, weight decay 1e-4 (torch's own
    default decay is 0.01). Marks the leaves as requiring gradients."""
    leaves = [t.requires_grad_(True) for _, t in named_leaves(params)]
    return torch.optim.AdamW(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)


def make_train_step(cfg: EncoderConfig, optimizer: torch.optim.Optimizer,
                    tau: float = 0.05, dtype=torch.bfloat16):
    """Returns step(params, batch) -> {"loss", "in_batch_acc"} (0-d tensors,
    left on the device), which updates the parameters (those `optimizer`
    holds) in place."""

    def train_step(params, batch):
        optimizer.zero_grad(set_to_none=True)
        loss, acc = contrastive_loss(params, cfg, batch, tau=tau, dtype=dtype)
        loss.backward()
        optimizer.step()
        return {"loss": loss.detach(), "in_batch_acc": acc}

    return train_step


def pair_batches(tokenizer, pairs, batch_size: int, max_len: int,
                 seed: int = 0, query_key: str = "query",
                 passage_key: str = "fact", device=None) -> Iterator[dict]:
    """Tokenized (query, passage) batches of a pairs list (the
    data/*_pairs.json schema) as tensors on `device`, in the JAX module's
    order; a last partial batch is dropped."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(pairs))
    for i in range(0, len(order) - batch_size + 1, batch_size):
        chunk = [pairs[j] for j in order[i:i + batch_size]]
        q_ids, q_mask = tokenizer.encode_batch(
            ["query: " + c[query_key] for c in chunk], max_len)
        p_ids, p_mask = tokenizer.encode_batch(
            ["passage: " + c.get(passage_key, c.get("context", "")) for c in chunk],
            max_len)
        yield {name: torch.as_tensor(arr, device=dev) for name, arr in
               (("q_ids", q_ids), ("q_mask", q_mask), ("p_ids", p_ids), ("p_mask", p_mask))}


def train_encoder(params, cfg: EncoderConfig, tokenizer, pairs,
                  epochs: int = 1, batch_size: int = 16, max_len: int = 64,
                  lr: float = 1e-5, tau: float = 0.05, dtype=torch.bfloat16,
                  seed: int = 0, device=None):
    """Train a copy of `params` on `device` (the card unless the caller
    passes "cpu"). Returns (trained params, history): one
    {"loss", "in_batch_acc"} of floats a step."""
    dev = resolve_device(device)
    params = map_tree(params, lambda t: t.detach().to(dev, copy=True))
    optimizer = adamw(params, lr)
    step_fn = make_train_step(cfg, optimizer, tau=tau, dtype=dtype)
    metrics = []
    for epoch in range(epochs):
        for batch in pair_batches(tokenizer, pairs, batch_size, max_len,
                                  seed=seed + epoch, device=dev):
            metrics.append(step_fn(params, batch))
        if metrics:
            logger.info("epoch %d: loss=%.4f acc=%.3f", epoch,
                        float(metrics[-1]["loss"]), float(metrics[-1]["in_batch_acc"]))
    # one read of the device at the end, not one a step
    history = [{k: float(v) for k, v in m.items()} for m in metrics]
    return map_tree(params, lambda t: t.detach()), history


# ---------------------------------------------------------------------------
# checkpointing (safetensors, dotted leaf names)
# ---------------------------------------------------------------------------

def save_checkpoint(path: str, params) -> int:
    """Every leaf of `params` under its dotted name, in its own dtype.
    Returns the bytes written."""
    return write_safetensors(path, dict(named_leaves(params)))


def load_checkpoint(path: str, params_template):
    """The tree saved at `path`, in the structure of `params_template` and on
    its leaves' devices, each leaf in its stored dtype. Raises ValueError on
    a name missing from either side or a shape unlike the template's."""
    stored = read_safetensors(path)
    want = dict(named_leaves(params_template))
    if set(stored) != set(want):
        raise ValueError(f"{path}: missing {sorted(set(want) - set(stored))}, "
                         f"unexpected {sorted(set(stored) - set(want))}")
    for name, t in want.items():
        if tuple(stored[name].shape) != tuple(t.shape):
            raise ValueError(f"{path}: {name} has shape {tuple(stored[name].shape)}, "
                             f"the template {tuple(t.shape)}")

    def build(tree, prefix=""):
        return {k: build(v, prefix + k + ".") if isinstance(v, dict)
                else stored[prefix + k].to(v.device, copy=True) for k, v in tree.items()}

    return build(params_template)
