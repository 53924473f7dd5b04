"""Parameters: random init at full width, HF safetensors checkpoints, and the
converters of JAX parameter trees, prefix-KV entries and IVF indexes.

Counterpart of `rag_serving_system_tpu/models/weights.py`. The trees keep
the JAX layout: dense weights (in, out), layer weights stacked on a leading
L axis, the decoder's `lm_head` omitted when tied to `embed`. Checkpoints
are read and written by this module's own safetensors reader and writer
(`read_safetensors`, `write_safetensors`): the format is an 8-byte header
length, a JSON header and raw little-endian data, and the port must not need
the `safetensors` package.
"""

from __future__ import annotations

import json
import mmap
import os

import numpy as np
import torch

from rag_serving_system_torch.models.configs import DecoderConfig, EncoderConfig


def _trunc_normal(g: torch.Generator, shape, dtype, device, std=0.02):
    """Normal clipped to +-2 sigma, times std: the JAX init's distribution
    (not its bits: torch.Generator and jax.random differ)."""
    x = torch.randn(shape, generator=g, dtype=torch.float32, device=device)
    return x.clamp_(-2.0, 2.0).mul_(std).to(dtype)


def init_encoder_params(cfg: EncoderConfig, seed: int = 0, dtype=torch.bfloat16,
                        device="cpu") -> dict:
    g = torch.Generator(device=device).manual_seed(seed)
    h, ff, n = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers

    def rnd(*shape):
        return _trunc_normal(g, shape, dtype, device)

    def const(value, *shape):
        return torch.full(shape, value, dtype=dtype, device=device)

    return {
        "embed": {
            "word": rnd(cfg.vocab_size, h),
            "pos": rnd(cfg.max_position_embeddings, h),
            "type": rnd(cfg.type_vocab_size, h),
            "ln_scale": const(1.0, h),
            "ln_bias": const(0.0, h),
        },
        "layers": {
            "qkv_w": rnd(n, h, 3 * h),
            "qkv_b": const(0.0, n, 3 * h),
            "o_w": rnd(n, h, h),
            "o_b": const(0.0, n, h),
            "attn_ln_scale": const(1.0, n, h),
            "attn_ln_bias": const(0.0, n, h),
            "ff_w1": rnd(n, h, ff),
            "ff_b1": const(0.0, n, ff),
            "ff_w2": rnd(n, ff, h),
            "ff_b2": const(0.0, n, h),
            "ff_ln_scale": const(1.0, n, h),
            "ff_ln_bias": const(0.0, n, h),
        },
    }


def init_decoder_params(cfg: DecoderConfig, seed: int = 1, dtype=torch.bfloat16,
                        device="cpu") -> dict:
    g = torch.Generator(device=device).manual_seed(seed)
    h, n, ff = cfg.hidden_size, cfg.num_layers, cfg.intermediate_size
    qkv = (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim

    def rnd(*shape):
        return _trunc_normal(g, shape, dtype, device)

    params = {
        "embed": rnd(cfg.vocab_size, h),
        "layers": {
            "ln1": torch.ones((n, h), dtype=dtype, device=device),
            "qkv_w": rnd(n, h, qkv),
            "o_w": rnd(n, cfg.num_heads * cfg.head_dim, h),
            "ln2": torch.ones((n, h), dtype=dtype, device=device),
            "gu_w": rnd(n, h, 2 * ff),
            "down_w": rnd(n, ff, h),
        },
        "ln_f": torch.ones((h,), dtype=dtype, device=device),
    }
    if cfg.qkv_bias:
        params["layers"]["qkv_b"] = torch.zeros((n, qkv), dtype=dtype, device=device)
    if not cfg.tie_word_embeddings:
        params["lm_head"] = rnd(h, cfg.vocab_size)
    return params


# ---------------------------------------------------------------------------
# HF safetensors checkpoints
# ---------------------------------------------------------------------------

SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}


def read_safetensors(path: str) -> dict[str, torch.Tensor]:
    """One .safetensors file as a name → CPU tensor dict. The tensors are
    views of a private (copy-on-write) memory map of the file, which lives
    as long as any of them: nothing is read until a tensor is used, and a
    write to one never reaches the file."""
    with open(path, "rb") as f:
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    n = int.from_bytes(mm[:8], "little")
    header = json.loads(mm[8:8 + n].decode("utf-8"))
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in SAFETENSORS_DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has dtype {info['dtype']}, "
                             f"not one of {sorted(SAFETENSORS_DTYPES)}")
        dtype = SAFETENSORS_DTYPES[info["dtype"]]
        shape = tuple(info["shape"])
        begin, end = info["data_offsets"]
        count = int(np.prod(shape, dtype=np.int64))
        if (end - begin) != count * dtype.itemsize:
            raise ValueError(f"{path}: tensor {name!r} spans {end - begin} bytes, "
                             f"its shape {shape} needs {count * dtype.itemsize}")
        if count == 0:
            out[name] = torch.empty(shape, dtype=dtype)
        else:
            out[name] = torch.frombuffer(mm, dtype=dtype, count=count,
                                         offset=8 + n + begin).reshape(shape)
    return out


def named_leaves(tree: dict, prefix: str = ""):
    """(dotted name, leaf) of every leaf of a nested dict, in its order:
    `embed.word`, `layers.qkv_w`, ..."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from named_leaves(v, prefix + k + ".")
        else:
            yield prefix + k, v


def map_tree(tree: dict, fn) -> dict:
    """The nested dict with fn applied to every leaf."""
    return {k: map_tree(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def write_safetensors(path: str, tensors: dict) -> int:
    """Write name → tensor as one .safetensors file (8-byte little-endian
    header length, JSON header, raw little-endian data), each tensor in its
    own dtype: the inverse of `read_safetensors`. Tensors are copied to the
    host one at a time. Returns the bytes written."""
    codes = {dtype: code for code, dtype in SAFETENSORS_DTYPES.items()}
    header, offset = {}, 0
    for name, t in tensors.items():
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": codes[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    blob = json.dumps(header, separators=(",", ":")).encode("utf-8")
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(len(blob).to_bytes(8, "little"))
        f.write(blob)
        for t in tensors.values():
            f.write(t.detach().contiguous().cpu().reshape(-1).view(torch.uint8).numpy().data)
    return 8 + len(blob) + offset


def load_safetensors_dir(path: str) -> dict[str, torch.Tensor]:
    """Every *.safetensors file under `path` as one flat name → tensor dict."""
    files = sorted(f for f in os.listdir(path) if f.endswith(".safetensors"))
    if not files:
        raise FileNotFoundError(f"no .safetensors files in {path}")
    tensors: dict[str, torch.Tensor] = {}
    for fname in files:
        tensors.update(read_safetensors(os.path.join(path, fname)))
    return tensors


def _getter(tensors: dict, device, prefixes=("",)):
    """(A, W): `A(name)` is the named checkpoint tensor on `device` (tried
    under each prefix), `W(name)` the same transposed from HF's (out, in) to
    (in, out). Tensors move to the device as stored; the transposes,
    concatenations and the cast to the serving dtype then run there."""
    def A(name):
        for pre in prefixes:
            if pre + name in tensors:
                return tensors[pre + name].to(device)
        raise KeyError(f"none of {[pre + name for pre in prefixes]} in checkpoint "
                       f"(have {len(tensors)} tensors)")

    def W(name):
        return A(name).t()

    return A, W


def _stack_layers(layer_list: list[dict], dtype) -> dict:
    """[{name: (...)}] one dict a layer → {name: (L, ...)} in `dtype`."""
    return {k: torch.stack([layer[k] for layer in layer_list]).to(dtype)
            for k in layer_list[0]}


def load_encoder_params(cfg: EncoderConfig, snapshot_dir: str, dtype=torch.bfloat16,
                        device="cpu") -> dict:
    """An XLM-RoBERTa / BERT checkpoint in HF names as the port's tree: linear
    weights transposed to (in, out), q/k/v fused, layers stacked."""
    A, W = _getter(load_safetensors_dir(snapshot_dir), device,
                   ("", "roberta.", "bert."))
    layer_list = []
    for i in range(cfg.num_layers):
        p = f"encoder.layer.{i}."
        layer_list.append({
            "qkv_w": torch.cat([W(p + "attention.self.query.weight"),
                                W(p + "attention.self.key.weight"),
                                W(p + "attention.self.value.weight")], dim=1),
            "qkv_b": torch.cat([A(p + "attention.self.query.bias"),
                                A(p + "attention.self.key.bias"),
                                A(p + "attention.self.value.bias")], dim=0),
            "o_w": W(p + "attention.output.dense.weight"),
            "o_b": A(p + "attention.output.dense.bias"),
            "attn_ln_scale": A(p + "attention.output.LayerNorm.weight"),
            "attn_ln_bias": A(p + "attention.output.LayerNorm.bias"),
            "ff_w1": W(p + "intermediate.dense.weight"),
            "ff_b1": A(p + "intermediate.dense.bias"),
            "ff_w2": W(p + "output.dense.weight"),
            "ff_b2": A(p + "output.dense.bias"),
            "ff_ln_scale": A(p + "output.LayerNorm.weight"),
            "ff_ln_bias": A(p + "output.LayerNorm.bias"),
        })
    return {
        "embed": {
            "word": A("embeddings.word_embeddings.weight").to(dtype),
            "pos": A("embeddings.position_embeddings.weight").to(dtype),
            "type": A("embeddings.token_type_embeddings.weight").to(dtype),
            "ln_scale": A("embeddings.LayerNorm.weight").to(dtype),
            "ln_bias": A("embeddings.LayerNorm.bias").to(dtype),
        },
        "layers": _stack_layers(layer_list, dtype),
    }


def load_decoder_params(cfg: DecoderConfig, snapshot_dir: str, dtype=torch.bfloat16,
                        device="cpu") -> dict:
    """A Llama-family (Qwen2, Llama, Mistral) checkpoint in HF names as the
    port's tree: q/k/v and gate/up fused, `qkv_b` only under `cfg.qkv_bias`,
    `lm_head` only when the checkpoint has one and the config does not tie
    it."""
    tensors = load_safetensors_dir(snapshot_dir)
    A, W = _getter(tensors, device)
    layer_list = []
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        layer = {
            "ln1": A(p + "input_layernorm.weight"),
            "qkv_w": torch.cat([W(p + "self_attn.q_proj.weight"),
                                W(p + "self_attn.k_proj.weight"),
                                W(p + "self_attn.v_proj.weight")], dim=1),
            "o_w": W(p + "self_attn.o_proj.weight"),
            "ln2": A(p + "post_attention_layernorm.weight"),
            "gu_w": torch.cat([W(p + "mlp.gate_proj.weight"),
                               W(p + "mlp.up_proj.weight")], dim=1),
            "down_w": W(p + "mlp.down_proj.weight"),
        }
        if cfg.qkv_bias:
            layer["qkv_b"] = torch.cat([A(p + "self_attn.q_proj.bias"),
                                        A(p + "self_attn.k_proj.bias"),
                                        A(p + "self_attn.v_proj.bias")], dim=0)
        layer_list.append(layer)
    params = {
        "embed": A("model.embed_tokens.weight").to(dtype),
        "layers": _stack_layers(layer_list, dtype),
        "ln_f": A("model.norm.weight").to(dtype),
    }
    if "lm_head.weight" in tensors and not cfg.tie_word_embeddings:
        params["lm_head"] = W("lm_head.weight").contiguous().to(dtype)
    return params


def find_snapshot(weights_dir: str | None, model_name: str) -> str | None:
    """A local HF snapshot of `model_name`: under `weights_dir` (as
    `org--name`, as `name`, or the directory itself), else in the HF hub
    cache of the user's home. The first candidate that holds a .safetensors
    file."""
    candidates = []
    if weights_dir:
        candidates.append(os.path.join(weights_dir, model_name.replace("/", "--")))
        candidates.append(os.path.join(weights_dir, model_name.split("/")[-1]))
        candidates.append(weights_dir)
    hub = os.path.expanduser("~/.cache/huggingface/hub")
    repo = os.path.join(hub, "models--" + model_name.replace("/", "--"), "snapshots")
    if os.path.isdir(repo):
        for snap in sorted(os.listdir(repo)):
            candidates.append(os.path.join(repo, snap))
    for c in candidates:
        if c and os.path.isdir(c) and any(f.endswith(".safetensors")
                                          for f in os.listdir(c)):
            return c
    return None


def snapshot_hf_config(weights_dir: str | None, model_name: str) -> dict | None:
    """The snapshot's config.json, when a local snapshot with one exists: the
    engine then takes the architecture from the checkpoint, not a preset."""
    snap = find_snapshot(weights_dir, model_name)
    if not snap:
        return None
    cfg_path = os.path.join(snap, "config.json")
    if not os.path.exists(cfg_path):
        return None
    with open(cfg_path, "r", encoding="utf-8") as f:
        return json.load(f)


def get_encoder_params(cfg: EncoderConfig, weights_dir: str | None, model_name: str,
                       dtype=torch.bfloat16, device="cpu") -> tuple[dict, bool]:
    """(params, whether a checkpoint was loaded); random init (seed 0)
    without a snapshot."""
    snap = find_snapshot(weights_dir, model_name)
    if snap:
        return load_encoder_params(cfg, snap, dtype=dtype, device=device), True
    return init_encoder_params(cfg, seed=0, dtype=dtype, device=device), False


def get_decoder_params(cfg: DecoderConfig, weights_dir: str | None, model_name: str,
                       dtype=torch.bfloat16, device="cpu") -> tuple[dict, bool]:
    """(params, whether a checkpoint was loaded); random init (seed 1)
    without a snapshot."""
    snap = find_snapshot(weights_dir, model_name)
    if snap:
        return load_decoder_params(cfg, snap, dtype=dtype, device=device), True
    return init_decoder_params(cfg, seed=1, dtype=dtype, device=device), False


# ---------------------------------------------------------------------------
# converters of the JAX package's trees
# ---------------------------------------------------------------------------

def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes: reinterpret the 16 bits
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_jax(tree, device="cpu"):
    """A JAX parameter tree (dicts of arrays; numpy or jax leaves) as the
    port's tree of tensors. The layouts already agree, so this is a
    leaf-by-leaf copy. A quantized node of the JAX package
    (`QuantizedWeight`, `QuantizedWeight4`: a named tuple of `q` and
    `scale`) becomes the port's node of the same name with the same bits."""
    from rag_serving_system_torch.ops.quant import QuantizedWeight, QuantizedWeight4

    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [params_from_jax(v, device) for v in tree]
    if hasattr(tree, "q") and hasattr(tree, "scale"):
        node = QuantizedWeight4 if type(tree).__name__ == "QuantizedWeight4" else QuantizedWeight
        return node(_tensor(tree.q, device), _tensor(tree.scale, device))
    return _tensor(tree, device)


def prefix_kv_from_jax(kv, device="cpu"):
    """A JAX prefix-KV batch (M, L, 2, PL, Hk, D) (numpy or jax leaves), or
    its (int8 values, f32 scales) pair, as the port's tensors: what
    `qwen2.prefill(prefix_kv=...)` takes."""
    if isinstance(kv, (tuple, list)):
        return tuple(_tensor(leaf, device) for leaf in kv)
    return _tensor(kv, device)


def ivf_index_from_jax(index, device="cpu"):
    """A JAX `IvfIndex` (numpy or jax leaves) as the port's `IvfIndex`."""
    from rag_serving_system_torch.ops.ivf import IvfIndex

    return IvfIndex(*(_tensor(leaf, device) for leaf in index))
