"""PyTorch port: checkpoint, config and tokenizer loading against the JAX
package, on tiny HF models and tokenizers saved inside the test.

The port reads safetensors with its own reader (held against the
`safetensors` package on F32, F16, BF16 and I64), maps HF names to its tree
with the JAX loader's bits (`params_from_jax(load_*_params(...))`), derives
the same configs from config.json field by field, finds the same snapshot
directories, tokenizes like the JAX adapter, and the engine under
WEIGHTS_DIR gives the JAX engine's greedy answers in f32."""

import dataclasses
import json
import os
import sys

os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")
os.environ.setdefault("HF_HUB_OFFLINE", "1")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")
st = pytest.importorskip("safetensors.torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rag_serving_system_tpu.models import configs as jcfg  # noqa: E402
from rag_serving_system_tpu.models import tokenizer as jtok  # noqa: E402
from rag_serving_system_tpu.models import weights as jw  # noqa: E402
from rag_serving_system_torch.models import configs as tcfg  # noqa: E402
from rag_serving_system_torch.models import tokenizer as ttok  # noqa: E402
from rag_serving_system_torch.models import weights as tw  # noqa: E402

from test_hf_integration import DOCS, _save_fast, _train_tokenizer  # noqa: E402
from test_torch_engine import (  # noqa: E402
    jax_engine, jax_settings, port_engine, tiny_settings)
from test_torch_models import _scaled  # noqa: E402

E5_TINY, QWEN2_TINY = jcfg.E5_TINY, jcfg.QWEN2_TINY
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BPE_DIR = os.path.join(ROOT, "data", "bpe_tokenizer")
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(scope="module")
def snapshots(tmp_path_factory):
    """<root>/enc and <root>/dec: an XLM-R encoder and a Qwen2 decoder at the
    tiny presets' sizes, saved by `save_pretrained` with trained BPE
    tokenizers beside them (the layout of tests/test_hf_integration.py)."""
    from transformers import (Qwen2Config, Qwen2ForCausalLM, XLMRobertaConfig,
                              XLMRobertaModel)

    root = tmp_path_factory.mktemp("snapshots")
    enc_dir, dec_dir = str(root / "enc"), str(root / "dec")
    torch.manual_seed(0)
    XLMRobertaModel(XLMRobertaConfig(
        vocab_size=E5_TINY.vocab_size, hidden_size=E5_TINY.hidden_size,
        num_hidden_layers=E5_TINY.num_layers, num_attention_heads=E5_TINY.num_heads,
        intermediate_size=E5_TINY.intermediate_size,
        max_position_embeddings=E5_TINY.max_position_embeddings,
        type_vocab_size=1, pad_token_id=1, hidden_act="gelu",
    )).eval().save_pretrained(enc_dir)
    _save_fast(_train_tokenizer(["<unk>", "<pad>", "<eos>"]), enc_dir,
               pad="<pad>", eos="<eos>")
    torch.manual_seed(1)
    Qwen2ForCausalLM(Qwen2Config(
        vocab_size=QWEN2_TINY.vocab_size, hidden_size=QWEN2_TINY.hidden_size,
        num_hidden_layers=QWEN2_TINY.num_layers,
        num_attention_heads=QWEN2_TINY.num_heads,
        num_key_value_heads=QWEN2_TINY.num_kv_heads,
        intermediate_size=QWEN2_TINY.intermediate_size,
        max_position_embeddings=QWEN2_TINY.max_position_embeddings,
        rope_theta=QWEN2_TINY.rope_theta, rms_norm_eps=QWEN2_TINY.rms_norm_eps,
        tie_word_embeddings=True, pad_token_id=0, eos_token_id=1, bos_token_id=2,
    )).eval().save_pretrained(dec_dir)
    _save_fast(_train_tokenizer(["<pad>", "<eos>", "<unk>"]), dec_dir,
               pad="<pad>", eos="<eos>")
    return str(root), enc_dir, dec_dir


def _assert_trees_equal(ours, ref):
    """Every leaf of the port's tree bit-equal to the converted JAX tree."""
    assert set(ours) == set(ref)
    for k in ours:
        if isinstance(ours[k], dict):
            _assert_trees_equal(ours[k], ref[k])
        else:
            assert ours[k].dtype == ref[k].dtype and ours[k].shape == ref[k].shape, k
            assert torch.equal(ours[k], ref[k]), k


# ---------------------------------------------------------------------------
# the safetensors reader
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16,
                                   torch.int64], ids=["F32", "F16", "BF16", "I64"])
def test_reader_matches_safetensors(tmp_path, dtype):
    g = torch.Generator().manual_seed(0)
    if dtype.is_floating_point:
        mk = lambda *s: torch.randn(s, generator=g).to(dtype)  # noqa: E731
    else:
        mk = lambda *s: torch.randint(-2**40, 2**40, s, generator=g)  # noqa: E731
    tensors = {"a.weight": mk(5, 7), "b": mk(3), "scalar": mk(), "c": mk(2, 3, 4),
               "empty": torch.empty((0, 4), dtype=dtype)}
    path = str(tmp_path / "model.safetensors")
    st.save_file(tensors, path, metadata={"format": "pt"})
    ours, ref = tw.read_safetensors(path), st.load_file(path)
    assert set(ours) == set(ref) == set(tensors)
    for k in ref:
        assert ours[k].dtype == ref[k].dtype == dtype and ours[k].shape == ref[k].shape
        assert torch.equal(ours[k], ref[k]), k
    # a write to a loaded tensor never reaches the file
    ours["a.weight"].zero_()
    assert torch.equal(st.load_file(path)["a.weight"], tensors["a.weight"])


def test_reader_takes_every_file_of_a_directory(tmp_path):
    st.save_file({"x": torch.ones(2, 2)}, str(tmp_path / "model-00001-of-00002.safetensors"))
    st.save_file({"y": torch.zeros(3, dtype=torch.bfloat16)},
                 str(tmp_path / "model-00002-of-00002.safetensors"))
    (tmp_path / "config.json").write_text("{}")
    got = tw.load_safetensors_dir(str(tmp_path))
    assert set(got) == {"x", "y"} and got["y"].dtype == torch.bfloat16
    with pytest.raises(FileNotFoundError):
        tw.load_safetensors_dir(str(tmp_path / ".."))


def test_reader_refuses_a_short_tensor(tmp_path):
    header = json.dumps({"w": {"dtype": "F32", "shape": [4], "data_offsets": [0, 8]}})
    path = tmp_path / "bad.safetensors"
    path.write_bytes(len(header).to_bytes(8, "little") + header.encode() + b"\0" * 8)
    with pytest.raises(ValueError, match="needs 16"):
        tw.read_safetensors(str(path))
    header = json.dumps({"w": {"dtype": "F8_E4M3", "shape": [4], "data_offsets": [0, 4]}})
    path.write_bytes(len(header).to_bytes(8, "little") + header.encode() + b"\0" * 4)
    with pytest.raises(ValueError, match="F8_E4M3"):
        tw.read_safetensors(str(path))


# ---------------------------------------------------------------------------
# configs from config.json
# ---------------------------------------------------------------------------

DEC_HF = {
    "qwen25": dict(model_type="qwen2", vocab_size=151936, hidden_size=1536,
                   num_hidden_layers=28, num_attention_heads=12, num_key_value_heads=2,
                   intermediate_size=8960, rms_norm_eps=1e-6, rope_theta=1e6,
                   tie_word_embeddings=True, max_position_embeddings=32768,
                   eos_token_id=[151645, 151643], pad_token_id=151643),
    "llama_no_bias": dict(model_type="llama", vocab_size=128256, hidden_size=2048,
                          num_hidden_layers=16, num_attention_heads=32,
                          num_key_value_heads=8, head_dim=64, intermediate_size=8192,
                          eos_token_id=[128001, 128008, 128009]),
    "bare": dict(vocab_size=100, hidden_size=64, num_hidden_layers=1,
                 num_attention_heads=4, intermediate_size=128),
    "bias_overridden": dict(model_type="qwen2", attention_bias=False, vocab_size=100,
                            hidden_size=96, num_hidden_layers=2, num_attention_heads=4,
                            head_dim=32, intermediate_size=128, eos_token_id=7),
}
ENC_HF = {
    "xlmr": dict(model_type="xlm-roberta", vocab_size=250002, hidden_size=1024,
                 num_hidden_layers=24, num_attention_heads=16, intermediate_size=4096,
                 max_position_embeddings=514, type_vocab_size=1, layer_norm_eps=1e-5,
                 pad_token_id=1),
    "bert": dict(model_type="bert", vocab_size=30522, hidden_size=64,
                 num_hidden_layers=2, num_attention_heads=4, intermediate_size=128,
                 max_position_embeddings=512, type_vocab_size=2, layer_norm_eps=1e-12),
    "roberta_default_pad": dict(model_type="roberta", vocab_size=100, hidden_size=64,
                                num_hidden_layers=1, num_attention_heads=4,
                                intermediate_size=128, max_position_embeddings=66),
}


@pytest.mark.parametrize("name", list(DEC_HF))
def test_decoder_config_from_hf_matches_jax(name):
    ours = tcfg.decoder_config_from_hf(DEC_HF[name])
    assert dataclasses.asdict(ours) == dataclasses.asdict(
        jcfg.decoder_config_from_hf(DEC_HF[name]))
    if name == "qwen25":          # the published config gives the preset
        assert ours == tcfg.QWEN25_15B and ours.head_dim == 128 and ours.qkv_bias
    if name == "llama_no_bias":
        assert not ours.qkv_bias and ours.eos_token_id == 128001 == ours.pad_token_id


@pytest.mark.parametrize("name", list(ENC_HF))
def test_encoder_config_from_hf_matches_jax(name):
    ours = tcfg.encoder_config_from_hf(ENC_HF[name])
    assert dataclasses.asdict(ours) == dataclasses.asdict(
        jcfg.encoder_config_from_hf(ENC_HF[name]))
    if name == "xlmr":
        assert ours == tcfg.E5_LARGE
    if name == "bert":
        assert ours.position_style == "absolute" and ours.pad_token_id == 0


def test_snapshot_configs_match_jax_and_the_presets(snapshots):
    root, enc_dir, dec_dir = snapshots
    enc_hf, dec_hf = tw.snapshot_hf_config(root, enc_dir), tw.snapshot_hf_config(root, dec_dir)
    assert enc_hf == jw.snapshot_hf_config(root, enc_dir)
    assert dec_hf == jw.snapshot_hf_config(root, dec_dir)
    assert dataclasses.asdict(tcfg.encoder_config_from_hf(enc_hf)) == dataclasses.asdict(
        jcfg.encoder_config_from_hf(enc_hf))
    # HF's XLM-R default epsilon, not the preset's: the snapshot's value is taken
    assert tcfg.encoder_config_from_hf(enc_hf) == dataclasses.replace(
        tcfg.E5_TINY, layer_norm_eps=enc_hf["layer_norm_eps"])
    assert dataclasses.asdict(tcfg.decoder_config_from_hf(dec_hf)) == dataclasses.asdict(
        jcfg.decoder_config_from_hf(dec_hf))
    assert tcfg.decoder_config_from_hf(dec_hf) == tcfg.QWEN2_TINY


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loaded_encoder_equals_the_jax_loader(snapshots, dtype):
    _, enc_dir, _ = snapshots
    ref = tw.params_from_jax(jax.device_get(
        jw.load_encoder_params(E5_TINY, enc_dir, dtype=JDT[dtype])))
    ours = tw.load_encoder_params(tcfg.E5_TINY, enc_dir, dtype=TDT[dtype], device="cpu")
    _assert_trees_equal(ours, ref)
    assert ours["layers"]["qkv_w"].shape == (2, 64, 192)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loaded_decoder_equals_the_jax_loader(snapshots, dtype):
    _, _, dec_dir = snapshots
    ref = tw.params_from_jax(jax.device_get(
        jw.load_decoder_params(QWEN2_TINY, dec_dir, dtype=JDT[dtype])))
    ours = tw.load_decoder_params(tcfg.QWEN2_TINY, dec_dir, dtype=TDT[dtype], device="cpu")
    _assert_trees_equal(ours, ref)
    assert "lm_head" not in ours and "qkv_b" in ours["layers"]
    assert all(v.is_contiguous() for v in ours["layers"].values())


def _write_decoder(path, cfg, dtype, seed=3):
    """A seeded decoder checkpoint in HF names, written by `safetensors`."""
    rng = np.random.default_rng(seed)
    qd, kvd = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    h, ff = cfg.hidden_size, cfg.intermediate_size

    def rnd(*shape):
        return torch.tensor(rng.standard_normal(shape).astype(np.float32) * 0.05).to(dtype)

    t = {"model.embed_tokens.weight": rnd(cfg.vocab_size, h), "model.norm.weight": rnd(h)}
    if not cfg.tie_word_embeddings:
        t["lm_head.weight"] = rnd(cfg.vocab_size, h)
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        t.update({p + "input_layernorm.weight": rnd(h),
                  p + "post_attention_layernorm.weight": rnd(h),
                  p + "self_attn.q_proj.weight": rnd(qd, h),
                  p + "self_attn.k_proj.weight": rnd(kvd, h),
                  p + "self_attn.v_proj.weight": rnd(kvd, h),
                  p + "self_attn.o_proj.weight": rnd(h, qd),
                  p + "mlp.gate_proj.weight": rnd(ff, h),
                  p + "mlp.up_proj.weight": rnd(ff, h),
                  p + "mlp.down_proj.weight": rnd(h, ff)})
        if cfg.qkv_bias:
            t.update({p + "self_attn.q_proj.bias": rnd(qd),
                      p + "self_attn.k_proj.bias": rnd(kvd),
                      p + "self_attn.v_proj.bias": rnd(kvd)})
    os.makedirs(path, exist_ok=True)
    # two shards: the loader reads every file of the directory
    names = sorted(t)
    st.save_file({n: t[n] for n in names[::2]}, os.path.join(path, "a.safetensors"))
    st.save_file({n: t[n] for n in names[1::2]}, os.path.join(path, "b.safetensors"))
    return t


@pytest.mark.parametrize("stored,dtype", [("F32", "float32"), ("F16", "float32"),
                                          ("F16", "bfloat16"), ("F32", "bfloat16")])
def test_untied_biasless_decoder_equals_the_jax_loader(tmp_path, stored, dtype):
    """A Llama-style checkpoint: no QKV bias, its own lm_head, head size
    given in the config, stored in F32 or F16, in two shards."""
    jc = dataclasses.replace(QWEN2_TINY, qkv_bias=False, tie_word_embeddings=False,
                             num_layers=3, head_dim=32)
    tc = dataclasses.replace(tcfg.QWEN2_TINY, qkv_bias=False, tie_word_embeddings=False,
                             num_layers=3, head_dim=32)
    d = str(tmp_path / "llama")
    _write_decoder(d, tc, torch.float32 if stored == "F32" else torch.float16)
    ref = tw.params_from_jax(jax.device_get(jw.load_decoder_params(jc, d, dtype=JDT[dtype])))
    ours = tw.load_decoder_params(tc, d, dtype=TDT[dtype], device="cpu")
    _assert_trees_equal(ours, ref)
    assert ours["lm_head"].shape == (64, 512) and "qkv_b" not in ours["layers"]
    assert ours["layers"]["qkv_w"].shape == (3, 64, (4 + 2 * 2) * 32)


def test_bf16_checkpoint_loads_bit_for_bit(tmp_path):
    """The published decoders are stored in BF16, which the JAX loader's
    numpy reader cannot take: hold the port's loader to the stored bits."""
    d = str(tmp_path / "bf16")
    t = _write_decoder(d, tcfg.QWEN2_TINY, torch.bfloat16)
    ours = tw.load_decoder_params(tcfg.QWEN2_TINY, d, dtype=torch.bfloat16, device="cpu")
    assert ours["embed"].dtype == torch.bfloat16
    assert torch.equal(ours["embed"], t["model.embed_tokens.weight"])
    q, k, v = (t[f"model.layers.1.self_attn.{n}_proj.weight"].t() for n in "qkv")
    assert torch.equal(ours["layers"]["qkv_w"][1], torch.cat([q, k, v], dim=1))
    assert torch.equal(ours["layers"]["down_w"][0], t["model.layers.0.mlp.down_proj.weight"].t())
    assert torch.equal(ours["layers"]["qkv_b"][0],
                       torch.cat([t[f"model.layers.0.self_attn.{n}_proj.bias"] for n in "qkv"]))


def test_missing_tensor_names_the_candidates(tmp_path):
    st.save_file({"embeddings.word_embeddings.weight": torch.zeros(2, 2)},
                 str(tmp_path / "m.safetensors"))
    with pytest.raises(KeyError, match="roberta.encoder.layer.0"):
        tw.load_encoder_params(tcfg.E5_TINY, str(tmp_path))


@pytest.mark.parametrize("layout", ["org--name", "basename", "weights_dir_itself",
                                    "hub_cache", "nowhere"])
def test_find_snapshot_matches_jax(tmp_path, monkeypatch, layout):
    name = "acme/tiny-model"
    home = tmp_path / "home"
    monkeypatch.setenv("HOME", str(home))
    wd = tmp_path / "weights"
    wd.mkdir()
    where = {"org--name": wd / "acme--tiny-model", "basename": wd / "tiny-model",
             "weights_dir_itself": wd,
             "hub_cache": home / ".cache/huggingface/hub/models--acme--tiny-model"
                                 "/snapshots/abc123",
             "nowhere": None}[layout]
    if where is not None:
        where.mkdir(parents=True, exist_ok=True)
        st.save_file({"w": torch.zeros(1)}, str(where / "model.safetensors"))
        (where / "config.json").write_text(json.dumps({"vocab_size": 5}))
    weights_dir = None if layout == "hub_cache" else str(wd)
    got = tw.find_snapshot(weights_dir, name)
    assert got == jw.find_snapshot(weights_dir, name)
    assert got == (None if where is None else str(where))
    assert tw.snapshot_hf_config(weights_dir, name) == (
        None if where is None else {"vocab_size": 5})
    if where is None:
        params, real = tw.get_decoder_params(tcfg.QWEN2_TINY, weights_dir, name,
                                             dtype=torch.float32)
        assert not real and params["embed"].shape == (512, 64)
        _, real = tw.get_encoder_params(tcfg.E5_TINY, weights_dir, name,
                                        dtype=torch.float32)
        assert not real


# ---------------------------------------------------------------------------
# tokenizers
# ---------------------------------------------------------------------------

TEXTS = ["the answer to question 3 is 9 indeed", "what is the answer to question 7?",
         "", "the answer " * 30, "Zürich naïve 東京"]


@pytest.mark.parametrize("which", ["enc", "dec", "bpe"])
def test_hf_tokenizer_matches_the_jax_adapter(snapshots, which):
    d = {"enc": snapshots[1], "dec": snapshots[2], "bpe": BPE_DIR}[which]
    ours, ref = ttok.get_tokenizer(d, 151936), jtok.get_tokenizer(d, 151936)
    assert isinstance(ours, ttok.HFTokenizer) and isinstance(ref, jtok.HFTokenizer)
    assert (ours.pad_id, ours.eos_id) == (ref.pad_id, ref.eos_id)
    rows = ours.encode_many(TEXTS)
    assert rows == ref.encode_many(TEXTS) == [ours.encode(t) for t in TEXTS]
    assert ours.encode_many([]) == []
    assert [ours.decode(r) for r in rows] == [ref.decode(r) for r in rows]


def test_get_tokenizer_falls_back_to_hashing(tmp_path, monkeypatch):
    """No tokenizer files, or no `transformers`: the hash tokenizer at its
    default special ids, as in the JAX package."""
    ours, ref = ttok.get_tokenizer(str(tmp_path), 512), jtok.get_tokenizer(str(tmp_path), 512)
    assert isinstance(ours, ttok.HashTokenizer) and isinstance(ref, jtok.HashTokenizer)
    assert (ours.pad_id, ours.eos_id, ours.bos_id, ours.vocab_size) == (
        ref.pad_id, ref.eos_id, ref.bos_id, ref.vocab_size)
    monkeypatch.setitem(sys.modules, "transformers", None)   # import raises
    assert isinstance(ttok.get_tokenizer(BPE_DIR, 151936), ttok.HashTokenizer)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _corpus():
    rng = np.random.default_rng(0)
    return DOCS, rng.standard_normal((len(DOCS), 64)).astype(np.float32)


def test_engine_under_weights_dir_answers_like_jax(snapshots):
    """Both engines read their architectures, weights and tokenizers from the
    snapshots: the port's leaves are the JAX engine's, and so are the ids it
    retrieves and its greedy answers (decoder matrices then scaled by 8 in
    both, so that the answers vary)."""
    root, enc_dir, dec_dir = snapshots
    docs, emb = _corpus()
    over = dict(weights_dir=root, embed_model_name=enc_dir, llm_model_name=dec_dir,
                prompt_len_buckets=[64, 128], spec_gamma=2)
    je = jax_engine.RagEngine(jax_settings(**over), docs, emb)
    te = port_engine.RagEngine(tiny_settings(**over), docs, emb, device="cpu")
    assert isinstance(te.enc_tok, ttok.HFTokenizer) and isinstance(te.dec_tok, ttok.HFTokenizer)
    assert (te.enc_tok.pad_id, te.dec_tok.pad_id, te.dec_tok.eos_id) == (1, 0, 1)
    assert dataclasses.asdict(te.enc_cfg) == dataclasses.asdict(je.enc_cfg)
    assert te.dec_cfg == tcfg.QWEN2_TINY
    _assert_trees_equal(te.enc_params, tw.params_from_jax(jax.device_get(je.enc_params)))
    _assert_trees_equal(te.dec_params, tw.params_from_jax(jax.device_get(je.dec_params)))
    qs = ["what is the answer to question 7?", "question 3?",
          "the answer to question 5 is 25 indeed", "what is question 11"]
    ks = [2, 1, 2, 3]
    assert te.embed_and_retrieve(qs, ks) == je.embed_and_retrieve(qs, ks)
    assert te.process(qs, ks) == je.process(qs, ks)
    je.dec_params = _scaled(je.dec_params, 8.0)
    te.dec_params = _scaled(te.dec_params, 8.0)
    ours = te.process(qs, ks)
    assert ours == je.process(qs, ks)
    assert len({r["result"] for r in ours}) > 1     # decoded by the real tokenizer


def test_engine_quantizes_loaded_weights(snapshots):
    """Quantization follows loading, as in the JAX engine."""
    root, enc_dir, dec_dir = snapshots
    docs, emb = _corpus()
    over = dict(weights_dir=root, embed_model_name=enc_dir, llm_model_name=dec_dir,
                prompt_len_buckets=[64, 128], quant_weights="int8")
    je = jax_engine.RagEngine(jax_settings(**over), docs, emb)
    te = port_engine.RagEngine(tiny_settings(**over), docs, emb, device="cpu")
    ref = tw.params_from_jax(jax.device_get(je.dec_params))
    for name in ("qkv_w", "down_w"):
        assert torch.equal(te.dec_params["layers"][name].q, ref["layers"][name].q)
        assert torch.equal(te.dec_params["layers"][name].scale, ref["layers"][name].scale)
    assert all(isinstance(r["result"], str) for r in te.process(["question 3?"], [2]))


def test_engine_takes_a_derived_head_size_on_the_cpu_only(tmp_path):
    """A checkpoint whose head size has no prefill kernel is served on the
    CPU and named by `unsupported_settings` for a CUDA device: the check
    reads the derived config, not the preset's."""
    cfg = dataclasses.replace(tcfg.QWEN2_TINY, num_heads=8, num_kv_heads=2, head_dim=8)
    d = str(tmp_path / "odd")
    _write_decoder(d, cfg, torch.float32)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(dict(model_type="qwen2", vocab_size=512, hidden_size=64,
                       num_hidden_layers=2, num_attention_heads=8,
                       num_key_value_heads=2, intermediate_size=128,
                       tie_word_embeddings=True, eos_token_id=1, pad_token_id=0,
                       rope_theta=1e6), f)
    docs, emb = _corpus()
    s = tiny_settings(weights_dir=str(tmp_path), llm_model_name="odd")
    te = port_engine.RagEngine(s, docs, emb, device="cpu")
    assert te.dec_cfg.head_dim == 8 and te.dec_params["layers"]["qkv_w"].shape[-1] == 96
    assert isinstance(te.dec_tok, ttok.HashTokenizer)      # no tokenizer files there
    assert all(isinstance(r["result"], str) for r in te.process(["question 3?"], [2]))
    bad = port_engine.unsupported_settings(s, torch.device("cuda"), te.dec_cfg)
    assert len(bad) == 1 and "head size 8" in bad[0]
    assert not port_engine.unsupported_settings(s, torch.device("cuda"))


def test_bpe_tokenizer_directory_starts_the_engine(monkeypatch):
    """LLM_MODEL_NAME=data/bpe_tokenizer: at the tiny vocabulary (512 < 27056)
    both engines fall back to hashing; where the vocabulary fits (the tiny
    decoder widened to 32768 rows) both serve real BPE over random weights
    and give the same answers."""
    docs, emb = _corpus()
    over = dict(llm_model_name=BPE_DIR, embed_model_name=BPE_DIR)
    te = port_engine.RagEngine(tiny_settings(**over), docs, emb, device="cpu")
    assert isinstance(te.dec_tok, ttok.HashTokenizer) and isinstance(te.enc_tok, ttok.HashTokenizer)
    assert (te.dec_tok.pad_id, te.dec_tok.eos_id) == (0, 1)
    assert port_engine.RagEngine._fits_vocab(ttok.get_tokenizer(BPE_DIR, 151936), 512) is None

    wide_j = dataclasses.replace(QWEN2_TINY, vocab_size=32768)
    wide_t = dataclasses.replace(tcfg.QWEN2_TINY, vocab_size=32768)
    monkeypatch.setattr(jax_engine, "decoder_config_for", lambda preset: wide_j)
    monkeypatch.setattr(port_engine, "decoder_config_for", lambda preset: wide_t)
    over = dict(llm_model_name=BPE_DIR, prompt_len_buckets=[128, 256])
    je = jax_engine.RagEngine(jax_settings(**over), docs, emb)
    je.dec_params = _scaled(je.dec_params, 8.0)
    te = port_engine.RagEngine(tiny_settings(**over), docs, emb, device="cpu")
    assert isinstance(te.dec_tok, ttok.HFTokenizer) and isinstance(je.dec_tok, jtok.HFTokenizer)
    assert isinstance(te.enc_tok, ttok.HashTokenizer)
    te.enc_params = tw.params_from_jax(jax.device_get(je.enc_params))
    te.dec_params = tw.params_from_jax(jax.device_get(je.dec_params))
    qs = ["what is the answer to question 7?", "question 3?"]
    ours = te.process(qs, [2, 2])
    assert ours == je.process(qs, [2, 2])
    assert all(r["result"] and "<" not in r["result"][:1] for r in ours)
