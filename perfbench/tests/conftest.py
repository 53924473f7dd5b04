"""Fixtures of the benchmark's tests: a copy of the benchmark with a tiny
configuration and cell added as files (the way a later cell is added), and
the `chip` marker for tests that need a CUDA card.

    python -m pytest perfbench/tests -q          # here: the card's tests skip
"""

from __future__ import annotations

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY_CONFIG = "tiny-e5-qwen2.bf16"
TINY_CELL = "tiny.hot-zipf"


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card; skips without one")


@pytest.fixture
def chip():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip: python -m pytest perfbench/tests -m chip)")
    return "cuda"


def tiny_config() -> dict:
    """The bf16 configuration at the port's tiny preset, on the CPU."""
    with open(os.path.join(ROOT, "perfbench", "configs", "e5l-qwen2.5-1.5b.bf16.json")) as f:
        cfg = json.load(f)
    cfg["name"] = TINY_CONFIG
    cfg["env"]["MODEL_PRESET"] = "tiny"
    cfg["encoder"].update(vocab_size=512, hidden_size=64, num_hidden_layers=2,
                          num_attention_heads=4, intermediate_size=128)
    cfg["decoder"].update(vocab_size=512, hidden_size=64, num_hidden_layers=2,
                          num_attention_heads=4, num_key_value_heads=2, head_dim=16,
                          intermediate_size=128, eos_token_id=1, initializer_range=0.2)
    cfg["tokenizer"].update(decoder_eos_id=1, decoder_pad_id=0, decoder_stop_ids=[1])
    cfg["corpus"] = {"rows": 4096, "dim": 64, "dtype": "float32"}
    # initializer_range 0.2 on the tiny decoder: at 0.02 its layers' outputs
    # are so small beside the embedding that it answers the prompt's closing
    # eos with eos at once, and every answer is empty
    # the tiny models' own limits: at this size on the CPU sound runs read
    # embed_err ~0.004, retr_gap 0 and logit_gap_mean ~0.003
    cfg["limits"] = {"embed_err": 0.02, "retr_gap": 1e-4, "logit_gap_mean": 0.02}
    return cfg


@pytest.fixture
def tiny_tree(tmp_path):
    """(root, bench_dir) of a copy of BENCHMARK.json and perfbench/ with the
    tiny configuration and a tiny open-loop cell added as new files."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "perfbench"), root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    bench["configs"].append({"name": TINY_CONFIG, "source": "https://huggingface.co/Qwen/Qwen2.5-1.5B-Instruct",
                             "file": f"perfbench/configs/{TINY_CONFIG}.json",
                             "reduced": ["num_hidden_layers"], "why": "CPU tests"})
    bench["workloads"].append({"name": TINY_CELL, "config": TINY_CONFIG, "traffic": "hot-zipf",
                               "chips": 1, "why": "CPU tests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m and m["name"].endswith((".hot", "_p50_s", "_p95_s")):
            m["workloads"].append(TINY_CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    (root / "perfbench" / "configs" / f"{TINY_CONFIG}.json").write_text(json.dumps(tiny_config()))
    cell = {"name": TINY_CELL, "config": TINY_CONFIG, "traffic": "hot-zipf", "chips": 1,
            "why": "CPU tests",
            "params": {"rate_rps": 16,
                       "warmup": {"clients": 8, "closed_requests": 24, "open_seconds": 1}}}
    (root / "perfbench" / "workloads" / f"{TINY_CELL}.json").write_text(json.dumps(cell))
    return str(root), str(root / "perfbench")


def run_tiny(tiny_tree, seed: int, fault=None, control: bool = False, seconds: float = 3.0) -> dict:
    """One run of the tiny cell on the CPU, past the harness's look for a card."""
    from perfbench import run, spec

    root, bench_dir = tiny_tree
    cell = spec.cell(TINY_CELL, root=root, bench_dir=bench_dir)
    # a smaller sample, and a shorter wait for requests a fault never answers
    kept = run.CHECK_REQUESTS, run.GRACE_S
    run.CHECK_REQUESTS, run.GRACE_S = 6, 3.0
    try:
        return run.run_cell(cell, seed, seconds, False, device="cpu", control=control,
                            fault=fault)
    finally:
        run.CHECK_REQUESTS, run.GRACE_S = kept
