"""Decoder architectures are found by the configuration's
`decoder.model_type`, as `perfbench/decoders/<model_type>.py`.

`qwen2` is held to digests recorded on commit b93580a, where the harness
called `weights.decoder`, `reference.qwen_logits` over that tree in f32
(`judge._float`), `flops.decoder_flops` and a SiLU a layer in
`run.launch_counts` itself: the same calls, at conftest's tiny
configuration, on the CPU. A toy architecture added as files alone (its
module, a configuration naming it, and a cell of that configuration) runs a
whole tiny run through all five of its names; a `model_type` with no module
fails at set-up, naming the file.
"""

from __future__ import annotations

import hashlib
import json
import os
import re

import pytest
import torch

from conftest import TINY_CELL, TINY_CONFIG, tiny_config
from perfbench import spec

SEED = 271828
IDS = [0] + [10 + (37 * i) % 500 for i in range(40)]
# leaf -> SHA-256 of its bytes, dtype, shape (commit b93580a: weights.decoder)
WEIGHTS = {
    "embed": ("76919e8d02f674801cb38106377d4ed8a4bdc711d31f7ada10a80bf2c80d337d", (512, 64)),
    "layers.ln1": ("1ede9ebfa1ad011b89a3e3df648a958674d64afa0726d98858a68b8a4da14ee0", (2, 64)),
    "layers.qkv_w": ("1f7da64cc0e967e7b740549add56989d37f51277a46fa401f611a08c8e399228",
                     (2, 64, 128)),
    "layers.qkv_b": ("076a27c79e5ace2a3d47f9dd2e83e4ff6ea8872b3c2218f66c92b89b55f36560", (2, 128)),
    "layers.o_w": ("b2feabf6e0757e1cba33875f62290a922b8cee345836a80b5e0d4af4acb7a01b",
                   (2, 64, 64)),
    "layers.ln2": ("1ede9ebfa1ad011b89a3e3df648a958674d64afa0726d98858a68b8a4da14ee0", (2, 64)),
    "layers.gu_w": ("2d5d591edc8737453b9bc6cb5043f4338d5ed7a3735bf87deb889c64d6fda9a2",
                    (2, 64, 256)),
    "layers.down_w": ("12a2d85ce3d0f7512acc396c547d8ac1d1c8db7ccc192b61bee66905b32954dc",
                      (2, 128, 64)),
    "ln_f": ("e72710531b01d91ee76a2457cdc9c6c89a197db47da8ebd4ae672e13ddd668cd", (64,)),
}
# `at` -> SHA-256 of the f32 logits (commit b93580a: reference.qwen_logits)
LOGITS = [([40], "047d7418581e9a215e8df00f6e5c47b7aaf05aa89cbfb783668ca80eb0d24f32"),
          ([3, 17, 29, 40], "5f99884ddc8157fdd7517d0f05bbd83805b87e4e7b2860d6a7429cf65b255a40")]
# (start, end, logits) -> FLOPs (commit b93580a: flops.decoder_flops)
FLOPS = [((0, 1, 0), 147968.0), ((0, 359, 10), 86677504.0), ((100, 359, 10), 69346304.0)]


def _sha(t: torch.Tensor) -> str:
    return hashlib.sha256(t.contiguous().view(torch.uint8).numpy().tobytes()).hexdigest()


def _leaves(tree: dict, pre: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        out.update(_leaves(v, f"{pre}{k}.") if isinstance(v, dict) else {pre + k: v})
    return out


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_qwen2_reads_as_before(one_thread):
    cfg = tiny_config()["decoder"]
    dec = spec.decoder(cfg["model_type"])
    got = {k: (_sha(v), tuple(v.shape)) for k, v in
           _leaves(dec.weights(cfg, SEED, "cpu")).items()}
    assert got == WEIGHTS
    assert all(v.dtype == torch.bfloat16 for v in _leaves(dec.weights(cfg, SEED, "cpu")).values())
    logits = dec.reference(cfg, SEED, "cpu")
    for at, digest in LOGITS:
        out = logits(IDS, at)
        assert out.dtype == torch.float32 and out.shape == (len(at), 512)
        assert _sha(out) == digest
    assert [dec.flops(cfg, *span) for span, _ in FLOPS] == [f for _, f in FLOPS]
    assert dec.pass_launches(cfg) == {"silu": 2}


TOY = '''"""A toy decoder architecture: Qwen2's, with each use of its five names
recorded in CALLS."""

import os

from perfbench import spec

_qwen2 = spec.decoder("qwen2", os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CALLS = []


def _recorded(name):
    def call(*args, **kwargs):
        CALLS.append(name)
        return getattr(_qwen2, name)(*args, **kwargs)
    return call


weights = _recorded("weights")
reference = _recorded("reference")
flops = _recorded("flops")
pass_launches = _recorded("pass_launches")


class _Keys(dict):
    def items(self):
        CALLS.append("ENGINE_KEYS")
        return super().items()


ENGINE_KEYS = _Keys(_qwen2.ENGINE_KEYS)
'''


def _add_config(root: str, bench_dir: str, model_type: str) -> str:
    """A configuration of `model_type` and a cell of it, added as files the
    way conftest adds the tiny ones; the cell's name."""
    name, cell = f"tiny-{model_type}.bf16", f"tiny-{model_type}.hot-zipf"
    cfg = tiny_config()
    cfg["name"] = name
    cfg["decoder"]["model_type"] = model_type
    with open(os.path.join(bench_dir, "configs", f"{name}.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(bench_dir, "workloads", f"{TINY_CELL}.json")) as f:
        wl = json.load(f)
    wl.update(name=cell, config=name)
    with open(os.path.join(bench_dir, "workloads", f"{cell}.json"), "w") as f:
        json.dump(wl, f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    entry = next(c for c in bench["configs"] if c["name"] == TINY_CONFIG)
    bench["configs"].append(dict(entry, name=name, file=f"perfbench/configs/{name}.json"))
    bench["workloads"].append({k: wl[k] for k in ("name", "config", "traffic", "chips", "why")})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return cell


def test_architecture_added_as_files(tiny_tree, monkeypatch):
    from perfbench import run

    root, bench_dir = tiny_tree
    with open(os.path.join(bench_dir, "decoders", "toyarch.py"), "w") as f:
        f.write(TOY)
    cell = spec.cell(_add_config(root, bench_dir, "toyarch"), root=root, bench_dir=bench_dir)
    assert cell.decoder.CALLS == []
    runs = []

    class Kept(run.RunData):
        def __init__(self, **kw):
            super().__init__(**kw)
            runs.append(self)
    monkeypatch.setattr(run, "RunData", Kept)
    monkeypatch.setattr(run, "CHECK_REQUESTS", 6)
    monkeypatch.setattr(run, "GRACE_S", 3.0)
    res = run.run_cell(cell, 606060, 3.0, False, device="cpu")
    assert res["correct"], res["compared"]
    assert {"weights", "ENGINE_KEYS", "reference"} <= set(cell.decoder.CALLS)
    # a CPU run takes no trace: the trace's two users of the module, the
    # model-FLOP reader and the launch check, read the run's own data
    rd, = runs
    assert spec.metric("mfu.sat").read(rd) > 0
    want = run.launch_counts(rd.config, rd.snap0, rd.snap1, rd.cell.decoder)
    assert "silu" in want
    assert set(cell.decoder.CALLS) == {"weights", "ENGINE_KEYS", "reference", "flops",
                                       "pass_launches"}


def test_architecture_without_a_module_fails_at_set_up(tiny_tree):
    root, bench_dir = tiny_tree
    name = _add_config(root, bench_dir, "noarch")
    path = os.path.join(bench_dir, "decoders", "noarch.py")
    with pytest.raises(FileNotFoundError, match=re.escape(path)):
        spec.cell(name, root=root, bench_dir=bench_dir)
