"""PyTorch port: the hashing tokenizer's C path (`rag_serving_system_torch/
native/hashtok.c`) gives the ids of the port's Python path and of the JAX
package's `HashTokenizer`: on the served corpora, on non-ASCII text (which
takes the Python path), on the cases of `tests/test_native_tokenizer.py` and
on a seeded ASCII fuzz. Skipped where there is no C compiler; a compiler
that refuses the source fails."""

import json
import os
import shutil
import string

import numpy as np
import pytest

from rag_serving_system_tpu.models.tokenizer import HashTokenizer as JaxHashTokenizer
from rag_serving_system_torch.models import tokenizer as port_tok
from rag_serving_system_torch.native import get_hashtok_lib

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# vocabularies of the tiny presets, Qwen2.5 and e5-large
VOCABS = [512, 151936, 250002]


@pytest.fixture(scope="module")
def toks():
    if shutil.which("cc") is None:
        pytest.skip("no C compiler to build the tokenizer's C path")
    get_hashtok_lib()
    out = {}
    for v in VOCABS:
        ours = port_tok.HashTokenizer(vocab_size=v)
        assert ours._lib is not None
        out[v] = (ours, JaxHashTokenizer(vocab_size=v))
    return out


def _all_agree(toks, texts):
    for ours, ref in toks.values():
        for t in texts:
            got = ours.encode(t)
            assert got == ours._encode_py(t), repr(t)
            assert got == ref.encode(t) == ref._encode_py(t), repr(t)


CASES = [
    "Water boils at 100 degrees Celsius at sea level.",
    "query: What is the boiling point of water?",
    "a",
    "",
    "   leading spaces\tand\ttabs\n\nnewlines  ",
    "punct!@#$%^&*()_+-=[]{};':\",./<>?",
    "ascii separators\x1cbetween\x1dwords\x1ehere\x1ftoo",
    "under_scores_and_digits_42 mix3d t0kens",
    "Context:\nFact 1\n---\nFact 2\n\nQuestion: why?\n\nThe Answer to this question is: ",
    "\x00\x01\x7f control bytes",
]


@pytest.mark.parametrize("text", CASES)
def test_c_ids_equal_python_and_jax(toks, text):
    _all_agree(toks, [text])


@pytest.mark.parametrize("corpus", ["short_facts", "squad_real"])
def test_corpus_ids_equal_python_and_jax(toks, corpus):
    with open(os.path.join(ROOT, "data", f"{corpus}_contexts.json")) as f:
        docs = json.load(f)
    with open(os.path.join(ROOT, "data", f"{corpus}_queries.json")) as f:
        queries = json.load(f)
    _all_agree(toks, ["passage: " + d for d in docs] + ["query: " + q for q in queries])


def test_non_ascii_takes_the_python_path_with_the_same_ids(toks):
    texts = ["héllo wörld — ünïcode", "東京 and Zürich", "emoji 😀 at the end", "ß"]
    _all_agree(toks, texts)
    ours = toks[512][0]
    for t in texts:
        with pytest.raises(UnicodeEncodeError):
            t.encode("ascii")
        assert ours.encode(t) == ours._encode_py(t)


def test_batch_encode_mixes_both_paths(toks):
    ours, ref = toks[151936]
    texts = ["hello world"] * 4 + ["héllo"]
    for got, want in zip(ours.encode_batch(texts, max_len=8, pad_side="left"),
                         ref.encode_batch(texts, max_len=8, pad_side="left")):
        np.testing.assert_array_equal(got, want)


def test_seeded_ascii_fuzz(toks):
    rng = np.random.default_rng(11)
    chars = string.printable + "\x00\x1c\x7f"
    texts = ["".join(chars[i] for i in rng.integers(0, len(chars), int(rng.integers(0, 120))))
             for _ in range(300)]
    _all_agree(toks, texts)


def test_python_path_where_the_library_does_not_build(monkeypatch, caplog):
    """No compiler: the tokenizer says so and encodes in Python, same ids."""
    from rag_serving_system_torch import native

    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setenv("CC", "/nonexistent/cc")
    with caplog.at_level("WARNING"):
        tok = port_tok.HashTokenizer(vocab_size=512)
    assert tok._lib is None and "did not build" in caplog.text
    text = CASES[0]
    assert tok.encode(text) == JaxHashTokenizer(vocab_size=512).encode(text)


_BUILDER = r'''
import sys
from pathlib import Path
from rag_serving_system_torch import native
native.BUILD_DIR = Path(sys.argv[1])
print(native.build("hashtok.c", "libhashtok", ".so"))
'''


def test_concurrent_builds_share_one_output_outside_the_sources(tmp_path):
    """Six processes building at once (as six test workers may) all get one
    hash-named library in the build directory, no temporary file is left,
    and nothing is written beside the sources."""
    import subprocess
    import sys

    from rag_serving_system_torch import native

    if shutil.which("cc") is None:
        pytest.skip("no C compiler")
    src = sorted(p.name for p in native._SRC.iterdir() if p.name != "__pycache__")
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", _BUILDER, str(tmp_path)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(6)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), [err for _, err in outs]
    paths = {out.strip() for out, _ in outs}
    assert len(paths) == 1
    built = sorted(p.name for p in tmp_path.iterdir())
    assert built == [".lock", os.path.basename(paths.pop())]
    assert built[1].startswith("libhashtok_") and built[1].endswith(".so")
    assert sorted(p.name for p in native._SRC.iterdir() if p.name != "__pycache__") == src
    assert src == ["__init__.py", "hashtok.c", "httpfront.cc", "miniredis.cc"]
