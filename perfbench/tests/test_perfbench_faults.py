"""A run on the CPU, with the tiny configuration, past the harness's look for
a card: sound, it is correct; with the timed path broken underneath it, the
check says not correct. One case a fault the served cells can have: a token
altered where it is produced, half of each batch left out, the retrieved
ids altered, the encoder's or the decoder's weights altered after set-up."""

from __future__ import annotations

import pytest
import torch

from conftest import run_tiny


def _token(sysm):
    eng = sysm.engine
    orig = eng.generate_tokens

    def bad(prompts=None, staged=None):
        toks, n = orig(prompts, staged=staged)
        toks = toks.clone()
        toks[:, 0] = 20 + (toks[:, 0] + 7) % 400
        return toks, n
    eng.generate_tokens = bad


def _half_batch(sysm):
    eng = sysm.engine
    orig = eng.generate_tokens

    def bad(prompts=None, staged=None):
        toks, n = orig(prompts, staged=staged)
        return toks, max(1, n // 2) if n > 1 else n
    eng.generate_tokens = bad


def _ids(sysm):
    eng = sysm.engine
    orig = eng._topk

    def bad(q, k):
        s, i = orig(q, k)
        return s, (i + 1) % eng.n_docs
    eng._topk = bad


def _encoder(sysm):
    w = sysm.engine.enc_params
    with torch.no_grad():
        w["layers"]["ff_w2"][1].mul_(4.0)


def _decoder(sysm):
    w = sysm.engine.dec_params
    with torch.no_grad():
        w["layers"]["down_w"].mul_(16.0)


def test_sound_run_is_correct(tiny_tree):
    res = run_tiny(tiny_tree, 424242)
    assert res["correct"], res["compared"]
    assert res["failed"] == 0 and res["attempted"] == 48
    assert list(res["compared"])[-1] == "checked_requests"
    assert set(res["metrics"]) == {"throughput_rps", "latency_p50_s", "latency_p95_s", "setup_s"}


@pytest.mark.parametrize("fault,number", [(_token, "logit_gap_mean"),
                                          (_half_batch, "failed_requests"),
                                          (_ids, "retr_gap"), (_encoder, "embed_err"),
                                          (_decoder, "logit_gap_mean")],
                         ids=["token", "half_batch", "ids", "encoder", "decoder"])
def test_fault_is_not_correct(tiny_tree, fault, number):
    res = run_tiny(tiny_tree, 515151, fault=fault)
    assert not res["correct"]
    c = res["compared"][number]
    assert c["value"] > c["limit"], res["compared"]
