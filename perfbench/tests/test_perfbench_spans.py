"""The readers of the program's stage spans, on a fake run's window
snapshots: each reads its stage's mean over the window, in milliseconds,
and nothing where the program has no such stage (a parent that lacks it)."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from perfbench import spec

# metric -> (stage, its (seconds, count) at the window's open and close, ms)
SPANS = {
    "queue_wait_ms.hot": ("queue_wait", (4.0, 100), (16.0, 500), 30.0),
    "http_ms.hot": ("http", (0.1, 100), (0.3, 500), 0.5),
    "stage_prompts_ms.hot": ("stage_prompts", (0.5, 10), (0.9, 20), 40.0),
    "prefill_ms.sat": ("prefill", (2.0, 10), (5.0, 30), 150.0),
    "decode_step_ms.sat": ("decode", (9.0, 360), (36.0, 1440), 25.0),
}


def _run(stages0: dict, stages1: dict):
    return SimpleNamespace(snap0={"stages": stages0}, snap1={"stages": stages1})


@pytest.mark.parametrize("name", sorted(SPANS))
def test_reads_the_window_mean_of_its_stage(name):
    stage, a, b, want = SPANS[name]
    other = {"generate": (1.0, 1)}
    run = _run({stage: a, **other}, {stage: b, "generate": (9.0, 5)})
    assert spec.metric(name).read(run) == pytest.approx(want)


@pytest.mark.parametrize("name", sorted(SPANS))
def test_none_without_its_stage(name):
    stage, a, b, _ = SPANS[name]
    assert spec.metric(name).read(_run({"generate": (1.0, 1)}, {"generate": (9.0, 5)})) is None
    # present but not recorded in the window
    assert spec.metric(name).read(_run({stage: a}, {stage: a})) is None
