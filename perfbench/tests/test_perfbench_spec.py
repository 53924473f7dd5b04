"""The benchmark's data is found by name, and BENCHMARK.json agrees with
the files: a configuration, a cell and a metric are each added as new files
(and entries), with no edit to a file that is there."""

from __future__ import annotations

import json
import os
import re

import pytest

from conftest import ROOT, TINY_CELL, TINY_CONFIG
from perfbench import spec

BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("w", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves(w):
    cell = spec.cell(w)
    assert cell.config["name"] == [x for x in BENCH["workloads"] if x["name"] == w][0]["config"]
    assert "setup_s" in cell.end_to_end and len(cell.end_to_end) >= 2
    assert cell.per_layer, "every cell reports a per-layer metric"
    assert cell.mix["arrivals"] in ("poisson", "closed")
    if cell.mix["arrivals"] == "poisson":
        assert float(cell.mix["rate_rps"]) > 0


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_file_agrees(m):
    mod = spec.metric(m["name"])
    assert mod.UNIT == m["unit"] and mod.SOURCE == m["source"]
    if "layer" in m:
        assert mod.LAYER == m["layer"] and mod.MOVES == m["moves"]
        moved = [e for e in BENCH["end_to_end"] if e["name"] == m["moves"]][0]
        for w in m.get("workloads", []):
            assert w in moved.get("workloads", [w]), f"{w} does not report {m['moves']}"


def test_names_and_files():
    for c in BENCH["configs"]:
        assert NAME.match(c["name"]) and c["file"].startswith("perfbench/")
        cfg = json.load(open(os.path.join(ROOT, c["file"])))
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert {"embed_err", "retr_gap"} <= set(cfg["limits"]) <= {
            "embed_err", "retr_gap", "logit_gap", "logit_gap_mean"}
    for entry in BENCH["workloads"]:
        assert NAME.match(entry["name"]) and len(entry["why"]) <= 200
        wl = json.load(open(os.path.join(ROOT, "perfbench", "workloads", entry["name"] + ".json")))
        for k in ("config", "traffic", "chips", "why"):
            assert wl[k] == entry[k]
    assert BENCH["command"] == ["python3", "perfbench/run.py"] and BENCH["paths"] == ["perfbench"]


def test_cell_added_as_files(tiny_tree):
    root, bench_dir = tiny_tree
    cell = spec.cell(TINY_CELL, root=root, bench_dir=bench_dir)
    assert cell.config["name"] == TINY_CONFIG
    assert cell.mix["rate_rps"] == 16 and cell.mix["popularity"]["kind"] == "zipf"
    assert "latency_p95_s" in cell.end_to_end and "prefix_hit_rate.hot" in cell.per_layer
    assert "mfu.sat" not in cell.per_layer


def test_metric_added_as_a_file(tiny_tree):
    root, bench_dir = tiny_tree
    path = os.path.join(bench_dir, "metrics", "queue_rows.hot.py")
    with open(path, "w") as f:
        f.write('LAYER = "x"\nSOURCE = "program_counter"\nMOVES = "latency_p95_s"\n'
                'UNIT = "rows"\n\n\ndef read(run):\n    return run.answer\n')
    mod = spec.metric("queue_rows.hot", bench_dir=bench_dir)
    assert mod.read(type("R", (), {"answer": 3.0})()) == 3.0


def test_mismatched_cell_is_refused(tiny_tree):
    root, bench_dir = tiny_tree
    path = os.path.join(bench_dir, "workloads", TINY_CELL + ".json")
    wl = json.load(open(path))
    wl["traffic"] = "cold-unique"
    json.dump(wl, open(path, "w"))
    with pytest.raises(ValueError):
        spec.cell(TINY_CELL, root=root, bench_dir=bench_dir)


def test_traffic_shape_added_as_a_file(tiny_tree):
    # a bursty mix with per-request budgets: a new traffic file and a new
    # cell file; the one generator reads it
    from perfbench import generator

    root, bench_dir = tiny_tree
    burst = {"arrivals": "poisson", "rate_cycle": [[8, 1.0], [2, 2.0]],
             "popularity": {"kind": "zipf", "s": 1.0}, "new_tokens": [10, 128], "k": 2,
             "warmup": {"clients": 4, "closed_requests": 8, "open_seconds": 2}}
    with open(os.path.join(bench_dir, "traffic", "tiny-burst.json"), "w") as f:
        json.dump(burst, f)
    cell = {"name": "tiny.burst", "config": TINY_CONFIG, "traffic": "tiny-burst", "chips": 1,
            "why": "CPU tests", "params": {"rate_rps": 20}}
    with open(os.path.join(bench_dir, "workloads", "tiny.burst.json"), "w") as f:
        json.dump(cell, f)
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    bench["workloads"].append({k: cell[k] for k in ("name", "config", "traffic", "chips", "why")})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    got = spec.cell("tiny.burst", root=root, bench_dir=bench_dir)
    assert got.mix["rate_rps"] == 20 and got.mix["rate_cycle"] == [[8, 1.0], [2, 2.0]]
    plan = generator.Plan(got.mix, 5, 20.0)
    due = [t - plan.open_warm_s for t in plan.open_due if t >= plan.open_warm_s]
    assert len(due) == 2 * (20 * 8 + 40 * 2)
    assert all(10 <= r["max_new_tokens"] <= 128 for r in plan.open_reqs)
