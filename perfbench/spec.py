"""The benchmark's data, found by name.

`BENCHMARK.json` at the checkout's root lists the cells and the metrics. A
cell `<cell>` lives in `perfbench/workloads/<cell>.json` (its configuration,
its traffic mix and the mix's parameters for this cell), a configuration in
`perfbench/configs/<config>.json`, a traffic mix in
`perfbench/traffic/<mix>.json`, a metric in `perfbench/metrics/<metric>.py`
and a decoder architecture, by the configuration's `decoder.model_type`, in
`perfbench/decoders/<model_type>.py`. Nothing here lists them: a later cell,
configuration, mix, metric or architecture is a new file (and a new entry in
`BENCHMARK.json`).
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass, field

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


def _load_json(path: str) -> dict:
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return _load_json(os.path.join(root, "BENCHMARK.json"))


def config(name: str, bench_dir: str = BENCH_DIR) -> dict:
    return _load_json(os.path.join(bench_dir, "configs", f"{name}.json"))


def traffic(name: str, bench_dir: str = BENCH_DIR) -> dict:
    return _load_json(os.path.join(bench_dir, "traffic", f"{name}.json"))


def _module(path: str, kind: str, name: str):
    mod_name = f"perfbench_{kind}_" + "".join(c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric(name: str, bench_dir: str = BENCH_DIR):
    """The reader module of metric `name` (`read(run) -> float | None`, with
    LAYER, SOURCE, MOVES and UNIT beside it)."""
    return _module(os.path.join(bench_dir, "metrics", f"{name}.py"), "metric", name)


def decoder(model_type: str, bench_dir: str = BENCH_DIR):
    """The module of decoder architecture `model_type`: `weights`,
    `reference`, `ENGINE_KEYS`, `flops` and `pass_launches` (README, "Adding
    to it"). Raises, naming the file it looked for, where there is none."""
    path = os.path.join(bench_dir, "decoders", f"{model_type}.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"decoder.model_type {model_type!r} has no module: {path}")
    return _module(path, "decoder", model_type)


def decoder_of(dec_cfg: dict, bench_dir: str = BENCH_DIR):
    """The module of a configuration's `decoder` group; a bare group of
    shapes that names no `model_type` is read as Qwen2's."""
    return decoder(dec_cfg.get("model_type", "qwen2"), bench_dir)


@dataclass
class Cell:
    """One workload of BENCHMARK.json, resolved: its configuration, its
    traffic mix with the cell's parameters laid over the mix's, and the
    names of the metrics it reports with and without a trace, and the module
    of its configuration's decoder architecture."""
    name: str
    chips: int
    config: dict
    mix: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)
    decoder: object = None


def _reported_in(entry: dict, cell: str, e2e_names: set) -> bool:
    if "workloads" in entry:
        return cell in entry["workloads"]
    return entry.get("moves") is None or entry["moves"] in e2e_names


def cell(name: str, root: str = ROOT, bench_dir: str = BENCH_DIR) -> Cell:
    bench = benchmark(root)
    wl = _load_json(os.path.join(bench_dir, "workloads", f"{name}.json"))
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"BENCHMARK.json has no workload {name!r}")
    for key in ("config", "traffic", "chips"):
        if entry[key] != wl[key]:
            raise ValueError(f"{name}: {key} is {wl[key]!r} in its file and "
                             f"{entry[key]!r} in BENCHMARK.json")
    mix = dict(traffic(wl["traffic"], bench_dir))
    mix.update(wl.get("params", {}))
    e2e = [m["name"] for m in bench["end_to_end"] if _reported_in(m, name, set())]
    layer = [m["name"] for m in bench["per_layer"]
             if _reported_in(m, name, set(e2e))]
    cfg = config(wl["config"], bench_dir)
    return Cell(name=name, chips=int(wl["chips"]), config=cfg, mix=mix, end_to_end=e2e,
                per_layer=layer, decoder=decoder(cfg["decoder"]["model_type"], bench_dir))
