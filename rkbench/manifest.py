"""`BENCHMARK.json` and the files it names, found by name.

A cell (`workloads` entry) names a configuration and a traffic mix; the
configuration is `configs/<config>.json`, the mix `traffic/<traffic>.json`,
each per-layer metric `metrics/<name>.py` (a module with
`read(ctx) -> float | None`). The files name the code they need, each a
module found by name in a folder of its own:

  configuration `reference`           references/<name>.py  Reference, compare
  configuration `embeddings.kind`     embeddings/<kind>.py  make(g, cfg)
  configuration `storage`             storage/<name>.py     counts of a batch
  traffic `loop`                      loops/<name>.py       run(state, ...)
  traffic `query_items`               queries/<name>.py     draw(traffic, ...)

Adding one of them takes a new file (and, for a configuration, a mix or
a metric, a new manifest entry), and no edit here.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
MANIFEST = ROOT / "BENCHMARK.json"

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def load_manifest(path: Path = MANIFEST) -> dict:
    with open(path) as f:
        return json.load(f)


def workload(manifest: dict, name: str) -> dict:
    for cell in manifest["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; cells: "
                   f"{[c['name'] for c in manifest['workloads']]}")


def _json(folder: str, name: str) -> dict:
    if not NAME_RE.match(name):
        raise ValueError(f"bad name {name!r}")
    with open(HERE / folder / f"{name}.json") as f:
        return json.load(f)


def config(name: str) -> dict:
    """`configs/<name>.json`."""
    return _json("configs", name)


def traffic(name: str) -> dict:
    """`traffic/<name>.json`."""
    return _json("traffic", name)


def _module(folder: str, name: str):
    if not NAME_RE.match(name):
        raise ValueError(f"bad name {name!r}")
    path = HERE / folder / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"rkbench.{folder}.{name.replace('.', '_').replace('-', '_')}", path)
    if spec is None or not path.exists():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    """The `read(ctx)` function of `metrics/<name>.py`."""
    return _module("metrics", name).read


def reference(name: str):
    """`references/<name>.py`: a configuration's plain reference and the
    comparison that decides `correct`."""
    return _module("references", name)


def loop(name: str):
    """`loops/<name>.py`: drives a traffic mix's clients in the window."""
    return _module("loops", name)


def queries(name: str):
    """`queries/<name>.py`: draws a traffic mix's query items."""
    return _module("queries", name)


def embeddings(name: str):
    """`embeddings/<name>.py`: makes a configuration's users and items."""
    return _module("embeddings", name)


def storage(name: str):
    """`storage/<name>.py`: the least bytes and operations of a batch at a
    configuration's storage."""
    return _module("storage", name)


def metrics_for(manifest: dict, cell: str, key: str) -> list[dict]:
    """The `end_to_end` or `per_layer` metrics that `cell` reports: those
    that list it under `workloads`, and those that list no cells."""
    return [m for m in manifest[key]
            if "workloads" not in m or cell in m["workloads"]]
