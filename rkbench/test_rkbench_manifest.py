"""BENCHMARK.json against the contract's form, and every configuration,
traffic mix and per-layer metric found by the name the manifest gives."""
import json

import pytest

from rkbench import manifest

MAN = manifest.load_manifest()
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
CELLS = [c["name"] for c in MAN["workloads"]]
E2E = {m["name"]: m for m in MAN["end_to_end"]}


def _one_line(s: str, most: int = 200) -> bool:
    return 1 <= len(s) <= most and "\n" not in s and "\t" not in s


def test_keys_and_sizes():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(MAN)) <= 64 * 1024
    assert 1 <= len(MAN["paths"]) <= 16 and 1 <= len(MAN["command"]) <= 32
    assert all(_one_line(w) for w in MAN["command"])
    assert 1 <= MAN["run_seconds"] <= 51
    # a full check of 24 cells fits its 43,200 s
    assert (2 + 14 * 24) * (MAN["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200


@pytest.mark.parametrize("key", ["configs", "workloads", "end_to_end",
                                 "per_layer"])
def test_names_are_unique_and_allowed(key):
    names = [e["name"] for e in MAN[key]]
    assert len(set(names)) == len(names)
    for name in names:
        assert manifest.NAME_RE.match(name), name


@pytest.mark.parametrize("metric", MAN["end_to_end"] + MAN["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_form(metric):
    assert manifest.UNIT_RE.match(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in SOURCES
    for cell in metric.get("workloads", []):
        assert cell in CELLS


@pytest.mark.parametrize("metric", MAN["end_to_end"],
                         ids=lambda m: m["name"])
def test_end_to_end_bounds(metric):
    assert metric["source"] in ("host_clock", "device_trace")
    assert 0.01 <= metric["bound"] <= 0.25
    assert set(metric) <= {"name", "unit", "better", "bound", "source",
                           "workloads"}


@pytest.mark.parametrize("metric", MAN["per_layer"], ids=lambda m: m["name"])
def test_per_layer_names_moves_and_workloads(metric):
    assert metric["moves"] in E2E
    assert metric["workloads"], "every per-layer metric lists its cells"
    assert _one_line(metric["layer"])
    for cell in metric["workloads"]:
        moved = E2E[metric["moves"]]
        assert "workloads" not in moved or cell in moved["workloads"]
    assert set(metric) <= {"name", "unit", "better", "source", "layer",
                           "moves", "workloads"}


@pytest.mark.parametrize("cell", MAN["workloads"], ids=lambda c: c["name"])
def test_every_cell_reports_what_it_must(cell):
    e2e = {m["name"] for m in manifest.metrics_for(MAN, cell["name"],
                                                   "end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert manifest.metrics_for(MAN, cell["name"], "per_layer")
    assert cell["chips"] in (1, 4) and _one_line(cell["why"])


@pytest.mark.parametrize("cell", MAN["workloads"], ids=lambda c: c["name"])
def test_cell_files_found_by_name(cell):
    cfg = manifest.config(cell["config"])
    assert cfg["name"] == cell["config"]
    assert manifest.traffic(cell["traffic"])["name"] == cell["traffic"]
    ref = manifest.reference(cfg["reference"])
    assert ref.Reference and ref.compare
    traffic = manifest.traffic(cell["traffic"])
    assert manifest.loop(traffic["loop"]).run
    assert manifest.queries(traffic["query_items"]).draw
    assert manifest.embeddings(cfg["embeddings"]["kind"]).make
    assert manifest.storage(cfg["storage"]).query
    entry = next(c for c in MAN["configs"] if c["name"] == cell["config"])
    assert entry["file"] == f"rkbench/configs/{cell['config']}.json"
    assert set(entry["reduced"]) <= set(cfg)
    assert set(cfg["correct"]) == {"est_off_share", "pick_off_share"}


@pytest.mark.parametrize("metric", MAN["per_layer"], ids=lambda m: m["name"])
def test_metric_reader_found_by_name_and_silent_without_a_trace(metric):
    read = manifest.metric_reader(metric["name"])
    ctx = {"trace": None, "build_s": 1.5, "index_bytes": 2_000_000_000,
           "least_query_s": 1e-3, "least_step1_s": 1e-3}
    value = read(ctx)
    if metric["source"] == "device_trace":
        assert value is None        # nothing to read: left out, never 0
    else:
        assert value > 0


FINDERS = {"loops": ("loop", "run"), "queries": ("queries", "draw"),
           "embeddings": ("embeddings", "make"),
           "storage": ("storage", "step1"),
           "references": ("reference", "compare")}


@pytest.mark.parametrize(
    "folder,name", [(f, p.stem) for f in FINDERS
                    for p in sorted((manifest.HERE / f).glob("*.py"))],
    ids=lambda x: x)
def test_every_module_is_found_by_its_file_name(folder, name):
    finder, attr = FINDERS[folder]
    assert callable(getattr(getattr(manifest, finder)(name), attr))


def test_unknown_names_are_refused():
    with pytest.raises(ValueError):
        manifest.config("../BENCHMARK")
    with pytest.raises(KeyError):
        manifest.workload(MAN, "no-such-cell")
    with pytest.raises(FileNotFoundError):
        manifest.metric_reader("no.such_metric")
