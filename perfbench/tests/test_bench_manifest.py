"""BENCHMARK.json against the contract the driver checks, and against the
files the harness finds by name."""
import json
import re

import pytest

from perfbench import harness

MAN = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
E2E = {m["name"]: m for m in MAN["end_to_end"]}


def _one_line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(MAN)) <= 64 * 1024
    assert MAN["paths"] == ["perfbench"] and len(MAN["command"]) <= 32
    assert all(_one_line(w) for w in MAN["command"])
    assert not any(w.startswith("/") or ".." in w for w in MAN["command"])
    assert 1 <= MAN["run_seconds"] <= 51 and isinstance(MAN["run_seconds"], int)


@pytest.mark.parametrize("kind,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
    ("end_to_end", {"name", "unit", "better", "bound", "source", "workloads"}),
    ("per_layer", {"name", "unit", "better", "source", "layer", "moves", "workloads"}),
])
def test_entries_have_only_allowed_keys_and_valid_names(kind, keys):
    names = [e["name"] for e in MAN[kind]]
    assert len(names) == len(set(names))
    for e in MAN[kind]:
        required = keys - {"workloads"}
        assert required <= set(e) <= keys, e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for text in ("why", "layer") + (("source",) if kind == "configs" else ()):
            if text in e:
                assert _one_line(e[text]), (e["name"], text)


def test_metric_names_unique_across_kinds_and_sources_allowed():
    names = [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(names) == len(set(names))
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert E2E["setup_s"]["bound"] <= 0.25 and "workloads" not in E2E["setup_s"]


def _reports(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def test_every_moves_names_an_end_to_end_metric_each_of_its_cells_reports():
    cells = {w["name"] for w in MAN["workloads"]}
    for m in MAN["per_layer"]:
        assert m["moves"] in E2E, m["name"]
        for cell in m.get("workloads", cells):
            assert cell in cells and _reports(E2E[m["moves"]], cell), (m["name"], cell)


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    for w in MAN["workloads"]:
        e2e = [m["name"] for m in MAN["end_to_end"] if _reports(m, w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert any(_reports(m, w["name"]) for m in MAN["per_layer"]), w["name"]
        assert w["chips"] in (1, 4) and NAME.match(w["config"]) and NAME.match(w["traffic"])


def test_every_configuration_has_a_cell_and_a_file_under_paths():
    used = {w["config"] for w in MAN["workloads"]}
    files = [c["file"] for c in MAN["configs"]]
    assert len(files) == len(set(files))
    for c in MAN["configs"]:
        assert c["name"] in used, c["name"]
        assert c["file"].startswith("perfbench/") and (harness.REPO / c["file"]).is_file()
        cfg = harness.load_json(harness.REPO / c["file"])
        assert sorted(c["reduced"]) == sorted(cfg["reduced"]), c["name"]
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert not any(k.endswith(("_dim", "_rank", "_size")) for k in c["reduced"])
        assert c["source"].startswith("https://") and cfg["source"] == c["source"]


def test_a_pair_of_configuration_and_traffic_appears_once():
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_harness_finds_every_file_by_name():
    for w in MAN["workloads"]:
        cell = harness.load_cell(w["name"], MAN)
        assert (harness.HERE / "entries" / f"{cell.traffic['entry']}.py").is_file()
        assert cell.limits, w["name"]
        for m in cell.end_to_end + cell.per_layer:
            assert callable(harness.metric_reader(m["name"]))
        cell.model_kwargs()
        assert callable(cell.reference().served_gaps) and callable(cell.reference().train_steps)


def test_run_seconds_fits_a_full_check_of_24_cells():
    runs = 2 + 14 * 24
    assert runs * (MAN["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_at_most_a_quarter_of_the_cells_take_four_chips():
    four = sum(1 for w in MAN["workloads"] if w["chips"] == 4)
    assert four <= max(1, len(MAN["workloads"]) // 4)
