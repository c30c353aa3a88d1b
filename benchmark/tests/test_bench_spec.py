"""``BENCHMARK.json`` against the benchmark's contract, and the harness's
files found by name."""

import json
import re
import shutil

import pytest

from benchmark.harness import spec as S

ROOT = S.ROOT
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["command"][1].startswith(SPEC["paths"][0] + "/")
    assert 1 <= SPEC["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_and_units():
    names = ([m["name"] for m in METRICS] + CELLS + [c["name"] for c in SPEC["configs"]]
             + [w["traffic"] for w in SPEC["workloads"]]
             + [k for c in SPEC["configs"] for k in c["reduced"]])
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    for group in (METRICS, SPEC["workloads"], SPEC["configs"]):
        assert len({x["name"] for x in group}) == len(group)
    assert all(UNIT.match(m["unit"]) for m in METRICS)
    assert all(m["better"] in ("lower", "higher") for m in METRICS)
    for text in ([w["why"] for w in SPEC["workloads"]] + [c["why"] for c in SPEC["configs"]]
                 + [c["source"] for c in SPEC["configs"]] + [m["layer"] for m in SPEC["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    assert len(json.dumps(SPEC)) <= 64 * 1024


def test_entries_have_just_their_keys():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_every_metric_names_its_cells_and_each_reports_what_it_moves():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for m in SPEC["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in CELLS
            assert "workloads" not in moved or cell in moved["workloads"], (m["name"], cell)
    for cell in CELLS:
        c = S.load_cell(cell)
        assert "setup_s" in c.end_to_end and len(c.end_to_end) >= 2
        assert c.per_layer


def test_every_kernel_roofline_and_mfu_is_a_share():
    for m in SPEC["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%" and m["better"] == "higher"


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    c = S.load_cell(cell)
    assert hasattr(S.driver(c.workload["driver"]), "build")
    assert set(c.config["reduced"]) == set(
        {x["name"]: x for x in SPEC["configs"]}[
            {w["name"]: w for w in SPEC["workloads"]}[cell]["config"]]["reduced"])
    for name in c.per_layer:
        assert callable(S.metric_reader(name).read)
    assert c.workload["limits"]


def test_files_under_paths_are_named_from_names():
    for p in (ROOT / "benchmark").rglob("*"):
        if "__pycache__" in p.parts or p.is_dir():
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./\-]+$", rel), rel


def test_a_new_config_cell_and_metric_are_new_files(tmp_path):
    """A later change adds a configuration, a cell and a metric by adding
    files and entries: the harness finds them, and no file it had changes."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "benchmark").rglob("*") if p.is_file()}
    spec = json.loads(json.dumps(SPEC))
    cfg = json.loads((ROOT / "benchmark/configs/nerf-fern-d8w256.json").read_text())
    cfg["name"] = "nerf-other"
    (tmp_path / "benchmark/configs/nerf-other.json").write_text(json.dumps(cfg))
    wl = json.loads((ROOT / "benchmark/workloads/nerf-fern.view.json").read_text())
    wl["traffic"]["block"] = 8192
    (tmp_path / "benchmark/workloads/nerf-other.view.json").write_text(json.dumps(wl))
    (tmp_path / "benchmark/metrics/frame_rays.view.py").write_text(
        "def read(ctx):\n    return 42.0\n")
    spec["configs"].append({"name": "nerf-other", "source": "https://example.org/paper",
                            "file": "benchmark/configs/nerf-other.json", "reduced": [],
                            "why": "another scene"})
    spec["workloads"].append({"name": "nerf-other.view", "config": "nerf-other",
                              "traffic": "exact-view-8k", "chips": 1, "why": "smaller blocks"})
    next(m for m in spec["end_to_end"] if m["name"] == "frames_per_s")["workloads"].append(
        "nerf-other.view")
    spec["per_layer"].append({"name": "frame_rays.view", "unit": "rays", "better": "higher",
                              "source": "program_counter", "layer": "render",
                              "moves": "frames_per_s", "workloads": ["nerf-other.view"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    cell = S.load_cell("nerf-other.view", tmp_path)
    assert cell.config["name"] == "nerf-other"
    assert cell.workload["traffic"]["block"] == 8192
    assert cell.per_layer == ["frame_rays.view"]
    assert S.metric_reader("frame_rays.view", tmp_path).read(None) == 42.0
    assert S.load_cell("nerf-fern.view", tmp_path).per_layer == S.load_cell(
        "nerf-fern.view").per_layer
    assert all(p.read_bytes() == b for p, b in before.items())
