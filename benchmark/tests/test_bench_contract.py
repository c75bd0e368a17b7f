"""The rules ``BENCHMARK.json`` keeps: its keys, names, units, bounds,
cells and the run length that a full check of 24 cells can afford."""

import json
import os
import re

from conftest import ROOT

PATH = os.path.join(ROOT, "BENCHMARK.json")
SPEC = json.load(open(PATH))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
DIR = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def _text(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_size():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(PATH) <= 64 * 1024


def test_paths_and_command():
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert DIR.match(p) and not p.startswith("/") and ".." not in p
        assert os.path.isdir(os.path.join(ROOT, p))
    cmd = SPEC["command"]
    assert 1 <= len(cmd) <= 32 and all(_text(w) for w in cmd)
    assert not any(w.startswith("/") or ".." in w for w in cmd)


def test_run_length_fits_a_full_check_of_24_cells():
    t = SPEC["run_seconds"]
    assert isinstance(t, int) and 1 <= t <= 51
    assert (2 + 14 * 24) * (t + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_configs():
    cfgs = SPEC["configs"]
    assert 1 <= len(cfgs) <= 24
    used = {w["config"] for w in SPEC["workloads"]}
    files = [c["file"] for c in cfgs]
    assert len(set(files)) == len(files)
    for c in cfgs:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert _text(c["source"]) and _text(c["why"])
        assert any(c["file"].startswith(p + "/") for p in SPEC["paths"])
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])


def test_workloads():
    cells = SPEC["workloads"]
    assert 1 <= len(cells) <= 24
    names = {c["name"] for c in SPEC["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in cells]
    assert len(set(pairs)) == len(pairs)
    assert len({w["name"] for w in cells}) == len(cells)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert _text(w["why"])
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)


def test_metrics():
    e2e, layers = SPEC["end_to_end"], SPEC["per_layer"]
    assert 1 <= len(e2e) <= 16 and 1 <= len(layers) <= 128
    names = [m["name"] for m in e2e + layers]
    assert len(set(names)) == len(names)
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert {m["name"]: m for m in e2e}["setup_s"]["bound"] <= 0.25
    assert "workloads" not in {m["name"]: m for m in e2e}["setup_s"]
    by_name = {m["name"]: m for m in e2e}
    for m in layers:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _text(m["layer"]) and m["moves"] in by_name
        moved = by_name[m["moves"]].get("workloads", sorted(cells))
        assert set(m.get("workloads", [])) <= set(moved)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for m in e2e + layers:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for w in SPEC["workloads"]:
        e2e = {m["name"] for m in SPEC["end_to_end"]
               if w["name"] in m.get("workloads", [w["name"]])}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(w["name"] in m.get("workloads", [])
                   or ("workloads" not in m and m["moves"] in e2e)
                   for m in SPEC["per_layer"])
