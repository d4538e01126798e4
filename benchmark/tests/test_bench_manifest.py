"""BENCHMARK.json against its schema: names, units, keys, the files each
entry names, and the time budget of a full check at its run length."""

import json
import re

import pytest

from benchmark.harness.spec import BENCH, ROOT, load_cell

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and \
        "\n" not in text and "\t" not in text


def test_keys_and_sizes():
    assert set(MANIFEST) == KEYS["top"]
    assert len(json.dumps(MANIFEST)) <= 64 * 1024
    for kind, entries in (("config", MANIFEST["configs"]),
                          ("workload", MANIFEST["workloads"])):
        for e in entries:
            assert set(e) == KEYS[kind], e
    for kind in ("end_to_end", "per_layer"):
        for m in MANIFEST[kind]:
            assert set(m) - {"workloads"} == KEYS[kind], m
    assert 1 <= len(MANIFEST["configs"]) <= 24
    assert 1 <= len(MANIFEST["workloads"]) <= 24
    assert 1 <= len(MANIFEST["end_to_end"]) <= 16
    assert 1 <= len(MANIFEST["per_layer"]) <= 128


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_are_unique_and_plain(kind):
    names = [e["name"] for e in MANIFEST[kind]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n


def test_units_and_directions():
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_command_and_paths():
    cmd = MANIFEST["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    for p in MANIFEST["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    for word in cmd[1:]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in MANIFEST["paths"])


def test_configs_are_files_under_paths():
    files = [c["file"] for c in MANIFEST["configs"]]
    assert len(files) == len(set(files))
    for c in MANIFEST["configs"]:
        assert c["file"].startswith("benchmark/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert cfg["source"] == c["source"] and _line(c["why"])
        assert c["reduced"] == cfg["reduced"] and len(c["reduced"]) <= 16
        used = [w for w in MANIFEST["workloads"] if w["config"] == c["name"]]
        assert used, c["name"]


def test_cells_find_their_files():
    pairs = set()
    fours = 0
    for w in MANIFEST["workloads"]:
        assert w["chips"] in (1, 4) and _line(w["why"])
        fours += w["chips"] == 4
        pairs.add((w["config"], w["traffic"]))
        cell = load_cell(w["name"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer, w["name"]
        assert cell.traffic["kind"] in ("batch", "open")
        assert (BENCH / "harness" / "loads"
                / f"{cell.traffic['kind']}.py").exists()
        assert (BENCH / "harness" / "families"
                / f"{cell.config['family']}.py").exists()
        assert cell.limits["numbers"]
    assert len(pairs) == len(MANIFEST["workloads"])
    assert fours <= max(1, len(MANIFEST["workloads"]) // 4)


def test_metrics_have_readers_and_move_reported_metrics():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    cells = {w["name"] for w in MANIFEST["workloads"]}
    layers = {}
    for m in MANIFEST["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in MANIFEST["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").exists(), m["name"]
        assert m["source"] in ("host_clock", "device_trace", "program_span",
                               "program_counter")
        assert _line(m["layer"]) and m["moves"] in e2e
        for w in m["workloads"]:
            assert w in cells
            reported = e2e[m["moves"]].get("workloads", cells)
            assert w in reported, (m["name"], w)
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_check_budget_fits_the_full_benchmark():
    s = MANIFEST["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    runs = 2 + 14 * 24
    assert runs * (s + 60) + 24 * 2 * 90 + 1200 <= 43200
