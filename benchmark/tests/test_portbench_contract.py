"""``BENCHMARK.json`` and the files it names: the shape the benchmark's
contract gives them, and every name resolving to its file."""
from __future__ import annotations

import json
import re

import pytest

from conftest import REPO

DOC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}


def test_top_level_keys_and_sizes():
    assert set(DOC) == {"command", "paths", "run_seconds", *KEYS}
    assert 1 <= DOC["run_seconds"] <= 51 and DOC["paths"] == ["benchmark"]
    assert len(json.dumps(DOC)) < 64 * 1024
    runs = 2 + 14 * 24
    assert runs * (DOC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("group", sorted(KEYS))
def test_entries(group):
    names = [e["name"] for e in DOC[group]]
    assert len(names) == len(set(names))
    for e in DOC[group]:
        assert set(e) - {"workloads"} == KEYS[group], e
        assert NAME.match(e["name"]), e["name"]
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")


def test_cells_resolve_to_their_files():
    configs = {c["name"]: c for c in DOC["configs"]}
    assert {w["config"] for w in DOC["workloads"]} == set(configs)
    for w in DOC["workloads"]:
        assert w["chips"] == 1
        assert (REPO / configs[w["config"]]["file"]).is_file()
        assert (REPO / "benchmark" / "traffic" / f"{w['traffic']}.json").is_file()
        limits = json.loads((REPO / "benchmark" / "limits" / f"{w['name']}.json").read_text())
        assert limits["limits"]
        e2e = [m for m in DOC["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert any(w["name"] in m["workloads"] for m in DOC["per_layer"])


def test_metrics():
    e2e = {m["name"]: m for m in DOC["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in DOC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in DOC["workloads"]}
    for m in DOC["per_layer"]:
        assert (REPO / "benchmark" / "metrics" / f"{m['name']}.py").is_file()
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        assert all(c in e2e[m["moves"]].get("workloads", cells) for c in m["workloads"])
