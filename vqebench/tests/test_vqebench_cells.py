"""BENCHMARK.json resolves, cell by cell, to the files the harness reads."""

import json
import re
from pathlib import Path

import pytest

from vqebench import generator, harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["vqebench"]
    assert BENCH["command"] == ["python3", "vqebench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    sp = harness.spec(cell, BENCH)
    loop = generator.loop(sp.traffic["loop"])
    assert loop.CALL in ("energy", "energy_and_grad") and callable(loop.run)
    assert (ROOT / "vqebench" / "ansatze"
            / f"{sp.config['ansatz']['builder']}.py").exists()
    assert (ROOT / "vqebench" / "references"
            / f"{sp.config['reference']}.py").exists()
    assert sp.limits and all(v > 0 for v in sp.limits.values())
    assert {m["name"] for m in sp.end_to_end} >= {"setup_s", "peak_mem_gib"}
    assert len(sp.end_to_end) >= 3 and sp.per_layer
    for m in sp.end_to_end + sp.per_layer:
        assert callable(harness.reader(m["name"]))


def test_names_and_entries():
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer",
                          "moves"}}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for part, need in keys.items():
        names = [e["name"] for e in BENCH[part]]
        assert len(names) == len(set(names))
        for e in BENCH[part]:
            assert set(e) - {"workloads"} == need, e["name"]
            assert NAME.match(e["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).exists() and c["reduced"] == []
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    chips = [w["chips"] for w in BENCH["workloads"]]
    assert all(c >= 1 and c & (c - 1) == 0 for c in chips)
    # at most a quarter of the cells, and always one, over several chips
    assert sum(c > 1 for c in chips) <= max(1, len(chips) // 4)
