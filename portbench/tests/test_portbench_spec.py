"""BENCHMARK.json against the contract the harness relies on: every name
resolves to its files, and the numbers stay inside their limits."""
import re

import pytest

from portbench import spec

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert len(BENCH["command"]) <= 32
    for word in BENCH["command"]:
        assert not word.startswith("/") and ".." not in word
    assert 1 <= BENCH["run_seconds"] <= 51
    n = len(BENCH["workloads"])
    assert 1 <= n <= 24 and 1 <= len(BENCH["configs"]) <= 24
    # a full check of 24 cells fits its time
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 \
        + 1200 <= 43200


def test_names_units_and_lines():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [x["name"] for x in BENCH["configs"] + BENCH["workloads"]
             + metrics]
    assert len(names) == len(set(names))
    for x in names:
        assert NAME.match(x), x
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for x in BENCH["configs"] + BENCH["workloads"]:
        assert 1 <= len(x["why"]) <= 200 and "\n" not in x["why"]
    for c in BENCH["configs"]:
        assert 1 <= len(c["source"]) <= 200
        assert c["file"].startswith("portbench/")
        assert set(c) == {"name", "source", "file", "reduced", "why"}


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}


@pytest.mark.parametrize("workload", CELLS)
def test_every_cell_resolves(workload):
    cell = spec.cell(BENCH, workload)
    assert cell["entry"]["chips"] in (1, 4)
    e2e = {m["name"] for m in cell["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell["per_layer"]
    E = spec.entry(cell["traffic"]["entry"])
    assert set(cell["limits"]) == set(E.NAMES)
    assert cell["traffic"]["name"] == cell["entry"]["traffic"]
    assert cell["config"]["name"] == cell["entry"]["config"]


def test_per_layer_metrics_have_readers():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    perf = (spec.ROOT / "PERF.md").read_text()
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= set(CELLS)
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert callable(spec.reader(m["name"]))
        assert f"\n| {m['layer']} | " in perf, m["layer"]  # PERF.md §3
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["name"].endswith("_roofline")
    assert any("mfu" in m["name"] for m in BENCH["per_layer"])


def test_unknown_names_raise():
    with pytest.raises(KeyError):
        spec.cell(BENCH, "no-such.cell")


def test_files_under_paths_are_named_as_names():
    for p in spec.HERE.rglob("*"):
        if p.is_file() and "__pycache__" not in p.parts:
            rel = p.relative_to(spec.ROOT).as_posix()
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
