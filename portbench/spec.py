"""Names to files: a cell of ``BENCHMARK.json`` to its configuration, its
traffic mix and its limits, and a per-layer metric to its reader. A later
cell or metric is new files and new entries here, never an edit.

- a configuration ``<c>``: the ``file`` its entry names
  (``portbench/configs/<c>.json``);
- a traffic mix ``<t>``: ``portbench/traffic/<t>.json``, whose ``entry``
  ``<e>`` names the module that sets up, drives and judges it:
  ``portbench/entries/<e>.py``;
- a cell ``<w>``: its limits, ``portbench/limits/<w>.json``;
- a per-layer metric ``<m>``: ``portbench/metrics/<m>.py``, whose
  ``read(run)`` returns the metric's value, or None where the run holds
  nothing to read.
"""
from __future__ import annotations

import functools
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _read(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(bench: dict, workload: str) -> dict:
    """The resolved cell: its entry, ``config``, ``traffic`` and ``limits``
    (file contents), and its ``end_to_end`` and ``per_layer`` metric
    entries. Raises KeyError for a name ``BENCHMARK.json`` lacks."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; have {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _read(ROOT / configs[w["config"]]["file"])
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if workload in m.get("workloads", [workload])
             and m["moves"] in moved]
    return dict(entry=w, config=config,
                traffic=_read(HERE / "traffic" / f"{w['traffic']}.json"),
                limits=_read(HERE / "limits" / f"{workload}.json"),
                end_to_end=e2e, per_layer=layer)


@functools.lru_cache(maxsize=None)
def _module(kind: str, name: str):
    """The module of ``portbench/<kind>/<name>.py``, loaded once."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no {path}")
    spec = importlib.util.spec_from_file_location(
        f"portbench.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """The ``read`` function of a per-layer metric's reader."""
    return _module("metrics", metric).read


def entry(name: str):
    """The module of an entry: ``Session(cell, seed, device, batch_hook)``
    (set-up; ``fit(hook)`` -> (result, record), ``kept(result, record)``,
    ``record(hook)`` -> (record, kept, snapshot), ``release()``,
    ``reference()`` -> an object whose ``judge(fits, kept, snapshot)``
    gives the numbers), ``NAMES`` (the numbers, in the order printed) and
    ``control_readings(cell, seed, device, variants)``."""
    return _module("entries", name)
