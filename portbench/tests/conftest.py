"""Tests of the benchmark itself, on the CPU at small sizes; those that
need a CUDA card carry the ``chip`` marker and skip without one."""
import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card; skips where there is none "
        "(run on the card: python3 -m pytest portbench/tests -m chip)")


@pytest.fixture
def needs_card():
    """Skip unless a CUDA card is present (decided in the test, never at
    import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here")


def small_cell(workload: str, rows: int = 4000, shrink: int = 500,
               d_dense: int = 32) -> dict:
    """A cell of BENCHMARK.json with its configuration cut for a test: rows,
    every field's vocabulary divided by ``shrink``, a smaller hot block."""
    from portbench import spec

    cell = copy.deepcopy(spec.cell(spec.load_benchmark(), workload))
    cfg = cell["config"]
    cfg["rows"] = rows
    for f in cfg["fields"]:
        f["vocab"] = max(4, f["vocab"] // shrink)
    cfg["features"] = sum(f["vocab"] for f in cfg["fields"]) + 3
    cfg["layout"]["d_dense"] = d_dense
    return cell
