"""The run on the card at a test's size: the kernels launch on the timed
path, the sound program is correct, a fault and the control (the
program's bfloat16 history) are not, and the traced readers find what
they read."""
import pytest

from portbench import faults, judge, spec
from portbench.run import measure

from conftest import small_cell

CELLS = ["kdda-lr.l2-grid8", "criteo-lr.l2-grid8"]


@pytest.mark.chip
@pytest.mark.parametrize("workload", CELLS)
def test_small_cell_on_the_card(needs_card, workload):
    cell = small_cell(workload, rows=50_000, shrink=50, d_dense=256)
    run, numbers, peak = measure(cell, 21, 1.0, True, device="cuda")
    assert peak > 0
    f = run.fits[0]
    assert f["launches"].get("tail_matvec", 0) > 0
    assert f["launches"].get("bucket_rmatvec", 0) > 0
    limits = cell["limits"]
    for k in ("loss_gap", "gnorm0_gap", "dir_gap", "grad_gap"):
        assert numbers[k] <= limits[k], (k, numbers)  # final_gap: size
    for m in cell["per_layer"]:
        v = spec.reader(m["name"])(run)
        assert v is not None and v >= 0, m["name"]
        if m["unit"] == "%":
            assert v <= 105, m["name"]
    _, bad, _ = measure(cell, 22, 0.0, False, device="cuda",
                        hooks={"fit": lambda s: faults.unchanged})
    assert not judge.verdict(bad, limits)
    cell["traffic"]["optimizer"]["lane_history_dtype"] = "bfloat16"
    _, ctl, _ = measure(cell, 23, 0.0, False, device="cuda")
    assert ctl["dir_gap"] > limits["dir_gap"], ctl
