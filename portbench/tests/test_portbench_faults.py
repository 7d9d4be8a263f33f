"""The judge on a run at a test's size: the sound program passes, and
each fault the cells can have, and the control (the program's bfloat16
history), come out not correct. On the CPU the program runs its kernels'
plain versions; the harness's look for a card is skipped by calling
`measure`."""

import pytest
import torch

from portbench import faults, judge
from portbench.run import measure

from conftest import small_cell

CELLS = ["kdda-lr.l2-grid8", "criteo-lr.l2-grid8"]


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_passes_the_first_step(workload):
    """Every number but ``final_gap``, whose margin drift grows with the
    size, within the cell's limit; the recorded fit replays the timed."""
    cell = small_cell(workload)
    run, numbers, _ = measure(cell, 11, 0.0, False, device="cpu")
    assert len(run.fits) == 1 and run.fits[0]["iters_sum"] > 0
    assert run.check_iteration > cell["traffic"]["optimizer"]["history"]
    assert run.replay_gap == 0.0
    limits = cell["limits"]
    for k in ("loss_gap", "gnorm0_gap", "dir_gap", "grad_gap"):
        assert numbers[k] <= limits[k], (k, numbers)


HOOKS = {
    "unchanged": {"fit": lambda s: faults.unchanged},
    "half_batch": {"batch": faults.half_batch},
    "permuted": {"fit": lambda s: faults.permuted(s.perm_cols)},
}


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", sorted(HOOKS))
def test_fault_comes_out_not_correct(workload, fault):
    cell = small_cell(workload)
    _, numbers, _ = measure(cell, 12, 0.0, False, device="cpu",
                            hooks=HOOKS[fault])
    assert not judge.verdict(numbers, cell["limits"]), numbers


@pytest.mark.parametrize("workload", CELLS)
def test_control_comes_out_not_correct(workload):
    cell = small_cell(workload)
    cell["traffic"]["optimizer"]["lane_history_dtype"] = "bfloat16"
    _, numbers, _ = measure(cell, 13, 0.0, False, device="cpu")
    assert not judge.verdict(numbers, cell["limits"]), numbers
    assert numbers["dir_gap"] > cell["limits"]["dir_gap"]


def test_direction_matches_the_solvers_two_loop():
    """The reference's recursion against the program's over pairs that
    some lanes did not take, with the history wrapped."""
    from photon_tpu_torch.optim.lane_lbfgs import LaneHistory

    from portbench.reference import glm as ref

    g = torch.Generator().manual_seed(5)
    d, G, m = 64, 3, 4
    H = LaneHistory(m, d, G, torch.float32, "cpu")
    pairs = []
    for i in range(7):
        s = torch.randn(d, G, generator=g)
        y = s * (1.0 + torch.rand(d, G, generator=g))
        take = torch.tensor([True, i % 2 == 0, i != 5])
        if i == 3:
            y[:, 2] = -y[:, 2]  # fails the curvature condition
        H.push(s, y, take)
        pairs = (pairs + [(s, y, take)])[-m:]
    grad = torch.randn(d, G, generator=g)
    want = ref.direction(grad, pairs)
    got = H.direction(grad)
    assert torch.allclose(got.double(), want, rtol=1e-5, atol=1e-6)
