"""The readers of the program's own gauges (`portbench.program`): None
where the program set none, and each value from a snapshot made by
hand."""
import pytest

from portbench import spec

READERS = ("host_busy_ms_per_iter", "sync_wait_ms_per_iter",
           "solver_syncs_per_iter", "lane_occupancy_pct",
           "layout_host_pass_s", "layout_device_s")
LANE = {"solver.lane.iterations": 100, "solver.lane.trials": 150,
        "solver.lane.searching_lane_trials": 1000, "solver.lane.lanes": 8,
        "solver.lane.syncs": 251, "solver.lane.sync_wait_s": 6.5,
        "solver.lane.wall_s": 7.2, "train.layout.host_pass_s": 80.25,
        "train.layout.device_s": 4.5}
WANT = {"host_busy_ms_per_iter": 7.0, "sync_wait_ms_per_iter": 65.0,
        "solver_syncs_per_iter": 2.51, "lane_occupancy_pct": 1000 / 12,
        "layout_host_pass_s": 80.25, "layout_device_s": 4.5}


@pytest.fixture
def registry():
    from photon_tpu_torch import telemetry

    telemetry.reset()
    yield telemetry
    telemetry.reset()


@pytest.mark.parametrize("name", READERS)
def test_reader_gives_none_without_the_programs_gauges(registry, name):
    registry.gauge("serving.batch_fill", 0.5)  # some other gauge
    assert spec.reader(name)(None) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_a_snapshot(registry, name):
    for k, v in LANE.items():
        registry.gauge(k, v)
    assert spec.reader(name)(None) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", READERS[:4])
def test_lane_readers_give_none_for_a_solve_of_no_iteration(registry,
                                                            name):
    for k, v in LANE.items():
        registry.gauge(k, 0 if k.startswith("solver.") else v)
    assert spec.reader(name)(None) is None
