"""Host time inside the lane solver's read-backs, the device work the host
waits for, per lock-step iteration of the last lane solve (the
program's ``solver.lane.*`` gauges), in ms."""
from portbench import program


def read(run):
    g = program.gauges("solver.lane.sync_wait_s", "solver.lane.iterations")
    if g is None or not g[1]:
        return None
    return 1e3 * g[0] / g[1]
