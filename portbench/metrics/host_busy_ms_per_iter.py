"""Host time of a lock-step iteration outside its read-backs: the last
lane solve's wall less the host time spent inside its read-backs, per
lock-step iteration (the program's ``solver.lane.*`` gauges), in ms."""
from portbench import program


def read(run):
    g = program.gauges("solver.lane.wall_s", "solver.lane.sync_wait_s",
                       "solver.lane.iterations")
    if g is None or not g[2]:
        return None
    wall, wait, iters = g
    return 1e3 * (wall - wait) / iters
