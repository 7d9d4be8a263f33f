"""The share of the lanes a line-search trial evaluates that are still
searching, over the last lane solve's trials (the program's
``solver.lane.*`` gauges), in percent."""
from portbench import program


def read(run):
    g = program.gauges("solver.lane.searching_lane_trials",
                       "solver.lane.lanes", "solver.lane.trials")
    if g is None or not g[1] * g[2]:
        return None
    return 100.0 * g[0] / (g[1] * g[2])
