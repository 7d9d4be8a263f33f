"""The lane solver's own read-backs (both sites, ``solver.host_syncs.*``)
per lock-step iteration of the last lane solve (the program's
``solver.lane.*`` gauges)."""
from portbench import program


def read(run):
    g = program.gauges("solver.lane.syncs", "solver.lane.iterations")
    if g is None or not g[1]:
        return None
    return g[0] / g[1]
