"""The ELL tail kernel's share of its roofline at the cell's lanes: the
least time of one pass (`portbench.roofline.tail_matvec`) over the
profiler's device time a launch, in percent."""
from portbench import devtrace, roofline


def read(run):
    if not run.trace:
        return None
    t, n = devtrace.kernel_time(run.trace, "bell_tail_matvec_kernel")
    if not n or t <= 0:
        return None
    least = roofline.tail_matvec(run.counts, run.lanes).least_s()[0]
    return 100.0 * least / (t / n)
