"""The occurrence-bucket X^T r kernel's share of its roofline at the
cell's lanes: the least time of one pass (`portbench.roofline.
bucket_rmatvec`) over the profiler's device time a launch, in percent."""
from portbench import devtrace, roofline


def read(run):
    if not run.trace:
        return None
    t, n = devtrace.kernel_time(run.trace, "bell_bucket_rmatvec_kernel")
    if not n or t <= 0:
        return None
    least = roofline.bucket_rmatvec(run.counts, run.lanes).least_s()[0]
    return 100.0 * least / (t / n)
