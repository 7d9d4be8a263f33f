"""The card's idle share over the profiled fits: 1 - (the union of device
kernel, copy and set intervals) / their host wall, in percent."""


def read(run):
    if not run.trace or run.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
