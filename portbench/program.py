"""What the program counts of itself: the gauges of its telemetry registry
(`photon_tpu_torch.telemetry.snapshot`), read once a run has ended. In a
run, the last lane solve is the fit recorded after the window for the
judge, the timed computation once more; the last layout build is the
set-up's. A program that sets none of them gives None."""
from __future__ import annotations


def gauges(*names: str):
    """The gauges ``names`` as floats, or None unless all are set."""
    from photon_tpu_torch import telemetry

    g = telemetry.snapshot()["gauges"]
    if not all(n in g for n in names):
        return None
    return [float(g[n]) for n in names]
