"""The whole fit's share of the card's peak: the least time of the X
passes the window's fits made (kernel launches of the two tail kernels,
one a pass) and of their history sweeps (`portbench.roofline.fit_work`),
over the fits' host wall, in percent."""
from portbench import roofline


def read(run):
    least = wall = 0.0
    for f in run.fits:
        mv = f["launches"].get("tail_matvec", 0)
        rmv = f["launches"].get("bucket_rmatvec", 0)
        if not (mv and rmv):
            return None
        least += roofline.fit_work(run.counts, run.lanes, mv, rmv,
                                   f["lockstep_iters"],
                                   run.history).least_s()[0]
        wall += f["wall_s"]
    return 100.0 * least / wall
