"""L-BFGS iterations summed over the lanes of a fit (`OptResult.iterations`),
the mean over the window's fits."""


def read(run):
    return sum(f["iters_sum"] for f in run.fits) / len(run.fits)
