"""Lock-step line-search trials (`OptResult.trials`) per lock-step
iteration, over the window's fits."""


def read(run):
    iters = sum(f["lockstep_iters"] for f in run.fits)
    return sum(f["trials"] for f in run.fits) / iters if iters else None
