"""Host-device synchronizations the program makes in one fit after the
window (the card's sync debug mode around the entry's call), per
lock-step iteration."""


def read(run):
    if not run.syncs or not run.syncs["lockstep_iters"]:
        return None
    return run.syncs["n"] / run.syncs["lockstep_iters"]
