"""Host wall of the layout build (`to_blocked_ell`), closed by a
synchronize: set-up's largest part."""


def read(run):
    return run.layout_build_s
