"""Host seconds of the layout build's numpy passes (the hot/cold split,
the occurrence buckets, the tail width ladder): the program's
``train.layout.host_pass_s`` gauge of the set-up's build."""
from portbench import program


def read(run):
    g = program.gauges("train.layout.host_pass_s")
    return None if g is None else g[0]
