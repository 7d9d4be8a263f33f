"""Host seconds of the layout build's device work (the hot block's
scatter on the card, the uploads of the tail and its maps): the program's
``train.layout.device_s`` gauge of the set-up's build."""
from portbench import program


def read(run):
    g = program.gauges("train.layout.device_s")
    return None if g is None else g[0]
