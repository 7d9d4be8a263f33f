"""The benchmark of ``photon_tpu_torch`` on one or more CUDA cards.

``python3 -m portbench.run`` runs one cell of ``BENCHMARK.json`` once
(`run`). A cell is a configuration (``configs/<name>.json``: a data set's
published shape, read by the one generator, `gen`) under a traffic mix
(``traffic/<name>.json``: the entry and its solver options), judged by the
plain reference (`reference`) through `judge` within the cell's limits
(``limits/<cell>.json``). Each per-layer metric is a reader,
``metrics/<name>.py``; `roofline` holds the peaks and the least counts,
`devtrace` the profiler and sync readers. `control` reads the judge's
numbers for the control and the planted faults (`faults`).
"""
