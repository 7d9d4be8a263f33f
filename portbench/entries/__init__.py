"""The entries the window drives, one module each, found by the name a
traffic mix gives under ``entry`` (`portbench.spec.entry`)."""
