"""Device placement helpers (the single-device part of
`photon_tpu/parallel`; meshes wait for ROADMAP queue A item 10)."""
