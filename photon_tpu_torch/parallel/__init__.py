"""Device meshes and the multi-process spine (port of
`photon_tpu/parallel`): `mesh` (slots, the slot-ordered reduction, row
sharding, the replica x data mesh, the process group), `launch`
(spawned cluster members), `selfcheck` (their targets) and ``python -m
photon_tpu_torch.parallel --selftest``."""
