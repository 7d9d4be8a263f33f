"""Device meshes and the multi-process spine (port of
`photon_tpu/parallel`): `mesh` (slots, the slot-ordered reduction, row
sharding, the process group), `launch` (spawned cluster members),
`selfcheck` (their targets) and ``python -m photon_tpu_torch.parallel
--selftest``. The replica x data hybrid mesh waits for ROADMAP queue A
item 10."""
