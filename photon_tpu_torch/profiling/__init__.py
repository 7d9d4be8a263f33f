"""Modeled program costs (the port of `photon_tpu/profiling`'s
`StaticCost`; `model.lane_grid_cost` prices a lane-grid solve for the
lane tuner). The attribution ledger (`profiling.ledger`, `dispatch`) waits
for ROADMAP queue A item 11.5."""
from photon_tpu_torch.profiling.model import StaticCost

__all__ = ["StaticCost"]
