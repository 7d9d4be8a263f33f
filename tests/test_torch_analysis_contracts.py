"""The port's contract registry against the reference's.

- The registry holds every one of the reference's 51 contracts (the
  `analysis.registry` docstring table names each with its port and
  reference ``module:line``, checked here), with the same tags,
  collective budget, ``require_f32_accum`` and forbid family, mapped
  (the reference's scatter families, transfer family and
  ``dot_general`` to `photon_tpu_torch.analysis.walker`'s).
- Every contract holds on the CPU (one case each).
- On the mesh family, the port's reductions match the reference's traced
  jaxpr: the reference's declared budget counts `psum` calls, which the
  contract itself holds; under this jax a psum binds one equation per
  leaf, so `walker.collective_counts` of the reference's jaxpr counts the
  reduced leaves, and the port's psum calls reduce exactly as many
  non-None leaves. ``game_re_mesh_bucket_solve`` no longer traces under
  this jax (its scan carry types differ); the port is held to the
  reference's declared budget there.
- The six self-test CLIs' ``contracts`` checks pass on the CPU.
"""
import os
import re

import jax.core
import jax.extend.core

# The JAX package imports `jax.core.ClosedJaxpr`/`Jaxpr`, which jax 0.9
# moved to `jax.extend.core`: alias the missing public names back before
# anything of photon_tpu is imported.
for _name in dir(jax.extend.core):
    if not _name.startswith("_") and not hasattr(jax.core, _name):
        setattr(jax.core, _name, getattr(jax.extend.core, _name))

import pytest  # noqa: E402

from photon_tpu.analysis import contracts as RC  # noqa: E402
from photon_tpu.analysis import walker as RW  # noqa: E402
from photon_tpu.analysis.registry import (  # noqa: E402
    load_registry as ref_load_registry)
from photon_tpu_torch.analysis import registry as PR  # noqa: E402
from photon_tpu_torch.analysis import walker as PW  # noqa: E402
from photon_tpu_torch.analysis.contracts import (  # noqa: E402
    check_contract, check_names, trace_contract)
from photon_tpu_torch.parallel.mesh import Mesh  # noqa: E402

REF = ref_load_registry()
PORT = PR.load_registry()

FORBID_MAP = {
    frozenset(): frozenset(),
    frozenset(RW.SCATTER_PRIMITIVES): PW.SCATTER_PRIMITIVES,
    frozenset(RW.SCATTER_ADD_PRIMITIVES): PW.SCATTER_ADD_PRIMITIVES,
    frozenset(RW.TRANSFER_PRIMITIVES): PW.TRANSFER_PRIMITIVES,
    frozenset({"dot_general"}): PW.DOT_GENERAL,
}

MESH_FAMILY = (
    "mesh_value_and_grad", "hybrid_mesh_value_and_grad",
    "multihost_grad_only_dcn", "streamed_mesh_finish",
    "streamed_mesh_trial_totals", "streamed_mesh_chunk_init",
    "streamed_mesh_blocked_ell_chunk_partials",
    "sharded_hybrid_value_and_grad", "sharded_permuted_value_and_grad",
    "sharded_permuted_grid_lanes", "sharded_blocked_ell_value_and_grad",
    "game_streamed_fixed_evaluation", "game_score_stream_chunk",
)
# reference specs that no longer trace under this jax
UNTRACEABLE = ("game_re_mesh_bucket_solve",)


def test_the_registry_holds_every_reference_contract():
    assert len(REF) == 51 and set(PORT) == set(REF)


@pytest.mark.parametrize("name", sorted(REF))
def test_each_contract_keeps_the_reference_law(name):
    ref, port = REF[name], PORT[name]
    assert port.tags == ref.tags
    assert dict(port.collectives or {}) == dict(ref.collectives or {})
    assert port.require_f32_accum == ref.require_f32_accum
    assert port.forbid == FORBID_MAP[frozenset(ref.forbid)]
    assert not (port.allow_transfers or port.allow_f64
                or port.allow_weak_args)


def test_the_registry_table_names_each_registration():
    table = re.findall(r"- ``(\w+)``:\n  (\S+):(\d+) \(reference (\S+):"
                       r"(\d+)\)", PR.__doc__)
    assert sorted(n for n, *_ in table) == sorted(REF)
    for name, rel, line, ref_rel, ref_line in table:
        for pkg, r, n in (("photon_tpu_torch", rel, line),
                          ("photon_tpu", ref_rel, ref_line)):
            with open(_path(pkg, r)) as fh:
                lines = fh.read().splitlines()
            head = "\n".join(lines[int(n) - 1:int(n) + 2])
            assert "register_contract(" in head and f'"{name}"' in head, (
                pkg, r, n)


def _path(pkg: str, rel: str) -> str:
    root = os.path.dirname(os.path.dirname(os.path.dirname(PR.__file__)))
    return os.path.join(root, pkg, rel)


@pytest.mark.parametrize("name", sorted(PORT))
def test_each_contract_holds_on_the_cpu(name):
    assert [str(v) for v in check_contract(PORT[name], device="cpu")] == []


@pytest.mark.parametrize("name", ["telemetry_off_is_free",
                                  "checkpoint_off_is_free",
                                  "checkpoint_off_tron_free",
                                  "ledger_off_is_free"])
def test_an_off_solve_makes_the_bare_solves_syncs(name):
    # each hook's off law is held against the bare solver on the same
    # problem, not only against a budget that would hide an added sync
    traced = trace_contract(PORT[name], "cpu")
    assert traced.bare is not None
    assert traced.second.syncs == traced.bare.syncs > 0


def _port_reductions(name, monkeypatch) -> tuple:
    """(psum calls, non-None leaves they reduce) in the contract's
    steady-state call on the CPU."""
    fn, args = PORT[name].build("cpu")[:2]
    fn(*args)  # the warm call
    seen: list = []
    orig = Mesh.psum

    def spy(self, parts):
        seen.append(sum(t is not None for t in parts[0]))
        return orig(self, parts)

    monkeypatch.setattr(Mesh, "psum", spy)
    fn(*args)
    return len(seen), sum(seen)


@pytest.mark.parametrize("name", MESH_FAMILY)
def test_mesh_reductions_match_the_reference_jaxpr(name, monkeypatch):
    traced = RC.trace_contract(REF[name])
    counts = RW.collective_counts(traced.closed_jaxpr)
    ref_leaves = counts.get("psum", 0) + counts.get("psum_invariant", 0)
    calls, leaves = _port_reductions(name, monkeypatch)
    assert calls == dict(REF[name].collectives or {}).get("psum", 0)
    assert leaves == ref_leaves


@pytest.mark.parametrize("name", UNTRACEABLE)
def test_untraceable_reference_specs_hold_the_declared_budget(
        name, monkeypatch):
    with pytest.raises(TypeError):
        RC.trace_contract(REF[name])
    calls, _ = _port_reductions(name, monkeypatch)
    assert calls == dict(REF[name].collectives or {}).get("psum", 0)


def _cli_contracts():
    from photon_tpu_torch.continual import __main__ as continual_cli
    from photon_tpu_torch.game import __main__ as game_cli
    from photon_tpu_torch.kernels import __main__ as kernels_cli
    from photon_tpu_torch.tuning import __main__ as tuning_cli

    return {"kernels": kernels_cli.KERNEL_CONTRACTS,
            "game": game_cli.GAME_E2E_CONTRACTS,
            "continual": continual_cli.CONTINUAL_CONTRACTS,
            "ingest": ("ingest_plane_chunk_invariance",),
            "tuning": tuning_cli.TUNING_CONTRACTS,
            "profiling": ("ledger_off_is_free",)}


@pytest.mark.parametrize("cli", ["kernels", "game", "continual", "ingest",
                                 "tuning", "profiling"])
def test_selftest_contracts_check_passes_on_the_cpu(cli):
    names = _cli_contracts()[cli]
    got = check_names(names, "cpu")
    assert got == {"ok": True, "n": len(names)}
