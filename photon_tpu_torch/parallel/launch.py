"""Single-box multi-process launcher: the test substrate of the
multi-process mesh spine (port of `photon_tpu/parallel/launch.py`).

``launch(target, n_processes)`` spawns N fresh OS processes (the spawn
context: CUDA does not survive a fork), forms one `torch.distributed`
group of them over a localhost TCP rendezvous, and runs ``target(ctx)``
in every process. ``total_devices`` fixes the GLOBAL slot count, so every
process count presents the same mesh: with 8 slots, 1 process owns 8, 2
own 4 each, 4 own 2 each — the same slot arithmetic and the same
slot-ordered reduction, hence the same bits (`parallel.mesh.psum`).

The child protocol, in order:

1. the ``env`` overrides and the ``PHOTON_TPU_*`` cluster knobs are
   exported;
2. on CUDA the child pins its card (`torch.cuda.set_device`) before it
   allocates anything: card ``rank`` under NCCL (a card per process),
   card ``rank % count`` under gloo (several ranks may share one);
3. `parallel.mesh.initialize_distributed` forms the group;
4. ``target(LaunchContext)`` runs; its (picklable) return value rides a
   pipe back to the parent; the group is torn down.

Failure story: a child that raises ships its traceback to the parent,
which terminates and joins EVERY child before raising
:class:`ChildFailure` naming each failing, dead or hung rank (the
``timeout_s`` deadline bounds the whole run). A host that refuses even
a localhost rendezvous surfaces as :class:`ClusterUnavailable`.

Targets must be module-level functions (`parallel.selfcheck`): a spawn
child imports their module afresh. Build every kernel (and the native
library) in the parent first: a child killed mid-build would leave the
build's lock behind.
"""
from __future__ import annotations

import dataclasses
import multiprocessing
import os
import socket
import time
import traceback
from typing import Callable, Optional, Sequence

__all__ = ["LaunchContext", "ClusterUnavailable", "ChildFailure",
           "free_port", "launch"]

_INIT_ERRORS = ("Connection refused", "timed out", "Timed out",
                "failed to connect", "Address already in use",
                "DistNetworkError")


class ClusterUnavailable(RuntimeError):
    """The localhost process group could not form (a host that blocks even
    127.0.0.1 TCP) — an environment limitation, reported distinctly from
    a failing rank."""


class ChildFailure(RuntimeError):
    """One or more launched processes raised, died or hung; the message
    carries every failing rank's traceback or exit status."""


@dataclasses.dataclass(frozen=True)
class LaunchContext:
    """What a launched target knows about its place in the cluster."""

    process_id: int
    num_processes: int
    coordinator: str
    devices_per_process: int
    args: tuple = ()
    device: str = "cuda"
    backend: Optional[str] = None

    @property
    def total_devices(self) -> int:
        return self.devices_per_process * self.num_processes


def free_port() -> int:
    """An OS-assigned free localhost TCP port for the rendezvous."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _child_main(conn, target: Callable, ctx: LaunchContext,
                env: dict) -> None:
    """Child entry (spawn: a fresh interpreter). Results and errors ride
    the pipe."""
    try:
        os.environ.update(env)
        os.environ["PHOTON_TPU_COORDINATOR"] = ctx.coordinator
        os.environ["PHOTON_TPU_NUM_PROCESSES"] = str(ctx.num_processes)
        os.environ["PHOTON_TPU_PROCESS_ID"] = str(ctx.process_id)
        import torch

        from photon_tpu_torch.parallel import mesh as M

        dev = torch.device(ctx.device)
        if dev.type == "cuda":
            count = torch.cuda.device_count()
            card = (ctx.process_id if ctx.backend in (None, "nccl")
                    else ctx.process_id % max(count, 1))
            if card >= count:
                raise RuntimeError(
                    f"rank {ctx.process_id}: no card {card} ({count} "
                    "visible); NCCL needs a card per process — launch with "
                    "backend='gloo' to share one")
            torch.cuda.set_device(card)
            dev = torch.device("cuda", card)
        try:
            M.initialize_distributed(ctx.coordinator, ctx.num_processes,
                                     ctx.process_id,
                                     initialization_timeout=120,
                                     backend=ctx.backend, device=dev)
        except Exception as e:  # noqa: BLE001 — classified below
            if any(p in f"{type(e).__name__}: {e}" for p in _INIT_ERRORS):
                conn.send(("cluster_unavailable",
                           f"{type(e).__name__}: {e}"))
                return
            raise
        try:
            conn.send(("ok", target(ctx)))
        finally:
            M.shutdown_distributed()
    except Exception as e:  # noqa: BLE001 — the child's boundary: it ships
        try:
            conn.send(("error", f"{type(e).__name__}: {e}\n"
                                f"{traceback.format_exc()}"))
        except Exception:  # noqa: BLE001 — pipe gone: the parent sees it
            pass
    finally:
        conn.close()


def launch(target: Callable, n_processes: int, *, args: Sequence = (),
           total_devices: int = 8, timeout_s: float = 300.0,
           env: Optional[dict] = None, device: str = "cuda",
           backend: Optional[str] = None) -> list:
    """Run ``target(ctx)`` in ``n_processes`` fresh spawn-context
    processes forming one process group; return the per-rank results in
    rank order.

    ``total_devices`` (the global mesh slot count) must split over
    ``n_processes`` as `parallel.mesh.check_slot_split` allows.
    ``device`` is each child's device — ``cuda`` unless the caller asks
    for ``"cpu"``; ``backend`` its group's (default:
    NCCL on CUDA, gloo on the CPU; ``"gloo"`` to share a card). ``env``
    adds child environment variables (fault knobs, barrier timeouts).
    Raises :class:`ClusterUnavailable` when even a localhost group cannot
    form, :class:`ChildFailure` when any rank raises, dies, or misses the
    ``timeout_s`` deadline — every child is stopped and joined first."""
    n_processes = int(n_processes)
    if n_processes < 1:
        raise ValueError(f"n_processes must be >= 1, got {n_processes}")
    if total_devices % n_processes:
        raise ValueError(
            f"total_devices={total_devices} does not divide into "
            f"{n_processes} processes — the global mesh would change shape "
            "across process counts")
    from photon_tpu_torch.parallel.mesh import check_slot_split

    check_slot_split(total_devices, n_processes)
    if backend == "nccl" and str(device).startswith("cpu"):
        raise ValueError("NCCL reduces CUDA tensors; a CPU launch uses gloo")
    coordinator = f"127.0.0.1:{free_port()}"
    mp = multiprocessing.get_context("spawn")
    procs: list = []
    conns: list = []
    results: list = [None] * n_processes
    errors: list = []
    unavailable: list = []
    try:
        for rank in range(n_processes):
            ctx = LaunchContext(rank, n_processes, coordinator,
                                total_devices // n_processes, tuple(args),
                                str(device), backend)
            parent_conn, child_conn = mp.Pipe(duplex=False)
            p = mp.Process(target=_child_main,
                           args=(child_conn, target, ctx, dict(env or {})),
                           name=f"photon-launch-{rank}", daemon=True)
            p.start()
            child_conn.close()  # the parent keeps only the read end
            procs.append(p)
            conns.append(parent_conn)
        deadline = time.monotonic() + float(timeout_s)
        for rank, conn in enumerate(conns):
            remaining = max(deadline - time.monotonic(), 0.0)
            if not conn.poll(remaining):
                errors.append(f"rank {rank}: no result within "
                              f"{timeout_s:.0f}s (hung or killed)")
                continue
            try:
                status, payload = conn.recv()
            except EOFError:
                procs[rank].join(timeout=5.0)
                errors.append(f"rank {rank}: died without a result "
                              f"(exitcode {procs[rank].exitcode})")
                continue
            if status == "ok":
                results[rank] = payload
            elif status == "cluster_unavailable":
                unavailable.append(f"rank {rank}: {payload}")
            else:
                errors.append(f"rank {rank}: {payload}")
    finally:
        grace = time.monotonic() + 2.0  # ranks that answered exit now
        for p in procs:
            p.join(timeout=max(grace - time.monotonic(), 0.0))
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=30.0)
        for p in procs:
            if p.is_alive():  # terminate ignored: last resort
                p.kill()
                p.join(timeout=10.0)
        for conn in conns:
            conn.close()
    if unavailable and not errors:
        raise ClusterUnavailable(
            "localhost process group could not form:\n"
            + "\n".join(unavailable))
    if errors or unavailable:
        raise ChildFailure(
            f"{len(errors) + len(unavailable)}/{n_processes} launched "
            "processes failed:\n" + "\n".join(errors + unavailable))
    return results
