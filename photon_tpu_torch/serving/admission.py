"""Admission control: the serving tier's overload-policy plane (port of
`photon_tpu/serving/admission.py`).

Pure decisions over queue depth and deadlines — no queue, no threads, no
device — so the dispatcher stays policy free. Three mechanisms, each off
by default:

- **watermark shedding**: queue depth ≥ ``shed_watermark`` at submit
  resolves the request immediately to a typed :class:`Shed`;
- **deadlines**: a per-request ``deadline_ms`` (request field, else the
  policy default) becomes an absolute nanosecond deadline at enqueue; an
  expired request resolves to ``Shed("deadline_expired")`` instead of
  occupying a batch slot;
- **bounded submit**: ``submit(timeout=)`` (or ``submit_timeout_s``)
  bounds the blocking put; a still-full queue sheds (``"queue_full"``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

# Shed reasons (the `Shed.reason` vocabulary).
SHED_WATERMARK = "watermark"
SHED_QUEUE_FULL = "queue_full"
SHED_DEADLINE = "deadline_expired"


@dataclasses.dataclass(frozen=True)
class Shed:
    """The typed result a dropped request's Future resolves to — shedding
    is an answer ("not now"), not an exception.

    reason: ``watermark``, ``queue_full`` or ``deadline_expired``.
    queue_depth: the depth observed when the decision was made.
    waited_ms: how long the request sat before being shed.
    """

    reason: str
    queue_depth: int = 0
    waited_ms: float = 0.0

    def __bool__(self) -> bool:
        # a Shed is falsy so `if result:` reads as "was it scored"
        return False


@dataclasses.dataclass(frozen=True)
class AdmissionPolicy:
    """The overload knobs; every default is None = off.

    deadline_ms: default per-request deadline, measured from enqueue.
    shed_watermark: queue depth at/above which submit sheds immediately.
    submit_timeout_s: default bound on a blocking submit (0 = never block).
    """

    deadline_ms: Optional[float] = None
    shed_watermark: Optional[int] = None
    submit_timeout_s: Optional[float] = None

    @property
    def active(self) -> bool:
        return (self.deadline_ms is not None
                or self.shed_watermark is not None
                or self.submit_timeout_s is not None)


class AdmissionController:
    """Pure policy evaluation for one dispatcher: "admit?", "what
    deadline?", "expired?"."""

    def __init__(self, policy: Optional[AdmissionPolicy] = None):
        self.policy = policy or AdmissionPolicy()

    def submit_shed_reason(self, queue_depth: int) -> Optional[str]:
        """Shed reason for a submit seen at ``queue_depth``, or None."""
        wm = self.policy.shed_watermark
        if wm is not None and queue_depth >= wm:
            return SHED_WATERMARK
        return None

    def deadline_ns(self, req, t_enqueue_ns: int) -> Optional[int]:
        """Absolute perf_counter_ns deadline for one request (request field
        wins over the policy default; None = no deadline)."""
        ms = getattr(req, "deadline_ms", None)
        if ms is None:
            ms = self.policy.deadline_ms
        if ms is None:
            return None
        return t_enqueue_ns + int(float(ms) * 1e6)

    def submit_timeout_s(self, timeout: Optional[float]) -> Optional[float]:
        """Effective submit bound: explicit ``timeout`` wins over the
        policy default; None = block until there is room."""
        return self.policy.submit_timeout_s if timeout is None else timeout

    @staticmethod
    def expired(pending, now_ns: Optional[int] = None) -> bool:
        """Has this pending request's deadline passed?"""
        dl = getattr(pending, "deadline_ns", None)
        if dl is None:
            return False
        return (time.perf_counter_ns() if now_ns is None else now_ns) > dl
