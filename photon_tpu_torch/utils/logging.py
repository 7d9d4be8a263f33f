"""Logging setup (the port's copy of `photon_tpu/utils/logging.py`).

Reference parity: com.linkedin.photon.ml.util.PhotonLogger — a logger that
writes both to the console and to a per-run log file under the output
directory, with the driver's standard format.

Level semantics: ``level=None`` (the default) means "keep whatever this
logger already has" — a later ``photon_logger(name)`` call (e.g. a second
driver phase re-resolving the same logger to add a file handler) can no
longer silently reset an explicitly configured level back to INFO. Only
the FIRST configuration of an unconfigured logger defaults to INFO. The
``PHOTON_TPU_LOG_LEVEL`` environment variable (a name like ``DEBUG`` or a
number) overrides every explicit level — the operator's knob for turning
a production run chatty without touching job configs.
"""
from __future__ import annotations

import logging
import os
import sys
from typing import Optional

_FORMAT = "%(asctime)s %(levelname)s %(name)s: %(message)s"


def _env_level() -> Optional[int]:
    """PHOTON_TPU_LOG_LEVEL, parsed: a standard level name ("DEBUG",
    "warning") or a numeric level; unset/unparseable -> None."""
    from photon_tpu_torch.utils.env import get_raw

    raw = (get_raw("PHOTON_TPU_LOG_LEVEL") or "").strip()
    if not raw:
        return None
    if raw.isdigit():
        return int(raw)
    level = logging.getLevelName(raw.upper())
    return level if isinstance(level, int) else None


def photon_logger(
    name: str = "photon_tpu",
    output_dir: Optional[str] = None,
    level: Optional[int] = None,
    propagate: bool = False,
) -> logging.Logger:
    """Console logger, plus a file handler at <output_dir>/<name>.log when an
    output dir is given (reference: PhotonLogger writes to HDFS logs dir).

    ``propagate=True`` lets records bubble to the root logger as well
    (used by hot-path signal logs that test harnesses capture via root
    propagation); the default keeps the reference behavior of owning the
    output to avoid duplicates under a configured root logger.
    """
    logger = logging.getLogger(name)
    env = _env_level()
    if env is not None:
        logger.setLevel(env)
    elif level is not None:
        logger.setLevel(level)
    elif logger.level == logging.NOTSET:
        logger.setLevel(logging.INFO)
    logger.propagate = propagate
    fmt = logging.Formatter(_FORMAT)
    have_stream = any(
        isinstance(h, logging.StreamHandler)
        and not isinstance(h, logging.FileHandler)
        for h in logger.handlers
    )
    if not have_stream:
        sh = logging.StreamHandler(sys.stderr)
        sh.setFormatter(fmt)
        logger.addHandler(sh)
    if output_dir is not None:
        os.makedirs(output_dir, exist_ok=True)
        path = os.path.join(output_dir, f"{name}.log")
        if not any(
            isinstance(h, logging.FileHandler)
            and getattr(h, "baseFilename", None) == os.path.abspath(path)
            for h in logger.handlers
        ):
            fh = logging.FileHandler(path)
            fh.setFormatter(fmt)
            logger.addHandler(fh)
    for h in logger.handlers:
        # handlers stay at NOTSET: the LOGGER's level is the single
        # effective level, so a level change applies to every sink at once
        h.setLevel(logging.NOTSET)
    return logger
