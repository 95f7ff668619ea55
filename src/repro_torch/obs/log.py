"""Shared ``repro_torch`` logger.

Every module logs through a child of the single ``repro_torch`` logger
(``get_logger("repro_torch.multitenant.plancache")`` etc.), so one
``configure_logging(level)`` call — wired to ``--log-level`` on the pool
CLI — controls the whole stack, and the pool daemon inherits real
logs instead of the ad-hoc ``print``/``warnings.warn`` mix this replaced.

Library rule: importing ``repro_torch`` never configures handlers or touches
the root logger; only entry points call ``configure_logging``.
"""

from __future__ import annotations

import logging

ROOT_NAME = "repro_torch"


def get_logger(name: str = ROOT_NAME) -> logging.Logger:
    """The shared ``repro_torch`` logger (or a dotted child of it)."""
    if name != ROOT_NAME and not name.startswith(ROOT_NAME + "."):
        name = f"{ROOT_NAME}.{name}"
    return logging.getLogger(name)


def configure_logging(level: str | int = "warning") -> logging.Logger:
    """Entry-point setup: one stderr handler on the ``repro_torch`` logger.

    Idempotent — repeated calls re-level the existing handler instead of
    stacking duplicates (the pool CLI may be invoked in-process by
    tests/benches)."""
    if isinstance(level, str):
        level = getattr(logging, level.upper())
    logger = get_logger()
    logger.setLevel(level)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s %(name)s: %(message)s"))
        logger.addHandler(handler)
    for handler in logger.handlers:
        handler.setLevel(level)
    return logger
