"""Logging setup: console logging on rank 0 only.

Counterpart of avt_tpu/utils/logging.py: standard logging, with every rank
but 0 held at WARNING.
"""
from __future__ import annotations

import logging
import os
import sys

import torch


def _process_rank() -> int:
    """The launcher's RANK, else torch.distributed's rank once a process
    group is up, else 0."""
    rank = os.environ.get("RANK")
    if rank is not None:
        return int(rank)
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_rank()
    return 0


def get_logger(name: str = "avt_tpu_torch", level: int = logging.INFO) -> logging.Logger:
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    logger.setLevel(level)
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(
        logging.Formatter("%(asctime)s %(levelname).1s %(name)s: %(message)s",
                          datefmt="%H:%M:%S"))
    logger.addHandler(handler)
    if _process_rank() != 0:
        logger.setLevel(logging.WARNING)
    return logger
