"""Logging and wall-clock profiling — counterpart of
``aimet_tpu/utils/logger.py``.

Port of the reference's AimetLogger singleton with per-area levels
(aimet_common/utils.py:137-214, default_logging_config.json) and the
``profile`` context manager (:488)."""
from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from enum import Enum
from typing import Dict, Optional

_DEFAULT_LEVELS = {
    "Quant": "INFO",
    "Svd": "INFO",
    "ChannelPruning": "INFO",
    "Winnow": "INFO",
    "ConnectedGraph": "INFO",
    "Utils": "INFO",
    "Test": "INFO",
    "AutoQuant": "INFO",
    "MixedPrecision": "INFO",
}


class AimetLogger:
    """Area-scoped logger registry (singleton semantics by module state)."""

    class LogAreas(Enum):
        Quant = "Quant"
        Svd = "Svd"
        ChannelPruning = "ChannelPruning"
        Winnow = "Winnow"
        ConnectedGraph = "ConnectedGraph"
        Utils = "Utils"
        Test = "Test"
        AutoQuant = "AutoQuant"
        MixedPrecision = "MixedPrecision"

    _loggers: Dict[str, logging.Logger] = {}
    _configured = False

    @classmethod
    def _configure(cls):
        if cls._configured:
            return
        levels = dict(_DEFAULT_LEVELS)
        cfg_path = os.environ.get("AIMET_TPU_LOG_CONFIG")
        if cfg_path and os.path.exists(cfg_path):
            with open(cfg_path) as f:
                levels.update(json.load(f))
        fmt = logging.Formatter(
            "%(asctime)s %(name)s %(levelname)s: %(message)s")
        for area, level in levels.items():
            lg = logging.getLogger(f"aimet_tpu_torch.{area}")
            lg.setLevel(getattr(logging, level))
            if not lg.handlers:
                h = logging.StreamHandler()
                h.setFormatter(fmt)
                lg.addHandler(h)
            cls._loggers[area] = lg
        cls._configured = True

    @classmethod
    def get_area_logger(cls, area) -> logging.Logger:
        cls._configure()
        name = area.value if isinstance(area, cls.LogAreas) else str(area)
        return cls._loggers.setdefault(
            name, logging.getLogger(f"aimet_tpu_torch.{name}"))

    @classmethod
    def set_area_logger_level(cls, area, level: int):
        cls.get_area_logger(area).setLevel(level)

    @classmethod
    def set_level_for_all_areas(cls, level: int):
        cls._configure()
        for lg in cls._loggers.values():
            lg.setLevel(level)


@contextlib.contextmanager
def profile(label: str, logger: Optional[logging.Logger] = None,
            results: Optional[Dict[str, float]] = None):
    """Wall-clock timing context (aimet_common/utils.py:488)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        elapsed = time.perf_counter() - t0
        msg = f"{label}: {elapsed:.3f} s"
        (logger or AimetLogger.get_area_logger(
            AimetLogger.LogAreas.Utils)).info(msg)
        if results is not None:
            results[label] = elapsed
