"""glog-style logging (twin of legoslam_tpu/utils/logging.py): one
single-line format and a per-module getter under the "legoslam" root."""

from __future__ import annotations

import logging
import os
import sys

_FORMAT = "%(levelname).1s%(asctime)s %(name)s] %(message)s"
_configured = False


def get_logger(name: str = "legoslam") -> logging.Logger:
    global _configured
    if not _configured:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT, datefmt="%m%d %H:%M:%S"))
        root = logging.getLogger("legoslam")
        root.addHandler(handler)
        root.setLevel(os.environ.get("LEGOSLAM_LOGLEVEL", "INFO").upper())
        root.propagate = False
        _configured = True
    return logging.getLogger(name)
