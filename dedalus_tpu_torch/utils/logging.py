"""Process-stamped logging setup (parity: dedalus/tools/logging.py, fresh)."""

import logging
import sys

from .config import config

_initialized = False


def setup_logging():
    global _initialized
    if _initialized:
        return
    _initialized = True
    level = config.get('logging', 'stdout_level').upper()
    handler = logging.StreamHandler(sys.stdout)
    formatter = logging.Formatter('%(asctime)s %(name)s %(levelname)s :: %(message)s')
    handler.setFormatter(formatter)
    root = logging.getLogger()
    root.addHandler(handler)
    root.setLevel(getattr(logging, level, logging.INFO))


setup_logging()
