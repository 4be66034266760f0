"""Framework logger (reference capability: tools/RAiDER/logger.py:58-88).

A single shared logger named "raider_tpu_torch" with colored console output plus
optional debug/error file handlers rooted at a configurable directory.
"""

import logging
import os
import sys

_COLORS = {
    'DEBUG': '\033[36m',
    'INFO': '\033[32m',
    'WARNING': '\033[33m',
    'ERROR': '\033[31m',
    'CRITICAL': '\033[41m',
}
_RESET = '\033[0m'


class _ColorFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        msg = super().format(record)
        if sys.stderr.isatty():
            color = _COLORS.get(record.levelname, '')
            return f'{color}{msg}{_RESET}'
        return msg


logger = logging.getLogger('raider_tpu_torch')
logger.setLevel(logging.DEBUG)

_stream = logging.StreamHandler()
_stream.setLevel(logging.INFO)
_stream.setFormatter(_ColorFormatter('%(asctime)s %(levelname)s %(message)s', '%H:%M:%S'))
logger.addHandler(_stream)

_file_handlers: list = []


def set_logger_path(path: str, verbose: bool = False) -> None:
    """Attach debug.log / error.log file handlers under ``path``."""
    global _file_handlers
    for h in _file_handlers:
        logger.removeHandler(h)
    _file_handlers = []
    os.makedirs(path, exist_ok=True)

    debug_h = logging.FileHandler(os.path.join(path, 'debug.log'))
    debug_h.setLevel(logging.DEBUG)
    debug_h.setFormatter(logging.Formatter('[%(asctime)s] %(levelname)s - %(message)s'))
    error_h = logging.FileHandler(os.path.join(path, 'error.log'))
    error_h.setLevel(logging.ERROR)
    error_h.setFormatter(logging.Formatter('[%(asctime)s] %(levelname)s - %(message)s'))
    logger.addHandler(debug_h)
    logger.addHandler(error_h)
    _file_handlers = [debug_h, error_h]
    if verbose:
        _stream.setLevel(logging.DEBUG)
