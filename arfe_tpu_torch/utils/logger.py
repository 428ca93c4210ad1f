"""Root logger (the port's copy of ``arfe_tpu/utils/logger.py``; ref:
mmdet/utils/logger.py:6-25)."""
from __future__ import annotations

import logging

FORMAT = '%(asctime)s - %(name)s - %(levelname)s - %(message)s'


def get_root_logger(log_file=None, log_level=logging.INFO):
    """The ``arfe_tpu_torch`` logger: to stderr and, with ``log_file``, to
    that file. A later call with another ``log_file`` (a second run in the
    same process) closes the earlier file and writes to the new one."""
    logger = logging.getLogger('arfe_tpu_torch')
    handlers = []
    if not any(type(h) is logging.StreamHandler for h in logger.handlers):
        handlers.append(logging.StreamHandler())
    if log_file is not None:
        for h in [h for h in logger.handlers
                  if isinstance(h, logging.FileHandler)]:
            logger.removeHandler(h)
            h.close()
        handlers.append(logging.FileHandler(log_file, 'w'))
    for h in handlers:
        h.setFormatter(logging.Formatter(FORMAT))
        h.setLevel(log_level)
        logger.addHandler(h)
    logger.setLevel(log_level)
    return logger
