"""Structured JSON logging: a JSON file handler and a plain stdout one."""
from __future__ import annotations

import json
import logging
import sys
import time
from typing import Optional


class JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        payload = {
            'ts': round(time.time(), 3),
            'level': record.levelname,
            'name': record.name,
            'message': record.getMessage(),
        }
        extra = getattr(record, 'data', None)
        if isinstance(extra, dict):
            payload.update(extra)
        return json.dumps(payload)


def configure(log_file: Optional[str] = None, stdout: bool = True,
              debug: bool = False, quiet: bool = False) -> logging.Logger:
    """Root-logger setup: JSON file handler + optional stdout."""
    root = logging.getLogger()
    root.setLevel(logging.DEBUG if debug
                  else logging.WARNING if quiet else logging.INFO)
    root.handlers.clear()
    if log_file:
        fh = logging.FileHandler(log_file)
        fh.setFormatter(JsonFormatter())
        root.addHandler(fh)
    if stdout:
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(logging.Formatter('%(asctime)s %(levelname)s %(message)s'))
        root.addHandler(sh)
    # per-sample data logging stays quiet
    logging.getLogger('offsetguided_tpu_torch.data').setLevel(logging.WARNING)
    return root


def log_record(logger: logging.Logger, message: str, **data):
    """Structured record: `{type, epoch, step, head_losses, ...}`."""
    logger.info(message, extra={'data': data})
