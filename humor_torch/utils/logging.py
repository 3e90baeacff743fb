"""Print-and-append logger (port of humor_tpu/utils/logging.py)."""

from __future__ import annotations

import datetime
import os
from typing import Optional


class Logger:
    """Prints timestamped lines and appends them to one log file."""

    log_file: Optional[str] = None

    @classmethod
    def init(cls, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        cls.log_file = path
        with open(path, "a") as f:
            f.write(f"=== log opened {datetime.datetime.now()} ===\n")

    @classmethod
    def log(cls, msg: str) -> None:
        line = f"[{datetime.datetime.now().strftime('%H:%M:%S')}] {msg}"
        print(line, flush=True)
        if cls.log_file:
            with open(cls.log_file, "a") as f:
                f.write(line + "\n")
