"""Logger tee: everything printed also lands in <output_dir>/log.txt.

A copy of ``rpo_tpu/engine/logger.py`` (Dassl's setup_logger contract):
log.txt is scraped downstream by parse_test_res.py, so the tee captures
stdout verbatim.
"""
from __future__ import annotations

import os
import sys
import time


class _Tee:
    def __init__(self, stream, fpath: str):
        self.stream = stream
        self.file = open(fpath, "a")

    def write(self, msg: str) -> None:
        self.stream.write(msg)
        self.file.write(msg)
        self.file.flush()

    def flush(self) -> None:
        self.stream.flush()
        self.file.flush()

    def isatty(self) -> bool:
        return False


def setup_logger(output_dir: str) -> None:
    if not output_dir:
        return
    os.makedirs(output_dir, exist_ok=True)
    fpath = os.path.join(output_dir, "log.txt")
    if os.path.exists(fpath):
        # Dassl setup_logger: an existing log.txt is never overwritten; the
        # new run writes to log.txt-<timestamp>, so parse_test_res (which
        # reads exactly log.txt) keeps the first run's results
        fpath += time.strftime("-%Y-%m-%d-%H-%M-%S")
    sys.stdout = _Tee(sys.__stdout__, fpath)
