"""Run logger: stdout mirror + file handler.

Copy of ``safe_denoiser_tpu/utils/logging.py``. Log lines such as
"Repellency applied at timestep t" are read by the reference's log parser,
so the runners keep emitting them.
"""

from __future__ import annotations

import logging


class Logger:
    def __init__(self, filename: str):
        # a per-file logger (not the module logger), so parallel runs do not
        # write into each other's logs.txt
        self.logger = logging.getLogger(f"safe_denoiser_tpu_torch.{filename}")
        self.logger.setLevel(logging.DEBUG)
        self.logger.propagate = False
        if not self.logger.handlers:
            formatter = logging.Formatter(
                "%(asctime)s - %(levelname)s - %(message)s")
            file_handler = logging.FileHandler(filename)
            file_handler.setLevel(logging.DEBUG)
            file_handler.setFormatter(formatter)
            self.logger.addHandler(file_handler)

    def log(self, text: str) -> None:
        print(text)
        self.logger.info(text)
