"""Structured step logging (counterpart of pg_asr_tpu/utils/logging.py
``StepLogger``): stdout lines plus an append-only JSONL file
(<model_dir>/metrics.jsonl)."""

from __future__ import annotations

import json
import os
import time


class StepLogger:
    def __init__(self, model_dir: str | None = None, echo: bool = True):
        self.echo = echo
        self.path = None
        if model_dir:
            os.makedirs(model_dir, exist_ok=True)
            self.path = os.path.join(model_dir, "metrics.jsonl")

    def log(self, **fields) -> None:
        fields.setdefault("ts", time.time())
        if self.path:
            with open(self.path, "a") as fo:
                fo.write(json.dumps(fields) + "\n")
        if self.echo:
            msg = " ".join(
                f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                for k, v in fields.items() if k != "ts"
            )
            print(f"[step] {msg}", flush=True)
