"""Training metrics logging (port of ``avatar_tpu/utils/metrics.py``).

The names are the reference trainer's (``train/loss``, ``train/rel_mse``,
``train/nrmse``, ``train/epoch``, ``train/lr``, ``val/loss``). The logger
appends JSON lines to ``<output_dir>/metrics.jsonl`` and mirrors them to
wandb when a project is given and the package imports (imported only
then).
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Dict, Optional


class MetricsLogger:
    def __init__(
        self,
        output_dir: Optional[str] = None,
        wandb_project: Optional[str] = None,
        wandb_run_name: Optional[str] = None,
        wandb_config: Optional[dict] = None,
    ):
        self._jsonl = None
        if output_dir:
            path = Path(output_dir)
            path.mkdir(parents=True, exist_ok=True)
            self._jsonl = open(path / "metrics.jsonl", "a")

        self._wandb = None
        if wandb_project:
            try:
                import wandb

                self._wandb = wandb
                wandb.init(
                    project=wandb_project, name=wandb_run_name,
                    config=wandb_config or {},
                )
            except ImportError:
                self._wandb = None

    def set_summary(self, **kwargs):
        if self._wandb is not None:
            for k, v in kwargs.items():
                self._wandb.run.summary[k] = v
        self.log(0, {f"summary/{k}": v for k, v in kwargs.items()})

    def log(self, step: int, payload: Dict[str, Any]):
        record = {"step": step, "time": time.time(), **payload}
        if self._jsonl is not None:
            self._jsonl.write(json.dumps(record) + "\n")
            self._jsonl.flush()
        if self._wandb is not None:
            self._wandb.log(payload, step=step)

    def finish(self):
        if self._jsonl is not None:
            self._jsonl.close()
        if self._wandb is not None:
            self._wandb.finish()
