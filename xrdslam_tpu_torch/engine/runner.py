"""Top-level runner: output dir, config dump, dataset, pipeline launch.

Counterpart of ``xrdslam_tpu/engine/runner.py``.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional, Type

from ..common.datasets import get_dataset
from ..configs.base import InstantiateConfig
from ..pipeline.slam import SLAMPipelineConfig, resolve_device


@dataclass
class RunnerConfig(InstantiateConfig):
    _target: Type = field(default_factory=lambda: Runner)
    algorithm_name: str = ""
    xrdslam: SLAMPipelineConfig = field(default_factory=SLAMPipelineConfig)
    data: Optional[str] = None
    data_type: str = "synthetic"
    out_dir: str = "outputs"

    def save_config(self) -> None:
        os.makedirs(self.out_dir, exist_ok=True)
        (Path(self.out_dir) / "config.yml").write_text(str(self))


class Runner:
    def __init__(self, config: RunnerConfig) -> None:
        self.config = config

    def setup(self):
        cfg = self.config
        cfg.save_config()
        device = resolve_device(cfg.xrdslam.device)  # before any work: no CPU fallback
        dataset = get_dataset(cfg.data or "", cfg.data_type, device=str(device))
        self.pipeline = cfg.xrdslam.setup(dataset=dataset, out_dir=cfg.out_dir)
        return self.pipeline

    def run(self) -> None:
        self.setup()
        self.pipeline.run()
