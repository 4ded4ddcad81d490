"""Stage-wise learning-rate configs.

Counterpart of ``xrdslam_tpu/engine/schedulers.py`` for the algorithms the
port runs. A config is read by its algorithm, which sets each phase's lr
on the optimizer; Adam's moments carry over from phase to phase, since
they do not depend on the lr.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class PointSLAMSchedulerConfig:
    """Two-phase lr: ``start_lr`` for the geometry phase, ``end_lr`` after.
    The split is the algorithm's ``mapping_geo_iter_ratio``; the reference's
    ``geo_iter_ratio`` and ``max_steps`` are read by nothing and not kept."""

    start_lr: float = 0.001
    end_lr: float = 0.005

    def lr_for_stage(self, stage: str) -> float:
        return self.start_lr if stage == "geometry" else self.end_lr
