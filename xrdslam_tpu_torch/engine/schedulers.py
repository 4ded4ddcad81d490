"""Stage-wise learning-rate configs.

Counterpart of ``xrdslam_tpu/engine/schedulers.py`` for the algorithms the
port runs. A config is read by its algorithm, which sets each phase's lr
on the optimizer; Adam's moments carry over from phase to phase, since
they do not depend on the lr.
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class PointSLAMSchedulerConfig:
    """Two-phase lr: ``start_lr`` for the geometry phase, ``end_lr`` after.
    The split is the algorithm's ``mapping_geo_iter_ratio``; the reference's
    ``geo_iter_ratio`` and ``max_steps`` are read by nothing and not kept."""

    start_lr: float = 0.001
    end_lr: float = 0.005

    def lr_for_stage(self, stage: str) -> float:
        return self.start_lr if stage == "geometry" else self.end_lr


@dataclass
class LRconfig:
    """NICE-SLAM's learning rate of one group in each mapping stage."""

    coarse: float = 0.0
    middle: float = 0.0
    fine: float = 0.0
    color: float = 0.005


@dataclass
class NiceSLAMSchedulerConfig:
    """lr(stage) = ``stage_lr``'s entry for the stage. The stage splits are
    the algorithm's ``mapping_middle_iter_ratio`` and
    ``mapping_fine_iter_ratio``; the reference's ``coarse``, the ratios and
    ``max_steps`` here are read by nothing and not kept."""

    stage_lr: LRconfig = field(default_factory=LRconfig)

    def lr_for_stage(self, stage: str) -> float:
        return getattr(self.stage_lr, stage)
