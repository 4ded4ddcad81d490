"""Algorithm registry: full default config trees per algorithm.

Counterpart of ``xrdslam_tpu/configs/registry.py``. Only Co-SLAM is
ported; its entry carries the reference package's co-slam hyperparameters
with the exact per-vertex hash (``hash_packed=False``). Per-scene bounds
default to Replica office0 and are CLI-overridable.
"""
from __future__ import annotations

from typing import Dict

from ..algorithms.coslam import CoSLAMConfig
from ..engine.optimizers import AdamOptimizerConfig
from ..engine.runner import RunnerConfig
from ..models.joint_encoding import JointEncodingConfig
from ..pipeline.slam import MapperConfig, SLAMPipelineConfig, TrackerConfig

algorithm_configs: Dict[str, RunnerConfig] = {}

descriptions = {"co-slam": "Implementation of co-slam (exact hash grid, CUDA kernels)."}

algorithm_configs["co-slam"] = RunnerConfig(
    algorithm_name="co-slam",
    xrdslam=SLAMPipelineConfig(
        tracker=TrackerConfig(map_every=5),
        mapper=MapperConfig(keyframe_every=5),
        algorithm=CoSLAMConfig(
            rot_rep="axis_angle",
            tracking_n_iters=10,
            mapping_n_iters=10,
            mapping_first_n_iters=200,
            mapping_sample=2048,
            tracking_sample=1024,
            min_sample_pixels=100,
            tracking_Wedge=20,
            tracking_Hedge=20,
            # Replica office0 bounds
            mapping_bound=[[-3, 3], [-4, 2.5], [-2, 2.5]],
            max_keyframes=512,
            model=JointEncodingConfig(cam_depth_trunc=100.0, hash_packed=False),
            optimizers={
                "decoder": {"optimizer": AdamOptimizerConfig(lr=1e-2, weight_decay=1e-6, betas=(0.9, 0.99)), "scheduler": None},
                "embed_fn": {"optimizer": AdamOptimizerConfig(lr=1e-2, eps=1e-15, betas=(0.9, 0.99)), "scheduler": None},
                "tracking_pose_r": {"optimizer": AdamOptimizerConfig(lr=1e-3), "scheduler": None},
                "tracking_pose_t": {"optimizer": AdamOptimizerConfig(lr=1e-3), "scheduler": None},
                "mapping_pose_r": {"optimizer": AdamOptimizerConfig(lr=1e-3, accum_step=5), "scheduler": None},
                "mapping_pose_t": {"optimizer": AdamOptimizerConfig(lr=1e-3, accum_step=5), "scheduler": None},
            },
        ),
    ),
)
