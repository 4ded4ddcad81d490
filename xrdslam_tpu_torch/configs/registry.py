"""Algorithm registry: full default config trees per algorithm.

Counterpart of ``xrdslam_tpu/configs/registry.py`` for the ported
algorithms, with the reference package's hyperparameters: Co-SLAM with the
exact per-vertex hash (``hash_packed=False``; per-scene bounds default to
Replica office0 and are CLI-overridable), and SplaTAM.
"""
from __future__ import annotations

from typing import Dict

from ..algorithms.coslam import CoSLAMConfig
from ..algorithms.splatam import SplaTAMConfig
from ..engine.optimizers import AdamOptimizerConfig
from ..engine.runner import RunnerConfig
from ..models.gaussian_splatting import GaussianSplattingConfig
from ..models.joint_encoding import JointEncodingConfig
from ..pipeline.slam import MapperConfig, SLAMPipelineConfig, TrackerConfig

algorithm_configs: Dict[str, RunnerConfig] = {}

descriptions = {
    "co-slam": "Implementation of co-slam (exact hash grid, CUDA kernels).",
    "splaTAM": "Implementation of splaTAM (tile rasterizer, CUDA kernels).",
}

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

algorithm_configs["splaTAM"] = RunnerConfig(
    algorithm_name="splaTAM",
    xrdslam=SLAMPipelineConfig(
        tracker=TrackerConfig(map_every=1, use_relative_pose=True, save_debug_result=False),
        mapper=MapperConfig(keyframe_every=5),
        algorithm=SplaTAMConfig(
            rot_rep="quat",
            tracking_n_iters=40,
            mapping_n_iters=60,
            mapping_first_n_iters=60,
            mapping_window_size=24,
            model=GaussianSplattingConfig(),
            optimizers={
                "means3D": {"optimizer": AdamOptimizerConfig(lr=0.0001, eps=1e-15), "scheduler": None},
                "rgb_colors": {"optimizer": AdamOptimizerConfig(lr=0.0025, eps=1e-15), "scheduler": None},
                "unnorm_rotations": {"optimizer": AdamOptimizerConfig(lr=0.001, eps=1e-15), "scheduler": None},
                "logit_opacities": {"optimizer": AdamOptimizerConfig(lr=0.05, eps=1e-15), "scheduler": None},
                "log_scales": {"optimizer": AdamOptimizerConfig(lr=0.001, eps=1e-15), "scheduler": None},
                "tracking_pose_r": {"optimizer": AdamOptimizerConfig(lr=0.0004), "scheduler": None},
                "tracking_pose_t": {"optimizer": AdamOptimizerConfig(lr=0.002), "scheduler": None},
            },
        ),
    ),
)
