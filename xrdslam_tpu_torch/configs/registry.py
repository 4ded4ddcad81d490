"""Algorithm registry: full default config trees per algorithm.

Counterpart of ``xrdslam_tpu/configs/registry.py`` for the ported
algorithms, with the reference package's hyperparameters: Co-SLAM (the
reference's entry: the packed patch-row hash, per-scene bounds of Replica
office0, CLI-overridable; the ``embed_fn_color`` optimizer group is left
out while ``oneGrid=False`` is not ported), NICE-SLAM, SplaTAM,
Point-SLAM (its decoders train from scratch: the pretrained
``middle_fine.pt`` that the reference entry names is not in the
repository), Vox-Fusion (its random window is the only keyframe
selection it has) and DPVO (its ``pretrained/dpvo/dpvo.pth`` is not in the
repository either: the network starts random, with a warning, unless
``model.pretrained_path`` names a ``.npz`` checkpoint such as
``pretrained/dpvo_synth.npz``) and NeuralRecon (its
``pretrained/neural_recon/model_000047.ckpt`` is absent too: the network
keeps random weights, with the reference package's warning). Knobs that
nothing in the port reads yet are left out of each entry.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict

from ..algorithms.coslam import CoSLAMConfig
from ..algorithms.dpvo import DPVOConfig
from ..algorithms.neural_recon import NeuralReconConfig
from ..algorithms.nice_slam import NiceSLAMConfig
from ..algorithms.point_slam import PointSLAMConfig
from ..algorithms.splatam import SplaTAMConfig
from ..algorithms.voxfusion import VoxFusionConfig
from ..common.mesher import MesherConfig
from ..engine.optimizers import AdamOptimizerConfig
from ..engine.runner import RunnerConfig
from ..engine.schedulers import LRconfig, NiceSLAMSchedulerConfig, PointSLAMSchedulerConfig
from ..models.conv_onet import ConvOnetConfig
from ..models.conv_onet_pointslam import ConvOnet2Config
from ..models.gaussian_splatting import GaussianSplattingConfig
from ..models.joint_encoding import JointEncodingConfig
from ..models.neucon import NeuConModelConfig
from ..models.vonet import VONetConfig
from ..models.sparse_voxel import SparseVoxelConfig
from ..pipeline.slam import MapperConfig, SLAMPipelineConfig, TrackerConfig

algorithm_configs: Dict[str, RunnerConfig] = {}

descriptions = {
    "co-slam": "Implementation of co-slam (packed hash grid; the exact hash and the triplane by option).",
    "nice-slam": "Implementation of nice-slam (dense feature grids; K4 as their gradient).",
    "splaTAM": "Implementation of splaTAM (tile rasterizer, CUDA kernels).",
    "point-slam": "Implementation of point-slam (spatial-hash kNN with a CUDA row gather).",
    "vox-fusion": "Implementation of vox-fusion (device voxel hash; K4 as its embeddings' gradient).",
    "dpvo": "Implementation of dpvo (patch-graph visual odometry; K4 under its segment and block sums).",
    "neuralRecon": "Implementation of neuralRecon (dense coarse-to-fine NeuCon fragments fused into global volumes).",
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
            ray_batch_size=30720,
            tracking_Wedge=20,
            tracking_Hedge=20,
            # Replica office0 bounds
            mapping_bound=[[-3, 3], [-4, 2.5], [-2, 2.5]],
            marching_cubes_bound=[[-2.2, 2.6], [-3.4, 2.1], [-1.4, 2.0]],
            max_keyframes=512,
            mesher=MesherConfig(resolution=256, points_batch_size=30000),
            model=JointEncodingConfig(cam_depth_trunc=100.0),
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

algorithm_configs["nice-slam"] = RunnerConfig(
    algorithm_name="nice-slam",
    xrdslam=SLAMPipelineConfig(
        tracker=TrackerConfig(map_every=5, use_relative_pose=False, save_debug_result=False),
        mapper=MapperConfig(keyframe_every=50),
        algorithm=NiceSLAMConfig(
            coarse=True,
            rot_rep="quat",
            tracking_n_iters=10,
            mapping_n_iters=60,
            mapping_first_n_iters=1500,
            mapping_window_size=5,
            tracking_sample=200,
            mapping_sample=1000,
            min_sample_pixels=200,
            ray_batch_size=30720,
            tracking_Wedge=100,
            tracking_Hedge=100,
            # Replica office0 bounds
            mapping_bound=[[-5.5, 5.9], [-6.7, 5.4], [-4.7, 5.3]],
            marching_cubes_bound=[[-5.5, 5.9], [-6.7, 5.4], [-4.7, 5.3]],
            mapping_middle_iter_ratio=0.4,
            mapping_fine_iter_ratio=0.6,
            mapping_lr_factor=1.0,
            mapping_lr_first_factor=5.0,
            max_keyframes=64,
            mesher=MesherConfig(resolution=256, points_batch_size=30000),
            model=ConvOnetConfig(
                mapping_frustum_feature_selection=True,
                pretrained_decoders_coarse=Path("pretrained/nice_slam/coarse.pt"),
                pretrained_decoders_middle_fine=Path("pretrained/nice_slam/middle_fine.pt"),
            ),
            optimizers={
                "decoder": {"optimizer": AdamOptimizerConfig(), "scheduler": NiceSLAMSchedulerConfig(
                    stage_lr=LRconfig(coarse=0.0, middle=0.0, fine=0.0, color=0.005))},
                "grid_coarse": {"optimizer": AdamOptimizerConfig(), "scheduler": NiceSLAMSchedulerConfig(
                    stage_lr=LRconfig(coarse=0.001, middle=0.0, fine=0.0, color=0.0))},
                "grid_middle": {"optimizer": AdamOptimizerConfig(), "scheduler": NiceSLAMSchedulerConfig(
                    stage_lr=LRconfig(coarse=0.0, middle=0.1, fine=0.005, color=0.005))},
                "grid_fine": {"optimizer": AdamOptimizerConfig(), "scheduler": NiceSLAMSchedulerConfig(
                    stage_lr=LRconfig(coarse=0.0, middle=0.0, fine=0.005, color=0.005))},
                "grid_color": {"optimizer": AdamOptimizerConfig(), "scheduler": NiceSLAMSchedulerConfig(
                    stage_lr=LRconfig(coarse=0.0, middle=0.0, fine=0.0, color=0.005))},
                "tracking_pose": {"optimizer": AdamOptimizerConfig(lr=1e-3), "scheduler": None},
                "mapping_pose": {"optimizer": AdamOptimizerConfig(), "scheduler": NiceSLAMSchedulerConfig(
                    stage_lr=LRconfig(coarse=0.0, middle=0.0, fine=0.0, color=0.001))},
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

algorithm_configs["point-slam"] = RunnerConfig(
    algorithm_name="point-slam",
    xrdslam=SLAMPipelineConfig(
        tracker=TrackerConfig(map_every=5, lazy_start=20, use_relative_pose=False, save_debug_result=False),
        mapper=MapperConfig(keyframe_every=20),
        algorithm=PointSLAMConfig(
            rot_rep="quat",
            tracking_n_iters=40,
            mapping_n_iters=300,
            mapping_first_n_iters=1500,
            mapping_window_size=12,
            tracking_sample=1500,
            mapping_sample=5000,
            min_sample_pixels=40,
            ray_batch_size=3072,
            tracking_Wedge=100,
            tracking_Hedge=100,
            model=ConvOnet2Config(),
            optimizers={
                "decoder": {"optimizer": AdamOptimizerConfig(), "scheduler": PointSLAMSchedulerConfig(start_lr=0.001, end_lr=0.005)},
                "geometry": {"optimizer": AdamOptimizerConfig(), "scheduler": PointSLAMSchedulerConfig(start_lr=0.03, end_lr=0.005)},
                "color": {"optimizer": AdamOptimizerConfig(), "scheduler": PointSLAMSchedulerConfig(start_lr=0.0, end_lr=0.005)},
                "tracking_pose": {"optimizer": AdamOptimizerConfig(lr=2e-3), "scheduler": None},
            },
        ),
    ),
)

algorithm_configs["vox-fusion"] = RunnerConfig(
    algorithm_name="vox-fusion",
    xrdslam=SLAMPipelineConfig(
        tracker=TrackerConfig(map_every=1, use_relative_pose=True, save_debug_result=False, init_pose_offset=10),
        mapper=MapperConfig(keyframe_every=50),
        algorithm=VoxFusionConfig(
            rot_rep="axis_angle",
            tracking_n_iters=30,
            mapping_n_iters=15,
            mapping_first_n_iters=30,
            mapping_window_size=5,
            mapping_sample=1024,
            tracking_sample=1024,
            ray_batch_size=3072,
            max_keyframes=64,
            model=SparseVoxelConfig(),
            optimizers={
                "decoder": {"optimizer": AdamOptimizerConfig(lr=5e-3), "scheduler": None},
                "embeddings": {"optimizer": AdamOptimizerConfig(lr=5e-3), "scheduler": None},
                "tracking_pose": {"optimizer": AdamOptimizerConfig(lr=1e-2), "scheduler": None},
                "mapping_pose": {"optimizer": AdamOptimizerConfig(lr=1e-3), "scheduler": None},
            },
        ),
    ),
)

algorithm_configs["dpvo"] = RunnerConfig(
    algorithm_name="dpvo",
    xrdslam=SLAMPipelineConfig(
        tracker=TrackerConfig(map_every=-1),
        algorithm=DPVOConfig(
            mapping_window_size=32,
            patch_lifetime=13,
            patch_per_frame=96,
            init_frame_num=8,
            optimization_window=10,
            buffer_size=2048,
            mem=32,
            model=VONetConfig(pretrained_path="pretrained/dpvo/dpvo.pth"),
        ),
    ),
)

algorithm_configs["neuralRecon"] = RunnerConfig(
    algorithm_name="neuralRecon",
    xrdslam=SLAMPipelineConfig(
        tracker=TrackerConfig(map_every=1, use_relative_pose=False, save_debug_result=False),
        algorithm=NeuralReconConfig(
            mapping_window_size=9,
            max_depth=3.5,
            c2w_offset=(0.0, 0.0, 1.5),
            mesh_use_double=False,
            model=NeuConModelConfig(
                n_vox=96,
                voxel_size=0.05,
                pos_weight=1.5,
                pretrained_path="pretrained/neural_recon/model_000047.ckpt",
            ),
        ),
    ),
)
