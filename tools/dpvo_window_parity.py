"""DPVO with the registry's edge graph and every frame kept, in the JAX package or its PyTorch port, on the CPU.

    JAX_PLATFORMS=cpu python tools/dpvo_window_parity.py {jax|torch} [FRAMES]

Runs DPVO on the committed trained weights (``pretrained/dpvo_synth.npz``)
on the synthetic office at the size they were trained at (160x120, 40
frames by default) with the registry entry's edge graph (96 patches a
frame, lifetime 13, optimisation window 10, removal window 22, ``mem`` 32)
and ``chip_smoke.py``'s ``dpvo@registry`` changes (every frame accepted
before initialisation and kept: motion threshold 0, keyframe threshold
0.01), so the window grows to 22 frames and ~45,000 edges in a bucket of
65,536. Prints the frames kept, the edges at the end and the sim(3) ATE:
the two packages' runs compared at the registry's graph size (~6 min in
JAX, ~8 min in the port on four cores; ~3 GB).
"""
import copy
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(ROOT, "pretrained", "dpvo_synth.npz")
HEIGHT, WIDTH = 120, 160
SETTINGS = dict(patch_per_frame=96, patch_lifetime=13, init_frame_num=8, optimization_window=10, removal_window=22,
                keyframe_index=4, keyframe_thresh=0.01, buffer_size=512, mem=32, edge_chunk=1024,
                motion_init_thresh=0.0)


def main(pkg: str, frames: int) -> None:
    sys.path.insert(0, ROOT)
    out_dir = tempfile.mkdtemp(prefix="dpvo_window_")
    t0 = time.time()
    if pkg == "jax":
        from xrdslam_tpu.algorithms.dpvo import DPVOConfig
        from xrdslam_tpu.common.synthetic import SyntheticDataset
        from xrdslam_tpu.models.vonet import VONetConfig
        from xrdslam_tpu.pipeline.slam import MapperConfig, SLAMPipelineConfig, TrackerConfig
        from xrdslam_tpu.utils.eval_ate import evaluate_ate

        ds = SyntheticDataset(n_frames=frames, height=HEIGHT, width=WIDTH, scene="office")
        cfg = SLAMPipelineConfig(
            tracker=TrackerConfig(map_every=-1, render_freq=-1, save_re_render_result=False),
            mapper=MapperConfig(keyframe_every=10**9),
            algorithm=DPVOConfig(model=VONetConfig(pretrained_path=WEIGHTS), **SETTINGS), enable_vis=False)
        pipe = cfg.setup(dataset=ds, out_dir=out_dir, verbose=False)
    else:
        import torch

        from xrdslam_tpu_torch.configs.registry import algorithm_configs
        from xrdslam_tpu_torch.utils.eval_ate import evaluate_ate

        torch.set_num_threads(4)
        cfg = copy.deepcopy(algorithm_configs["dpvo"])
        cfg.data, cfg.data_type = f"n_frames={frames},height={HEIGHT},width={WIDTH},scene=office", "synthetic"
        cfg.out_dir = out_dir
        cfg.xrdslam.device = "cpu"
        for key, value in SETTINGS.items():
            setattr(cfg.xrdslam.algorithm, key, value)
        cfg.xrdslam.algorithm.model.pretrained_path = WEIGHTS
        pipe = cfg.setup().setup()
        ds = pipe.dataset
    pipe.run()
    algo = pipe.algorithm
    est = [np.asarray(p) for p in algo.estimate_c2w_list]
    ate = evaluate_ate([np.asarray(p) for p in ds.poses], est, correct_scale=True)["rmse"] * 100
    print(f"{pkg}: {frames} frames, {algo.n} kept, {len(algo.ii)} edges at the end, sim(3) ATE {ate:.6f} cm, "
          f"{time.time() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]) if len(sys.argv) > 2 else 40)
