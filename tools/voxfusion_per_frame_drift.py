"""Vox-Fusion's registry schedule per frame, in the JAX package or its PyTorch port, on the CPU.

    JAX_PLATFORMS=cpu python tools/voxfusion_per_frame_drift.py {jax|torch} {per-frame|groups} SEED

Runs the registry's ``vox-fusion`` entry on the synthetic office at a
reduced size (170x300, 256 tracking and mapping rays a window slot, 20
frames; the model and the iteration counts are the registry's) through the
package's own pipeline, per frame (``XRDSLAM_DISABLE_SUPER=1``) or through
its fused per-frame step, at the given seed, and prints the ATE beside the
ATE of a camera frozen at frame 0 and each frame's translation error. It
shows whether the reference's per-frame tracking holds this sequence at the
registry's schedule (it takes ~8 minutes and ~2 GB on two cores).
"""
import copy
import os
import sys
import tempfile
import time

import numpy as np

N_FRAMES, HEIGHT, WIDTH, RAYS = 20, 170, 300, 256


def main(pkg: str, mode: str, seed: int) -> None:
    if mode == "per-frame":
        os.environ["XRDSLAM_DISABLE_SUPER"] = "1"
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    if pkg == "jax":
        from xrdslam_tpu.common.synthetic import SyntheticDataset
        from xrdslam_tpu.configs.registry import algorithm_configs
        from xrdslam_tpu.utils.eval_ate import evaluate_ate

        ds = SyntheticDataset(n_frames=N_FRAMES, height=HEIGHT, width=WIDTH, scene="office")
    else:
        import torch

        from xrdslam_tpu_torch.common.synthetic import SyntheticDataset
        from xrdslam_tpu_torch.configs.registry import algorithm_configs
        from xrdslam_tpu_torch.utils.eval_ate import evaluate_ate

        torch.set_num_threads(2)
        ds = SyntheticDataset(f"n_frames={N_FRAMES},height={HEIGHT},width={WIDTH},scene=office")
    cfg = copy.deepcopy(algorithm_configs["vox-fusion"].xrdslam)
    if pkg != "jax":
        cfg.device = "cpu"
    cfg.algorithm.tracking_sample = cfg.algorithm.mapping_sample = RAYS
    cfg.algorithm.seed = seed
    t0 = time.time()
    pipe = cfg.setup(dataset=ds, out_dir=tempfile.mkdtemp(), verbose=False)
    pipe.run()
    algo = pipe.algorithm
    ate = evaluate_ate(algo.gt_c2w_list, algo.estimate_c2w_list)["rmse"] * 100
    frozen = evaluate_ate(algo.gt_c2w_list, [algo.gt_c2w_list[0]] * N_FRAMES)["rmse"] * 100
    err = [round(float(np.linalg.norm(np.asarray(e)[:3, 3] - np.asarray(g)[:3, 3])) * 100, 2)
           for e, g in zip(algo.estimate_c2w_list, algo.gt_c2w_list)]
    print(f"{pkg} {mode} seed {seed}: ATE {ate} cm, frozen camera {frozen} cm, {time.time() - t0:.0f} s", flush=True)
    print(err, flush=True)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2], int(sys.argv[3]))
