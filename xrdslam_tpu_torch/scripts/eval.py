"""``ds-eval``: the offline evaluation of a run's outputs.

Counterpart of ``xrdslam_tpu/scripts/eval.py``, with the same flags and
the same ``eval_result.json``: the ATE RMSE with Horn's alignment from the
trajectory archive, then, given a ground-truth mesh, the reconstruction
metrics, with the reconstructed mesh pre-aligned by the ATE's rotation and
translation (kept only where that brings the meshes closer) before ICP:

  * ``calc_3d_metric``: accuracy / completion / completion ratio;
  * the Tanks and Temples evaluation: P/R/F at tau, cumulative curves and
    error-coloured meshes under ``<output>/tnt``;
  * ``calc_2d_metric``: the unseen-view depth-L1, rendered by the tile mesh
    rasterizer on ``--device``; it reads ``<gt_mesh>_pc_unseen.npy`` where
    there is one.

The run's own render metrics (``eval_2d.json``, from the pipeline's
re-render sweep) are merged in, so that one file holds every column of
``BASELINE.md``.

Usage: python -m xrdslam_tpu_torch.scripts.eval --output <run dir>
       [--gt-mesh gt.ply] [--n-imgs-2d 1000] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import pickle
import sys
import time

import numpy as np

from ..pipeline.slam import resolve_device
from ..utils.eval_ate import evaluate_ate


def load_eval_tar(path: str) -> dict:
    with open(path, "rb") as f:
        return pickle.load(f)


def _plot_ate(data: dict, res: dict, path: str) -> None:
    """Top-down plot of the aligned estimate against the ground truth, with
    each frame's error segment and the RMSE in the title. Skipped, with a
    line that says so, where matplotlib is not installed."""
    try:
        import matplotlib
    except ImportError:
        print("[ds-eval] ATE plot skipped: matplotlib is not installed")
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    gt = np.stack([np.asarray(p)[:3, 3] for p in data["gt_c2w_list"]])
    est = np.stack([np.asarray(p)[:3, 3] for p in data["estimate_c2w_list"]])
    n = min(len(gt), len(est))
    gt, est = gt[:n], est[:n]
    est_al = res.get("scale", 1.0) * est @ np.asarray(res["rot"]).T + np.asarray(res["trans"])
    fig, ax = plt.subplots(figsize=(7, 6))
    ax.plot(gt[:, 0], gt[:, 2], "k-", lw=1, label="ground truth")
    ax.plot(est_al[:, 0], est_al[:, 2], "b-", lw=1, label="estimated")
    for a, b in zip(gt, est_al):
        ax.plot([a[0], b[0]], [a[2], b[2]], "r-", lw=0.4, alpha=0.5)
    ax.legend()
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.set_aspect("equal", adjustable="datalim")
    ax.set_title(f"ATE RMSE {res['rmse'] * 100:.2f} cm")
    fig.savefig(path, dpi=110)
    plt.close(fig)


def main(argv=None) -> dict:
    """Evaluate, write ``eval_result.json`` and return it with the seconds
    of each stage (``seconds``, which the file leaves out)."""
    p = argparse.ArgumentParser(prog="ds-eval", description="Evaluate SLAM outputs")
    p.add_argument("--output", type=str, required=True, help="outputs dir containing eval.tar")
    p.add_argument("--gt-mesh", type=str, default=None, help="ground-truth mesh (ply) for 3D metrics")
    p.add_argument("--correct-scale", action="store_true")
    p.add_argument("--distance-thresh", type=float, default=0.01,
                   help="T&T F-score threshold (m); docs/benchmark.md uses 0.01 (0.05 for NeuralRecon)")
    p.add_argument("--no-eval-2d", action="store_true", help="skip unseen-view depth-L1")
    p.add_argument("--n-imgs-2d", type=int, default=1000, help="unseen views for calc_2d_metric")
    p.add_argument("--device", type=str, default="cuda", help="device of the unseen-view renders (cuda or cpu)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)  # before any work: CUDA asked for and absent raises

    seconds = {}
    t0 = time.perf_counter()
    data = load_eval_tar(os.path.join(args.output, "eval.tar"))
    res = evaluate_ate(data["gt_c2w_list"], data["estimate_c2w_list"], correct_scale=args.correct_scale)
    print(f"ate rmse: {res['rmse'] * 100:.4f} cm")
    _plot_ate(data, res, os.path.join(args.output, "eval_ate_plot.png"))
    seconds["ate"] = time.perf_counter() - t0

    out = {"ate_rmse_cm": res["rmse"] * 100, **res}

    if args.gt_mesh is not None:
        from scipy.spatial import cKDTree

        from ..utils.eval_recon import (calc_2d_metric, calc_3d_metric, evaluate_3d_reconstruction,
                                        sample_mesh_points)
        from ..utils.io import Mesh, read_ply

        t0 = time.perf_counter()
        rec = read_ply(os.path.join(args.output, "mesh", "final_mesh_rec.ply"))
        gt = read_ply(args.gt_mesh)
        # pre-align with the trajectory's alignment. On a short trajectory
        # Horn's rotation is unconstrained (the poses are nearly a point) and
        # can put the mesh beyond ICP's basin, so it is kept only where it
        # brings the meshes closer.
        R, t = np.asarray(res["rot"]), np.asarray(res["trans"])
        s = float(res.get("scale", 1.0))  # the similarity's scale (--correct-scale)
        pre = Mesh(s * (rec.vertices @ R.T) + t, rec.faces, rec.vertex_colors)
        tree = cKDTree(sample_mesh_points(gt, 5000, seed=2))
        d_pre = tree.query(sample_mesh_points(pre, 5000, seed=3), k=1)[0].mean()
        d_id = tree.query(sample_mesh_points(rec, 5000, seed=3), k=1)[0].mean()
        if d_pre <= d_id:
            rec = pre

        m3d = calc_3d_metric(rec, gt)
        for k, v in m3d.items():
            print(f"{k}: {v:.4f}")
        out.update(m3d)
        seconds["3d"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        tnt = evaluate_3d_reconstruction(rec, gt, distance_thresh=args.distance_thresh,
                                         out_dir=os.path.join(args.output, "tnt"), scene_name="scene")
        print(f"tnt precision/recall/fscore @ {args.distance_thresh} m: "
              f"{tnt['precision']:.4f} / {tnt['recall']:.4f} / {tnt['fscore']:.4f}")
        out.update({"tnt_precision_pct": tnt["precision"] * 100, "tnt_recall_pct": tnt["recall"] * 100,
                    "tnt_fscore_pct": tnt["fscore"] * 100, "tnt_dist_stats": tnt["dist_stats"]})
        seconds["tnt"] = time.perf_counter() - t0

        if not args.no_eval_2d:
            t0 = time.perf_counter()
            unseen_path = args.gt_mesh.replace(".ply", "_pc_unseen.npy")
            pc_unseen = np.load(unseen_path) if os.path.exists(unseen_path) else None
            m2d = calc_2d_metric(rec, gt, n_imgs=args.n_imgs_2d, align=True, pc_unseen=pc_unseen, device=device)
            print(f"unseen-view depth l1: {m2d['depth_l1_cm']:.4f} cm ({m2d['views']} views, "
                  f"{1e3 * m2d['render_s_per_view']:.1f} ms a view's two renders on {device})")
            out["unseen_depth_l1_cm"] = m2d["depth_l1_cm"]
            seconds["2d"] = time.perf_counter() - t0
            seconds["2d_render_s_per_view"] = m2d["render_s_per_view"]

    # the run's own render metrics, so that one file has every column
    e2d_path = os.path.join(args.output, "eval_2d.json")
    if os.path.exists(e2d_path):
        with open(e2d_path) as f:
            out["render_metrics"] = json.load(f)

    with open(os.path.join(args.output, "eval_result.json"), "w") as f:
        json.dump(out, f, indent=2)
    return {**out, "seconds": seconds}


def entrypoint() -> None:
    main(sys.argv[1:])


if __name__ == "__main__":
    entrypoint()
