"""Drive the PyTorch port on one CUDA card and check it.

    python3 chip_smoke.py

1. Prints the card (torch and nvidia-smi).
2. Builds every kernel from ``xrdslam_tpu_torch/kernels/*.cu``, one nvcc per
   source, all at once, and prints their ptxas reports.
3. Holds each kernel against its plain PyTorch twin at the shapes of the
   main paths and times both with CUDA events (median of 20 runs, twin,
   kernel, kernel, twin), beside its bound (the least time the card could
   take, from the bytes it must move and the operations it must do, on
   the float32 and on the special-function units):
   the hash-grid kernels K1-K3 at Co-SLAM's mapping shapes (N = 176,128
   points, some outside [0,1]^3) and the plane-layout hash-grid kernels
   K8/K9 at the same shapes (nothing in the repository calls them: they
   are held at function level); the forwards K1 and K8 also at tracking's
   N = 44,032 and on office surface samples at both N, each held to the
   bits of the former, point-major forward (``POINT_MAJOR_FWD_CU``) and
   to the same bits in two launches, and timed beside it; the rasterizer
   K5/K6 and the scatter-add K4 on gaussians grown from an office frame at 600x340 and binned at its
   pose (836 tiles, K = 256, 131,072 rows), with a seeded random upstream
   gradient, and K5/K6 again binned with K = 512 (the SplaTAM gate's);
   K5/K6 also by device time. The row
   gather K7 at Point-SLAM's mapping shape: the union rows of the point map
   grown from office frame 0 at 600x340 (registry settings), gathered for
   the 24,960 surface samples of 4,992 rays (bit for bit against the twin,
   at width 1024 for K7a and 128 for K7b, timed against
   ``torch.index_select``); and K4 at ``table_lookup``'s shape, the
   199,680 neighbour rows of those samples into the 262,144 x 32 table.
   K4 at each of its six shapes (SplaTAM's, ``table_lookup``'s, the
   packed hash's and the tri-plane's on uniform random points, and the
   main-path launches of the packed hash over its 16 levels and of the
   tri-plane over its 6 planes on office surface samples) must give the
   same bits in two launches, and is timed with and
   without its ordering beside ``Tensor.index_add_`` and torch's
   deterministic ``index_put_(accumulate=True)``; the hash-grid dx must
   give the same bits in every launch. Every kernel is also timed by
   device time, and a ``[launch]`` line gives what a launch costs the host
   beyond it (CUDA events minus device time).
4. Runs, through the port's runner: Co-SLAM on the synthetic office at
   600x340 with the benchmark settings, twice (gated): with the exact hash
   grid (K1-K3; K1's launches counted by N, and K1 held to the
   point-major forward's bits and timed beside it on the run's own inputs
   at each N) and at the registry's default, the packed hash (K4 as its
   tables' gradient, launches equal to the schedule's); Co-SLAM at the
   accuracy protocol (``bench_accuracy.py``'s configuration: the
   tri-plane, 200 frames; gated on ATE, K4 launches equal to the
   schedule's), with the pipeline's post-run sweep at ``render_freq`` 50
   (every other run has it off), then its protocol row from the sweep's
   files: PSNR, SSIM and depth-L1 of ``eval_2d.json`` (``render_img`` every
   50 frames), and accuracy, completion and completion ratio of
   ``mesh/final_mesh_rec.ply`` (the final mesh culled by the estimated
   poses) against the scene's exact one, printed as one ``[protocol]`` line
   beside the JAX package's row of ``BENCH_ACCURACY.json`` and the verdicts
   of ``bench_accuracy.py``'s gates (read from the two files as data; only
   the ATE gate and finite values fail the smoke); then ``ds-eval`` of the
   port on that output dir (``scripts/eval.py``: ATE, the 3D metrics, the
   Tanks and Temples P/R/F at 1 cm and the unseen-view depth-L1 at 20
   views rendered by the tile mesh rasterizer on the card, the culled exact
   mesh as the ground truth), one ``[ds-eval]`` line with each metric and
   its seconds, failing on a non-finite one. These three runs go
   through the pipeline's group path (each 5-frame group from frame 10 on is one CUDA graph
   replay, a key's first group its warm-up and capture; each run must
   have taken it), and each prints a ``[groups]`` line (the groups, the
   frames each path took, the captures by key with their seconds, the
   replays, the graph pool's memory) and a ``[graph]`` line: from one
   saved state and generator state, the run's last group program eagerly
   twice and its graph replayed once, the replay held to the eager
   group's bits (the exact hash: poses, losses and keyframe rows within
   ``GRAPH_EXACT_TOL``) and to its launches. Then the packed-hash run
   again on its first 20 frames with ``XRDSLAM_DISABLE_SUPER=1`` (every
   frame per frame, gated the same), and a ``[steady]`` line with the four
   runs' steady s/frame;
   SplaTAM on the office at 600x340 for 20 frames with the registry's
   settings but 512 slots per tile (gated), through the group path
   (frames 2-18, each one CUDA graph replay of the fused step, keyed
   ``(do_kf, densify)``), with its ``[graph]`` line (the replay against
   two eager frames from one saved state: their bits, or, where the eager
   frames differ, within ``SPLATAM_GRAPH_SPREAD`` times their distance)
   and an ``[order]`` line (the device time of a mapping call's K4
   orderings built up front for the window against one per iteration);
   the same run per frame (``XRDSLAM_DISABLE_SUPER=1``, gated); SplaTAM's
   main path, the registry's settings (256 slots per tile; ATE reported:
   see ``SPLATAM_GATE``), through groups; a short densification run
   (``DENSIFY``, 6 frames, 3 through groups; ``[densify]``: its last group
   step with and without densification from one state, the count must grow
   inside the mapping program, the table stay finite); each SplaTAM run's
   K5/K6/K4 launches equal to ``splatam_schedule``; ``[steady]`` gives
   SplaTAM's s/frame by both paths. Beside the Co-SLAM protocol run and
   the SplaTAM runs, a second process (``start_child``) runs NICE-SLAM's
   and Vox-Fusion's per-frame A/B runs (``--per-frame`` below; gated, its
   output printed after a ``[child]`` line once it is joined, before
   Point-SLAM's runs; the steady s/frame of the runs that overlap it is
   read with the other process on the card). Then Point-SLAM's main path, the
   registry's settings on the office at 600x340 for 12 frames (gated; K7
   and K4 launches equal to the schedule's), with its ``[mesh]`` line
   (``get_mesh``, TSDF fusion of the keyframes: seconds, counts, finite) and
   its ``[graph]`` line (office frames 12-16 as one group from the run's
   final state, its head a keyframe, at ``POINTSLAM_PROFILE_MAP_ITERS``
   mapping iterations: the group eagerly twice, the first time as the
   warm-up of its two graphs' captures, the head's and the tail's, and
   replayed once, the replay
   held to the eager group's bits and K7 and K4 launches, with the
   captures' seconds, the pool's MiB, and a replay's wall, device time
   and busy share); NICE-SLAM at full width (the
   registry's model: C = 32, 5-block decoders, grids of 2.0 / 0.32 / 0.16 /
   0.16 m, 32 + 16 samples, the coarse level) with ``bench_accuracy.py``'s
   settings (``niceslam_protocol_config``) on the office at 600x340 for 60
   frames, gated, through the group path (frames 4-57, 27 groups of 2, one
   CUDA graph per ``(group, optimize_pose, do_kf)``, all four keys
   captured), its K4 launches equal to ``niceslam_schedule`` in all and by
   table (the middle grid's, the fine and colour grids', the coarse
   grid's), its ``[graph]`` line (a replay's bits against the eager
   group's), ``render_img`` at the last frame and ``get_mesh`` (finite, not
   empty), and ``[steady]``. K4 is also held to
   its twin at NICE-SLAM's three shapes, on the corner ids of a mapping
   iteration's samples of office frame 0: the middle grid's (460,800 ids
   into 4,998 x 32), the fine grid's (460,800 into 39,984 x 32) and the
   coarse grid's (256,000 into 120 x 32). Vox-Fusion at the registry's
   settings (the full model: 0.2 m voxels, 16,384 voxels, 20,000
   embeddings of 16, 96 probes, 20 hits x 10 samples; 30 tracking and 15
   mapping iterations of 1,024 rays a window slot, window 5, relative
   poses offset by 10 m) on the office for 60 frames, not cut, gated,
   through its fused step (frames 2-58, one CUDA graph replay a frame,
   keys ``(optimize_pose, do_kf)``, both captured: frame 50 is a keyframe
   inside one), its K4 launches equal to ``voxfusion_schedule``, its
   ``[voxels]`` line (voxels and vertices allocated, either table full),
   ``[insert]`` (frame 0's depth inserted on the device into an empty map
   against the host ``VoxelHashMap``: the same voxel coordinates and
   vertex count), ``[graph]`` (a replay's bits against the eager frame's),
   ``render_img`` at the last frame and ``get_mesh``, and ``[steady]``.
   K4 is also held to its twin at
   Vox-Fusion's shape, on the ids and upstream gradient of the last
   iteration of the first mapping call on office frame 0 (819,200 ids
   into 20,000 x 16; voxel 0's 8 rows, where the segments that hit no
   voxel point, hold most of them). DPVO on the committed trained weights
   (``pretrained/dpvo_synth.npz``): ``tests/test_dpvo_trained.py``'s run
   (the office at 160x120, 40 frames, 48 patches; gated at its sim(3) ATE
   of 2 cm alone) and the registry's entry at 600x340 for 40 frames (96
   patches, every frame accepted before initialisation and kept, so the
   edge graph grows to the registry's steady ~53,000 edges in a bucket of
   65,536: ``DPVO_REGISTRY``; its sim(3) ATE reported), each with K4's
   launches equal to ``dpvo_schedule`` (12 an update, 4 a motion probe),
   K4 held to its twin and timed at the registry run's SoftAgg and
   bundle-adjuster shapes (the largest DPVO gives it) on one update at its
   last state, and that run's update profiled by stage; ``dpvo@trained``
   again on the committed weights written out as a reference-layout
   ``dpvo.pth`` (``dpvo@trained-pth``: it must load and give the ``.npz``
   run's poses). DPVO's training (``dpvo@train``, ``DPVO_TRAIN``): VONet
   trained on the card from random weights at the first stage of
   ``tools/dpvo_full_run.py``'s recipe, one step's gradients with K4 held
   to the same step's with the twins, K4's launches to the counted schedule
   (``engine/dpvo_train.train_step_scatters``, 22 a step; by rows, and by
   role as the training run's calls give them), the learning gates of
   ``tests/test_dpvo_train.py``, K4 checked and timed at each of a step's
   six shapes, a step profiled at 160x120 and at 600x340
   with 96 patches, and the trained tree run at ``dpvo@trained``'s
   configuration (``dpvo@port-trained``; ATE reported). NICE-SLAM's
   decoders at the end of its protocol run written as the reference's
   ``middle_fine.pt`` / ``coarse.pt`` and loaded by a run of its first 8
   frames, its first mapping 300 iterations (``nice-slam@pretrained``:
   loaded, the frozen decoders the same bits after the run, K4's launches
   the schedule's; ATE reported). NeuralRecon
   (cuDNN's convolutions in full float32; K4 as the back-projection's
   gradient, so only its training launches a hand kernel): its in-env
   training at ``tests/test_neucon_sequence.py``'s configuration, gated at
   that test's gates (``neuralrecon@test``); the registry's entry at full
   width through the runner on the office's 200 frames, gated on its
   fragment count against the host gating's and finite volumes, with a
   profile of one fragment by stage and of one training step
   (``neuralrecon@registry``); and a training run at full width on those
   frames (``neuralrecon@train96``, gated on a falling loss, its
   reconstruction reported beside random weights'), each training run's
   K4 launches held to one a view and level a step, and K4 checked and
   timed at the 96^3 level's shape. A gated run's ATE must be at most
   10 cm and at most half that of a camera frozen at frame 0
   (``FROZEN_ATE_SHARE``). Every pose must be finite and every kernel of
   each main path launched (the launch counts are zeroed just before each
   run and read just after).
5. Profiles one tracking and one mapping call of each run on a main path
   (of a Co-SLAM, SplaTAM, NICE-SLAM or Vox-Fusion run also one replay of
   its last group's graph)
   and of SplaTAM's K = 512 run with torch.profiler
   (Point-SLAM's mapping call with 30 iterations): wall time, device busy
   time and the kernels that take it. ``[elapsed]`` lines stamp the
   phases.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Any failed check raises (non-zero exit,
no result).

    python3 chip_smoke.py --niceslam-protocol

builds the kernels and runs NICE-SLAM at the accuracy protocol
(``bench_accuracy.py``'s NICE-SLAM row: 200 office frames, the same
settings as the default run's) and prints its ``[protocol]`` row (PSNR,
SSIM, depth-L1 of ``render_img`` every 50 frames; accuracy, completion
and its ratio of the culled mesh) beside the JAX package's row of
``BENCH_ACCURACY.json`` and ``bench_accuracy.py``'s gates for NICE-SLAM;
reported, not gated (only finiteness fails it); no result line.

    python3 chip_smoke.py --dpvo

builds the kernels and runs DPVO's part of the default run alone (its two
runs and the ``.pth`` run, K4 at its shapes, the profile), then prints the
kernels line of its K4 records; no result line.

    python3 chip_smoke.py --dpvo-train

builds the kernels and runs DPVO's training part of the default run alone
(``dpvo@train`` and ``dpvo@port-trained``), then prints the kernels line of
its K4 records; no result line. ``--dpvo-train-full`` trains at the whole
committed recipe (400 iterations at 2e-4, then 1,600 at 1e-4, seed 1) and
gates ``dpvo@port-trained`` at ``tests/test_dpvo_trained.py``'s 2.0 cm.

    python3 chip_smoke.py --dpvo-train-seeds N

trains the whole recipe from random weights at seeds 0 .. N - 1 and
reports each trained tree's ``dpvo@trained`` ATE and their spread, then
seed 0's first 20 steps on the card against the same steps in float64 on
the CPU; no result line.

    python3 chip_smoke.py --neuralrecon

builds the kernels and runs NeuralRecon's part of the default run alone
(its three runs, the profile, K4 at its shape), then prints the kernels
line of its K4 record; no result line.

    python3 chip_smoke.py --slots-probe

builds the kernels and measures SplaTAM's registry run against one change
at a time (``SLOTS_PROBE``: a larger table, more slots per tile, the JAX
package's smoke schedule), the evidence behind ``SPLATAM_GATE``; it prints
one JSON line per setting and no result line.

    python3 chip_smoke.py --raster-variants

builds the rasterizer with one change at a time (``RASTER_VARIANTS``) and
times each beside the shipped K5/K6 on the grown office frame at K = 256
and 512 (``[variant]`` lines, no result line): what each part of the
kernels' design costs or saves.

    python3 chip_smoke.py --scatter-variants

checks and times K4 at its six shapes (as the default run does) beside
K4's former atomic design, rebuilt from ``ATOMIC_SCATTER_CU`` with scalar and
with float4 atomics, and the main paths' single K4 launch against one per
level or plane (``[lever]`` lines); then rebuilds the hash-grid backward
with one change at a time (``HASHGRID_VARIANTS``) and times dx, dtable and
both (``[variant]`` lines, no result line).

    python3 chip_smoke.py --hashgrid-fwd-variants

times the hash-grid forward (K1 and K8) as shipped beside the point-major forward
and the shipped design with one change at a time (G = 1, 2, 4, 16 levels a
thread; no x-pair loads; no output staging; loads only, the floor of its
access pattern; 4x the points per block; the largest L1; the hashed
levels' pair loads not kept in L1) at random and office surface points, at
N = 176,128 and 44,032, by CUDA events and device time, with each one's
ptxas registers (``[variant]`` lines, no result line).

    python3 chip_smoke.py --determinism-probe

runs each main path for a few frames under
``torch.use_deterministic_algorithms(True, warn_only=True)`` and prints
every operation torch names as non-deterministic (``[determinism]`` lines,
no result line).

    python3 chip_smoke.py --pointslam-groups

runs Point-SLAM at the registry's settings on 50 office frames through the
pipeline (~6 minutes with the build): frames 0-29 and 45-49 per frame,
30-44 in three groups (the head's graph and the tail's, a tail key with
and one without a keyframe, both captured), gated on ATE as the 12-frame
run, K7 and K4 launches equal to ``pointslam_schedule`` for that split;
``[graph]`` (frames 50-54 from the final state at the registry's 300
mapping iterations, as in the default run), ``[steady]`` (frames 21-29
per frame, the group frames by the pipeline's clock, the replayed
group's s/frame) and ``[mesh]`` with the mesh's accuracy, completion and
completion ratio against the scene's exact mesh, reported (no result
line).

    python3 chip_smoke.py --ds-eval

runs Co-SLAM's protocol run with its sweep as the default run does, holds
the ``[protocol]`` row from the sweep's files to the values of the hand
loop it replaced (``render_img`` every 50 frames from the generator state
the sweep started from, ``get_mesh``, the evaluation cull, the same
metric functions: equal), then ``ds-eval`` at the reference's 1,000 unseen
views (``[ds-eval]``, with the raster's seconds a view; no result line).

    python3 chip_smoke.py --per-frame

runs the per-frame A/B runs that the default run starts in its second
process: NICE-SLAM at the protocol's settings on its first 20 frames and
Vox-Fusion's registry entry on 60 frames, every frame per frame
(``XRDSLAM_DISABLE_SUPER=1``), each gated (Vox-Fusion at the ATE of a
camera frozen at frame 0 instead of half of it, see
``VOXFUSION_PER_FRAME_NOTE``), schedule, no groups; ``[steady]`` (no
result line).

    python3 chip_smoke.py --pointslam-repeat N --protocol-repeat M --niceslam-seeds S --voxfusion-seeds V

runs Point-SLAM's gated main path N times, then Co-SLAM at the accuracy
protocol (tri-plane, 200 frames, seed 0) and its row M times, then the
default run's NICE-SLAM (60 office frames, the protocol's settings)
through groups and per frame at seeds 0 .. S - 1, then Vox-Fusion's
(60 office frames, the registry's settings) through groups, per frame and
per frame at seeds 0 .. V - 1 (any of the flags alone also works), and prints each run's ATE beside its gate, a
digest of its poses' bits, the rows and NICE-SLAM's and Vox-Fusion's
largest frame error (nothing gated, no result line), and whether the runs
of each repeated kind were identical.
"""
from __future__ import annotations

import atexit
import copy
import functools
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

COSLAM_FRAMES = 60
# the packed hash's per-frame A/B runs the first 20 of those frames: the
# smoke's DPVO runs took the time the other 40 took
COSLAM_PER_FRAME_FRAMES = 20
PROTOCOL_FRAMES = 200  # bench_accuracy.py's sequence
PROTOCOL_RENDER_FREQ = 50  # bench_accuracy.py's default render_freq
DS_EVAL_VIEWS = 20  # the default run's unseen views for ds-eval (--ds-eval: the reference's 1,000)
SPLATAM_FRAMES = 20
POINTSLAM_FRAMES = 12  # a first mapping of 1,500 iterations, then 11 x (40 tracking + 300 mapping)
# NICE-SLAM at the accuracy protocol's settings: frames 4-57 go through 27
# groups of 2; keyframes at 0, 10, ..., 50 put the keyframe count above 4
# (pose optimisation in mapping) from the group at 42 on, so the run
# captures all four keys (2, optimize_pose, do_kf)
NICESLAM_FRAMES = 60
# NICE-SLAM's per-frame A/B runs the first 20 of those frames (~2.5 s a
# frame): the smoke's Vox-Fusion runs took the time the other 40 took
NICESLAM_PER_FRAME_FRAMES = 20
# Vox-Fusion at the registry's settings (map_every 1, keyframe_every 50):
# frames 2-58 go through the fused step, frame 50 a keyframe inside one, so
# the run captures both keys (optimize_pose, do_kf): (True, False), (True, True)
VOXFUSION_FRAMES = 60
# VOXFUSION_PER_FRAME_NOTE: Vox-Fusion's per-frame A/B runs the same
# settings, gated looser than the other runs: its ATE must be at most
# ATE_LIMIT_CM and at most VOXFUSION_PER_FRAME_FROZEN_SHARE of a frozen
# camera's, i.e. it must beat a camera that never moves. At the registry's
# 30 tracking iterations a frame (tuned for office0's 2,000 frames; the
# office tour moves 33 times as far a frame) the reference's per-frame
# tracking drifts on this sequence in either package: ``--voxfusion-seeds``
# runs both paths at several seeds; tools/voxfusion_per_frame_drift.py runs
# the JAX package and the port per frame on the CPU at a reduced size
# (PERF.md, PR 11).
VOXFUSION_PER_FRAME_FROZEN_SHARE = 1.0
# The profiled Point-SLAM mapping call runs 30 of the registry's 300
# iterations: torch.profiler took ~4.5 minutes of the host to process a
# 300-iteration call (420,000 kernels), and a 60-iteration call about a
# minute; the iterations are alike.
POINTSLAM_PROFILE_MAP_ITERS = 30
# ``[graph] point-slam``: from the final state of the gated 12-frame run,
# office frames 12-16 as one group (its head mapped and made a keyframe),
# eagerly twice and through its two graphs once, at
# POINTSLAM_PROFILE_MAP_ITERS mapping iterations (the smoke's time; the
# iterations are alike). ``--pointslam-groups`` runs the registry's 300.
POINTSLAM_GRAPH_HEAD = 12
# ``--pointslam-groups``: 50 office frames at the registry's settings, so
# that frames 30-44 go through three groups (keyframes at 0, 20 and 40:
# both tail keys captured); frames 21-29 are the per-frame figure
POINTSLAM_GROUP_FRAMES = 50
# SplaTAM's accuracy gate runs the main path's data and settings with one
# change: 512 slots per tile. A tile keeps the K nearest of the gaussians
# whose binning box (3 sigma + 8 px) overlaps it, up to 38 x 38 of them for
# the ~1 px gaussians grown one per pixel. At the registry's 256 the map
# grown from a frame leaves most of that frame's silhouette below 0.5 (the
# "[coverage]" line), and the reference package's per-frame tracking drifts
# on such a map at the registry's schedule (40 tracking and 60 mapping
# iterations per frame); tests/test_torch_splatam.py shows that drift in the
# JAX package and holds the port's tracking to it. The registry run's ATE
# is reported ungated. ``--slots-probe`` measures the registry run against
# one change at a time.
SPLATAM_GATE = {"algorithm.model.k_per_tile": 512}
G262144 = {"algorithm.model.max_gaussians": 262_144}
# the JAX package's SplaTAM smoke schedule (tests/test_e2e_algorithms.py)
SMOKE_SCHEDULE = {"algorithm.tracking_n_iters": 6, "algorithm.mapping_n_iters": 10,
                  "algorithm.mapping_first_n_iters": 15, "algorithm.mapping_window_size": 3,
                  "mapper.keyframe_every": 2}
SLOTS_PROBE = {
    "registry": {},
    "table262144": G262144,
    "k512": SPLATAM_GATE,
    "table262144_k512": {**G262144, **SPLATAM_GATE},
    "table262144_k512_track10": {**G262144, **SPLATAM_GATE, "algorithm.tracking_n_iters": 10},
    "k1024": {"algorithm.model.k_per_tile": 1024},
    "smoke_schedule": SMOKE_SCHEDULE,
}
N_MAP = 176_128  # (2048 keyframe + 2048 current rays) x 43 samples
N_TRACK = 44_032  # 1024 rays x 43 samples
HEIGHT, WIDTH = 340, 600
# DPVO: tests/test_dpvo_trained.py's configuration of the registry's entry
# on the committed trained weights (the office at 160x120, 40 frames,
# gated at its sim(3) ATE bound), then the registry's entry at 600x340 on
# the same weights, which were trained at 160x120 (its ATE reported), with
# two changes, the test's. Every frame is accepted before initialisation:
# at the registry's motion_init_thresh of 2 px no frame is, as the motion
# probe's median runs over the padded edge table, 96 real edges in a bucket
# of 2,048, so it is the padded edges' constant |d.bias| (0.050 px on these
# weights) in either package (PERF.md, Findings). And every frame is kept
# (keyframe_thresh 0.01): at the registry's 15 px the office tour's slow
# motion drops frame n - 5 after every frame, the window stays at 8 frames
# and 6,144 edges, and the registry's steady edge graph (22 frames of 96
# patches, ~53,000 edges in a bucket of 65,536) never forms
DPVO_WEIGHTS = os.path.join(ROOT, "pretrained", "dpvo_synth.npz")
DPVO_FRAMES = 40
DPVO_TRAINED_DATA = f"n_frames={DPVO_FRAMES},height=120,width=160,scene=office"
DPVO_TRAINED = {"algorithm.patch_per_frame": 48, "algorithm.patch_lifetime": 13, "algorithm.init_frame_num": 8,
                "algorithm.optimization_window": 10, "algorithm.removal_window": 16, "algorithm.keyframe_index": 4,
                "algorithm.keyframe_thresh": 0.01, "algorithm.buffer_size": 512, "algorithm.mem": 24,
                "algorithm.edge_chunk": 2048, "algorithm.motion_init_thresh": 0.0,
                "algorithm.model.pretrained_path": DPVO_WEIGHTS}
DPVO_REGISTRY = {"algorithm.model.pretrained_path": DPVO_WEIGHTS, "algorithm.motion_init_thresh": 0.0,
                 "algorithm.keyframe_thresh": DPVO_TRAINED["algorithm.keyframe_thresh"]}
DPVO_ATE_LIMIT_CM = 2.0
# dpvo@trained-pth: the committed weights through the reference-layout
# .pth are the same float32 bits, so the run repeats the .npz run's; its
# poses may differ from them by at most this (m or rotation entry), which
# only a non-deterministic kernel in the run could take
DPVO_PTH_POSE_TOL = 1e-5
# dpvo@train: VONet trained on the card from random weights at the first
# stage of tools/dpvo_full_run.py's recipe (16 office frames at 160x120,
# 64 patches in one correlation chunk, 3 px of noise, lr 2e-4, seed 0, 400
# iterations) and gated as tests/test_dpvo_train.py gates its training:
# the mean of the last 10 losses below DPVO_TRAIN_LOSS_DROP of the first
# 10; on a held-out batch (default_rng(123)), one update's error below
# DPVO_TRAIN_NOISE_SHARE of the noise's and below DPVO_TRAIN_RANDOM_SHARE
# of the random weights'; weights in (0, 1). The trained tree then runs
# dpvo@trained's configuration (its ATE reported: 400 iterations are a
# fifth of the committed weights' recipe). --dpvo-train-full adds the
# recipe's second stage (1,600 iterations at 1e-4, seed 1) and gates that
# run at DPVO_ATE_LIMIT_CM. A training step is profiled at 160x120 and at
# 600x340 with the registry's 96 patches
DPVO_TRAIN_DATA = "n_frames=16,height=120,width=160,scene=office"
DPVO_TRAIN = dict(n_iters=400, lr=2e-4, m=64, chunk=64, noise_px=3.0, seed=0)
DPVO_TRAIN_RESUME = dict(n_iters=1600, lr=1e-4, seed=1)
DPVO_TRAIN_LOSS_DROP = 0.55
DPVO_TRAIN_NOISE_SHARE = 0.6
DPVO_TRAIN_RANDOM_SHARE = 0.8
DPVO_TRAIN_REGISTRY_M = 96  # the registry's patch_per_frame
# --dpvo-train-seeds: seed 0's first steps on the card against the CPU's float64
DPVO_WITNESS_STEPS = 20
# a training step's gradients with K4 against the same step with the twins:
# within DPVO_TRAIN_GRAD_RTOL of the larger of a leaf's largest entry and
# DPVO_TRAIN_GRAD_FLOOR of the largest entry of any leaf (sums in another
# order). The floor is for the biases before the encoders' instance norms,
# whose gradient is zero but for float32 rounding: ~1e-7 of the largest
# entry in both runs, on an H100 and on the CPU
DPVO_TRAIN_GRAD_RTOL = 1e-4
DPVO_TRAIN_GRAD_FLOOR = 1e-2
# NICE-SLAM with pretrained decoders: the middle, fine and coarse decoders
# of the end of the smoke's nice-slam@protocol run written as the
# reference's middle_fine.pt / coarse.pt and loaded by a run of the same
# settings on its first 8 frames (frames 4-5 one group, captured), its
# first mapping cut from the protocol's 1,500 iterations to
# NICESLAM_PRETRAINED_FIRST_ITERS, which took 34 of the run's 62 s on an
# H100 (gated: loaded, the frozen decoders the same bits after the run,
# K4's launches the schedule's; ATE reported)
NICESLAM_PRETRAINED_FRAMES = 8
NICESLAM_PRETRAINED_FIRST_ITERS = 300
# NeuralRecon. neuralrecon@test: tests/test_neucon_sequence.py's sequence
# (12 frames of the simple scene at 48x64, n_vox 32 at 0.15 m, fragments
# of 3 + 1 views, no gating; 2 epochs x 25 steps a fragment) and its gates:
# the loss ends below NEURALRECON_LOSS_DROP of its first value, and the
# fused mesh of the trained weights (F-score at the voxel size, 0.15 m)
# beats NEURALRECON_TEST_GATES and random weights
NEURALRECON_TEST_DATA = "n_frames=12,height=48,width=64"
NEURALRECON_TEST = dict(mapping_window_size=3, min_angle=0.0, min_distance=0.0, max_depth=3.0, img_size_w=64,
                        img_size_h=48)
NEURALRECON_TEST_MODEL = dict(n_vox=32, voxel_size=0.15)
NEURALRECON_TEST_STEPS = 25
NEURALRECON_LOSS_DROP = 0.25
NEURALRECON_TEST_GATES = {"accuracy_cm": 15.0, "completion_cm": 30.0, "f1_pct": 50.0}
# neuralrecon@registry: the registry's entry (n_vox 96 at 0.05 m, 10 views
# of 640x480 a fragment, gating at 15 degrees and 0.1 m) on the office's
# 200 frames at 600x340, random weights. neuralrecon@train96: the same with
# a keyframe every 2 cm, so that the tour gives several fragments, trained
# for NEURALRECON_TRAIN96_STEPS steps a fragment (one epoch) and fused
# again; its reconstruction at 5 cm against random weights', reported
NEURALRECON_FRAMES = 200
NEURALRECON_TRAIN96 = {"algorithm.min_distance": 0.02}
NEURALRECON_TRAIN96_STEPS = 4
ATE_LIMIT_CM = 10.0
# A gated run must also score at most this share of the ATE of a camera
# that never moves (every pose frame 0's): the office tour moves 0.6 cm a
# frame, so over Point-SLAM's 12 frames that camera scores 2.16 cm, far
# inside ATE_LIMIT_CM, and only this bound tells tracking from none.
FROZEN_ATE_SHARE = 0.5
# A group replayed from a saved state against the eager group from the same
# state and generator state ([graph]): the exact hash's table gradient adds
# with fp32 atomics (K3) in another order in every run, so its poses (m,
# rad), best losses (relative) and keyframe rows are held to this; the
# packed hash and the tri-plane to the same bits.
GRAPH_EXACT_TOL = 1e-4
# SplaTAM's replay ([graph] splaTAM@k512): the eager frame's bits where two
# eager frames give the same bits; where they differ (cuDNN's SSIM backward
# may sum in another order in each call), the replay's distance from the
# first eager frame may be at most this many times the eager frames' own
SPLATAM_GRAPH_SPREAD = 4.0
# SplaTAM with densification on: a short run through groups (frames 2-4).
# The registry's mapping_densify_dict starts at iteration 500 and never
# fires within a 60-iteration mapping call; this run keeps its thresholds
# and scales its schedule to the call: one densification, at iteration 30.
# At 600x340 and K = 512 that clones 16-24% of the gaussians (their mean
# screen gradient reaches grad_thresh; all are small) and growth adds
# 40,000-70,000 a frame after the first's 204,000, so the map passes a
# million rows by frame 5: the run has room for 2,097,152
DENSIFY_FRAMES = 6
DENSIFY = {"algorithm.mapping_use_gaussian_splatting_densification": True,
           "algorithm.model.max_gaussians": 2_097_152,
           "algorithm.model.mapping_densify_dict": dict(
               start_after=30, remove_big_after=3000, stop_after=30, densify_every=30, grad_thresh=0.0002,
               num_to_split_into=2, removal_opacity_threshold=0.005, final_removal_opacity_threshold=0.005,
               reset_opacities_every=3000)}
FWD_ATOL = 1e-5
BWD_RTOL = 1e-4  # of max |twin|: sums in another order (fp32 atomics in K2-K4)
# NVIDIA H100 SXM, published peaks (data sheet): HBM rate and float32 rate
# outside the tensor cores, the rate of the kernels' arithmetic; and the
# special-function units' rate (exp, log, reciprocal): 16 a clock on each
# of the 132 SMs at the 1.98 GHz boost clock
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
PEAK_SFU_OPS_PER_S = 132 * 16 * 1.98e9


def cuda_ms(fn, reps: int = 20) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs, by CUDA events."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def device_rows(prof) -> dict:
    """{kernel name: [launches, device ns]} of a finished torch.profiler run,
    read from its raw events: building its ``key_averages`` takes minutes
    of the host for a trace of several 100,000 kernels."""
    from torch.autograd import DeviceType

    rows: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            r = rows.setdefault(e.name(), [0, 0])
            r[0] += 1
            r[1] += e.duration_ns()
    return rows


def device_ms(fn, reps: int = 20) -> float:
    """Mean device time of ``fn``'s kernels per call, from torch.profiler over
    ``reps`` calls: the card's own time, without the host's launch gaps that
    CUDA events around a short kernel also take in. The profiler now and
    then records no device event at all: it is asked again, twice, and
    then CUDA events time ``fn`` instead (a ``[time]`` line says so)."""
    import torch
    from torch.profiler import ProfilerActivity

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ns = sum(ns for _, ns in device_rows(prof).values())
        if ns > 0:
            return ns / 1e6 / reps
    print("[time] torch.profiler recorded no device event in 3 tries: timed by CUDA events instead", flush=True)
    return cuda_ms(fn, reps)


def device_ms_many(fns, reps: int = 20) -> dict:
    """``device_ms`` of each of ``fns`` ({name: fn}) from one torch.profiler
    session (late in a long process a session costs the host ~2 s to
    start and read, more than the timing itself): each function's ``reps``
    calls inside a ``record_function`` range ended by a synchronize, its
    device events read as ``profile_phases`` reads them. A name whose range
    recorded no device event is asked again, twice, and then timed by CUDA
    events (a ``[time]`` line says so)."""
    import torch
    from torch.profiler import ProfilerActivity, record_function

    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    out, todo = {}, dict(fns)
    for _ in range(3):
        with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for name, fn in todo.items():
                with record_function(f"phase:{name}"):
                    for _ in range(reps):
                        fn()
                    torch.cuda.synchronize()
        rows = phase_rows(prof, todo)
        for name in list(todo):
            ns = sum(ns for _, ns in rows[name].values())
            if ns > 0:
                out[name] = ns / 1e6 / reps
                del todo[name]
        if not todo:
            return out
    for name, fn in todo.items():
        print(f"[time] torch.profiler recorded no device event for {name} in 3 tries: timed by CUDA events instead",
              flush=True)
        out[name] = cuda_ms(fn, reps)
    return out


def interleaved(kern, twin):
    """(kernel ms, twin ms): twin, kernel, kernel, twin, so both see the
    same card state; the better of each pair."""
    t1, k1, k2, t2 = cuda_ms(twin), cuda_ms(kern), cuda_ms(kern), cuda_ms(twin)
    return min(k1, k2), min(t1, t2)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: float, n_ops: float, n_sfu: float = 0.0):
    """(bound ms, what bounds it): the largest of bytes over the memory
    rate, float32 operations over the float32 rate and special-function
    operations over the special-function rate ("operations" for both)."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, max(n_ops / PEAK_F32_OPS_PER_S, n_sfu / PEAK_SFU_OPS_PER_S)
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def check(name: str, err: float, limit: float, scale: float) -> None:
    if not np.isfinite(err) or err > limit:
        raise RuntimeError(f"kernel {name} disagrees with its twin: max abs err {err:.3e} > {limit:.3e}")
    print(f"[check] {name}: max abs err {err:.3e} (limit {limit:.3e}, max |twin| {scale:.3e})")


def same_bits(name: str, outs) -> None:
    """Raise unless every tensor of ``outs`` (launches on the same inputs)
    has the same bits as the first."""
    import torch

    torch.cuda.synchronize()
    if not all(torch.equal(outs[0], o) for o in outs[1:]):
        raise RuntimeError(f"kernel {name} gave different bits on the same inputs")
    print(f"[check] {name}: the same bits in {len(outs)} launches")


def scatter_case(name: str, idx, g, rows: int, device, order=None):
    """K4 at one shape (ids ``idx`` [N], g [N, C] into ``rows``): checked
    against its twin and for the same bits in two launches, from the ids and
    on ``order`` (a caller's ordering built once, which may leave out zero
    entries: where a row is longer than a piece that regroups its sum, so
    each is held to the twin on its own); then timed from the ids (its
    ordering included) and on ``order``, the sums alone; beside
    ``index_add_`` and torch's deterministic ``index_put_(accumulate=True)``,
    by CUDA events and by device time. Returns the record's numbers."""
    import torch

    from xrdslam_tpu_torch.ops import scatter as sc

    order = order or sc.scatter_order(idx, rows)
    outs = [sc.scatter_add(idx, g, rows) for _ in range(2)]
    same_bits(name, outs)
    on_order = [sc.scatter_add_ordered(order, g) for _ in range(2)]
    same_bits(f"{name} on a built ordering", on_order)
    acc_t = sc.scatter_add_torch(idx, g, rows)
    scale = float(acc_t.abs().max())
    err = float((outs[0] - acc_t).abs().max())
    check(name, err, BWD_RTOL * scale, scale)
    check(f"{name} on a built ordering", float((on_order[0] - acc_t).abs().max()), BWD_RTOL * scale, scale)
    del outs, on_order, acc_t
    ok = (idx >= 0) & (idx < rows)
    idx_long, g_ok = idx[ok].long(), g[ok].contiguous()
    lib_out = torch.empty((rows, g.shape[1]), device=device)

    def index_add():
        lib_out.zero_()
        lib_out.index_add_(0, idx_long, g_ok)

    def index_put():
        torch.use_deterministic_algorithms(True)
        try:
            lib_out.zero_()
            lib_out.index_put_((idx_long,), g_ok, accumulate=True)
        finally:
            torch.use_deterministic_algorithms(False)

    kern = lambda: sc.scatter_add(idx, g, rows)  # noqa: E731
    sums = lambda: sc.scatter_add_ordered(order, g)  # noqa: E731
    k_ms, t_ms = interleaved(kern, lambda: sc.scatter_add_torch(idx, g, rows))
    sort = lambda: torch.sort(idx, stable=True)  # noqa: E731
    ev = {"sums": min(cuda_ms(sums), cuda_ms(sums)), "order": min(cuda_ms(lambda: sc.scatter_order(idx, rows))
                                                                  for _ in range(2)),
          "sort": min(cuda_ms(sort), cuda_ms(sort)),
          "index_add_": min(cuda_ms(index_add), cuda_ms(index_add)),
          "index_put_": min(cuda_ms(index_put), cuda_ms(index_put))}
    dev = device_ms_many({"kernel": kern, "sums": sums, "sort": sort, "index_add_": index_add,
                          "index_put_": index_put})
    for vname, lib in SCATTER_VARIANTS.items():
        atomic_variant(vname, lib, idx, g, rows, device)
    b_ms, by = bound(nbytes(idx, g) + rows * g.shape[1] * 4, int((g_ok != 0).sum()))
    print(f"[time] {name}: N={idx.shape[0]} x {g.shape[1]} into {rows} rows; kernel {k_ms:.4f} ms "
          f"(device {dev['kernel']:.4f}), the sums alone on a built ordering {ev['sums']:.4f} (device "
          f"{dev['sums']:.4f}), the ordering {ev['order']:.4f} (its torch.sort {ev['sort']:.4f}, device "
          f"{dev['sort']:.4f}); twin {t_ms:.4f}; index_add_ {ev['index_add_']:.4f} "
          f"(device {dev['index_add_']:.4f}); deterministic index_put_ {ev['index_put_']:.4f} (device "
          f"{dev['index_put_']:.4f}); bound {b_ms:.4f} ms ({by})", flush=True)
    if dev["kernel"] > dev["index_put_"]:
        print(f"[note] {name}: K4's device time {dev['kernel']:.4f} ms is above deterministic index_put_'s "
              f"{dev['index_put_']:.4f}")
    return {"max_abs_err": err, "ms": k_ms, "device_ms": dev["kernel"], "sums_ms": ev["sums"],
            "sums_device_ms": dev["sums"], "plain_ms": t_ms, "bound_ms": b_ms, "bound_by": by,
            "library_ms": ev["index_add_"], "index_put_det_ms": ev["index_put_"],
            "index_put_det_device_ms": dev["index_put_"]}


# ``--scatter-variants``: K4's former design, one fp32 atomicAdd per (entry, channel)
# into a table the wrapper zeroes (zero entries skipped), and the same design
# with one float4 atomicAdd per (entry, 4 channels) (sm_90, global memory).
# Built from this source beside the shipped kernel and timed at K4's shapes
# (the price of determinism); not part of the package.
ATOMIC_SCATTER_CU = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__global__ void __launch_bounds__(256)
scatter_add_kernel(const int32_t* __restrict__ idx, const float* __restrict__ g, float* __restrict__ out, int64_t n,
                   int c_dim, int64_t num_rows) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n * c_dim) return;
  const int64_t e = t / c_dim;
  const float val = __ldg(g + t);
  if (val == 0.0f) return;
  const int64_t row = (int64_t)__ldg(idx + e);
  if (row < 0 || row >= num_rows) return;
  atomicAdd(out + row * c_dim + (t - e * c_dim), val);
}
__global__ void __launch_bounds__(256)
scatter_add4_kernel(const int32_t* __restrict__ idx, const float4* __restrict__ g, float4* __restrict__ out,
                    int64_t n, int c4, int64_t num_rows) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n * c4) return;
  const int64_t e = t / c4;
  const float4 val = __ldg(g + t);
  if (val.x == 0.0f && val.y == 0.0f && val.z == 0.0f && val.w == 0.0f) return;
  const int64_t row = (int64_t)__ldg(idx + e);
  if (row < 0 || row >= num_rows) return;
  atomicAdd(out + row * c4 + (t - e * c4), val);
}
extern "C" int xr_scatter_add_atomic(const int32_t* idx, const float* g, float* out, long long n, int c_dim,
                                     long long num_rows, int vec4, void* stream) {
  const int64_t threads = (int64_t)n * (vec4 ? c_dim / 4 : c_dim);
  if (threads == 0) return 0;
  const unsigned int blocks = (unsigned int)((threads + 255) / 256);
  if (vec4)
    scatter_add4_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(idx, (const float4*)g, (float4*)out, n, c_dim / 4,
                                                                  num_rows);
  else
    scatter_add_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(idx, g, out, n, c_dim, num_rows);
  return (int)cudaGetLastError();
}
extern "C" const char* xr_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }
"""
SCATTER_VARIANTS = {}  # name -> the atomic library, set by --scatter-variants


def atomic_variant(name: str, lib, idx, g, rows: int, device) -> None:
    """K4's former atomic design (scalar, or ``float4`` atomics where ``name`` ends
    in 4) at one shape, its zero fill included: error against the twin, ms
    by CUDA events and device time, and whether two launches agree."""
    import torch

    from xrdslam_tpu_torch import kernels
    from xrdslam_tpu_torch.ops import scatter as sc

    vec4 = int(name.endswith("4"))

    def run():
        out = torch.zeros((rows, g.shape[1]), device=device)
        kernels.check(lib, lib.xr_scatter_add_atomic(idx.data_ptr(), g.data_ptr(), out.data_ptr(), idx.shape[0],
                                                     g.shape[1], rows, vec4, kernels.stream(g)), name)
        return out

    a, b = run(), run()
    torch.cuda.synchronize()
    want = sc.scatter_add_torch(idx, g, rows)
    err = float((a - want).abs().max() / want.abs().max())
    print(f"[variant] K4 {name}: {min(cuda_ms(run), cuda_ms(run)):.4f} ms, device {device_ms(run):.4f} ms, "
          f"max err / max |twin| {err:.1e}, two launches {'the same' if torch.equal(a, b) else 'differ'}", flush=True)


VARIANT_PTXAS = {}  # variant name -> its ptxas report


def build_variants(source: str, variants, out_dir) -> dict:
    """``kernels/<source>.cu`` with each variant's (text, replacement) edits,
    or a variant's whole text where it is a string, compiled in parallel
    (one nvcc each) into ``out_dir``; name -> the loaded library."""
    import ctypes

    from xrdslam_tpu_torch import kernels

    src = (kernels.SOURCE_DIR / f"{source}.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in variants.items():
        text = src
        if isinstance(edits, str):
            text = edits
        else:
            for old, new in edits:
                if old not in text:
                    raise RuntimeError(f"variant {name}: {old!r} is not in {source}.cu")
                text = text.replace(old, new)
        (out_dir / f"{name}.cu").write_text(text)
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(out_dir / f"lib{name}.so"), str(out_dir / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    libs = {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{err}")
        VARIANT_PTXAS[name] = err
        lib = libs[name] = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
        lib.xr_cuda_error_string.argtypes, lib.xr_cuda_error_string.restype = [ctypes.c_int], ctypes.c_char_p
    return libs


# ``--scatter-variants`` also rebuilds kernels/hashgrid.cu with one change at
# a time: float2 atomics only (no float4 for an aligned pair of entries),
# scalar atomics (the former dtable: 16 per (point, level)), and dx summed with
# three fp32 atomics per (point, level) into a zeroed dx (the former dx) in
# place of the warp shuffles.
HASHGRID_VARIANTS = {
    "float2_only": [("if (!kPlanes && (e[0] ^ e[1]) == 1u) {", "if (false) {")],
    "pr4_dtable": [("if (!kPlanes && (e[0] ^ e[1]) == 1u) {", "if (false) {"),
                   ("if (!kPlanes) {\n    atomicAdd(reinterpret_cast<float2*>",
                    "if (false) {\n    atomicAdd(reinterpret_cast<float2*>")],
    "dx_atomics": [("for (int off = (1 << log2_lp) >> 1; off > 0; off >>= 1) {",
                    "for (int off = 0; off > 0; off >>= 1) {"),
                   ("  if (l == 0 && p < n) {\n    dx[3 * p + 0] = ddx;\n    dx[3 * p + 1] = ddy;\n"
                    "    dx[3 * p + 2] = ddz;\n  }",
                    "  if (p < n && l < lv.n_levels) {\n    atomicAdd(dx + 3 * p + 0, ddx);\n"
                    "    atomicAdd(dx + 3 * p + 1, ddy);\n    atomicAdd(dx + 3 * p + 2, ddz);\n  }")],
}


def hashgrid_variants(spec, device) -> None:
    """The hash-grid backward as shipped and as each of ``HASHGRID_VARIANTS``
    at N = 176,128 (the mapping shape, random points as ``check_hashgrid``):
    dx alone, dtable alone and both, by CUDA events and device time, with
    the error against the twin. Nothing is gated."""
    import ctypes

    import torch

    from xrdslam_tpu_torch import kernels
    from xrdslam_tpu_torch.ops import hashgrid_fast as hf

    libs = build_variants("hashgrid", HASHGRID_VARIANTS, kernels.BUILD_DIR / "variants")
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.uniform(-0.05, 1.05, (N_MAP, 3)).astype(np.float32), device=device)
    g = torch.as_tensor(rng.standard_normal((N_MAP, spec.out_dim)).astype(np.float32), device=device)
    table = torch.as_tensor(rng.standard_normal((spec.n_levels, spec.table_size, 2)).astype(np.float32), device=device)
    dt_t, dx_t = hf.hashgrid_bwd_torch(table, x, g, spec)
    res, dense = hf.level_args(spec)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name, lib in {"shipped": kernels.load("hashgrid"), **libs}.items():
        lib.xr_hashgrid_bwd.argtypes = [p, p, p, p, p, ll, i, i, p, p, p]
        for case, (nd, nx) in {"dx": (False, True), "dtable": (True, False), "dx+dtable": (True, True)}.items():
            def run():
                dt = torch.zeros_like(table) if nd else None
                dx = torch.zeros((N_MAP, 3), device=device) if nx else None  # zeroed for the atomic variant
                kernels.check(lib, lib.xr_hashgrid_bwd(
                    table.data_ptr(), x.data_ptr(), g.data_ptr(), dx.data_ptr() if nx else None,
                    dt.data_ptr() if nd else None, N_MAP, spec.n_levels, spec.log2_table_size, res, dense,
                    kernels.stream(x)), name)
                return dt, dx

            dt, dx = run()
            torch.cuda.synchronize()
            errs = []
            if nd:
                errs.append(f"dtable {float((dt - dt_t).abs().max() / dt_t.abs().max()):.1e}")
            if nx:
                errs.append(f"dx {float((dx - dx_t).abs().max() / dx_t.abs().max()):.1e}")
            print(f"[variant] hashgrid_bwd {name} [{case}]: {min(cuda_ms(run), cuda_ms(run)):.4f} ms, device "
                  f"{device_ms(run):.4f} ms (zero fills included); max err / max |twin|: {', '.join(errs)}",
                  flush=True)


def scatter_variants(spec, device) -> None:
    """K4 at its six shapes beside its former atomic design (scalar and float4
    atomics), ``index_add_`` and torch's deterministic ``index_put_``; then
    the hash-grid backward's variants. Prints ``[time]``, ``[lever]`` and
    ``[variant]`` lines; nothing but the kernels' checks is gated."""
    import ctypes

    from xrdslam_tpu_torch import kernels

    lib = build_variants("scatter", {"atomic": ATOMIC_SCATTER_CU}, kernels.BUILD_DIR / "variants")["atomic"]
    p, ll = ctypes.c_void_p, ctypes.c_longlong
    lib.xr_scatter_add_atomic.argtypes = [p, p, p, ll, ctypes.c_int, ll, ctypes.c_int, p]
    SCATTER_VARIANTS.update({"atomic": lib, "atomic_float4": lib})
    check_scatter_coslam(spec, device)
    check_raster_at(device, 256, with_scatter=True)
    check_point_table(device)
    SCATTER_VARIANTS.clear()
    hashgrid_variants(spec, device)


# The former hash-grid forward on both layouts, point-major (one thread per
# (point, level), levels fastest), kept as source text: the default run
# holds the shipped forward to its bits and times both in one call;
# --hashgrid-fwd-variants times it beside the variants. Not part of the
# package.
POINT_MAJOR_FWD_CU = r"""
#include <cuda_runtime.h>
#include <stdint.h>
namespace {
constexpr int kMaxLevels = 32;
constexpr int kThreads = 256;
struct Levels {
  int n_levels;
  int log2_t;
  int res[kMaxLevels];
  int dense[kMaxLevels];
};
__device__ __forceinline__ void cell_axis(float x, int res, float* frac, uint32_t* i0) {
  const float p = fminf(fmaxf(x, 0.0f), 1.0f) * (float)res;
  int i = (int)floorf(p);
  i = min(max(i, 0), res - 1);
  *frac = p - (float)i;
  *i0 = (uint32_t)i;
}
__device__ __forceinline__ uint32_t corner_row(uint32_t gx, uint32_t gy, uint32_t gz, uint32_t res,
                                               bool dense, uint32_t mask) {
  if (dense) {
    const uint32_t s = res + 1u;
    return gx + s * (gy + s * gz);
  }
  return ((gx * 1u) ^ (gy * 2654435761u) ^ (gz * 805459861u)) & mask;
}
template <bool kPlanes>
__device__ __forceinline__ float2 load_entry(const float* __restrict__ level, uint32_t e, uint32_t t) {
  if (kPlanes) return make_float2(__ldg(level + e), __ldg(level + t + e));
  return __ldg(reinterpret_cast<const float2*>(level) + e);
}
template <bool kPlanes>
__global__ void __launch_bounds__(kThreads)
hashgrid_fwd_kernel(const float* __restrict__ table, const float* __restrict__ x,
                    float* __restrict__ out, int64_t n, Levels lv) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n * lv.n_levels) return;
  const int64_t p = t / lv.n_levels;
  const int l = (int)(t - p * lv.n_levels);
  const int res = lv.res[l];
  const bool dense = lv.dense[l] != 0;
  const uint32_t mask = (1u << lv.log2_t) - 1u;
  float fx, fy, fz;
  uint32_t ix, iy, iz;
  cell_axis(__ldg(x + 3 * p + 0), res, &fx, &ix);
  cell_axis(__ldg(x + 3 * p + 1), res, &fy, &iy);
  cell_axis(__ldg(x + 3 * p + 2), res, &fz, &iz);
  const uint32_t tsize = 1u << lv.log2_t;
  const float* level = table + ((int64_t)l << (lv.log2_t + 1));
  float a0 = 0.0f, a1 = 0.0f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int cx = c >> 2, cy = (c >> 1) & 1, cz = c & 1;
    const uint32_t e = corner_row(ix + cx, iy + cy, iz + cz, (uint32_t)res, dense, mask);
    const float w = (cx ? fx : 1.0f - fx) * (cy ? fy : 1.0f - fy) * (cz ? fz : 1.0f - fz);
    const float2 f = load_entry<kPlanes>(level, e, tsize);
    a0 += w * f.x;
    a1 += w * f.y;
  }
  reinterpret_cast<float2*>(out)[t] = make_float2(a0, a1);
}
template <bool kPlanes>
int launch_fwd(const float* table, const float* x, float* out, long long n, int n_levels, int log2_t,
               const int* res, const int* dense, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || log2_t < 7 || log2_t > 30) return (int)cudaErrorInvalidValue;
  Levels lv;
  lv.n_levels = n_levels;
  lv.log2_t = log2_t;
  for (int i = 0; i < n_levels; ++i) {
    lv.res[i] = res[i];
    lv.dense[i] = dense[i];
  }
  if (n == 0) return 0;
  const unsigned int blocks = (unsigned int)((n * n_levels + kThreads - 1) / kThreads);
  hashgrid_fwd_kernel<kPlanes><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(table, x, out, n, lv);
  return (int)cudaGetLastError();
}
}  // namespace
extern "C" int xr_hashgrid_fwd(const float* table, const float* x, float* out, long long n, int n_levels,
                               int log2_t, const int* res, const int* dense, void* stream) {
  return launch_fwd<false>(table, x, out, n, n_levels, log2_t, res, dense, stream);
}
extern "C" int xr_hashgrid_planes_fwd(const float* planes, const float* x, float* out, long long n, int n_levels,
                                      int log2_t, const int* res, const int* dense, void* stream) {
  return launch_fwd<true>(planes, x, out, n, n_levels, log2_t, res, dense, stream);
}
extern "C" const char* xr_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }
"""


def bind_fwd(lib):
    import ctypes

    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for fn in (lib.xr_hashgrid_fwd, lib.xr_hashgrid_planes_fwd):
        fn.argtypes = [p, p, p, ll, i, i, p, p, p]
    return lib


@functools.lru_cache(maxsize=None)
def point_major_fwd_lib():
    """The point-major forward (``POINT_MAJOR_FWD_CU``), built and bound once."""
    from xrdslam_tpu_torch import kernels

    return bind_fwd(build_variants("hashgrid", {"pm": POINT_MAJOR_FWD_CU}, kernels.BUILD_DIR / "variants")["pm"])


def fwd_call(lib, planes: bool, tab, x, spec, out):
    """One launch of ``lib``'s forward (the shipped library, the point-major
    one or a variant's) on [L, T, 2] or, with ``planes``, [L, 2, T/128, 128] into
    ``out``; returns ``out``."""
    from xrdslam_tpu_torch import kernels
    from xrdslam_tpu_torch.ops import hashgrid_fast as hf

    res, dense = hf.level_args(spec)
    fn = lib.xr_hashgrid_planes_fwd if planes else lib.xr_hashgrid_fwd
    kernels.check(lib, fn(tab.data_ptr(), x.data_ptr(), out.data_ptr(), x.shape[0], spec.n_levels,
                          spec.log2_table_size, res, dense, kernels.stream(x)), "hash-grid forward")
    return out


def fwd_shapes(x_random, device):
    """The forward's four shapes: ``x_random`` (N_MAP uniform random
    points, some outside the box) and office surface samples
    (``office_surface_points``, ray-major, as the main path orders them),
    each at mapping's N = 176,128 and at tracking's first 44,032 (1,024
    rays of the surface samples)."""
    surface = office_surface_points(device)
    return {"random": x_random, "random@track": x_random[:N_TRACK].contiguous(),
            "surface": surface, "surface@track": surface[:N_TRACK].contiguous()}


def fwd_bound(spec, tab, x, out):
    """The forward's bound: the table, x and out moved once; per (point,
    level) 12 float operations for the cell and 6 per corner (2 for its
    weight, 2 multiply-adds)."""
    return bound(nbytes(tab, x, out), x.shape[0] * spec.n_levels * (12 + 8 * 6))


def check_fwd(planes: bool, tab, shapes, spec):
    """The shipped forward (K1, or K8 with ``planes``) at each of ``shapes``:
    against its twin (FWD_ATOL), the same bits in two launches and as the
    point-major forward; timed by CUDA events beside the twin (twin,
    kernel, kernel, twin) and by device time, the point-major forward the
    same in this call, beside the bound. Returns {shape: its numbers}."""
    import torch

    from xrdslam_tpu_torch.ops import hashgrid_fast as hf
    from xrdslam_tpu_torch.ops import hashgrid_planes as hp

    name = "K8 planes fwd" if planes else "K1 fwd"
    kern = hp.hashgrid_planes_fwd if planes else hf.hashgrid_fwd
    twin = hp.hashgrid_planes_fwd_torch if planes else hf.hashgrid_fwd_torch
    pm = point_major_fwd_lib()
    found = {}
    for shape, x in shapes.items():
        out = [kern(tab, x, spec) for _ in range(2)]
        ref = fwd_call(pm, planes, tab, x, spec, torch.empty_like(out[0]))
        same_bits(f"{name} [{shape}]", out)
        same_bits(f"{name} [{shape}] and the point-major forward", [out[0], ref])
        want = twin(tab, x, spec)
        err = float((out[0] - want).abs().max())
        check(f"{name} [{shape}]", err, FWD_ATOL, float(want.abs().max()))
        run = lambda: kern(tab, x, spec)  # noqa: E731
        run_pm = lambda: fwd_call(pm, planes, tab, x, spec, ref)  # noqa: E731
        k_ms, t_ms = interleaved(run, lambda: twin(tab, x, spec))
        p_ms = min(cuda_ms(run_pm), cuda_ms(run_pm))
        dev, p_dev = device_ms(run), device_ms(run_pm)
        b_ms, by = fwd_bound(spec, tab, x, out[0])
        print(f"[time] {name} [{shape}] N={x.shape[0]}: kernel {k_ms:.4f} ms, device {dev:.4f} ms; the "
              f"point-major forward {p_ms:.4f} ms, device {p_dev:.4f} ms (device time {dev / p_dev:.3f} of it); "
              f"twin {t_ms:.4f} ms")
        print(f"[bound] {name} [{shape}]: {b_ms:.4f} ms ({by})")
        found[shape] = {"n": x.shape[0], "max_abs_err": err, "ms": k_ms, "device_ms": dev, "point_major_ms": p_ms,
                        "point_major_device_ms": p_dev, "plain_ms": t_ms, "bound_ms": b_ms, "bound_by": by}
    return found


def fwd_record(found):
    """A forward's kernels-line numbers: at the random mapping shape, as in
    earlier PRs, with every shape's numbers beside them."""
    r = found["random"]
    return {"max_abs_err": max(f["max_abs_err"] for f in found.values()), "ms": r["ms"], "device_ms": r["device_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
            "point_major_ms": r["point_major_ms"], "point_major_device_ms": r["point_major_device_ms"],
            "shapes": {k: {m: f[m] for m in ("n", "device_ms", "point_major_device_ms", "bound_ms")}
                       for k, f in found.items()}}


FWD_G_LINE = r"constexpr int kFwdLevels = kPlanes \? (\d+) : (\d+);"


def fwd_g_variants(gs):
    """``hashgrid.cu`` rebuilt with G levels a thread on both layouts, for
    each G of ``gs`` (name -> edits), and the shipped (K1's G, K8's G)."""
    import re

    from xrdslam_tpu_torch import kernels

    m = re.search(FWD_G_LINE, (kernels.SOURCE_DIR / "hashgrid.cu").read_text())
    return ({f"G{g}": [(m.group(0), f"constexpr int kFwdLevels = {g};")] for g in gs},
            (int(m.group(2)), int(m.group(1))))


def fwd_by_n(by_n, inputs):
    """K1 at each N of the exact-hash run (``by_n``: N -> the wrapper's
    launch count), on the first inputs the run gave it at that N
    (``inputs``: N -> table, x, spec): the same bits as the point-major
    forward; device time of it, of the point-major forward and of K1 at
    the other G, and each one's time summed over the run's launches, the
    measure G is chosen by. Returns N -> numbers."""
    import torch

    from xrdslam_tpu_torch import kernels
    from xrdslam_tpu_torch.ops import hashgrid_fast as hf

    gs, (k1_g, _) = fwd_g_variants((1, 2, 4))
    gs.pop(f"G{k1_g}")
    g_libs = {g: bind_fwd(lib) for g, lib in build_variants("hashgrid", gs, kernels.BUILD_DIR / "variants").items()}
    pm, found = point_major_fwd_lib(), {}
    total = {f"shipped (G{k1_g})": 0.0, "point-major": 0.0, **{g: 0.0 for g in gs}}
    for n, launches in by_n.items():
        tab, x, spec = inputs[int(n)]
        out = hf.hashgrid_fwd(tab, x, spec)
        ref = fwd_call(pm, False, tab, x, spec, torch.empty_like(out))
        same_bits(f"K1 fwd on the exact run's inputs at N={n} and the point-major forward", [out, ref])
        dev = device_ms(lambda: hf.hashgrid_fwd(tab, x, spec))
        p_dev = device_ms(lambda: fwd_call(pm, False, tab, x, spec, ref))
        g_dev = {g: device_ms(lambda lib=lib: fwd_call(lib, False, tab, x, spec, ref)) for g, lib in g_libs.items()}
        print(f"[time] K1 fwd on the exact run's inputs N={n} ({launches} launches): device {dev:.4f} ms; "
              f"the point-major forward {p_dev:.4f} ms ({dev / p_dev:.3f} of it); "
              + ", ".join(f"{g} {t:.4f} ms" for g, t in g_dev.items()))
        for name, t in ((f"shipped (G{k1_g})", dev), ("point-major", p_dev), *g_dev.items()):
            total[name] += launches * t
        found[n] = {"launches": launches, "device_ms": dev, "point_major_device_ms": p_dev,
                    **{f"{g}_device_ms": t for g, t in g_dev.items()}}
    print("[time] K1 fwd device time summed over the exact run's launches: "
          + ", ".join(f"{name} {t:.3f} ms" for name, t in total.items()))
    return found


# --hashgrid-fwd-variants: the forward rebuilt with one change at a time
FWD_WEIGHT = "const float w = (cx ? fx[j] : 1.0f - fx[j]) * (cy ? fy[j] : 1.0f - fy[j]) * (cz ? fz[j] : 1.0f - fz[j]);"
FWD_LAUNCH = "  hashgrid_fwd_kernel<kPlanes><<<(unsigned int)"
# the pair load of [L, T, 2] on a hashed level not kept in L1 (PTX's
# L1::no_allocate), a dense level's as shipped
FWD_HASHED_NO_L1 = r"""
__device__ __forceinline__ float4 ldg4_level(const float4* p, bool dense) {
  if (dense) return __ldg(p);
  float4 v;
  asm("ld.global.nc.L1::no_allocate.v4.f32 {%0,%1,%2,%3}, [%4];"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(p));
  return v;
}
template <bool kPlanes>
__device__ __forceinline__ void load_pair("""
FWD_VARIANTS = {
    # e0 and e1 each from a load of its own
    "no_pairs": [("float2* f0, float2* f1) {\n",
                  "float2* f0, float2* f1) {\n  *f0 = load_entry<kPlanes>(level, e0, t);\n"
                  "  *f1 = load_entry<kPlanes>(level, e1, t);\n  return;\n")],
    # each output written straight to out, 8 bytes at a time
    "no_staging": [("reinterpret_cast<float2*>(os + q * row)[l] = make_float2(a0, a1);",
                    "reinterpret_cast<float2*>(out)[(p0 + q) * nl + l] = make_float2(a0, a1);"),
                   ("  __syncthreads();\n  // the block's [np, 2L] outputs",
                    "  return;\n  // the block's [np, 2L] outputs")],
    # the index arithmetic and the loads; no weights, the entries only added
    "loads_only": [(FWD_WEIGHT, "const float w = 1.0f;")],
    # 4x the points per block (more of a ray's samples in one block's L1)
    "points_x4": [("  const int chunks = groups >= kThreads / 32 ? 1 : (kThreads / 32) / groups;",
                   "  const int chunks = 4 * (groups >= kThreads / 32 ? 1 : (kThreads / 32) / groups);")],
    # the largest L1 the carveout allows (the least shared memory)
    "max_l1": [(FWD_LAUNCH, "  cudaFuncSetAttribute(hashgrid_fwd_kernel<kPlanes>, "
                            "cudaFuncAttributePreferredSharedMemoryCarveout, 0);\n" + FWD_LAUNCH)],
    "hashed_no_l1": [("template <bool kPlanes>\n__device__ __forceinline__ void load_pair(", FWD_HASHED_NO_L1),
                     ("float2* f0, float2* f1) {", "float2* f0, float2* f1, bool dense) {"),
                     ("tsize, &f[j][k], &f[j][k + 4]);", "tsize, &f[j][k], &f[j][k + 4], dense);"),
                     ("__ldg(reinterpret_cast<const float4*>(level) + (e0 >> 1))",
                      "ldg4_level(reinterpret_cast<const float4*>(level) + (e0 >> 1), dense)")],
}


def print_ptxas(name: str, report: str, what: str) -> None:
    """The ptxas lines of ``report`` for the entry functions whose names hold ``what``."""
    entry = ""
    for ln in report.splitlines():
        if "Compiling entry function" in ln:
            entry = ln.split("'")[1] if "'" in ln else ln
        elif what in entry and ("registers" in ln or "spill" in ln):
            print(f"[ptxas] {name} {entry}: {ln.strip()}")


def fwd_sectors(spec, x):
    """The 32-byte table sectors K1's corner loads ask for on x [N, 3], from
    the port's ``grid_corners``: (requests: the distinct sectors of each
    shipped load instruction, 32 consecutive points at one level, the
    x-pair's pair load and, where e0 ^ e1 != 1, e1's own; then the distinct
    sectors of each block of 32 and of 128 points over all levels, what
    the SMs fetch where L1 keeps a sector for the block's life)."""
    import torch

    from xrdslam_tpu_torch.ops.encodings import grid_corners

    rows, _ = grid_corners(torch.clamp(x, 0.0, 1.0), spec)  # [N, L, 8], corner c = 4 cx + 2 cy + cz
    base = torch.arange(spec.n_levels, device=x.device)[None, :, None] * spec.table_size
    sec = (rows + base) >> 2
    n = x.shape[0] // 128 * 128

    def distinct(a, per):  # distinct non-negative values in each run of ``per`` entries
        a = a.reshape(-1, per).sort(dim=1).values
        return int(((a[:, 1:] != a[:, :-1]) & (a[:, 1:] >= 0)).sum() + (a[:, 0] >= 0).sum())

    e0, e1 = rows[:n, :, :4], rows[:n, :, 4:]
    s1 = torch.where((e0 ^ e1) == 1, -1, sec[:n, :, 4:])
    warp = lambda a: a.reshape(n // 32, 32, -1).transpose(1, 2)  # noqa: E731  (instruction, lane)
    requests = distinct(warp(sec[:n, :, :4]), 32) + distinct(warp(s1), 32)
    return requests, distinct(sec[:n], 32 * rows.shape[1] * 8), distinct(sec[:n], 128 * rows.shape[1] * 8)


def hashgrid_fwd_variants(spec, device) -> None:
    """K1 and K8 as shipped, as the point-major forward and as each variant
    (G = 1, 2, 4, 16 levels a thread; ``FWD_VARIANTS``) at the four shapes of
    ``fwd_shapes``: by CUDA events (the better of two rounds, the variants
    in one order then the other) and device time, with the error against
    the twin and whether the bits are the point-major forward's.
    Nothing is gated but the builds and launches."""
    import torch

    from xrdslam_tpu_torch import kernels
    from xrdslam_tpu_torch.ops import hashgrid_fast as hf
    from xrdslam_tpu_torch.ops import hashgrid_planes as hp

    gs, (k1_g, k8_g) = fwd_g_variants((1, 2, 4, 16))
    shipped = f"shipped (K1 G{k1_g}, K8 G{k8_g})"
    variants = {"point-major": POINT_MAJOR_FWD_CU, **gs, **FWD_VARIANTS}
    built = build_variants("hashgrid", variants, kernels.BUILD_DIR / "variants")
    for name in variants:
        print_ptxas(name, VARIANT_PTXAS[name], "fwd")
    libs = {"point-major": built.pop("point-major"), shipped: kernels.load("hashgrid"), **built}
    for lib in libs.values():
        bind_fwd(lib)
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.uniform(-0.05, 1.05, (N_MAP, 3)).astype(np.float32), device=device)
    table = torch.as_tensor(rng.standard_normal((spec.n_levels, spec.table_size, 2)).astype(np.float32), device=device)
    for kernel, planes, tab in (("K1", False, table), ("K8", True, hp.pack_table(table))):
        twin = hp.hashgrid_planes_fwd_torch if planes else hf.hashgrid_fwd_torch
        for shape, xs in fwd_shapes(x, device).items():
            want = twin(tab, xs, spec)
            outs = {name: fwd_call(lib, planes, tab, xs, spec, torch.empty_like(want)) for name, lib in libs.items()}
            runs = {name: (lambda lib=lib, out=outs[name]: fwd_call(lib, planes, tab, xs, spec, out))
                    for name, lib in libs.items()}
            ev = {name: [] for name in libs}
            for order in (list(libs), list(libs)[::-1]):
                for name in order:
                    ev[name].append(cuda_ms(runs[name]))
            dev = {name: device_ms(run) for name, run in runs.items()}
            b_ms, by = fwd_bound(spec, tab, xs, want)
            if not planes:
                req, blk32, blk128 = fwd_sectors(spec, xs)
                t = dev[shipped]
                print(f"[sectors] K1 [{shape}] N={xs.shape[0]}: {req / 1e6:.3f} M sector requests by the shipped "
                      f"loads; distinct per block of 32 points {blk32 / 1e6:.3f} M, of 128 {blk128 / 1e6:.3f} M: "
                      f"{32 * blk32 / t / 1e9:.2f} TB/s of 32-byte sectors at its device time {t:.4f} ms")
            for name in libs:
                err = float((outs[name] - want).abs().max())
                same = torch.equal(outs[name], outs["point-major"])
                print(f"[variant] {kernel} [{shape}] N={xs.shape[0]} {name}: {min(ev[name]):.4f} ms, device "
                      f"{dev[name]:.4f} ms ({dev[name] / dev['point-major']:.3f} of the point-major's), max abs err "
                      f"{err:.1e}, {'the point-major bits' if same else 'other bits'}; bound {b_ms:.4f} ms ({by})",
                      flush=True)


def steady_stats(frame_times):
    """Steady per-frame seconds as the reference benchmark computes them:
    drop the first 15 frames, then frames slower than 4x the median."""
    t = np.asarray(frame_times[15:])
    med = np.median(t)
    keep = t[t < 4 * med]
    return float(np.mean(keep)), int(len(t) - len(keep))


def _counted_modules():
    from xrdslam_tpu_torch.ops import gaussian_raster, hashgrid_fast, hashgrid_planes, row_gather, scatter

    return hashgrid_fast, hashgrid_planes, gaussian_raster, scatter, row_gather


def reset_all_launches() -> None:
    for mod in _counted_modules():
        mod.reset_launches()


def all_launches():
    return {k: v for mod in _counted_modules() for k, v in mod.LAUNCHES.items()}


# ---------------------------------------------------------------------------
# kernels against their twins
# ---------------------------------------------------------------------------

def check_hashgrid(spec, device):
    """K1-K3 vs twin at the mapping shapes, K1 also at ``fwd_shapes``';
    returns the per-kernel records."""
    import torch

    from xrdslam_tpu_torch.ops import hashgrid_fast as hf

    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.uniform(-0.05, 1.05, (N_MAP, 3)).astype(np.float32), device=device)
    g = torch.as_tensor(rng.standard_normal((N_MAP, spec.out_dim)).astype(np.float32), device=device)
    table = torch.as_tensor(rng.standard_normal((spec.n_levels, spec.table_size, 2)).astype(np.float32), device=device)

    fwd = check_fwd(False, table, fwd_shapes(x, device), spec)
    dt_k, dx_k = hf.hashgrid_bwd(table, x, g, spec, True, True)
    torch.cuda.synchronize()
    dt_t, dx_t = hf.hashgrid_bwd_torch(table, x, g, spec, True, True)
    err = {"dx": float((dx_k - dx_t).abs().max()), "dtable": float((dt_k - dt_t).abs().max())}
    scale = {"dx": float(dx_t.abs().max()), "dtable": float(dt_t.abs().max())}
    limit = {"dx": BWD_RTOL * scale["dx"], "dtable": BWD_RTOL * scale["dtable"]}
    for k in err:
        check(k, err[k], limit[k], scale[k])
    err["dx+dtable"] = max(err["dx"], err["dtable"])
    # dx is summed without atomics: the same bits on every launch
    same_bits("hashgrid_bwd[dx]", [dx_k, hf.hashgrid_bwd(table, x, g, spec, False, True)[1],
                                   hf.hashgrid_bwd(table, x, g, spec, True, True)[1]])

    xt, gt = x[:N_TRACK].contiguous(), g[:N_TRACK].contiguous()
    times = {
        "dx": (lambda: hf.hashgrid_bwd(table, x, g, spec, False, True),
               lambda: hf.hashgrid_bwd_torch(table, x, g, spec, False, True)),
        "dtable": (lambda: hf.hashgrid_bwd(table, x, g, spec, True, False),
                   lambda: hf.hashgrid_bwd_torch(table, x, g, spec, True, False)),
        "dx+dtable": (lambda: hf.hashgrid_bwd(table, x, g, spec, True, True),
                      lambda: hf.hashgrid_bwd_torch(table, x, g, spec, True, True)),
        "dx@track": (lambda: hf.hashgrid_bwd(table, xt, gt, spec, False, True),
                     lambda: hf.hashgrid_bwd_torch(table, xt, gt, spec, False, True)),
    }
    ms, dev = {}, {}
    for k, (kern, twin) in times.items():
        ms[k] = interleaved(kern, twin)
        dev[k] = device_ms(kern)
        n = N_TRACK if k.endswith("@track") else N_MAP
        print(f"[time] {k:10s} N={n}: kernel {ms[k][0]:.4f} ms, device {dev[k]:.4f} ms, twin {ms[k][1]:.4f} ms")
    # Bounds at N points x L levels. Bytes: each input read once, each output
    # written once. Operations per (point, level), float only: 3 x 4 for the
    # cell position and fraction; per corner 2 products for its weight, and
    # 2 multiply-adds (4 operations) for the dtable terms or for g.f and
    # the 3 derivative terms (about 10) of dx.
    pl = N_MAP * spec.n_levels
    dx_out = torch.empty((N_MAP, 3), device=device)
    bounds = {
        "dx": bound(nbytes(table, x, g, dx_out), pl * (12 + 8 * 12)),
        "dtable": bound(nbytes(x, g, dt_k), pl * (12 + 8 * 6)),
        "dx+dtable": bound(nbytes(table, x, g, dx_out, dt_k), pl * (12 + 8 * 16)),
    }
    for k, (b_ms, by) in bounds.items():
        print(f"[bound] {k}: {b_ms:.4f} ms ({by})")
    src = "xrdslam_tpu_torch/kernels/hashgrid.cu"
    ref = "xrdslam_tpu/ops/hashgrid_fast.py"
    rows = (("hashgrid_bwd[dx]", "dx", f"{ref}:216", "hashgrid_bwd_dx"),
            ("hashgrid_bwd[dtable]", "dtable", f"{ref}:95", "hashgrid_bwd_dtable"),
            # mapping's call: K2 and K3 in one backward
            ("hashgrid_bwd[dx+dtable]", "dx+dtable", f"{ref}:216 and :95", "hashgrid_bwd_dx_dtable"))
    # no single PyTorch call computes a hash-grid encoding or its gradients
    return [{"name": "hashgrid_fwd", "route": "cuda", "source": src, "replaces": f"{ref}:202",
             "counter": "hashgrid_fwd", **fwd_record(fwd)}] + [
        {"name": name, "route": "cuda", "source": src, "replaces": rep, "counter": counter,
         "max_abs_err": err[k], "ms": ms[k][0], "device_ms": dev[k], "plain_ms": ms[k][1],
         "bound_ms": bounds[k][0], "bound_by": bounds[k][1], "library_ms": None}
        for name, k, rep, counter in rows]


def check_hashgrid_planes(spec, device):
    """K8/K9 vs twin at the mapping shape, on the plane layout of a random
    office-spec table, K8 also at ``fwd_shapes``'; returns the per-kernel
    records (0 launches: no path calls them)."""
    import torch

    from xrdslam_tpu_torch.ops import hashgrid_planes as hp

    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.uniform(-0.05, 1.05, (N_MAP, 3)).astype(np.float32), device=device)
    g = torch.as_tensor(rng.standard_normal((N_MAP, spec.out_dim)).astype(np.float32), device=device)
    table = torch.as_tensor(rng.standard_normal((spec.n_levels, spec.table_size, 2)).astype(np.float32), device=device)
    planes = hp.pack_table(table)

    fwd = check_fwd(True, planes, fwd_shapes(x, device), spec)
    dp_k, dx_k = hp.hashgrid_planes_bwd(planes, x, g, spec)
    torch.cuda.synchronize()
    dp_t, dx_t = hp.hashgrid_planes_bwd_torch(planes, x, g, spec)
    err = {"dx": float((dx_k - dx_t).abs().max()), "dplanes": float((dp_k - dp_t).abs().max())}
    scale = {"dx": float(dx_t.abs().max()), "dplanes": float(dp_t.abs().max())}
    for k in err:
        check(f"planes {k}", err[k], BWD_RTOL * scale[k], scale[k])
    del dp_t, dx_t
    kern = lambda: hp.hashgrid_planes_bwd(planes, x, g, spec)  # noqa: E731
    k_ms, t_ms = interleaved(kern, lambda: hp.hashgrid_planes_bwd_torch(planes, x, g, spec))
    dev = device_ms(kern)
    print(f"[time] planes bwd N={N_MAP}: kernel {k_ms:.4f} ms, device {dev:.4f} ms, twin {t_ms:.4f} ms")
    # Bounds as for K2/K3; K9's operations per corner are K2's and K3's
    # together (the weight once): 2 + 4 + 10.
    b_ms, by = bound(nbytes(planes, x, g, dx_k, dp_k), N_MAP * spec.n_levels * (12 + 8 * 16))
    print(f"[bound] planes bwd: {b_ms:.4f} ms ({by})")
    src, ref = "xrdslam_tpu_torch/kernels/hashgrid.cu", "xrdslam_tpu/ops/pallas_hashgrid.py"
    # no single PyTorch call computes a hash-grid encoding or its gradients
    return [{"name": "hashgrid_planes_fwd", "route": "cuda", "source": src,
             "replaces": f"{ref}:103 (_fwd_kernel; nothing in the repository calls it)", "counter": None,
             **fwd_record(fwd)},
            {"name": "hashgrid_planes_bwd", "route": "cuda", "source": src,
             "replaces": f"{ref}:123 (_bwd_kernel; nothing in the repository calls it)", "counter": None,
             "max_abs_err": max(err.values()), "ms": k_ms, "device_ms": dev, "plain_ms": t_ms, "bound_ms": b_ms,
             "bound_by": by, "library_ms": None}]


@functools.lru_cache(maxsize=None)
def office_surface_points(device, n_rays: int = 4096):
    """Co-SLAM's mapping samples on office frame 0 at 600x340 at its pose,
    normalised to the scene's bounds as the model encodes them: 4,096 random
    pixels x 43 depth-guided samples (32 uniform, 11 within 10 cm of the
    surface), ray-major, [N_MAP, 3]; made once per device."""
    import torch

    from xrdslam_tpu_torch.common.synthetic import SyntheticDataset
    from xrdslam_tpu_torch.configs.registry import algorithm_configs
    from xrdslam_tpu_torch.ops.sampling import camera_ray_dirs, coslam_z_vals

    ds = SyntheticDataset(f"n_frames=1,height={HEIGHT},width={WIDTH},scene=office", device=str(device))
    _, _, depth, pose = ds[0]
    c = algorithm_configs["co-slam"].xrdslam.algorithm.model
    gen = torch.Generator(device=device).manual_seed(0)
    u = torch.randint(0, WIDTH, (n_rays,), generator=gen, device=device)
    v = torch.randint(0, HEIGHT, (n_rays,), generator=gen, device=device)
    c2w = torch.as_tensor(np.asarray(pose, np.float32), device=device)
    rays_d = camera_ray_dirs(ds.get_camera(), device)[v, u] @ c2w[:3, :3].T
    d = torch.as_tensor(depth, device=device)[v, u][:, None]
    z = coslam_z_vals(d, n_rays, c.cam_near, c.cam_far, c.training_n_sample_d, c.training_range_d,
                      c.training_n_range_d, False)
    pts = c2w[:3, 3] + rays_d[:, None, :] * z[..., None]
    b = torch.as_tensor(ds.bounds, dtype=torch.float32, device=device)
    return ((pts - b[:, 0]) / (b[:, 1] - b[:, 0])).reshape(-1, 3).contiguous()


def check_scatter_coslam(spec, device):
    """K4 at the shapes Co-SLAM's encodings give it (mapping: N = 176,128
    points): the packed hash's finest level (rows of 16 into T = 65,536) and
    the tri-plane's finer scale (rows of 4 x 8 moments into 512^2 cells),
    rows from the cells of uniform random points (shapes that the main
    paths no longer launch: no launches in the record); and the main paths'
    launches on office surface samples (``office_surface_points``): the
    packed hash's over its 16 levels stacked and the tri-plane's over its 6
    planes stacked. Times each main-path launch against one launch per
    level or plane; returns the records."""
    import torch

    from xrdslam_tpu_torch.ops import hashgrid_packed, triplane
    from xrdslam_tpu_torch.ops import scatter as sc

    rng = np.random.default_rng(2)
    x = torch.as_tensor(rng.uniform(0.0, 1.0, (N_MAP, 3)).astype(np.float32), device=device)
    u0, _ = triplane._cells(x, 512)
    surface = office_surface_points(device)
    n = surface.shape[0]
    rid, _ = hashgrid_packed._cells(surface, spec)
    level_rows = [t.shape[0] for t in hashgrid_packed.pack_gather_tables(hashgrid_packed.packed_init(spec), spec)]
    stacked, offsets = hashgrid_packed.stacked_rows(rid, level_rows)
    planes = []  # the tri-plane's 6 planes stacked row-wise, as triplane._splat stacks them
    for R in (128, 512):
        cells, _ = triplane._cells(surface, R)
        planes += [((cells[:, a] * R + cells[:, b]), R) for a, b in triplane.PLANES]
    first = np.cumsum([0] + [R * R for _, R in planes])
    all_ids = torch.cat([r + int(f) for (r, _), f in zip(planes, first)]).to(torch.int32)
    # name -> (ids, width, rows, whose launches the record carries)
    cases = {
        "scatter_add[packed hash]": (hashgrid_packed._cells(x, spec)[0][:, -1].to(torch.int32), 16, spec.table_size,
                                     None),
        "scatter_add[triplane]": ((u0[:, 0] * 512 + u0[:, 1]).to(torch.int32), 32, 512 * 512, None),
        "scatter_add[packed hash, office surface]": (stacked, 16, offsets[-1], "scatter_add[co-slam@packed]"),
        "scatter_add[triplane, office surface]": (all_ids, 32, int(first[-1]), "scatter_add[co-slam@protocol]"),
    }
    records, g_of = [], {}
    for name, (idx, width, rows, counter) in cases.items():
        g = g_of[name] = torch.as_tensor(rng.standard_normal((idx.shape[0], width)).astype(np.float32), device=device)
        rec = scatter_case(name, idx.contiguous(), g, rows, device)
        records.append({"name": name, "route": "cuda", "source": "xrdslam_tpu_torch/kernels/scatter.cu",
                        "replaces": "xrdslam_tpu/ops/pallas_scatter.py:38", "counter": counter, **rec})
    # The levers: the main paths' one launch over the packed hash's 16
    # levels and over the tri-plane's 6 planes, against one launch per level
    # or plane, on the surface samples (orderings included)
    g, gm = g_of["scatter_add[packed hash, office surface]"], g_of["scatter_add[triplane, office surface]"]
    levers = {
        f"packed hash, office surface: one launch over {spec.n_levels} levels":
            ((stacked, g, offsets[-1]),
             [(rid[:, l].to(torch.int32).contiguous(), g.reshape(n, -1, 16)[:, l].contiguous(),
               offsets[l + 1] - offsets[l]) for l in range(spec.n_levels)]),
        "tri-plane, office surface: one launch over 6 planes":
            ((all_ids, gm, int(first[-1])),
             [(r.to(torch.int32).contiguous(), gm[k * n:(k + 1) * n], R * R) for k, (r, R) in enumerate(planes)]),
    }
    for what, (one, per) in levers.items():
        t_one = min(cuda_ms(lambda: sc.scatter_add(*one)) for _ in range(2))
        t_per = min(cuda_ms(lambda: [sc.scatter_add(*a) for a in per]) for _ in range(2))
        print(f"[lever] {what} {t_one:.4f} ms, one per level or plane {t_per:.4f} ms (device "
              f"{device_ms(lambda: sc.scatter_add(*one)):.4f} and "
              f"{device_ms(lambda: [sc.scatter_add(*a) for a in per]):.4f})")
    return records


def check_scatter_niceslam(device):
    """K4 at NICE-SLAM's three shapes no other path gives it, on the corner
    ids of a mapping iteration's samples of office frame 0 at its pose (the
    protocol's configuration, 600x340): the fine window's 6 slots x 200
    pixels x (32 + 16) samples x 8 corners into the middle grid (21 x 14 x
    17 rows of 32: about 92 ids a row, some rows long) and into the fine
    grid (42 x 28 x 34 rows; the colour grid has its shape), and the coarse
    window's 5 x 200 x 32 x 8 into the coarse grid (6 x 4 x 5 rows: about
    2,100 ids a row, K4's long-row path), with a seeded random upstream
    gradient. Returns the records; their launches are the main path's by
    table."""
    import torch

    from xrdslam_tpu_torch.common.frame import Frame
    from xrdslam_tpu_torch.common.synthetic import SyntheticDataset
    from xrdslam_tpu_torch.ops.sampling import sample_pixels
    from xrdslam_tpu_torch.ops.trilinear import grid_corners, normalize_3d_coordinate

    ds = SyntheticDataset(f"n_frames=1,height={HEIGHT},width={WIDTH},scene=office", device=str(device))
    _, rgb, depth, pose = ds[0]
    cfg = niceslam_protocol_config(ds.bounds.tolist()).xrdslam.algorithm
    algo = cfg.setup(camera=ds.get_camera(), device=device)
    m = algo.model
    fr = Frame(fid=0, rgb=rgb, depth=depth, init_pose=pose, rot_rep="quat")
    c2w = torch.as_tensor(fr.get_pose(), device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    records = []
    for grid, coarse in (("middle", False), ("fine", False), ("coarse", True)):
        n_slots = cfg.mapping_window_size + (0 if coarse else 1)
        n_rays = n_slots * max(cfg.mapping_sample // n_slots, cfg.min_sample_pixels)
        u, v = sample_pixels(n_rays, HEIGHT, WIDTH, generator=gen, device=device)
        rays_d = algo._dirs[v, u] @ c2w[:3, :3].T
        rays_o = c2w[:3, 3].expand(rays_d.shape)
        z = m._z_vals(rays_o, rays_d, fr.depth_dev(device)[v, u][:, None], not coarse)
        pts = (rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]).reshape(-1, 3)
        shape = m.grid_shapes[f"grid_{grid}"]
        ids, _ = grid_corners(shape, normalize_3d_coordinate(pts, m.bound_coarse if coarse else m.bound))
        ids = ids.reshape(-1).contiguous()
        rows = int(np.prod(shape))
        g = torch.randn((ids.shape[0], cfg.model.model_c_dim), generator=gen, device=device)
        name = f"scatter_add[nice-slam {grid} grid]"
        print(f"[nice-slam] {name}: {n_rays} rays x {z.shape[1]} samples x 8 corners = {ids.shape[0]} ids into "
              f"{shape} = {rows} rows; {int(torch.unique(ids).numel())} distinct, the most on one row "
              f"{int(torch.bincount(ids.long()).max())}")
        rec = scatter_case(name, ids, g, rows, device)
        records.append({"name": name, "route": "cuda", "source": "xrdslam_tpu_torch/kernels/scatter.cu",
                        "replaces": "xrdslam_tpu/ops/pallas_scatter.py:38", "counter": name, **rec})
    return records


def relative_first_pose(cfg):
    """Frame 0's pose in a relative-pose run (``cfg`` its pipeline's
    config): the identity, shifted by ``init_pose_offset``."""
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] += cfg.tracker.init_pose_offset
    return pose


def check_scatter_voxfusion(device):
    """K4 at Vox-Fusion's shape, on the ids and upstream gradient of a real
    mapping iteration: the last of the first mapping call on office frame 0
    at 600x340 (the registry's model, the frame at the run's first pose):
    5 window slots x 1,024 pixels x 20 segments x 8 corners = 819,200 ids
    into the 20,000 rows of 16 of the embedding table. A segment that hits
    no voxel points at voxel 0 with a zero gradient, so voxel 0's 8 rows are
    K4's long rows. Returns the record; its launches are the main path's."""
    import torch

    from xrdslam_tpu_torch.common.frame import Frame
    from xrdslam_tpu_torch.common.synthetic import SyntheticDataset
    from xrdslam_tpu_torch.configs.registry import algorithm_configs
    from xrdslam_tpu_torch.ops import scatter as sc

    cfg = copy.deepcopy(algorithm_configs["vox-fusion"].xrdslam)
    ds = SyntheticDataset(f"n_frames=1,height={HEIGHT},width={WIDTH},scene=office", device=str(device))
    _, rgb, depth, _ = ds[0]
    algo = cfg.algorithm.setup(camera=ds.get_camera(), device=device)
    last, shipped = [], sc.scatter_add

    def keep_last(idx, g, rows):
        last[:] = [idx.detach().clone(), g.detach().clone(), rows]
        return shipped(idx, g, rows)

    sc.scatter_add = keep_last
    try:
        algo.do_mapping(Frame(fid=0, rgb=rgb, depth=depth, init_pose=relative_first_pose(cfg)))
    finally:
        sc.scatter_add = shipped
    idx, g, rows = last
    per_row = torch.bincount(idx.long(), minlength=rows)
    vox0 = per_row[algo.maps["vox_vertex_idx"][0].long()].tolist()
    name = "scatter_add[vox-fusion]"
    print(f"[vox-fusion] {name}: {idx.shape[0]} ids x {g.shape[1]} into {rows} rows ({int(algo.maps['n_voxels'])} "
          f"voxels, {int(algo.maps['n_vertices'])} vertices after frame 0); {int((per_row > 0).sum())} rows hit, "
          f"voxel 0's 8 rows {vox0}; {float((g != 0).any(1).float().mean()):.4f} of the entries nonzero")
    rec = scatter_case(name, idx, g, rows, device)
    return [{"name": name, "route": "cuda", "source": "xrdslam_tpu_torch/kernels/scatter.cu",
             "replaces": "xrdslam_tpu/ops/pallas_scatter.py:38", "counter": name, **rec}]


def grown_office_frame(device, model_overrides=None):
    """The gaussians SplaTAM grows from office frame 0 at 600x340, binned at
    that frame's pose, as its main path bins them, with the registry's
    model settings and ``model_overrides``: (algo, params, dead, w2c, tiles,
    mask, count, the frame's depth)."""
    import torch

    from xrdslam_tpu_torch.common.frame import Frame
    from xrdslam_tpu_torch.common.synthetic import SyntheticDataset
    from xrdslam_tpu_torch.configs.registry import algorithm_configs

    ds = SyntheticDataset(f"n_frames=1,height={HEIGHT},width={WIDTH},scene=office", device=str(device))
    _, rgb, depth, pose = ds[0]
    cfg = copy.deepcopy(algorithm_configs["splaTAM"].xrdslam.algorithm)
    for name, value in (model_overrides or {}).items():
        setattr(cfg.model, name, value)
    algo = cfg.setup(camera=ds.get_camera(), device=device)
    fr = Frame(fid=0, rgb=rgb, depth=depth, init_pose=pose, rot_rep="quat")
    c2w = torch.as_tensor(fr.get_pose(), device=device)
    params, dead, count = algo.grow_step(algo.params, algo.dead, 0, fr.rgb_dev(device), fr.depth_dev(device), c2w,
                                         True)
    w2c = torch.linalg.inv(c2w)
    tiles, mask = algo.binning(params, dead, count, w2c)
    return algo, params, dead, w2c, tiles, mask, count, depth


def coverage(sil, depth):
    """How much of a frame a map covers: the mean silhouette over the pixels
    with depth, and the shares below growth's 0.5 and above tracking's
    0.99."""
    s = sil[:HEIGHT, :WIDTH].cpu().numpy()[depth > 0]
    return {"mean_sil": float(s.mean()), "below_0.5": float(np.mean(s < 0.5)), "above_0.99": float(np.mean(s > 0.99))}


def check_raster(device):
    """K5, K6 (at the registry's K = 256 and the gate's 512) and K4 vs
    twins on a grown office frame; returns the records."""
    import torch

    records = check_raster_at(device, 256, with_scatter=True)
    torch.cuda.empty_cache()
    return records + check_raster_at(device, SPLATAM_GATE["algorithm.model.k_per_tile"], with_scatter=False)


def raster_inputs(device, k_per_tile: int):
    """K5/K6's inputs on the main path's data: the gaussians grown from
    office frame 0, binned with ``k_per_tile`` slots, packed; and a seeded
    random upstream gradient. (tiled, gout, tile ids, tile mask, table
    rows, the frame's depth)."""
    import torch

    from xrdslam_tpu_torch.ops import gaussian_raster as gr

    algo, params, dead, w2c, tiles, mask, count, frame_depth = grown_office_frame(
        device, {"k_per_tile": k_per_tile})
    ntx, nty = algo.ntx, algo.nty
    G = algo.config.model.max_gaussians
    print(f"[raster] grown {count} gaussians; {tiles.shape[0]} tiles ({ntx} x {nty}), K = {tiles.shape[1]}, "
          f"{int(mask.sum())} of {mask.numel()} slots used")
    u, v, depth, sigma = algo.model.project(params, w2c)
    opacity = torch.sigmoid(params["logit_opacities"][:, 0]) * algo.model.alive_mask(dead, count)
    ch = torch.cat([params["rgb_colors"], depth[:, None], torch.ones_like(depth[:, None]), (depth * depth)[:, None],
                    torch.zeros((G, 2), device=device)], -1)
    tiled = gr._pack_tile_data(u, v, sigma, opacity, ch, tiles, mask)
    gen = torch.Generator(device=device).manual_seed(0)
    gout = torch.randn((nty * 16, ntx * 16, gr.N_CH), generator=gen, device=device)
    return tiled, gout, tiles, mask, G, frame_depth


def check_raster_at(device, k_per_tile: int, with_scatter: bool):
    """K5 and K6 (and K4, ``with_scatter``) against their twins on the
    gaussians grown from office frame 0 and binned with ``k_per_tile``
    slots; times each (K5 and K6 also by device time) and returns the
    records, named with a ``[k<K>]`` suffix away from the registry's K."""
    import torch

    from xrdslam_tpu_torch.ops import gaussian_raster as gr

    tiled, gout, tiles, mask, G, frame_depth = raster_inputs(device, k_per_tile)
    ntx, nty = gout.shape[1] // 16, gout.shape[0] // 16
    k = tiles.shape[1]
    tag = "" if k == 256 else f"[k{k}]"
    out_k = gr.raster_fwd(tiled, ntx, nty)
    # the fresh map as these slots render it (see SPLATAM_GATE)
    print(f"[coverage] grown frame at K = {k}: {json.dumps(coverage(out_k[..., 4], frame_depth))}")
    dg_k = gr.raster_bwd(tiled, gout, out_k, ntx, nty)
    torch.cuda.synchronize()
    out_t = gr.raster_fwd_torch(tiled, ntx, nty)
    dg_t = gr.raster_bwd_torch(tiled, gout, out_t, ntx, nty)
    err = {"raster_fwd": float((out_k - out_t).abs().max()), "raster_bwd": float((dg_k - dg_t).abs().max())}
    scale = {"raster_fwd": float(out_t.abs().max()), "raster_bwd": float(dg_t.abs().max())}
    limit = {"raster_fwd": FWD_ATOL, "raster_bwd": BWD_RTOL * scale["raster_bwd"]}
    for name in err:
        check(name + tag, err[name], limit[name], scale[name])
    if with_scatter:
        # K4's input on the main path: K6's output; the main path sums it on
        # its binning's ordering (masked slots left out), built once
        k4 = scatter_case("scatter_add", tiles.reshape(-1).contiguous(), dg_t.reshape(-1, gr.ROW).contiguous(), G,
                          device, order=gr.Binning(tiles, mask).order(G))
    del out_t, dg_t

    ms = {
        "raster_fwd": interleaved(lambda: gr.raster_fwd(tiled, ntx, nty), lambda: gr.raster_fwd_torch(tiled, ntx, nty)),
        "raster_bwd": interleaved(lambda: gr.raster_bwd(tiled, gout, out_k, ntx, nty),
                                  lambda: gr.raster_bwd_torch(tiled, gout, out_k, ntx, nty)),
    }
    dev_ms = {"raster_fwd": device_ms(lambda: gr.raster_fwd(tiled, ntx, nty)),
              "raster_bwd": device_ms(lambda: gr.raster_bwd(tiled, gout, out_k, ntx, nty))}
    for name, (k_ms, t_ms) in ms.items():
        dev = f", device {dev_ms[name]:.4f} ms" if name in dev_ms else ""
        print(f"[time] {name + tag:12s}: kernel {k_ms:.4f} ms{dev}, twin {t_ms:.4f} ms")
    # Bounds: the work of one walk over the live (pixel, slot) pairs, 256
    # pixels per live slot; masked slots need no work. Float32 operations
    # per pair: forward 28 (offset 2, r^2 3, scale 1, exp 1, opacity 1,
    # clamp 2, exp of the running log 1, weight 1, 8 channel multiply-adds
    # 16, log1p 1, running sum 1 - the clamp counted once); backward 60 (the
    # forward's 12 before the channels, g.c 16, contribution and prefix 3,
    # dalpha 4, the common term 2, 4 + 8 products, and 12 sums over pixels).
    # Special-function operations per pair: two exp and a log1p, and in the
    # backward a division. Bytes: every input read once and every output
    # written once.
    pairs = 256 * int(mask.sum())
    bounds = {
        "raster_fwd": bound(nbytes(tiled, out_k), 28 * pairs, 3 * pairs),
        "raster_bwd": bound(nbytes(tiled, gout, out_k, dg_k), 60 * pairs, 4 * pairs),
    }
    for name, (b_ms, by) in bounds.items():
        print(f"[bound] {name + tag}: {b_ms:.4f} ms ({by}; {pairs} live (pixel, slot) pairs)")
    src, ref = "xrdslam_tpu_torch/kernels/gaussian_raster.cu", "xrdslam_tpu/ops/gaussian_raster.py"
    records = [{"name": name + tag, "route": "cuda", "source": src, "replaces": f"{ref}:{line}", "counter": name + tag,
                "max_abs_err": err[name], "ms": ms[name][0], "device_ms": dev_ms[name], "plain_ms": ms[name][1],
                "bound_ms": bounds[name][0], "bound_by": bounds[name][1], "library_ms": None}
               for name, line in (("raster_fwd", 239), ("raster_bwd", 265))]
    if with_scatter:
        records.append({"name": "scatter_add" + tag, "route": "cuda", "source": "xrdslam_tpu_torch/kernels/scatter.cu",
                        "replaces": "xrdslam_tpu/ops/pallas_scatter.py:38", "counter": "scatter_add" + tag, **k4})
    return records


def check_point_table(device):
    """K7 (both widths) and K4 at Point-SLAM's mapping shapes vs their twins;
    returns the records."""
    import torch

    from xrdslam_tpu_torch.common.frame import Frame
    from xrdslam_tpu_torch.common.synthetic import SyntheticDataset
    from xrdslam_tpu_torch.configs.registry import algorithm_configs
    from xrdslam_tpu_torch.ops import row_gather as rg
    from xrdslam_tpu_torch.ops.point_table import hash_probe, knn_query

    ds = SyntheticDataset(f"n_frames=1,height={HEIGHT},width={WIDTH},scene=office", device=str(device))
    _, rgb, depth, pose = ds[0]
    cfg = copy.deepcopy(algorithm_configs["point-slam"].xrdslam.algorithm)
    algo = cfg.setup(camera=ds.get_camera(), device=device)
    fr = Frame(fid=0, rgb=rgb, depth=depth, init_pose=pose, rot_rep="quat")
    t0 = time.perf_counter()
    algo.add_points_from_frame(fr, cfg.pixels_adding)
    torch.cuda.synchronize()
    pm = algo.point_map
    print(f"[pointmap] office frame 0: {pm.n_points} points from {cfg.pixels_adding} pixels in "
          f"{time.perf_counter() - t0:.3f} s (insertion and upload), {int((pm.cell_count > 0).sum())} rows, "
          f"fullest {int(pm.cell_count.max())} of {pm.per_cell}, overflowed {pm.overflowed}")
    t0 = time.perf_counter()
    algo.maps = pm.device_state(device)
    torch.cuda.synchronize()
    up_s = time.perf_counter() - t0
    up_b = pm.cell_data.nbytes + pm.cell_keys.nbytes
    print(f"[pointmap] the whole map uploaded (device_state): {up_b / 2**20:.1f} MiB in {1e3 * up_s:.3f} ms "
          f"({up_b / up_s / 1e9:.2f} GB/s, host clock)")
    # a mapping iteration's queries: the surface samples of 12 window slots x
    # 416 pixels, on this frame at its pose (as render_rays places them)
    n_slots = cfg.mapping_window_size
    n_rays = n_slots * max(cfg.mapping_sample // n_slots, cfg.min_sample_pixels)
    gen = torch.Generator(device=device).manual_seed(0)
    u = torch.randint(0, WIDTH, (n_rays,), generator=gen, device=device)
    v = torch.randint(0, HEIGHT, (n_rays,), generator=gen, device=device)
    c2w = torch.as_tensor(fr.get_pose(), device=device)
    rays_d = algo._dirs[v, u] @ c2w[:3, :3].T
    d = fr.depth_dev(device)[v, u][:, None]
    m = cfg.model
    t = torch.linspace(0.0, 1.0, m.rendering_n_surface, device=device)
    z = m.rendering_near_end_surface * d * (1 - t) + m.rendering_far_end_surface * d * t
    far = torch.minimum(5.0 * d.mean(), (d * 1.2).max())
    z = torch.where(d > 0, z, torch.linspace(0.1, 1.0, m.rendering_n_surface, device=device) * far)
    pts = (c2w[:3, 3] + rays_d[:, None, :] * z[..., None]).reshape(-1, 3)
    n = pts.shape[0]
    idx, found = hash_probe(algo.maps, pts)
    table = algo.maps["cell_data"]
    table128 = table[:, :128].contiguous()
    print(f"[pointmap] {n} queries: {int(found.sum())} found a row, {int(torch.unique(idx).numel())} distinct rows")

    got = {"row_gather": rg.row_gather_rows(table, idx), "row_gather[C=128]": rg.row_gather_rows(table128, idx)}
    torch.cuda.synchronize()
    want = {"row_gather": rg.row_gather_torch(table, idx), "row_gather[C=128]": rg.row_gather_torch(table128, idx)}
    err = {}
    for name in got:
        same = torch.equal(got[name].view(torch.int32), want[name].view(torch.int32))
        if not same:
            raise RuntimeError(f"kernel {name} disagrees with its twin: the gathered rows differ in their bits")
        err[name] = float((got[name] - want[name]).abs().max())  # 0 when the bits agree (no NaN in the rows)
        print(f"[check] {name}: [{n}, {got[name].shape[1]}] equal to the twin bit for bit")

    # K4 at table_lookup's shape: the neighbour ids of these queries, a
    # seeded upstream gradient, into the 262,144-row feature table
    _, nb, _ = knn_query(algo.maps, pts, k=m.pointcloud_nn_num)
    nb = nb.reshape(-1).contiguous()
    g = torch.randn((nb.shape[0], m.c_dim), generator=gen, device=device)
    R = m.max_points
    print(f"[pointmap] table_lookup: {nb.shape[0]} rows of {m.c_dim} into {R}; {int(torch.unique(nb).numel())} "
          f"distinct, the most on one row {int(torch.bincount(nb.long()).max())}")
    k4 = scatter_case("scatter_add[table_lookup]", nb, g, R, device)

    idx_long = idx.long()
    kern = {"row_gather": lambda: rg.row_gather_rows(table, idx),
            "row_gather[C=128]": lambda: rg.row_gather_rows(table128, idx)}
    ms = {"row_gather": interleaved(kern["row_gather"], lambda: rg.row_gather_torch(table, idx)),
          "row_gather[C=128]": interleaved(kern["row_gather[C=128]"], lambda: rg.row_gather_torch(table128, idx))}
    lib_fn = {"row_gather": lambda: torch.index_select(table, 0, idx_long),
              "row_gather[C=128]": lambda: torch.index_select(table128, 0, idx_long)}
    lib = {name: min(cuda_ms(fn) for _ in range(2)) for name, fn in lib_fn.items()}
    dev = {name: (device_ms(kern[name]), device_ms(lib_fn[name])) for name in kern}
    for name, (k_ms, t_ms) in ms.items():
        print(f"[time] {name}: kernel {k_ms:.4f} ms (device {dev[name][0]:.4f}), twin {t_ms:.4f} ms, index_select "
              f"{lib[name]:.4f} ms (device {dev[name][1]:.4f})")
    # Bounds: each distinct row read once, each output row written once, the
    # ids read; no arithmetic.
    distinct = int(torch.unique(idx).numel())
    bounds = {
        "row_gather": bound(distinct * table.shape[1] * 4 + nbytes(got["row_gather"], idx), 0),
        "row_gather[C=128]": bound(distinct * 128 * 4 + nbytes(got["row_gather[C=128]"], idx), 0),
    }
    for name, (b_ms, by) in bounds.items():
        print(f"[bound] {name}: {b_ms:.4f} ms ({by})")
    rows = (("row_gather", "xrdslam_tpu/ops/row_gather.py:47", "row_gather"),
            # no path gathers at width 128: the main path launches K7 at 1024 only
            ("row_gather[C=128]", "xrdslam_tpu/ops/row_gather.py:29", None))
    records = [{"name": name, "route": "cuda", "source": "xrdslam_tpu_torch/kernels/row_gather.cu", "replaces": rep,
                "counter": counter, "max_abs_err": err[name], "ms": ms[name][0], "device_ms": dev[name][0],
                "plain_ms": ms[name][1], "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
                "library_ms": lib[name]}
               for name, rep, counter in rows]
    # an insertion's upload: office frame 1's surface points at
    # pixels_adding of its pixels added to the host map, then the rows they
    # changed written into the device map in place (PointMap.upload)
    _, _, depth1, pose1 = SyntheticDataset(f"n_frames=2,height={HEIGHT},width={WIDTH},scene=office",
                                           device=str(device))[1]
    vs, us = np.nonzero(depth1 > 0)
    pick = np.random.default_rng(1).choice(len(vs), min(cfg.pixels_adding, len(vs)), replace=False)
    v1, u1 = vs[pick], us[pick]
    added = pm.add_points(pose1[:3, 3] + (algo._dirs_np[v1, u1] @ pose1[:3, :3].T) * depth1[v1, u1][:, None])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = pm.upload(algo.maps)
    torch.cuda.synchronize()
    up_s = time.perf_counter() - t0
    if added == 0 or rows == 0:
        raise RuntimeError(f"[pointmap] office frame 1: {added} points added, {rows} rows uploaded")
    up_b = rows * (pm.cell_data.shape[1] * 4 + 12)
    print(f"[pointmap] an insertion's upload (office frame 1, {added} points): {rows} rows, "
          f"{up_b / 2**20:.2f} MiB in {1e3 * up_s:.3f} ms ({up_b / up_s / 1e9:.2f} GB/s, host clock)")
    return records + [{"name": "scatter_add[table_lookup]", "route": "cuda",
                       "source": "xrdslam_tpu_torch/kernels/scatter.cu",
                       "replaces": "xrdslam_tpu/ops/pallas_scatter.py:38", "counter": "scatter_add[point-slam]", **k4}]


def pointslam_schedule(cfg, n_frames: int, group_heads=()) -> dict:
    """K7 and K4 launches of a Point-SLAM run as the pipeline schedules it:
    per frame, every frame but the first tracked, the frames up to
    ``lazy_start``, every ``map_every``-th after it and the last mapped
    (the first with ``mapping_first_n_iters``); each group at
    ``group_heads`` tracks its ``map_every`` frames and maps its head. One
    gather per ``query_raw`` (each mapping and tracking iteration); one
    table gradient per geometry iteration, two per colour iteration, none
    in tracking."""
    a, t = cfg.xrdslam.algorithm, cfg.xrdslam.tracker
    G = t.map_every
    in_group = {h + j for h in group_heads for j in range(G)}
    tracked = [i for i in range(n_frames) if i > 0 and i not in in_group] + sorted(in_group)
    maps = [a.mapping_first_n_iters if i == 0 else a.mapping_n_iters for i in range(n_frames)
            if i not in in_group and (i <= t.lazy_start or i % G == 0 or i == n_frames - 1)]
    maps += [a.mapping_n_iters] * len(group_heads)
    geo = [int(a.mapping_geo_iter_ratio * it) for it in maps]
    return {"row_gather": sum(maps) + a.tracking_n_iters * len(tracked),
            "scatter_add": sum(g + 2 * (it - g) for g, it in zip(geo, maps))}


def splatam_schedule(algo_cfg, n_frames: int) -> dict:
    """K5, K6 and K4 launches of a SplaTAM run that maps every frame and
    tracks every frame after the first: one K6 and one K4 (the raster's
    backward) per tracking and mapping iteration; one K5 per iteration and
    per growth render (each mapped frame after the first)."""
    a = algo_cfg
    bwd = a.mapping_first_n_iters + (n_frames - 1) * (a.tracking_n_iters + a.mapping_n_iters)
    return {"raster_fwd": bwd + n_frames - 1, "raster_bwd": bwd, "scatter_add": bwd}


def check_splatam_run(pipeline, res: dict, groups: bool) -> None:
    """A SplaTAM run's K5/K6/K4 launches against ``splatam_schedule`` and its
    path: through groups (``through_groups``) or, per frame, none."""
    want = splatam_schedule(pipeline.algorithm.config, res["frames"])
    print(f"[launches] {res['run']}: {json.dumps(res['launches'])}; schedule {json.dumps(want)}")
    if res["launches"] != want:
        raise RuntimeError(f"{res['run']}: launches {res['launches']} differ from the schedule {want}")
    if groups:
        through_groups(res)
    elif res["groups"]["groups"]:
        raise RuntimeError(f"{res['run']}: {res['groups']['groups']} groups on the per-frame path")


def order_choice(pipeline) -> None:
    """``[order]``: the device time of a mapping call's K4 orderings, built
    as the port builds them (one per window frame, up front, each
    iteration's selected by its pick) against one built each iteration
    from the picked frame's tiles, on the run's last window and picks."""
    import torch

    from xrdslam_tpu_torch.ops.gaussian_raster import Binning, WindowBinning
    from xrdslam_tpu_torch.ops import lie

    algo = pipeline.algorithm
    _, _, inputs = group_inputs(pipeline)
    rgb, depth, win_slots, n_valid, picks = inputs[:5]
    w2c = lie.pose_inverse(torch.as_tensor(np.asarray(algo.estimate_c2w_list[-1], np.float32), device=algo.device))
    _, w2cs = algo.window(rgb, depth, w2c, win_slots, n_valid)
    tiles, masks = algo.bin_window(algo.params, algo.dead, algo.count_dev, w2cs)
    G = algo.config.model.max_gaussians

    def up_front():
        window = WindowBinning(tiles, masks, G)
        for i in range(picks.shape[0]):
            window.pick(picks[i:i + 1])

    def per_iteration():
        for i in range(picks.shape[0]):
            fi = picks[i:i + 1]
            Binning(torch.index_select(tiles, 0, fi)[0], torch.index_select(masks, 0, fi)[0]).order(G)

    a, b = device_ms(up_front, reps=3), device_ms(per_iteration, reps=3)
    print(f"[order] a mapping call's K4 orderings, device ms: up front ({tiles.shape[0]} window frames, "
          f"{picks.shape[0]} picks) {a:.4f}; per iteration ({picks.shape[0]} orderings) {b:.4f}")


def densify_check(pipeline) -> None:
    """``[densify]``: from the run's final state, its last group program
    with densification and the same program without, each eagerly from the
    same saved state: clones and splits must grow the count inside the
    mapping program, the table must stay finite. The state is put back
    after."""
    import torch

    from xrdslam_tpu_torch.models.gaussian_splatting import GAUSS_GROUPS

    algo = pipeline.algorithm
    key, program, inputs = group_inputs(pipeline)
    saved = algo.save_state()
    counts = {}
    for densify in (True, False):
        algo.load_state(saved)
        _, _, count = algo.fused_step(*inputs, do_kf=key[0], densify=densify)
        counts[densify] = int(count)
        if not all(bool(torch.isfinite(algo.params[g][:counts[densify]]).all()) for g in GAUSS_GROUPS):
            raise RuntimeError(f"splaTAM@densify: non-finite gaussians (densify={densify})")
    algo.load_state(saved)
    print(f"[densify] one group step from the run's final state ({int(saved[0][-1])} gaussians): "
          f"{counts[True]} with densification, {counts[False]} without")
    if counts[True] <= counts[False]:
        raise RuntimeError(f"splaTAM@densify: densification added no gaussians ({counts})")


def coslam_scatter_schedule(cfg, n_frames: int, encoding: str) -> int:
    """K4 launches of a Co-SLAM run whose frames are mapped every
    ``map_every`` and on the last frame: the packed hash scatters its tables'
    gradient (all levels in one launch) for each encode that a mapping
    backward differentiates (the rays'; after the first mapping also the
    smoothness grid's); the tri-plane its planes' moments (all planes and
    scales in one launch) for the rays' encode (its smoothness is a TV on the
    planes). Tracking's tables are constants: none."""
    a, t = cfg.xrdslam.algorithm, cfg.xrdslam.tracker
    n_later = sum(1 for i in range(1, n_frames) if i % t.map_every == 0 or i == n_frames - 1)
    first, later = a.mapping_first_n_iters, a.mapping_n_iters * n_later
    return first + later if encoding == "triplane" else first + 2 * later


def niceslam_protocol_config(bounds):
    """NICE-SLAM as ``bench_accuracy.py::build_from_registry`` configures it:
    the registry's entry (its model, its 1,500 first-mapping iterations)
    with the scene's bounds for mapping and meshing, 64 keyframes, and, for
    a sequence that covers the reference's 2,000-frame tour in 60 or 200
    frames, its tracking scaled up: 50 iterations of 1,024 rays at lr 3e-3,
    edges of 50 pixels, mapping every 2nd frame, a keyframe every 10th, the
    tracking lr decayed to 0.05 of itself."""
    from xrdslam_tpu_torch.configs.registry import algorithm_configs

    cfg = copy.deepcopy(algorithm_configs["nice-slam"])
    a = cfg.xrdslam.algorithm
    a.seed = 0
    a.mapping_bound = a.marching_cubes_bound = bounds
    a.max_keyframes = 64
    a.tracking_n_iters, a.tracking_sample = 50, 1024
    a.optimizers["tracking_pose"]["optimizer"].lr = 3e-3
    a.tracking_Wedge = a.tracking_Hedge = 50
    cfg.xrdslam.tracker.map_every = 2
    cfg.xrdslam.mapper.keyframe_every = 10
    a.tracking_lr_decay = 0.05
    return cfg


def niceslam_schedule(cfg, n_frames: int, grid_shapes) -> dict:
    """K4 launches of a NICE-SLAM run (``cfg`` its pipeline's config; no
    lazy start) with grids of ``grid_shapes``, in all and by the
    rows of the table summed into: each mapped frame (the first, every
    ``map_every``-th, the last) runs a fine call (the last frame, with
    colour refinement, 5 of them) and a coarse call. A fine call's middle
    iterations take the middle grid's gradient, its fine iterations the
    middle and fine grids', its colour iterations the middle, fine and
    colour grids'; a coarse iteration the coarse grid's. Tracking takes
    none."""
    a, t = cfg.algorithm, cfg.tracker
    if t.lazy_start >= 0:
        raise ValueError("the schedule assumes no lazy start")
    rows = {name: int(np.prod(shape)) for name, shape in grid_shapes.items()}
    by_rows: dict = {}

    def add(grid, n):
        by_rows[rows[grid]] = by_rows.get(rows[grid], 0) + n

    for i in range(n_frames):
        if not (i == 0 or i % t.map_every == 0 or i == n_frames - 1):
            continue
        n = a.mapping_first_n_iters if i == 0 else a.mapping_n_iters
        refine = i == n_frames - 1 and a.mapping_color_refine and i > 0
        m_end, f_end = int(a.mapping_middle_iter_ratio * n), int(a.mapping_fine_iter_ratio * n)
        calls = 5 if refine else 1
        add("grid_middle", calls * n)
        add("grid_fine", calls * (n - m_end))
        add("grid_color", calls * (n - f_end))
        if a.coarse:
            add("grid_coarse", n)
    return {"scatter_add": sum(by_rows.values()), "by_rows": {str(k): v for k, v in sorted(by_rows.items())}}


def check_niceslam_run(pipeline, res: dict, groups: bool) -> None:
    """A NICE-SLAM run's K4 launches against ``niceslam_schedule`` and its
    path: through the groups it must take (every group after its key's
    first replayed, all four keys captured) or, per frame, none."""
    want = niceslam_schedule(pipeline.config, res["frames"], pipeline.algorithm.model.grid_shapes)
    got = {"scatter_add": res["launches"]["scatter_add"], "by_rows": res["scatter_add_by_rows"]}
    print(f"[launches] {res['run']}: {json.dumps(got)}; schedule {json.dumps(want)}")
    if got != want:
        raise RuntimeError(f"{res['run']}: K4 launches {got} differ from the schedule {want}")
    g = res["groups"]
    if groups:
        through_groups(res)
        heads = list(range(4, res["frames"] - 2, 2))
        if g["group_heads"] != heads or len(g["captures"]) != 4:
            raise RuntimeError(f"{res['run']}: groups at {g['group_heads']} (want {heads}), "
                               f"{len(g['captures'])} keys captured (want 4)")
    elif g["groups"]:
        raise RuntimeError(f"{res['run']}: {g['groups']} groups on the per-frame path")


def check_outputs(pipeline, name: str) -> None:
    """``render_img`` at the last frame's estimate (with its depth) and
    ``get_mesh``: finite, a mesh with faces."""
    algo, ds = pipeline.algorithm, pipeline.dataset
    n = len(ds)
    _, gt_rgb, gt_depth, _ = ds[n - 1]
    t0 = time.perf_counter()
    color, depth = algo.render_img(np.asarray(algo.estimate_c2w_list[-1]), gt_depth=gt_depth, idx=n - 1)
    t_render = time.perf_counter() - t0
    t0 = time.perf_counter()
    mesh = algo.get_mesh()
    t_mesh = time.perf_counter() - t0
    from xrdslam_tpu_torch.common import metrics as M

    mask = gt_depth > 0
    rep = {"render_s": t_render, "psnr": M.psnr(color, gt_rgb, mask),
           "depth_l1_cm": M.depth_l1(depth, gt_depth, mask) * 100.0, "mesh_s": t_mesh,
           "vertices": 0 if mesh is None else len(mesh.vertices), "faces": 0 if mesh is None else len(mesh.faces)}
    print(f"[outputs] {name}: {json.dumps(rep)}")
    if not (np.isfinite(color).all() and np.isfinite(depth).all()) or color.shape != (HEIGHT, WIDTH, 3):
        raise RuntimeError(f"{name}: render_img gave non-finite values or shape {color.shape}")
    if mesh is None or not len(mesh.faces) or not np.isfinite(mesh.vertices).all():
        raise RuntimeError(f"{name}: get_mesh gave no surface or non-finite vertices")


def voxfusion_schedule(cfg, n_frames: int) -> int:
    """K4 launches of a Vox-Fusion run (``cfg`` its pipeline's config):
    every frame is mapped (``map_every`` 1), each mapping iteration takes
    the embeddings' gradient in one launch (the first call
    ``mapping_first_n_iters`` of them); tracking takes none."""
    a, t = cfg.algorithm, cfg.tracker
    if t.map_every != 1:
        raise ValueError("the schedule assumes that every frame is mapped")
    return a.mapping_first_n_iters + a.mapping_n_iters * (n_frames - 1)


def check_voxfusion_run(pipeline, res: dict, groups: bool) -> None:
    """A Vox-Fusion run's K4 launches against ``voxfusion_schedule``, its
    path (through groups: frames 2 to the last but one, both keys
    captured; per frame: none) and its voxel map (``[voxels]``: the voxels
    and vertices allocated, whether either table is full)."""
    want = voxfusion_schedule(pipeline.config, res["frames"])
    print(f"[launches] {res['run']}: {json.dumps(res['launches'])}; schedule scatter_add {want}")
    if res["launches"]["scatter_add"] != want:
        raise RuntimeError(f"{res['run']}: scatter_add launches {res['launches']['scatter_add']} != {want}")
    g = res["groups"]
    if groups:
        through_groups(res)
        heads, keys = list(range(2, res["frames"] - 1)), sorted(g["captures"])
        if g["group_heads"] != heads or keys != ["(True, False)", "(True, True)"]:
            raise RuntimeError(f"{res['run']}: groups at {g['group_heads']} (want {heads}), keys {keys}")
    elif g["groups"]:
        raise RuntimeError(f"{res['run']}: {g['groups']} groups on the per-frame path")
    algo = pipeline.algorithm
    m = algo.config.model
    nv, ne = int(algo.maps["n_voxels"]), int(algo.maps["n_vertices"])
    rep = {"voxels": nv, "max_voxels": m.max_voxels, "vertices": ne, "max_vertices": m.num_embeddings,
           "voxels_full": nv >= m.max_voxels, "vertices_full": ne >= m.num_embeddings}
    print(f"[voxels] {res['run']}: {json.dumps(rep)}")


def check_voxel_insertion(pipeline) -> None:
    """``[insert]``: frame 0's depth at the run's first pose, inserted on
    the device into an empty map (calls of the run's 1,024 new voxels at
    most, until one adds none), against the host ``VoxelHashMap`` on the
    same points: the same set of voxel coordinates and the same vertex
    count."""
    import torch

    from xrdslam_tpu_torch.algorithms.voxfusion import MAX_NEW_VOXELS
    from xrdslam_tpu_torch.ops import voxel_hash as vh

    algo = pipeline.algorithm
    m = algo.config.model
    c2w = torch.as_tensor(relative_first_pose(pipeline.config), device=algo.device)
    depth = torch.as_tensor(pipeline.dataset[0][2], device=algo.device)
    pts = (algo._dirs * depth[..., None]).reshape(-1, 3) @ c2w[:3, :3].T + c2w[:3, 3]
    valid = (depth > 0).reshape(-1)
    maps = vh.empty_device_maps(m.max_voxels, m.num_embeddings, device=algo.device)
    t0 = time.perf_counter()
    calls, before = 0, -1
    while int(maps["n_voxels"]) != before:
        before = int(maps["n_voxels"])
        vh.insert_points_device(maps, pts, valid, voxel_size=m.voxel_size, max_voxels=m.max_voxels,
                                max_vertices=m.num_embeddings, max_new=MAX_NEW_VOXELS)
        calls += 1
    t_dev = time.perf_counter() - t0
    host = vh.VoxelHashMap(m.max_voxels, m.num_embeddings, m.voxel_size)
    t0 = time.perf_counter()
    host.insert_points(pts[valid].cpu().numpy())
    t_host = time.perf_counter() - t0
    nv = int(maps["n_voxels"])
    dev_set = set(map(tuple, maps["vox_coords"][:nv].cpu().numpy().tolist()))
    host_set = set(map(tuple, host.vox_coords[:host.n_voxels].tolist()))
    rep = {"device_voxels": nv, "host_voxels": host.n_voxels, "device_vertices": int(maps["n_vertices"]),
           "host_vertices": host.n_vertices, "same_voxel_set": dev_set == host_set, "device_calls": calls,
           "device_s": t_dev, "host_s": t_host}
    print(f"[insert] vox-fusion frame 0: {json.dumps(rep)}")
    if dev_set != host_set or rep["device_vertices"] != host.n_vertices:
        raise RuntimeError(f"vox-fusion: the device insertion of frame 0 differs from the host allocator's: {rep}")


# ---------------------------------------------------------------------------
# the main paths
# ---------------------------------------------------------------------------

def run_slam(algorithm: str, data: str, counters=(), overrides=None, ate_limit_cm=None, tag: str = "", config=None,
             frozen_share: float = None, correct_scale: bool = False, sweep: bool = False):
    """One algorithm through the port's runner on synthetic ``data`` with
    the registry's settings and ``overrides`` ({dotted config path under
    ``xrdslam``: value}); returns (pipeline, results). The launch counts
    are zeroed just before the run and read just after; each of
    ``counters`` must have moved. The pipeline's post-run sweep
    (``eval_2d.json``, the final meshes) runs only with ``sweep``, every
    ``PROTOCOL_RENDER_FREQ`` frames; its seconds are ``sweep_s`` and the
    render generator's state before it ``pipeline.sweep_rng``. Poses must be finite; where
    ``ate_limit_cm`` is given, the ATE must be at most that and at most
    ``frozen_share`` (by default ``FROZEN_ATE_SHARE``) of the ATE of a
    camera frozen at frame 0. ``config`` replaces the registry's entry.
    ``correct_scale`` aligns the trajectory in sim(3), as monocular VO has
    no scale (the frozen camera's ATE stays in SE(3): a constant trajectory
    has no scale to align)."""
    import torch

    from xrdslam_tpu_torch.configs.registry import algorithm_configs
    from xrdslam_tpu_torch.ops import hashgrid_fast as hf
    from xrdslam_tpu_torch.ops import scatter as sc
    from xrdslam_tpu_torch.utils.eval_ate import evaluate_ate

    name = algorithm + tag
    cfg = copy.deepcopy(config or algorithm_configs[algorithm])
    cfg.data, cfg.data_type = data, "synthetic"
    cfg.out_dir = os.path.join(ROOT, "build", f"chip_smoke_{name}")
    cfg.xrdslam.device = "cuda"
    cfg.xrdslam.tracker.save_re_render_result = sweep
    cfg.xrdslam.tracker.render_freq = PROTOCOL_RENDER_FREQ
    for path, value in (overrides or {}).items():
        *parents, leaf = path.split(".")
        node = cfg.xrdslam
        for p in parents:
            node = getattr(node, p)
        setattr(node, leaf, value)
    t_setup = time.time()
    runner = cfg.setup()
    pipeline = runner.setup()
    n_frames = len(pipeline.dataset)
    sweep_s = []
    if sweep:
        shipped_sweep = pipeline.save_re_render_frames

        def timed_sweep():
            generator = getattr(pipeline.algorithm, "generator", None)
            pipeline.sweep_rng = None if generator is None else generator.get_state()
            t = time.perf_counter()
            shipped_sweep()
            torch.cuda.synchronize()
            sweep_s.append(time.perf_counter() - t)

        pipeline.save_re_render_frames = timed_sweep
    t0 = time.time()
    pipeline.dataset.prerender()
    torch.cuda.synchronize()
    reused = pipeline.dataset.n_shared
    print(f"[slam] {name}: {n_frames} frames ({data}): rendered {n_frames - reused}, took {reused} as an earlier run "
          f"rendered them, in {time.time() - t0:.3f} s (set-up {t0 - t_setup:.3f} s)")
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    t0 = time.time()
    pipeline.run()
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {k: v for k, v in all_launches().items() if k in counters}
    by_n = {str(n): c for n, c in sorted(hf.FWD_LAUNCHES_BY_N.items())}
    by_rows = {str(n): c for n, c in sorted(sc.LAUNCHES_BY_ROWS.items())}
    algo = pipeline.algorithm
    est = algo.estimate_c2w_list
    if len(est) != n_frames or algo._nonfinite_poses or not all(np.isfinite(p).all() for p in est):
        raise RuntimeError(f"{name}: non-finite or missing poses ({algo._nonfinite_poses} non-finite of {len(est)})")
    ate_cm = evaluate_ate(algo.gt_c2w_list, est, correct_scale=correct_scale)["rmse"] * 100.0
    frozen_cm = evaluate_ate(algo.gt_c2w_list, [algo.gt_c2w_list[0]] * n_frames)["rmse"] * 100.0
    res = {"run": name, "data": data, "overrides": overrides or {}, "frames": n_frames, "wall_s": wall,
           "ate_rmse_cm": ate_cm, "ate_sim3": correct_scale, "frozen_ate_cm": frozen_cm,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30, "sweep_s": sweep_s[0] if sweep_s else None,
           "launches": launches, "keyframes": len(algo.keyframe_fids),
           # translation error of each frame before alignment (cm)
           "frame_err_cm": [round(float(np.linalg.norm(e[:3, 3] - g[:3, 3])) * 100, 3)
                            for e, g in zip(est, algo.gt_c2w_list)]}
    if "hashgrid_fwd" in counters:  # K1's launches split by N, read with the others
        res["hashgrid_fwd_by_n"] = by_n
    if "scatter_add" in counters:  # K4's launches split by the rows summed into
        res["scatter_add_by_rows"] = by_rows
    if n_frames > 15:
        res["steady_s_per_frame"], res["spikes_dropped"] = steady_stats(pipeline.frame_times)
    else:  # too few frames for the steady rule: the mean after the first (its first mapping)
        res["s_per_frame_after_first"] = float(np.mean(pipeline.frame_times[1:]))
    if algorithm == "splaTAM":
        res["gaussians"] = algo.n_gauss
        res["gaussians_alive"] = int(algo.model.alive_mask(algo.dead, algo.n_gauss).sum())
    if algorithm == "dpvo":
        res.update(updates=algo.n_updates, probes=algo.n_probes, frames_kept=algo.n, edges_end=len(algo.ii),
                   updates_by_bucket={str(k): v for k, v in sorted(algo.buckets.items())},
                   weights=algo.model.loaded_from)
    if algorithm == "point-slam":
        res["n_points"] = algo.point_map.n_points
        res["overflowed"] = algo.point_map.overflowed
    with open(os.path.join(cfg.out_dir, "timings.json")) as f:
        res["phases"] = json.load(f)
    if hasattr(algo, "graphs"):
        res["groups"] = groups_report(pipeline, name)
    print(f"[slam] {json.dumps(res)}")
    if ate_limit_cm is not None:
        share = FROZEN_ATE_SHARE if frozen_share is None else frozen_share
        limit = min(ate_limit_cm, share * frozen_cm)
        print(f"[gate] {name}: {'sim(3) ' if correct_scale else ''}ATE {ate_cm:.4f} cm against {limit:.4f} cm (the "
              f"smaller of {ate_limit_cm} cm and {share} x {frozen_cm:.4f} cm, the ATE of a camera frozen at frame 0)")
        if not ate_cm <= limit:  # a NaN fails too (a sim(3) alignment of a constant trajectory)
            raise RuntimeError(f"{name}: ATE {ate_cm:.3f} cm > {limit:.3f} cm")
    if algorithm == "splaTAM" and not 0 < algo.n_gauss <= algo.config.model.max_gaussians:
        raise RuntimeError(f"{name}: gaussian count {algo.n_gauss} outside (0, {algo.config.model.max_gaussians}]")
    missing = [k for k in counters if launches.get(k, 0) == 0]
    if missing:
        raise RuntimeError(f"{name}: kernels never launched on the main path: {missing}")
    return pipeline, res


def groups_report(pipeline, name: str) -> dict:
    """The ``[groups]`` line of a finished run: the groups dispatched and
    the frames each path took, the captures by key (seconds of the warm-up,
    the key's first group, and of the capture), the replays, and the
    device memory of the graphs' pool."""
    import torch

    algo, G = pipeline.algorithm, pipeline.config.tracker.map_every
    n = len(pipeline.dataset)
    group_times = [pipeline.frame_times[h + j] for h in pipeline.groups for j in range(G)]
    rep = {"groups": len(pipeline.groups), "group_heads": pipeline.groups,
           # the median group frame: a key's first group (warm-up and capture)
           # lands in the frame times of the group before it, and the group
           # after it reads almost nothing (its work was done by then)
           "group_frame_s_median": float(np.median(group_times)) if group_times else None,
           "frames_in_groups": G * len(pipeline.groups), "frames_per_frame": n - G * len(pipeline.groups),
           "captures": {str(k): v for k, v in algo.graphs.captures.items()},
           "replays": {str(k): v for k, v in algo.graphs.replays.items()},
           "pool_mib": algo.graphs.pool_bytes() / 2**20,
           "memory_reserved_mib": torch.cuda.memory_reserved() / 2**20}
    print(f"[groups] {name}: {json.dumps(rep)}")
    return rep


def through_groups(res: dict) -> None:
    """A run must have taken the group path, every group after its key's
    first replayed."""
    g = res["groups"]
    if not g["groups"] or sum(g["replays"].values()) + len(g["captures"]) != g["groups"]:
        raise RuntimeError(f"{res['run']}: the group path did not carry the run: {g}")


def group_inputs(pipeline):
    """A group program of the run with a captured key, its key and inputs:
    the last ``map_every`` frames, seeded from the two estimated poses
    before them, as ``group_call`` builds them (with a keyframe, else
    without)."""
    from xrdslam_tpu_torch.common.frame import Frame

    algo, G = pipeline.algorithm, pipeline.config.tracker.map_every
    n = len(pipeline.dataset)
    frames = [Frame(fid=j, rgb=pipeline.dataset[j][1], depth=pipeline.dataset[j][2], rot_rep=algo.config.rot_rep)
              for j in range(n - G, n)]
    est = algo.estimate_c2w_list
    for do_kf in (True, False):
        key, program, inputs = algo.group_call(frames, do_kf, est[n - G - 1], est[n - G - 2])
        if key in algo.graphs.captures:
            return key, program, inputs
    raise RuntimeError(f"no captured key among {list(algo.graphs.captures)} fits the run's last group")


def check_group_replay(pipeline, name: str, exact: bool, spread: bool = False) -> None:
    """``[graph]``: from one saved state and generator state, the group
    program eagerly twice and its captured graph replayed once. The replay
    must give the eager run's bits (the exact hash: within
    ``GRAPH_EXACT_TOL``; with ``spread``, where the two eager runs differ,
    within ``SPLATAM_GRAPH_SPREAD`` times their distance), and launch what
    the eager group launched. The state is put back after."""
    import torch

    from xrdslam_tpu_torch.ops import hashgrid_fast as hf

    algo = pipeline.algorithm
    key, program, inputs = group_inputs(pipeline)
    saved = algo.save_state()
    runs = []
    for how in ("eager", "eager", "replay"):
        algo.load_state(saved)
        reset_all_launches()
        t0 = time.perf_counter()
        out = program(*inputs) if how == "eager" else algo.graphs(key, program, inputs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {**all_launches(), **{f"hashgrid_fwd@{k}": v for k, v in hf.FWD_LAUNCHES_BY_N.items()}}
        runs.append((how, wall, [o.clone() for o in out], [t.detach().clone() for t in algo._state_tensors()], launches))
    algo.load_state(saved)

    def diff(a, b):
        outs = max(float(((x - y).abs() / max(float(x.abs().max()), 1.0)).max()) for x, y in zip(a[2], b[2]))
        kf = max(float((x.double() - y.double()).abs().max()) for x, y in zip(a[3][-4:], b[3][-4:]))
        state = max(float((x.double() - y.double()).abs().max()) for x, y in zip(a[3], b[3]))
        same = all(torch.equal(x, y) for x, y in zip(a[2] + a[3], b[2] + b[3]))
        return {"same_bits": same, "poses_losses": outs, "keyframe_rows": kf, "state": state}

    eager2, replay = diff(runs[0], runs[1]), diff(runs[0], runs[2])
    rep = {"key": str(key), "eager_vs_eager": eager2, "replay_vs_eager": replay,
           "eager_s": runs[0][1], "replay_s": runs[2][1], "launches_eager": runs[0][4],
           "launches_replay": runs[2][4]}
    print(f"[graph] {name}: {json.dumps(rep)}")
    if runs[2][4] != runs[0][4]:
        raise RuntimeError(f"{name}: a replay launched {runs[2][4]}, the eager group {runs[0][4]}")
    if exact:
        if max(replay["poses_losses"], replay["keyframe_rows"]) > GRAPH_EXACT_TOL:
            raise RuntimeError(f"{name}: the replay is {replay} from the eager group (tolerance {GRAPH_EXACT_TOL})")
    elif spread and not eager2["same_bits"]:
        over = [k for k in ("poses_losses", "keyframe_rows", "state") if replay[k] > SPLATAM_GRAPH_SPREAD * eager2[k]]
        if over:
            raise RuntimeError(f"{name}: the replay is {replay} from the eager group, beyond {SPLATAM_GRAPH_SPREAD} x "
                               f"the eager groups' own {eager2} in {over}")
    elif not replay["same_bits"]:
        raise RuntimeError(f"{name}: the replay's bits differ from the eager group's: {replay}")


def protocol_config(bounds):
    """Co-SLAM as ``bench_accuracy.py::build_coslam`` configures it: the
    registry's entry with the tri-plane, the scene's bounds for mapping and
    meshing, a keyframe table sized to the run, 30,000 rays per render
    chunk and a mesher at resolution 256."""
    from xrdslam_tpu_torch.common.mesher import MesherConfig
    from xrdslam_tpu_torch.configs.registry import algorithm_configs
    from xrdslam_tpu_torch.models.joint_encoding import JointEncodingConfig

    cfg = copy.deepcopy(algorithm_configs["co-slam"])
    a = cfg.xrdslam.algorithm
    a.seed = 0
    a.mapping_bound = a.marching_cubes_bound = bounds
    a.max_keyframes = PROTOCOL_FRAMES // 5 + 2
    a.ray_batch_size = 30000
    a.mesher = MesherConfig(resolution=256)
    a.model = JointEncodingConfig(encoding="triplane")
    return cfg


def reference_row(algorithm: str = "co-slam"):
    """The JAX package's row of ``BENCH_ACCURACY.json`` for ``algorithm``
    and ``bench_accuracy.py``'s gates for it, both read as data."""
    import ast

    with open(os.path.join(ROOT, "BENCH_ACCURACY.json")) as f:
        row = next(r for r in json.load(f)["algorithms"] if r["algorithm"] == algorithm)
    with open(os.path.join(ROOT, "bench_accuracy.py")) as f:
        tree = ast.parse(f.read())
    gates = next(ast.literal_eval(n.value) for n in tree.body
                 if isinstance(n, ast.Assign) and any(getattr(t, "id", "") == "GATES" for t in n.targets))
    return row, gates[algorithm]


_CULLED_GT = {}
_EXACT = {}


def culled_gt_mesh(ds):
    """The scene's exact mesh (0.02 m, made once a process for a scene)
    culled to the frames' frustums, once a process for a scene, size and
    frame count (the trajectory depends on nothing else)."""
    from xrdslam_tpu_torch.utils.mesh_ops import cull_mesh

    key = (ds.scene, ds.camera.height, ds.camera.width, len(ds))
    if key not in _CULLED_GT:
        if ds.scene not in _EXACT:
            _EXACT[ds.scene] = ds.gt_mesh(voxel=0.02)
        _CULLED_GT[key] = cull_mesh(ds, _EXACT[ds.scene])
    return _CULLED_GT[key]


def protocol_row(pipeline, ate_cm: float, algorithm: str = "co-slam") -> dict:
    """``bench_accuracy.run_algo``'s row of a finished run of ``algorithm``
    (run with ``sweep``), from the pipeline's own outputs: PSNR, SSIM and
    depth-L1 of ``eval_2d.json`` (the sweep renders at the estimated pose
    every ``PROTOCOL_RENDER_FREQ`` frames), and accuracy, completion and
    completion ratio of ``mesh/final_mesh_rec.ply`` (the final mesh, culled
    by the estimated poses) against the culled exact mesh. Prints the
    ``[protocol]`` line and raises if a value is not finite."""
    from xrdslam_tpu_torch.ops import marching_tets
    from xrdslam_tpu_torch.utils.eval_recon import calc_3d_metric
    from xrdslam_tpu_torch.utils.io import read_ply

    ds = pipeline.dataset
    with open(os.path.join(pipeline.out_dir, "eval_2d.json")) as f:
        e2d = json.load(f)
    t0 = time.perf_counter()
    rec = read_ply(os.path.join(pipeline.out_dir, "mesh", "final_mesh_rec.ply"))
    m3 = calc_3d_metric(rec, culled_gt_mesh(ds))
    print(f"[protocol] from the sweep's files ({e2d['frames']} frames; the culled mesh {len(rec.vertices)} vertices, "
          f"{len(rec.faces)} faces, marching tetrahedra: {marching_tets.backend()} path): 3D metrics "
          f"{time.perf_counter() - t0:.3f} s")
    row = {"ate_cm": ate_cm, "psnr": e2d["psnr"], "ssim": e2d["ssim"], "depth_l1_cm": e2d["depth_l1"],
           "accuracy_cm": m3["accuracy_cm"], "completion_cm": m3["completion_cm"],
           "completion_ratio_pct": m3["completion_ratio_pct"], "precision_pct": m3["precision_pct"],
           "recall_pct": m3["recall_pct"], "f1_pct": m3["f1_pct"]}
    jax_row, gates = reference_row(algorithm)
    verdicts = {k: bool(row[k] <= thr) if op == "<=" else bool(row[k] >= thr) for k, (op, thr) in gates.items()}
    print("[protocol] " + json.dumps({"algorithm": algorithm, "port": row, "jax": {k: jax_row.get(k) for k in row},
                                      "gates": {k: list(v) for k, v in gates.items()}, "port_passes": verdicts,
                                      "frames": len(ds), "render_freq": PROTOCOL_RENDER_FREQ,
                                      "sweep": {k: e2d.get(k) for k in ("ms_ssim", "lpips", "debug_images")}}))
    bad = [k for k, v in row.items() if not np.isfinite(v)]
    if bad:
        raise RuntimeError(f"{algorithm}@protocol: non-finite {bad}")
    return row


def protocol_hand_row(pipeline) -> dict:
    """The row's render and mesh values computed by hand from the final
    state, as ``protocol_row`` did before the sweep was ported: ``render_img``
    every ``PROTOCOL_RENDER_FREQ`` frames from the generator state the sweep
    started from (the renders jitter their samples with it), ``get_mesh``,
    the evaluation cull and the 3D metrics."""
    from xrdslam_tpu_torch.common import metrics as M
    from xrdslam_tpu_torch.utils.eval_recon import calc_3d_metric
    from xrdslam_tpu_torch.utils.mesh_ops import cull_mesh

    algo, ds = pipeline.algorithm, pipeline.dataset
    est = algo.estimate_c2w_list
    if pipeline.sweep_rng is not None:
        algo.generator.set_state(pipeline.sweep_rng)
    sums = {"psnr": 0.0, "ssim": 0.0, "depth_l1": 0.0}
    frames = list(range(0, len(ds), PROTOCOL_RENDER_FREQ))
    for i in frames:
        _, gt_rgb, gt_depth, _ = ds[i]
        color, depth = algo.render_img(np.asarray(est[i]), gt_depth=gt_depth, idx=i)
        mask = gt_depth > 0
        sums["psnr"] += M.psnr(color, gt_rgb, mask)
        sums["ssim"] += M.ssim(color, gt_rgb)
        sums["depth_l1"] += M.depth_l1(depth, gt_depth, mask) * 100.0
    m3 = calc_3d_metric(cull_mesh(ds, algo.get_mesh(), estimate_c2w_list=est, eval_rec=True), culled_gt_mesh(ds))
    return {"psnr": sums["psnr"] / len(frames), "ssim": sums["ssim"] / len(frames),
            "depth_l1_cm": sums["depth_l1"] / len(frames),
            **{k: m3[k] for k in ("accuracy_cm", "completion_cm", "completion_ratio_pct", "precision_pct",
                                  "recall_pct", "f1_pct")}}


DS_EVAL_KEYS = ("ate_rmse_cm", "accuracy_cm", "completion_cm", "completion_ratio_pct", "precision_pct",
                "recall_pct", "f1_pct", "tnt_precision_pct", "tnt_recall_pct", "tnt_fscore_pct", "unseen_depth_l1_cm")


def ds_eval_run(pipeline, n_imgs: int, name: str = "co-slam@protocol") -> dict:
    """``ds-eval`` of the port (``scripts/eval.py``) on a finished sweep
    run's outputs, with the culled exact mesh written as the ground-truth
    PLY and ``n_imgs`` unseen views rendered on the card. Prints the
    ``[ds-eval]`` line (each metric, each stage's seconds, the raster's
    seconds a view) and raises on a non-finite metric."""
    from xrdslam_tpu_torch.scripts.eval import main as ds_eval

    gt_path = os.path.join(pipeline.out_dir, "gt_culled.ply")
    culled_gt_mesh(pipeline.dataset).export(gt_path)
    t0 = time.perf_counter()
    res = ds_eval(["--output", pipeline.out_dir, "--gt-mesh", gt_path, "--n-imgs-2d", str(n_imgs), "--device", "cuda"])
    rep = {"run": name, "views": n_imgs, **{k: res[k] for k in DS_EVAL_KEYS}, "seconds": res["seconds"],
           "total_s": time.perf_counter() - t0}
    print(f"[ds-eval] {json.dumps(rep)}")
    bad = [k for k in DS_EVAL_KEYS if not np.isfinite(res[k])]
    if bad:
        raise RuntimeError(f"{name}: ds-eval gave non-finite {bad}")
    return rep


def ds_eval_protocol() -> None:
    """``--ds-eval``: Co-SLAM's protocol run with its sweep; the
    ``[protocol]`` row from the sweep's files held to the hand loop's values
    (the same frames, generator state, metric functions and cull), then
    ``ds-eval`` at the reference's 1,000 unseen views."""
    office = f"height={HEIGHT},width={WIDTH},scene=office"
    pipeline, res = run_slam("co-slam", f"n_frames={PROTOCOL_FRAMES},{office}", ("scatter_add",), tag="@protocol",
                             config=protocol_config(office_bounds(office)), sweep=True)
    stamp("co-slam@protocol run with its sweep")
    row = protocol_row(pipeline, res["ate_rmse_cm"])
    hand = protocol_hand_row(pipeline)
    diff = {k: abs(row[k] - v) for k, v in hand.items()}
    print(f"[protocol] the hand loop's values: {json.dumps(hand)}; |sweep - hand| {json.dumps(diff)}")
    if max(diff.values()) > 0:
        raise RuntimeError(f"co-slam@protocol: the sweep's row differs from the hand loop's: {diff}")
    stamp("co-slam protocol row and the hand loop")
    ds_eval_run(pipeline, 1000)
    stamp("ds-eval at 1,000 views")


def profile(name: str, phases) -> None:
    """torch.profiler over one call of each phase (after one warm call)."""
    import torch
    from torch.profiler import ProfilerActivity

    for phase, fn in phases.items():
        fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        # device rows only: an operator row repeats its kernels' time
        rows = device_rows(prof)
        dev_ms = sum(ns for _, ns in rows.values()) / 1e6
        print(f"[profile] {name} {phase}: wall {wall_ms:.3f} ms, device busy {dev_ms:.3f} ms "
              f"({100 * dev_ms / max(wall_ms, 1e-9):.1f}%), kernels {sum(n for n, _ in rows.values())}")
        top = sorted(rows.items(), key=lambda kv: -kv[1][1])
        # the 12 largest rows, and every copy between host and device
        for key, (n, ns) in top[:12] + [kv for kv in top[12:] if kv[0].startswith("Memcpy HtoD")]:
            print(f"[profile]   {ns / 1e6:9.3f} ms  x{n:<5d} {key[:90]}")


def phase_rows(prof, phases) -> dict:
    """{phase: {kernel name: [launches, device ns]}} of a finished
    torch.profiler session (CPU and CUDA activities) in which each phase
    ran inside a ``record_function("phase:<name>")`` range: a device event
    is the phase's whose launching op started inside that range."""
    from torch.autograd import DeviceType

    events = list(prof.profiler.kineto_results.events())
    windows = [(e.start_ns(), e.end_ns(), e.name()[len("phase:"):]) for e in events
               if e.device_type() == DeviceType.CPU and e.name().startswith("phase:")]
    launched = {e.correlation_id(): e.start_ns() for e in events
                if e.device_type() == DeviceType.CPU and e.linked_correlation_id() == 0}
    rows = {phase: {} for phase in phases}
    for e in events:
        if e.device_type() != DeviceType.CUDA or e.is_user_annotation():
            continue
        t = launched.get(e.linked_correlation_id(), e.start_ns())
        phase = next((n for a, b, n in windows if a <= t <= b), None)
        if phase is not None:
            r = rows[phase].setdefault(e.name(), [0, 0])
            r[0] += 1
            r[1] += e.duration_ns()
    return rows


def profile_phases(name: str, phases) -> None:
    """``profile``'s lines for many short phases from one torch.profiler
    session (a session costs the host ~1–2 s to start and read): one warm
    pass over the phases, then each phase in turn inside a
    ``record_function`` range, ended by a synchronize; a device event is
    the phase's whose launching op started inside that range."""
    import torch
    from torch.profiler import ProfilerActivity, record_function

    for fn in phases.values():
        fn()
    torch.cuda.synchronize()
    walls = {}
    with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for phase, fn in phases.items():
            with record_function(f"phase:{phase}"):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                walls[phase] = (time.perf_counter() - t0) * 1e3
    rows = phase_rows(prof, phases)
    for phase in phases:
        dev_ms = sum(ns for _, ns in rows[phase].values()) / 1e6
        print(f"[profile] {name} {phase}: wall {walls[phase]:.3f} ms, device busy {dev_ms:.3f} ms "
              f"({100 * dev_ms / max(walls[phase], 1e-9):.1f}%), kernels {sum(n for n, _ in rows[phase].values())}")
        for key, (n, ns) in sorted(rows[phase].items(), key=lambda kv: -kv[1][1])[:6]:
            print(f"[profile]   {ns / 1e6:9.3f} ms  x{n:<5d} {key[:90]}")


def last_frame(pipeline):
    """A Frame of the run's last image at its estimated pose."""
    from xrdslam_tpu_torch.common.frame import Frame

    algo = pipeline.algorithm
    _, rgb, depth, _ = pipeline.dataset[len(pipeline.dataset) - 1]
    return Frame(fid=-1, rgb=rgb, depth=depth, init_pose=algo.estimate_c2w_list[-1], rot_rep=algo.config.rot_rep)


def profile_coslam(pipeline, name: str = "co-slam") -> None:
    """One replay of the run's last group graph (``group_inputs``), then one
    tracking and one (non-first) mapping call on the last frame; they
    update the finished run's map."""
    algo = pipeline.algorithm
    key, program, inputs = group_inputs(pipeline)
    fr = last_frame(pipeline)
    args = (fr.rgb_dev(algo.device), fr.depth_dev(algo.device), algo._pose(fr.t), algo._pose(fr.r))
    profile(name, {"group": lambda: algo.graphs(key, program, inputs),
                   "track": lambda: algo.track_step(*args),
                   "map": lambda: algo.map_step(*args, algo.config.mapping_n_iters, False, algo._cur_cap())})


def profile_steps(pipeline, name: str) -> None:
    """One replay of a captured program of the run (``group_inputs``), then
    one tracking call and one mapping call on the last frame, as the
    per-frame path makes them (SplaTAM: binning and 40 iterations; growth,
    window binning and 60. NICE-SLAM: 50 iterations; the fine window's 60
    and the coarse window's 60. Vox-Fusion: 30; the voxel insertion and
    15); they update the finished run's map."""
    algo = pipeline.algorithm
    key, program, inputs = group_inputs(pipeline)
    fr = last_frame(pipeline)
    profile(name, {"group": lambda: algo.graphs(key, program, inputs),
                   "track": lambda: algo.finish_tracking(algo.dispatch_tracking(fr)),
                   "map": lambda: algo.do_mapping(fr)})


def pointslam_group(pipeline, head: int, do_kf: bool, run=None):
    """Point-SLAM's group of the frames ``head .. head + map_every - 1`` of
    the run's scene and size (``head``: the first frame after the run)
    from the run's state, seeded from its last two estimated poses,
    through ``run`` (by default the algorithm's graphs); returns its device
    poses (t, q)."""
    import torch

    from xrdslam_tpu_torch.common.frame import Frame
    from xrdslam_tpu_torch.common.synthetic import SyntheticDataset
    from xrdslam_tpu_torch.ops import lie_np

    algo, G = pipeline.algorithm, pipeline.config.tracker.map_every
    cam = pipeline.dataset.get_camera()
    ds = SyntheticDataset(f"n_frames={head + G},height={cam.height},width={cam.width},scene={pipeline.dataset.scene}",
                          device=str(algo.device))
    frames = [Frame(fid=j, rgb=ds[j][1], depth=ds[j][2], rot_rep="quat") for j in range(head, head + G)]
    est = algo.estimate_c2w_list
    p1, p2 = (torch.cat([algo._tensor(v) for v in lie_np.matrix_to_pose_vec(np.asarray(c2w, np.float32),
                                                                            rot_rep="quat")])
              for c2w in (est[-1], est[-2]))
    return algo.group_step(frames, do_kf, p1, p2, run=run)


def check_pointslam_group(pipeline, name: str, head: int, do_kf: bool) -> dict:
    """``[graph]`` for Point-SLAM: from one saved state (the model, the
    device and host maps, the keyframe tables, both generators), the group
    at ``head`` (``pointslam_group``) eagerly twice (the first time, where
    its keys are not captured yet, as the capturing call's warm-up) and
    through its two graphs once. The replay must give the eager group's
    bits (poses, every state tensor, the host map) and launch the K7 and
    K4 the eager group launched. Prints the captures (seconds of warm-up
    and capture), the pool's MiB, each run's wall (the first one's with
    the capture) and, for the replay, the device time of its two graphs
    (CUDA events around each) and its busy share of the wall. The state is
    put back after."""
    import torch

    from xrdslam_tpu_torch.ops import row_gather as rg
    from xrdslam_tpu_torch.ops import scatter as sc

    algo = pipeline.algorithm
    keys = {("head",), (pipeline.config.tracker.map_every, algo.config.mapping_n_iters,
                        algo.config.mapping_pixels_based_on_color_grad, do_kf)}
    saved = algo.save_state()
    # where the keys are new, the first eager run is the capturing call's
    # warm-up: it runs the group eagerly (its result is the call's), and
    # the capture after it launches nothing
    fresh = sorted(str(k) for k in keys - set(algo.graphs.captures))
    spans = []

    def timed(key, program, inputs):
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = algo.graphs(key, program, inputs)
        ev[1].record()
        spans.append(("head" if key == ("head",) else "tail", *ev))
        return out

    runs = []
    eager = lambda k, f, x: tuple(f(*x))  # noqa: E731
    for run in (algo.graphs if fresh else eager, eager, timed):
        algo.load_state(saved)
        reset_all_launches()
        spans.clear()
        t0 = time.perf_counter()
        out = pointslam_group(pipeline, head, do_kf, run=run)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"row_gather": rg.LAUNCHES["row_gather"], "scatter_add": sc.LAUNCHES["scatter_add"]}
        host = [getattr(algo.point_map, k).copy() for k in ("pos", "cell_keys", "cell_count", "cell_list")]
        runs.append((wall, [o.clone() for o in out], [t.detach().clone() for t in algo._state_tensors()], host,
                     launches))
    algo.load_state(saved)
    by_graph = {name: a.elapsed_time(b) for name, a, b in spans}
    device_ms = sum(by_graph.values())

    def same(a, b):
        return (all(torch.equal(x, y) for x, y in zip(a[1] + a[2], b[1] + b[2]))
                and all(np.array_equal(x, y) for x, y in zip(a[3], b[3])))

    rep = {"head": head, "do_kf": do_kf, "mapping_n_iters": algo.config.mapping_n_iters, "captured": fresh,
           "eager_vs_eager_same_bits": same(runs[0], runs[1]), "replay_vs_eager_same_bits": same(runs[0], runs[2]),
           "eager_s": [runs[0][0], runs[1][0]], "replay_s": runs[2][0], "replay_device_ms": device_ms,
           "replay_device_ms_by_graph": by_graph,
           "replay_busy_pct": 100 * device_ms / 1e3 / runs[2][0],
           "launches_eager": runs[0][4], "launches_replay": runs[2][4],
           "captures": {str(k): v for k, v in algo.graphs.captures.items()},
           "replays": {str(k): v for k, v in algo.graphs.replays.items()},
           "pool_mib": algo.graphs.pool_bytes() / 2**20}
    print(f"[graph] {name}: {json.dumps(rep)}")
    if runs[2][4] != runs[0][4] or not runs[0][4]["row_gather"] or not runs[0][4]["scatter_add"]:
        raise RuntimeError(f"{name}: a replay launched {runs[2][4]}, the eager group {runs[0][4]}")
    if not rep["replay_vs_eager_same_bits"]:
        raise RuntimeError(f"{name}: the replay's bits differ from the eager group's")
    return rep


def pointslam_mesh(pipeline, name: str, metrics: bool) -> dict:
    """``[mesh]``: ``get_mesh`` on the run's state (TSDF fusion of its
    keyframes at ``mesh_resolution``): its seconds, vertex and face counts,
    every vertex finite; with ``metrics``, accuracy, completion and
    completion ratio of the mesh culled to the run's frustums against the
    scene's exact mesh culled alike, reported (the JAX row of
    ``BENCH_ACCURACY.json`` fails all six gates), not gated."""
    import torch

    from xrdslam_tpu_torch.ops import marching_tets
    from xrdslam_tpu_torch.utils.eval_recon import calc_3d_metric
    from xrdslam_tpu_torch.utils.mesh_ops import cull_mesh

    algo, ds = pipeline.algorithm, pipeline.dataset
    t0 = time.perf_counter()
    mesh = algo.get_mesh()
    torch.cuda.synchronize()
    t_mesh = time.perf_counter() - t0
    if mesh is None or not len(mesh.faces) or not np.isfinite(mesh.vertices).all():
        raise RuntimeError(f"{name}: get_mesh gave {'no surface' if mesh is None else 'a non-finite mesh'}")
    rep = {"get_mesh_s": t_mesh, "keyframes": algo.kf_count, "mesh_resolution": algo.config.mesh_resolution,
           "vertices": len(mesh.vertices), "faces": len(mesh.faces), "marching_tets": marching_tets.backend()}
    if metrics:
        t0 = time.perf_counter()
        m3 = calc_3d_metric(cull_mesh(ds, mesh, estimate_c2w_list=algo.estimate_c2w_list, eval_rec=True),
                            culled_gt_mesh(ds))
        rep.update(metric_s=time.perf_counter() - t0,
                   **{k: m3[k] for k in ("accuracy_cm", "completion_cm", "completion_ratio_pct")})
    print(f"[mesh] {name}: {json.dumps(rep)}")
    return rep


def pointslam_groups_run(office: str) -> None:
    """``--pointslam-groups``: POINTSLAM_GROUP_FRAMES office frames at the
    registry's settings through the pipeline, gated as the 12-frame run:
    three groups (30, 35, 40), both tail keys captured, K7 and K4 launches
    equal to ``pointslam_schedule``'s for that split; ``[steady]``: the
    per-frame frames 21-29, the group frames by the pipeline's clock (the
    steady rule and the median group frame) and one group replayed from
    the final state (frames 50-54, ``[graph]``); ``[mesh]`` on the final
    state, with its 3-D metrics."""
    from xrdslam_tpu_torch.configs.registry import algorithm_configs

    cfg = algorithm_configs["point-slam"]
    pipeline, res = run_slam("point-slam", f"n_frames={POINTSLAM_GROUP_FRAMES},{office}",
                             ("row_gather", "scatter_add"), ate_limit_cm=ATE_LIMIT_CM, tag="@groups")
    algo, G = pipeline.algorithm, cfg.xrdslam.tracker.map_every
    want = pointslam_schedule(cfg, POINTSLAM_GROUP_FRAMES, pipeline.groups)
    tail = (G, algo.config.mapping_n_iters, algo.config.mapping_pixels_based_on_color_grad)
    keys = {("head",), tail + (False,), tail + (True,)}
    print(f"[launches] point-slam@groups: {json.dumps(res['launches'])}; schedule {json.dumps(want)}")
    if pipeline.groups != [30, 35, 40] or set(algo.graphs.captures) != keys:
        raise RuntimeError(f"point-slam@groups: groups {pipeline.groups}, captures {list(algo.graphs.captures)}")
    if res["launches"] != want:
        raise RuntimeError(f"point-slam@groups: launches {res['launches']} differ from the schedule {want}")
    ft = pipeline.frame_times
    rep = check_pointslam_group(pipeline, "point-slam@groups", POINTSLAM_GROUP_FRAMES, False)
    steady = {"per_frame_21_29_s": float(np.mean(ft[21:30])), "groups_steady_rule_s": res["steady_s_per_frame"],
              "group_frame_median_s": res["groups"]["group_frame_s_median"],
              "group_frames_s": [ft[h] for h in pipeline.groups], "replayed_group_s_per_frame": rep["replay_s"] / G}
    print(f"[steady] point-slam@groups: {json.dumps(steady)}")
    pointslam_mesh(pipeline, "point-slam@groups", metrics=True)


def profile_pointslam(pipeline) -> None:
    """One tracking call (40 iterations) and one mapping call (insertion,
    the map's upload, ``POINTSLAM_PROFILE_MAP_ITERS`` iterations) on the
    last frame, as the pipeline makes them; the mapping calls update the
    finished run's map."""
    algo = pipeline.algorithm
    fr = last_frame(pipeline)
    algo.config.mapping_n_iters = POINTSLAM_PROFILE_MAP_ITERS
    profile("point-slam", {"track": lambda: algo.finish_tracking(algo.dispatch_tracking(fr)),
                           "map": lambda: algo.do_mapping(fr)})


def slots_probe(device) -> None:
    """SplaTAM's registry run (the office at 600x340, 20 frames) against one
    change at a time (``SLOTS_PROBE``, dotted config paths under
    ``xrdslam``): the coverage of the map grown from frame 0 at that
    setting, then the run's ATE and per-frame error. Nothing is gated but
    finite poses."""
    import torch

    data = f"n_frames={SPLATAM_FRAMES},height={HEIGHT},width={WIDTH},scene=office"
    prefix = "algorithm.model."
    for name, overrides in SLOTS_PROBE.items():
        model = {k[len(prefix):]: v for k, v in overrides.items() if k.startswith(prefix)}
        algo, params, dead, w2c, tiles, mask, count, depth = grown_office_frame(device, model)
        out = algo.model.render(params, algo.model.alive_mask(dead, count), w2c, (tiles, mask), algo.ntx, algo.nty)
        cov = coverage(out["sil"], depth)
        del algo, params, dead, tiles, mask, out
        _, res = run_slam("splaTAM", data, overrides=overrides, tag=f"@{name}")
        torch.cuda.empty_cache()
        print(json.dumps({"slots_probe": name, "overrides": overrides, "grown_frame_coverage": cov,
                          "ate_rmse_cm": res["ate_rmse_cm"], "frame_err_cm": res["frame_err_cm"],
                          "gaussians": res["gaussians"], "steady_s_per_frame": res["steady_s_per_frame"]}))


# ``--raster-variants``: kernels/gaussian_raster.cu rebuilt with one change
# each, (text, replacement) pairs, to time what each part of the design
# costs or saves. The first three change the function (the "[variant]"
# line prints their error against the twin) and measure a cost only.
RASTER_VARIANTS = {
    "no_row_sums": [("const float s = warp_reduce_scatter(v, lane);", "const float s = v[lane >> 1];")],
    "fast_log1p": [("log1pf(-alpha)", "__logf(1.0f - alpha)")],
    "fast_exp": [("expf(", "__expf(")],
    "ieee_division": [("__fdividef(suffix, fmaxf(1.0f - alpha, 1e-6f))", "suffix / fmaxf(1.0f - alpha, 1e-6f)")],
    "whole_tile_forward": [
        ("constexpr int kFwdPix = kTile * kTile / 2;", "constexpr int kFwdPix = kTile * kTile;"),
        ("const int tile = blockIdx.x / 2, row0 = (blockIdx.x % 2) * (kTile / 2), t = threadIdx.x;",
         "const int tile = blockIdx.x, row0 = 0, t = threadIdx.x;"),
        ("raster_fwd_kernel<kFwdPixPerThread><<<2 * n_tiles,", "raster_fwd_kernel<kFwdPixPerThread><<<n_tiles,")],
    "fwd_2_px_per_thread": [("constexpr int kFwdPixPerThread = 1;", "constexpr int kFwdPixPerThread = 2;")],
    "fwd_4_px_per_thread": [("constexpr int kFwdPixPerThread = 1;", "constexpr int kFwdPixPerThread = 4;")],
    "bwd_1_px_per_thread": [("constexpr int kBwdPixPerThread = 4;", "constexpr int kBwdPixPerThread = 1;")],
    "bwd_2_px_per_thread": [("constexpr int kBwdPixPerThread = 4;", "constexpr int kBwdPixPerThread = 2;")],
}


def raster_variants(device) -> None:
    """K5 and K6 as shipped and as each of ``RASTER_VARIANTS`` on the
    gaussians grown from office frame 0 (K = 256 and 512): milliseconds by
    CUDA events and by device time, and the largest error against the twin
    (K6's relative to its largest entry). Nothing is gated."""
    import ctypes

    import torch

    from xrdslam_tpu_torch import kernels
    from xrdslam_tpu_torch.ops import gaussian_raster as gr

    libs = build_variants("gaussian_raster", RASTER_VARIANTS, kernels.BUILD_DIR / "variants")
    p, i = ctypes.c_void_p, ctypes.c_int
    for lib in [kernels.load("gaussian_raster"), *libs.values()]:
        lib.xr_raster_fwd.argtypes = [p, p, i, i, i, p]
        lib.xr_raster_bwd.argtypes = [p, p, p, p, i, i, i, p]
        lib.xr_cuda_error_string.argtypes, lib.xr_cuda_error_string.restype = [i], ctypes.c_char_p
    for k_per_tile in (256, SPLATAM_GATE["algorithm.model.k_per_tile"]):
        tiled, gout, tiles, _, _, _ = raster_inputs(device, k_per_tile)
        ntx, nty = gout.shape[1] // 16, gout.shape[0] // 16
        n_tiles, k = tiles.shape
        img_t = gr.raster_fwd_torch(tiled, ntx, nty)
        dg_t = gr.raster_bwd_torch(tiled, gout, img_t, ntx, nty)
        img, dg = torch.empty_like(img_t), torch.empty_like(tiled)
        stream = torch.cuda.current_stream().cuda_stream
        for name, lib in {"shipped": kernels.load("gaussian_raster"), **libs}.items():
            def fwd():
                kernels.check(lib, lib.xr_raster_fwd(tiled.data_ptr(), img.data_ptr(), n_tiles, k, ntx, stream), name)

            def bwd():
                kernels.check(lib, lib.xr_raster_bwd(tiled.data_ptr(), gout.data_ptr(), img_t.data_ptr(),
                                                     dg.data_ptr(), n_tiles, k, ntx, stream), name)

            fwd()
            bwd()
            torch.cuda.synchronize()
            err_f = float((img - img_t).abs().max())
            err_b = float((dg - dg_t).abs().max() / dg_t.abs().max())
            ms_f, ms_b = min(cuda_ms(fwd), cuda_ms(fwd)), min(cuda_ms(bwd), cuda_ms(bwd))
            print(f"[variant] K = {k} {name}: raster_fwd {ms_f:.4f} ms, device {device_ms(fwd):.4f} ms, "
                  f"max abs err {err_f:.1e}; raster_bwd {ms_b:.4f} ms, device {device_ms(bwd):.4f} ms, "
                  f"max err / max |twin| {err_b:.1e}", flush=True)
        del tiled, gout, img_t, dg_t, img, dg
        torch.cuda.empty_cache()


def trajectory_digest(pipeline) -> str:
    """A digest of the bits of a run's estimated poses."""
    import hashlib

    return hashlib.sha1(np.ascontiguousarray(np.asarray(pipeline.algorithm.estimate_c2w_list)).tobytes()).hexdigest()[:16]


def repeat_runs(pointslam: int, protocol: int, niceslam_seeds: int = 0, voxfusion_seeds: int = 0) -> None:
    """Point-SLAM's gated main path (registry settings, 12 office frames)
    ``pointslam`` times, then Co-SLAM at the accuracy protocol (tri-plane,
    200 frames, seed 0) and its row ``protocol`` times, then NICE-SLAM's
    run of the default smoke (60 office frames, the protocol's settings)
    through groups and per frame at seeds 0 .. ``niceslam_seeds`` - 1, then
    Vox-Fusion's (60 office frames, the registry's settings) through groups
    and per frame at seeds 0 .. ``voxfusion_seeds`` - 1, in one process: each run's ATE (full
    precision) beside its gate, a digest of its poses' bits, the protocol
    rows and, for NICE-SLAM and Vox-Fusion, the largest frame error
    (``[seeds]``); nothing gated. Prints whether the runs of each repeated
    kind were identical."""
    import torch

    office = f"height={HEIGHT},width={WIDTH},scene=office"
    seen = {}
    for i in range(pointslam):
        pipeline, res = run_slam("point-slam", f"n_frames={POINTSLAM_FRAMES},{office}", ("row_gather", "scatter_add"),
                                 tag=f"#{i}")
        digest = trajectory_digest(pipeline)
        seen.setdefault("point-slam", []).append((res["ate_rmse_cm"], digest))
        print(f"[repeat] point-slam run {i}: ATE {res['ate_rmse_cm']!r} cm, gate "
              f"{min(ATE_LIMIT_CM, FROZEN_ATE_SHARE * res['frozen_ate_cm']):.4f} cm, poses {digest}", flush=True)
        del pipeline
        torch.cuda.empty_cache()
    bounds = office_bounds(office)
    for i in range(protocol):
        pipeline, res = run_slam("co-slam", f"n_frames={PROTOCOL_FRAMES},{office}", ("scatter_add",),
                                 tag=f"@protocol#{i}", config=protocol_config(bounds), sweep=True)
        row = protocol_row(pipeline, res["ate_rmse_cm"])
        digest = trajectory_digest(pipeline)
        seen.setdefault("co-slam@protocol", []).append((json.dumps(row), digest))
        print(f"[repeat] co-slam@protocol run {i}: ATE {res['ate_rmse_cm']!r} cm, poses {digest}, row "
              f"{json.dumps(row)}", flush=True)
        del pipeline
        torch.cuda.empty_cache()
    for seed in range(niceslam_seeds):
        for path in ("groups", "per-frame"):
            config = niceslam_protocol_config(bounds)
            config.xrdslam.algorithm.seed = seed
            if path == "per-frame":
                os.environ["XRDSLAM_DISABLE_SUPER"] = "1"
            try:
                pipeline, res = run_slam("nice-slam", f"n_frames={NICESLAM_FRAMES},{office}", ("scatter_add",),
                                         tag=f"@seed{seed}-{path}", config=config)
            finally:
                os.environ.pop("XRDSLAM_DISABLE_SUPER", None)
            row = {"seed": seed, "path": path, "ate_cm": res["ate_rmse_cm"],
                   "gate_cm": min(ATE_LIMIT_CM, FROZEN_ATE_SHARE * res["frozen_ate_cm"]),
                   "max_frame_err_cm": max(res["frame_err_cm"]), "poses": trajectory_digest(pipeline)}
            print(f"[seeds] {json.dumps(row)}", flush=True)
            del pipeline
            torch.cuda.empty_cache()
    for seed in range(voxfusion_seeds):
        for path in ("groups", "per-frame"):
            if path == "per-frame":
                os.environ["XRDSLAM_DISABLE_SUPER"] = "1"
            try:
                pipeline, res = run_slam("vox-fusion", f"n_frames={VOXFUSION_FRAMES},{office}", ("scatter_add",),
                                         overrides={"algorithm.seed": seed}, tag=f"@seed{seed}-{path}")
            finally:
                os.environ.pop("XRDSLAM_DISABLE_SUPER", None)
            share = FROZEN_ATE_SHARE if path == "groups" else VOXFUSION_PER_FRAME_FROZEN_SHARE
            row = {"seed": seed, "path": path, "ate_cm": res["ate_rmse_cm"],
                   "gate_cm": min(ATE_LIMIT_CM, share * res["frozen_ate_cm"]),
                   "max_frame_err_cm": max(res["frame_err_cm"]), "poses": trajectory_digest(pipeline)}
            print(f"[seeds] vox-fusion {json.dumps(row)}", flush=True)
            del pipeline
            torch.cuda.empty_cache()
    for name, runs in seen.items():
        print(f"[repeat] {name}: {len(runs)} runs, identical: {all(r == runs[0] for r in runs)}")


def office_bounds(office: str):
    """The synthetic office's bounds as a nested list (the mapping bound)."""
    from xrdslam_tpu_torch.common.synthetic import SyntheticDataset

    return SyntheticDataset(office).bounds.tolist()


def determinism_probe() -> None:
    """Each main path, short, under ``torch.use_deterministic_algorithms(True,
    warn_only=True)``: every operation torch names as having no
    deterministic implementation on the card, with the number of its
    warnings. Co-SLAM (packed hash, 8 frames), Co-SLAM at the protocol's
    configuration (tri-plane, 8 frames, then one ``render_img``), SplaTAM
    (registry settings, 3 frames) and Point-SLAM (registry settings, 3
    frames). Nothing is gated."""
    import collections
    import warnings

    import torch

    office = f"height={HEIGHT},width={WIDTH},scene=office"
    bounds = office_bounds(office)
    bench = {"algorithm.mapping_bound": bounds, "algorithm.max_keyframes": 8}
    runs = (("co-slam", "@packed", 8, bench, None), ("co-slam", "@protocol", 8, None, protocol_config(bounds)),
            ("splaTAM", "", 3, None, None), ("point-slam", "", 3, None, None))
    for algorithm, tag, frames, overrides, config in runs:
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                # a control: an operation torch names on every card
                torch.histc(torch.rand(100, device="cuda"))
                pipeline, _ = run_slam(algorithm, f"n_frames={frames},{office}", overrides=overrides,
                                       tag=tag + "#probe", config=config)
                if tag == "@protocol":
                    _, _, gt_depth, _ = pipeline.dataset[0]
                    pipeline.algorithm.render_img(np.asarray(pipeline.algorithm.estimate_c2w_list[0]),
                                                  gt_depth=gt_depth, idx=0)
                    torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
        named = collections.Counter(str(w.message).split("\n")[0][:200] for w in caught
                                    if "deterministic" in str(w.message))
        print(f"[determinism] {algorithm}{tag}: {len(named)} operations named (the control histc among them), "
              f"{len(caught)} warnings in all")
        for msg, count in named.most_common():
            print(f"[determinism]   x{count:<6d} {msg}")
        del pipeline
        torch.cuda.empty_cache()


def niceslam_runs(office: str, bounds) -> dict:
    """NICE-SLAM's main path at the protocol's settings, 60 office frames,
    through groups (gated, schedule, replay check, outputs, profile);
    ``[steady]``; then ``niceslam_pretrained_run``. Returns the K4
    launches of the group run by table, under the K4 records' names (the
    fine grid's rows take the colour grid's launches too). Its per-frame
    A/B is ``niceslam_per_frame`` (the default run's second process)."""
    import torch

    data = f"n_frames={NICESLAM_FRAMES},{office}"
    config = niceslam_protocol_config(bounds)
    pipeline, res = run_slam("nice-slam", data, ("scatter_add",), ate_limit_cm=ATE_LIMIT_CM, tag="@protocol",
                             config=config)
    check_niceslam_run(pipeline, res, groups=True)
    shapes = pipeline.algorithm.model.grid_shapes
    by_rows = res["scatter_add_by_rows"]
    launches = {f"scatter_add[nice-slam {grid} grid]": by_rows[str(int(np.prod(shapes[f"grid_{grid}"])))]
                for grid in ("middle", "fine", "coarse")}
    steady = {"nice-slam@protocol": [res["steady_s_per_frame"], res["groups"]["group_frame_s_median"]]}
    from xrdslam_tpu_torch.utils.torch_convert import decoder_tree

    # the run's decoders, before the checks below map further
    trees = {name: decoder_tree(pipeline.algorithm.model.decoders[name]) for name in ("middle", "fine", "coarse")}
    check_group_replay(pipeline, "nice-slam@protocol", exact=False)
    check_outputs(pipeline, "nice-slam@protocol")
    profile_steps(pipeline, "nice-slam@protocol")
    print(f"[steady] NICE-SLAM s/frame, by the steady rule and the median group frame: {json.dumps(steady)}")
    stamp("nice-slam@protocol run, replay check, outputs and profile")
    del pipeline
    torch.cuda.empty_cache()
    niceslam_pretrained_run(office, config, trees)
    return launches


def niceslam_per_frame(office: str, bounds) -> None:
    """NICE-SLAM at the protocol's settings on its first
    NICESLAM_PER_FRAME_FRAMES frames, every frame per frame (the A/B
    hatch; gated, schedule, no groups); ``[steady]`` (frames 15 on)."""
    import torch

    os.environ["XRDSLAM_DISABLE_SUPER"] = "1"
    try:
        pipeline, res = run_slam("nice-slam", f"n_frames={NICESLAM_PER_FRAME_FRAMES},{office}", ("scatter_add",),
                                 ate_limit_cm=ATE_LIMIT_CM, tag="@protocol-per-frame",
                                 config=niceslam_protocol_config(bounds))
    finally:
        del os.environ["XRDSLAM_DISABLE_SUPER"]
    check_niceslam_run(pipeline, res, groups=False)
    print(f"[steady] NICE-SLAM per frame, frames 15-{NICESLAM_PER_FRAME_FRAMES - 1} of its "
          f"{NICESLAM_PER_FRAME_FRAMES}: {json.dumps({'nice-slam@protocol-per-frame': res['steady_s_per_frame']})}")
    stamp("nice-slam@protocol-per-frame run")
    del pipeline
    torch.cuda.empty_cache()


def niceslam_pretrained_run(office: str, config, trees) -> None:
    """NICE-SLAM at ``config``'s settings (the first mapping
    ``NICESLAM_PRETRAINED_FIRST_ITERS`` iterations) on its first
    ``NICESLAM_PRETRAINED_FRAMES`` frames with the decoders ``trees``
    written as the reference's ``middle_fine.pt`` and ``coarse.pt`` and
    named by the config: they must load (``pretrained_available``, only
    the colour decoder trained, no geometric supervision), stay the same
    bits through the run, and K4's launches be the schedule's; the ATE is
    reported."""
    import torch

    from xrdslam_tpu_torch.utils.param_tree import flatten_tree
    from xrdslam_tpu_torch.utils.torch_convert import decoder_tree, save_nice_decoders

    d = os.path.join(ROOT, "build", "chip_smoke_pretrained")
    os.makedirs(d, exist_ok=True)
    mf, coarse = os.path.join(d, "middle_fine.pt"), os.path.join(d, "coarse.pt")
    save_nice_decoders(mf, trees, coarse)
    cfg = copy.deepcopy(config)
    cfg.xrdslam.algorithm.model.pretrained_decoders_middle_fine = mf
    cfg.xrdslam.algorithm.model.pretrained_decoders_coarse = coarse
    cfg.xrdslam.algorithm.mapping_first_n_iters = NICESLAM_PRETRAINED_FIRST_ITERS
    pipeline, res = run_slam("nice-slam", f"n_frames={NICESLAM_PRETRAINED_FRAMES},{office}", ("scatter_add",),
                             tag="@pretrained", config=cfg)
    model = pipeline.algorithm.model
    want = niceslam_schedule(pipeline.config, res["frames"], model.grid_shapes)
    got = {"scatter_add": res["launches"]["scatter_add"], "by_rows": res["scatter_add_by_rows"]}
    after = {name: flatten_tree(decoder_tree(model.decoders[name])) for name in trees}
    same = all(np.array_equal(a[k], flatten_tree(trees[name])[k]) for name, a in after.items() for k in a)
    print(f"[nice-slam] nice-slam@pretrained: pretrained_available {model.pretrained_available}, trainable "
          f"decoders {model.trainable_decoders}, geometric supervision {model.geo_supervision}; the frozen "
          f"decoders the same bits after the run: {same}; ATE {res['ate_rmse_cm']:.4f} cm (reported); groups "
          f"{res['groups']['groups']}; K4 {json.dumps(got)}, schedule {json.dumps(want)}")
    if not (model.pretrained_available and model.trainable_decoders == ["color"] and not model.geo_supervision
            and same and got == want):
        raise RuntimeError("nice-slam@pretrained: the decoders did not load, changed, or K4's launches differ")
    stamp("nice-slam@pretrained run")
    del pipeline
    torch.cuda.empty_cache()



def niceslam_protocol() -> None:
    """``--niceslam-protocol``: NICE-SLAM at ``bench_accuracy.py``'s
    protocol (200 office frames, ``niceslam_protocol_config``) and its
    ``[protocol]`` row beside the JAX package's; reported, not gated."""
    office = f"height={HEIGHT},width={WIDTH},scene=office"
    pipeline, res = run_slam("nice-slam", f"n_frames={PROTOCOL_FRAMES},{office}", ("scatter_add",),
                             tag="@protocol200", config=niceslam_protocol_config(office_bounds(office)), sweep=True)
    protocol_row(pipeline, res["ate_rmse_cm"], "nice-slam")
    stamp("nice-slam protocol row")


def voxfusion_runs(office: str) -> dict:
    """Vox-Fusion's main path, the registry's entry on 60 office frames,
    through groups (gated, schedule, voxels, frame 0's insertion against the
    host allocator, replay check, outputs, profile); ``[steady]``. Returns
    K4's launches of the group run under its record's name. Its per-frame
    A/B is ``voxfusion_per_frame`` (the default run's second process)."""
    import torch

    data = f"n_frames={VOXFUSION_FRAMES},{office}"
    pipeline, res = run_slam("vox-fusion", data, ("scatter_add",), ate_limit_cm=ATE_LIMIT_CM, tag="@registry")
    check_voxfusion_run(pipeline, res, groups=True)
    launches = {"scatter_add[vox-fusion]": res["launches"]["scatter_add"]}
    steady = {"vox-fusion@registry": [res["steady_s_per_frame"], res["groups"]["group_frame_s_median"]]}
    check_voxel_insertion(pipeline)
    check_group_replay(pipeline, "vox-fusion@registry", exact=False)
    check_outputs(pipeline, "vox-fusion@registry")
    profile_steps(pipeline, "vox-fusion@registry")
    print(f"[steady] Vox-Fusion s/frame, by the steady rule and the median group frame: {json.dumps(steady)}")
    stamp("vox-fusion@registry run, insertion and replay checks, outputs and profile")
    del pipeline
    torch.cuda.empty_cache()
    return launches


def voxfusion_per_frame(office: str) -> None:
    """Vox-Fusion's registry entry on the 60 office frames, every frame
    per frame (the A/B hatch; gated as VOXFUSION_PER_FRAME_NOTE says;
    finite poses, schedule, no groups); ``[steady]``."""
    import torch

    os.environ["XRDSLAM_DISABLE_SUPER"] = "1"
    try:
        pipeline, res = run_slam("vox-fusion", f"n_frames={VOXFUSION_FRAMES},{office}", ("scatter_add",),
                                 ate_limit_cm=ATE_LIMIT_CM, tag="@registry-per-frame",
                                 frozen_share=VOXFUSION_PER_FRAME_FROZEN_SHARE)
    finally:
        del os.environ["XRDSLAM_DISABLE_SUPER"]
    check_voxfusion_run(pipeline, res, groups=False)
    print(f"[steady] Vox-Fusion per frame: {json.dumps({'vox-fusion@registry-per-frame': res['steady_s_per_frame']})}")
    stamp("vox-fusion@registry-per-frame run")
    del pipeline
    torch.cuda.empty_cache()


def dpvo_schedule(algo) -> int:
    """K4 launches of a DPVO run: ``UPDATE_SCATTERS`` an update (4 in the
    update operator, 4 in each of the bundle adjuster's 2 iterations),
    ``PROBE_SCATTERS`` a motion probe (the update operator's)."""
    from xrdslam_tpu_torch.algorithms.dpvo import PROBE_SCATTERS, UPDATE_SCATTERS

    return UPDATE_SCATTERS * algo.n_updates + PROBE_SCATTERS * algo.n_probes


def check_dpvo_run(pipeline, res: dict, weights: str = DPVO_WEIGHTS) -> None:
    """A DPVO run's K4 launches against ``dpvo_schedule``, and its weights:
    the checkpoint ``weights`` must have loaded."""
    algo = pipeline.algorithm
    want = dpvo_schedule(algo)
    print(f"[launches] {res['run']}: {json.dumps(res['launches'])}; schedule scatter_add {want} "
          f"({algo.n_updates} updates, {algo.n_probes} probes)")
    if res["launches"]["scatter_add"] != want:
        raise RuntimeError(f"{res['run']}: scatter_add launches {res['launches']['scatter_add']} != {want}")
    if algo.model.loaded_from != weights:
        raise RuntimeError(f"{res['run']}: the weights {weights} did not load ({algo.model.loaded_from!r})")


def scatter_calls(fn):
    """The K4 calls that ``fn()`` makes (each ``scatter_add_ordered``: the
    ordered sums of ``scatter_add``, ``segment_sum`` and the table
    gradients), as [(ordering, g)]; ``fn`` runs."""
    from xrdslam_tpu_torch.ops import scatter as sc

    calls, shipped = [], sc.scatter_add_ordered

    def keep(order, g):
        calls.append((order, g.detach().clone()))
        return shipped(order, g)

    sc.scatter_add_ordered = keep
    try:
        fn()
    finally:
        sc.scatter_add_ordered = shipped
    return calls


def dpvo_update_calls(algo):
    """The K4 calls of one update at ``algo``'s state (the update is made):
    [(idx, g, rows)]."""
    return [(order.idx.detach().clone(), g, order.num_rows) for order, g in scatter_calls(algo.update)]


def check_scatter_dpvo(pipeline, res: dict) -> list:
    """K4 at a DPVO run's two largest shapes, on the ids and sums of one
    update at its last state: SoftAgg's (E padded edges x 384 into E + 1
    rows) and the bundle adjuster's E blocks (2E x 6 into m n rows, m the
    window's patches, n its frames). Returns the records; their launches
    are the run's at those rows (K4's count by the rows it sums into)."""
    algo = pipeline.algorithm
    calls = dpvo_update_calls(algo)
    W, M = algo.W_BA, algo.M
    soft = next(c for c in calls if c[1].shape[1] == algo.DIM)
    ep = next(c for c in calls if c[2] == W * M * W)
    records = []
    for what, (idx, g, rows) in (("softagg", soft), ("ba-ep", ep)):
        name = f"scatter_add[{res['run']} {what}]"
        per_row = np.bincount(idx.cpu().numpy(), minlength=rows)
        launches = res["scatter_add_by_rows"].get(str(rows), 0)
        print(f"[dpvo] {name}: {idx.shape[0]} ids x {g.shape[1]} into {rows} rows; {int((per_row > 0).sum())} "
              f"rows hit, the longest {int(per_row.max())}; launches at these rows in the run: {launches}")
        rec = scatter_case(name, idx, g, rows, algo.device)
        records.append({"name": name, "route": "cuda", "source": "xrdslam_tpu_torch/kernels/scatter.cu",
                        "replaces": "xrdslam_tpu/ops/pallas_scatter.py:38", "counter": name,
                        "shape": [int(idx.shape[0]), int(g.shape[1]), rows], "run_launches": launches, **rec})
    return records


def profile_dpvo(pipeline, name: str) -> None:
    """One update at the run's last state, whole (host graph, uploads,
    device work, readback) and by stage: the host half (``inputs``), the
    two encoders on the last frame (``encoders``), the correlation, the
    update operator and the bundle adjuster, each on the same inputs."""
    import torch

    from xrdslam_tpu_torch.common.frame import upload

    algo = pipeline.algorithm
    _, rgb, _, _ = pipeline.dataset[len(pipeline.dataset) - 1]
    img = upload(np.ascontiguousarray(rgb[: algo.ht, : algo.wd].transpose(2, 0, 1), np.float32), algo.device)
    centers = torch.rand((algo.M, 2), device=algo.device) * torch.tensor([algo.w4 - 2, algo.h4 - 2],
                                                                         device=algo.device) + 1
    inp = algo.update_inputs()
    with torch.no_grad():
        coords, corr = algo.correlate(inp)
        _, delta, weight = algo.operator(inp, corr)
    print(f"[dpvo] {name} profiled state: {inp['E_real']} edges in a bucket of {inp['E']}, {algo.n} frames")
    with torch.no_grad():
        profile(name, {"update": algo.update, "inputs": algo.update_inputs,
                       "encoders": lambda: algo.detect(img, centers), "correlation": lambda: algo.correlate(inp),
                       "operator": lambda: algo.operator(inp, corr),
                       "ba": lambda: algo.adjust(inp, coords, delta, weight)})


def dpvo_runs(office: str) -> tuple:
    """DPVO on the committed trained weights: ``tests/test_dpvo_trained.py``'s
    run (gated at its sim(3) ATE bound), then the registry's entry at
    600x340 (``DPVO_REGISTRY``; finite poses; ATE reported), each with K4's
    launches held to ``dpvo_schedule``; K4 checked at DPVO's two largest
    shapes, the registry run's at its last state (22 frames of edges in a
    bucket of 65,536); the registry run's profile. Returns (the records,
    their launches by name)."""
    import torch

    # the JAX test's gate alone: its sim(3) ATE against an SE(3) frozen
    # camera's would mix two alignments
    pipeline, res = run_slam("dpvo", DPVO_TRAINED_DATA, ("scatter_add",), overrides=DPVO_TRAINED,
                             ate_limit_cm=DPVO_ATE_LIMIT_CM, tag="@trained", frozen_share=float("inf"),
                             correct_scale=True)
    check_dpvo_run(pipeline, res)
    steady = {"dpvo@trained": res.get("steady_s_per_frame")}
    poses = np.stack(pipeline.algorithm.estimate_c2w_list)
    stamp("dpvo@trained run")
    del pipeline
    torch.cuda.empty_cache()
    dpvo_pth_run(poses)
    pipeline, res = run_slam("dpvo", f"n_frames={DPVO_FRAMES},{office}", ("scatter_add",),
                             overrides=DPVO_REGISTRY, tag="@registry", correct_scale=True)
    check_dpvo_run(pipeline, res)
    steady["dpvo@registry"] = res.get("steady_s_per_frame")
    print(f"[dpvo] registry run: sim(3) ATE {res['ate_rmse_cm']:.4f} cm (reported), {res['edges_end']} edges at "
          f"the end, updates by bucket {json.dumps(res['updates_by_bucket'])}, peak {res['peak_mem_gib']:.3f} GiB")
    print(f"[steady] DPVO s/frame by the steady rule: {json.dumps(steady)}")
    stamp("dpvo@registry run")
    records = check_scatter_dpvo(pipeline, res)
    stamp("K4 at dpvo@registry's shapes")
    profile_dpvo(pipeline, "dpvo@registry")
    stamp("dpvo@registry profile")
    del pipeline
    torch.cuda.empty_cache()
    return records, {r["counter"]: r.pop("run_launches") for r in records}


def dpvo_pth_run(npz_poses) -> None:
    """``dpvo@trained`` again on the committed weights written out as a
    ``dpvo.pth`` in the reference's layout (``utils/torch_convert``): the
    converted checkpoint must load and give the ``.npz`` run's poses
    (``npz_poses``; the same bits, or within ``DPVO_PTH_POSE_TOL``)."""
    import torch

    from xrdslam_tpu_torch.utils.param_tree import load_params
    from xrdslam_tpu_torch.utils.torch_convert import save_dpvo_weights

    pth = os.path.join(ROOT, "build", "chip_smoke_pretrained", "dpvo.pth")
    os.makedirs(os.path.dirname(pth), exist_ok=True)
    save_dpvo_weights(pth, load_params(DPVO_WEIGHTS))
    pipeline, res = run_slam("dpvo", DPVO_TRAINED_DATA, ("scatter_add",),
                             overrides={**DPVO_TRAINED, "algorithm.model.pretrained_path": pth}, tag="@trained-pth",
                             correct_scale=True)
    check_dpvo_run(pipeline, res, weights=pth)
    poses = np.stack(pipeline.algorithm.estimate_c2w_list)
    diff = float(np.abs(poses - npz_poses).max())
    print(f"[dpvo] dpvo@trained-pth: {os.path.getsize(pth)} bytes of reference-layout checkpoint; poses against "
          f"the .npz run's: identical bits {bool(np.array_equal(poses, npz_poses))}, max abs difference {diff:.3e} "
          f"(limit {DPVO_PTH_POSE_TOL}); sim(3) ATE {res['ate_rmse_cm']:.4f} cm")
    if not diff <= DPVO_PTH_POSE_TOL:
        raise RuntimeError(f"dpvo@trained-pth: poses differ from the .npz run's by {diff:.3e}")
    stamp("dpvo@trained-pth run")
    del pipeline
    torch.cuda.empty_cache()


def dpvo_correct(model, batch, n_rec: int = 1, chunk: int = 64):
    """``tests/test_dpvo_train.py``'s held-out step: the estimate after
    ``n_rec`` updates from ``cur0`` and the last weights, as numpy."""
    import torch

    from xrdslam_tpu_torch.engine import dpvo_train as T

    with torch.no_grad():
        for cur, delta, weight in T.recurrent_steps(model, batch["images"], batch["centers"], batch["cur0"], n_rec,
                                                    chunk):
            pass
    return (cur + delta).cpu().numpy(), weight.cpu().numpy()


def check_train_grads(net, batch, chunk: int) -> None:
    """One training step's loss and gradients with K4 against the same
    step's with every K4 call replaced by its plain twin, on the card
    (``DPVO_TRAIN_GRAD_RTOL``); and the same bits in two steps."""
    import torch

    from xrdslam_tpu_torch.engine import dpvo_train as T
    from xrdslam_tpu_torch.ops import scatter as sc

    params = list(net.parameters())
    runs = [T.value_and_grad(net, params, batch, chunk=chunk) for _ in range(2)]
    shipped = sc.scatter_add, sc.scatter_add_ordered
    sc.scatter_add, sc.scatter_add_ordered = sc.scatter_add_torch, sc.scatter_add_sorted_torch
    try:
        sc.reset_launches()
        twin_loss, twin = T.value_and_grad(net, params, batch, chunk=chunk)
        if sc.LAUNCHES["scatter_add"]:
            raise RuntimeError("dpvo@train: the twins' step launched K4")
    finally:
        sc.scatter_add, sc.scatter_add_ordered = shipped
    (loss, grads), (loss2, grads2) = runs
    if not (torch.equal(loss, loss2) and all(torch.equal(a, b) for a, b in zip(grads, grads2))):
        raise RuntimeError("dpvo@train: two steps on the same inputs gave different bits")
    floor = DPVO_TRAIN_GRAD_FLOOR * max(float(g.abs().max()) for g in twin)
    worst, worst_name = 0.0, ""
    for (name, _), g, w in zip(net.named_parameters(), grads, twin):
        err = float((g - w).abs().max()) / max(float(w.abs().max()), floor)
        if not np.isfinite(err) or err > DPVO_TRAIN_GRAD_RTOL:
            raise RuntimeError(f"dpvo@train: {name}'s gradient with K4 is {err:.3e} (relative) from the twins'")
        worst, worst_name = max((worst, worst_name), (err, name))
    agg = max(float(g.abs().max()) for (n, _), g in zip(net.named_parameters(), grads)
              if n.startswith("update.agg_kk.f") or n.startswith("update.agg_ij.f"))
    if not agg > 0:
        raise RuntimeError("dpvo@train: no gradient reached the SoftAggs' f through their sums")
    print(f"[check] dpvo@train step gradients, K4 against the twins on the card: loss {float(loss):.6f} vs "
          f"{float(twin_loss):.6f}, the largest leaf error {worst:.3e} ({worst_name}; limit {DPVO_TRAIN_GRAD_RTOL} "
          f"of the larger of the leaf's largest entry and {floor:.3e}); the same bits in two steps; "
          f"SoftAgg f's largest gradient {agg:.3e}")


def k4_roles(fn, m: int, keep: bool = False) -> tuple:
    """Runs ``fn()`` (a training step, or a whole training run, at ``m``
    patches) and returns (the K4 launches it made by role, counted at each
    ``scatter_add_ordered`` call that launched the kernel in this run;
    with ``keep``, the first (ordering, g) of each role). The roles:
    SoftAgg's sums and gathers (m ids x 384 into m + 1 rows; each patch its
    own group, ``softagg-kk``, or all in group 0, ``softagg-ij``: told
    apart by the largest id, read after ``fn`` so that the run is not
    synchronised), the context sample's table gradient (4 taps a patch x
    384), the patch sampler's (9 pixels x 4 taps a patch x 128) and the
    correlation's (x 128, into the 1/4-resolution rows, ``corr-level1``,
    or the pooled ones, ``corr-level2``)."""
    import torch

    from xrdslam_tpu_torch.ops import scatter as sc

    seen, largest, kept, shipped = [], [], [], sc.scatter_add_ordered

    def count(order, g):
        before = sc.LAUNCHES["scatter_add"]
        out = shipped(order, g)
        if sc.LAUNCHES["scatter_add"] == before + 1:
            n, c, rows = order.idx.shape[0], g.shape[1], order.num_rows
            if c == 384 and n == m and rows == m + 1:
                key = len(largest)  # a SoftAgg call, resolved after the run
                largest.append(order.keys[-1:])  # the sorted ids' last: a view, no copy
            else:
                key = "context" if c == 384 else "patches" if n == 36 * m else f"corr-rows{rows}"
            seen.append(key)
            if keep:
                kept.append((key, order, g.detach().clone()))
        return out

    sc.scatter_add_ordered = count
    try:
        fn()
    finally:
        sc.scatter_add_ordered = shipped
    top = torch.cat(largest).cpu().numpy() if largest else np.zeros(0)
    corr = sorted({k for k in seen if isinstance(k, str) and k.startswith("corr-rows")},
                  key=lambda k: -int(k[len("corr-rows"):]))
    names = dict(zip(corr, ("corr-level1", "corr-level2")))

    def role(key):
        if isinstance(key, int):
            return "softagg-ij" if int(top[key]) == 0 else "softagg-kk"
        return names.get(key, key)

    counts: dict = {}
    for key in seen:
        counts[role(key)] = counts.get(role(key), 0) + 1
    firsts: dict = {}
    for key, order, g in kept:
        firsts.setdefault(role(key), (order, g))
    return counts, firsts


def train_recipe(net, ds, dev, stages) -> list:
    """``net`` trained in place through ``stages`` (``DPVO_TRAIN`` and,
    for the whole recipe, ``DPVO_TRAIN_RESUME`` over it); the losses."""
    from xrdslam_tpu_torch.engine import dpvo_train as T

    losses = []
    for st in stages:
        net, stage_losses = T.train(net, ds, dev, n_iters=st["n_iters"], lr=st["lr"], m=st["m"], seed=st["seed"],
                                    noise_px=st["noise_px"], log_every=100, chunk=st["chunk"])
        losses += stage_losses
    return losses


def port_trained_run(net, tag: str, gate):
    """The tree of ``net`` saved and run at ``dpvo@trained``'s
    configuration (``dpvo@port-trained``), its ATE gated at ``gate`` cm
    (None: reported); returns the run's record."""
    import torch

    from xrdslam_tpu_torch.engine import dpvo_train as T

    path = os.path.join(ROOT, "build", "chip_smoke_pretrained", f"dpvo_port_trained{tag}.npz")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    T.save_params(path, net.tree())
    pipeline, res = run_slam("dpvo", DPVO_TRAINED_DATA, ("scatter_add",),
                             overrides={**DPVO_TRAINED, "algorithm.model.pretrained_path": path},
                             ate_limit_cm=gate, tag=f"@port-trained{tag}", frozen_share=float("inf"),
                             correct_scale=True)
    check_dpvo_run(pipeline, res, weights=path)
    del pipeline
    torch.cuda.empty_cache()
    return res


def dpvo_train_runs(office: str, full: bool = False, device: str = "cuda") -> tuple:
    """``dpvo@train``: VONet trained on the card (``DPVO_TRAIN``; with
    ``full`` the recipe's second stage too), one step's gradients held to
    the twins', K4's launches to the counted schedule, the learning gates,
    K4 checked and timed at each of a step's shapes, a step profiled at
    160x120 and at 600x340 with 96 patches, and the trained tree run at
    ``dpvo@trained``'s configuration. Returns (the records, their launches
    by name)."""
    import torch

    from xrdslam_tpu_torch.common.synthetic import SyntheticDataset
    from xrdslam_tpu_torch.engine import dpvo_train as T
    from xrdslam_tpu_torch.models.vonet import VONet, VONetConfig
    from xrdslam_tpu_torch.ops import scatter as sc

    dev = torch.device(device)
    cfg = DPVO_TRAIN
    ds = SyntheticDataset(DPVO_TRAIN_DATA, device=device)
    ds.prerender()
    net = VONet(VONetConfig()).to(dev)  # random weights, seed 0
    random_net = copy.deepcopy(net)
    losses: list = []
    batch = T.upload_batch(T.make_batch(ds, np.random.default_rng(99), m=cfg["m"], noise_px=cfg["noise_px"]), dev)
    check_train_grads(net, batch, cfg["chunk"])
    params = list(net.parameters())
    step = lambda: T.value_and_grad(net, params, batch, chunk=cfg["chunk"])  # noqa: E731
    sc.reset_launches()
    step_roles, _ = k4_roles(step, cfg["m"])
    step_rows = {str(k): v for k, v in sorted(sc.LAUNCHES_BY_ROWS.items())}
    per_step = T.train_step_scatters(cfg["m"], 2, cfg["chunk"])
    if sum(step_roles.values()) != per_step or len(step_roles) != 6:
        raise RuntimeError(f"dpvo@train: a step made K4 launches {step_roles}, the schedule {per_step} in 6 roles")
    stamp("dpvo@train set-up and gradient check")

    stages = [dict(cfg)] + ([{**cfg, **DPVO_TRAIN_RESUME}] if full else [])
    n_iters = sum(st["n_iters"] for st in stages)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    t0 = time.perf_counter()
    counts_by_role, _ = k4_roles(lambda: losses.extend(train_recipe(net, ds, dev, stages)), cfg["m"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = all_launches()
    by_rows = {str(k): v for k, v in sorted(sc.LAUNCHES_BY_ROWS.items())}
    want_rows = {k: v * n_iters for k, v in step_rows.items()}
    want_roles = {k: v * n_iters for k, v in sorted(step_roles.items())}
    counts_by_role = dict(sorted(counts_by_role.items()))
    print(f"[launches] dpvo@train: {json.dumps(launches)}; by rows {json.dumps(by_rows)}; by role "
          f"{json.dumps(counts_by_role)}; schedule scatter_add {per_step} a step x {n_iters} = {per_step * n_iters}, "
          f"by rows {json.dumps(want_rows)}, by role {json.dumps(want_roles)}")
    if (launches["scatter_add"] != per_step * n_iters or by_rows != want_rows
            or counts_by_role != want_roles or sum(counts_by_role.values()) != launches["scatter_add"]):
        raise RuntimeError(f"dpvo@train: K4 launches {launches['scatter_add']} by rows {by_rows}, by role "
                           f"{counts_by_role} differ from the schedule's {per_step * n_iters}, {want_rows}, "
                           f"{want_roles}")
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    print(f"[train] dpvo@train: {n_iters} iterations in {wall:.3f} s ({1e3 * wall / n_iters:.3f} ms an iteration, "
          f"batches made on the host included), peak {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; loss "
          f"{first:.4f} -> {last:.4f} (mean of the first and last 10; gate: below {DPVO_TRAIN_LOSS_DROP} x the first)")
    if not last < DPVO_TRAIN_LOSS_DROP * first:
        raise RuntimeError(f"dpvo@train: the loss fell from {first:.4f} to {last:.4f} only")
    # the held-out batch of tests/test_dpvo_train.py's gates (a fresh generator)
    b = T.make_batch(ds, np.random.default_rng(123), m=cfg["m"], noise_px=cfg["noise_px"])
    held = T.upload_batch(b, dev)
    v = b["valid"] > 0
    base = float(np.linalg.norm(b["cur0"] - b["target"], axis=-1)[v].mean())
    cur_rand, _ = dpvo_correct(random_net, held, chunk=cfg["chunk"])
    cur_tr, w_tr = dpvo_correct(net, held, chunk=cfg["chunk"])
    rand = float(np.linalg.norm(cur_rand - b["target"], axis=-1)[v].mean())
    tr = float(np.linalg.norm(cur_tr - b["target"], axis=-1)[v].mean())
    w_mean = float(w_tr.mean())
    print(f"[gate] dpvo@train held-out batch ({int(v.sum())} valid patches): error {tr:.4f} px after one update "
          f"against the noise's {base:.4f} (limit {DPVO_TRAIN_NOISE_SHARE} x) and random weights' {rand:.4f} (limit "
          f"{DPVO_TRAIN_RANDOM_SHARE} x); mean weight {w_mean:.4f} (in (0, 1))")
    if not (v.sum() >= 8 and tr < DPVO_TRAIN_NOISE_SHARE * base and tr < DPVO_TRAIN_RANDOM_SHARE * rand
            and 0.0 < w_mean < 1.0):
        raise RuntimeError("dpvo@train: the trained operator fails the held-out gates")
    stamp("dpvo@train training and gates")

    # K4 at each of a step's shapes, on the trained weights' step; the
    # launches are the training run's, by role
    _, firsts = k4_roles(step, cfg["m"], keep=True)
    records, counts = [], {}
    for role, (order, g) in sorted(firsts.items()):
        name = f"scatter_add[dpvo@train {role}]"
        per_row = np.bincount(order.idx.cpu().numpy(), minlength=order.num_rows)
        print(f"[dpvo] {name}: {order.idx.shape[0]} ids x {g.shape[1]} into {order.num_rows} rows "
              f"({int((per_row > 0).sum())} hit, the longest {int(per_row.max())}); {step_roles[role]} a step, "
              f"{counts_by_role[role]} in the training run")
        rec = scatter_case(name, order.idx, g, order.num_rows, dev, order=order)
        counts[name] = counts_by_role[role]
        records.append({"name": name, "route": "cuda", "source": "xrdslam_tpu_torch/kernels/scatter.cu",
                        "replaces": "xrdslam_tpu/ops/pallas_scatter.py:38", "counter": name,
                        "shape": [int(order.idx.shape[0]), int(g.shape[1]), order.num_rows],
                        "calls_a_step": step_roles[role], **rec})
    stamp("K4 at dpvo@train's shapes")

    # a training step profiled, at the smoke's size and at 600x340 with the
    # registry's 96 patches
    big = SyntheticDataset(f"n_frames=4,{office}", device=device)
    big_batch = T.upload_batch(T.make_batch(big, np.random.default_rng(0), m=DPVO_TRAIN_REGISTRY_M,
                                            noise_px=cfg["noise_px"]), dev)
    for tag, bt in (("160x120 m64", batch), (f"600x340 m{DPVO_TRAIN_REGISTRY_M}", big_batch)):
        torch.cuda.synchronize()
        base_mem = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        T.value_and_grad(net, params, bt, chunk=cfg["chunk"])
        torch.cuda.synchronize()
        print(f"[train] dpvo@train step at {tag}: peak {(torch.cuda.max_memory_allocated() - base_mem) / 2**30:.3f} "
              f"GiB above its inputs")
        profile(f"dpvo@train {tag}", {"step": lambda bt=bt: T.value_and_grad(net, params, bt, chunk=cfg["chunk"])})
    stamp("dpvo@train step profiles")

    # the trained tree through the pipeline at dpvo@trained's configuration
    res = port_trained_run(net, "", DPVO_ATE_LIMIT_CM if full else None)
    print(f"[dpvo] dpvo@port-trained ({n_iters} iterations trained on the card): sim(3) ATE {res['ate_rmse_cm']:.4f} "
          f"cm ({'gated' if full else 'reported'}), the committed weights' 1.4839 cm (2,000 iterations)")
    stamp("dpvo@port-trained run")
    return records, counts


def dpvo_train_seeds(n_seeds: int, device: str = "cuda") -> None:
    """The whole recipe (``DPVO_TRAIN``, then ``DPVO_TRAIN_RESUME``) from
    random weights at initial seeds 0 .. ``n_seeds`` - 1 (batch seeds 2 s
    and 2 s + 1; seed 0 is ``--dpvo-train-full``'s run), each trained
    tree's ``dpvo@trained`` ATE reported against ``DPVO_ATE_LIMIT_CM`` and
    their spread; then a witness of the card's training: seed 0's first
    ``DPVO_WITNESS_STEPS`` steps on the card (float32, K4) against the
    same steps in float64 on the CPU (the twins), on the same batches."""
    import torch

    from xrdslam_tpu_torch.common.synthetic import SyntheticDataset
    from xrdslam_tpu_torch.models.vonet import VONet, VONetConfig

    dev = torch.device(device)
    ds = SyntheticDataset(DPVO_TRAIN_DATA, device=device)
    ds.prerender()
    ates = []
    for seed in range(n_seeds):
        stages = [{**DPVO_TRAIN, "seed": 2 * seed}, {**DPVO_TRAIN, **DPVO_TRAIN_RESUME, "seed": 2 * seed + 1}]
        net = VONet(VONetConfig(), seed=seed).to(dev)
        t0 = time.perf_counter()
        losses = train_recipe(net, ds, dev, stages)
        wall = time.perf_counter() - t0
        res = port_trained_run(net, f"-seed{seed}", None)
        ates.append(res["ate_rmse_cm"])
        print(f"[seeds] dpvo@train seed {seed}: {len(losses)} iterations in {wall:.3f} s, loss {np.mean(losses[:10]):.4f} -> "
              f"{np.mean(losses[-10:]):.4f}; dpvo@port-trained sim(3) ATE {res['ate_rmse_cm']:.4f} cm "
              f"({'within' if res['ate_rmse_cm'] <= DPVO_ATE_LIMIT_CM else 'above'} {DPVO_ATE_LIMIT_CM} cm)", flush=True)
        stamp(f"dpvo@train seed {seed}")
    print(f"[seeds] dpvo@port-trained over {n_seeds} seeds: ATE {json.dumps([round(a, 4) for a in ates])} cm, mean "
          f"{np.mean(ates):.4f}, min {min(ates):.4f}, max {max(ates):.4f}; {sum(a <= DPVO_ATE_LIMIT_CM for a in ates)} "
          f"within {DPVO_ATE_LIMIT_CM} cm; the committed weights (JAX, one run) 1.4839 cm")
    card = VONet(VONetConfig(), seed=0).to(dev)
    cpu = VONet(VONetConfig(), seed=0).double()
    start = [p.clone() for p in cpu.parameters()]
    first = [{**DPVO_TRAIN, "n_iters": DPVO_WITNESS_STEPS}]
    l32 = train_recipe(card, ds, dev, first)
    l64 = train_recipe(cpu, ds, torch.device("cpu"), first)
    rel = [abs(a - b) / abs(b) for a, b in zip(l32, l64)]
    diff = max(float((a.cpu().double() - b).abs().max()) for a, b in zip(card.parameters(), cpu.parameters()))
    moved = max(float((b - b0).abs().max()) for b, b0 in zip(cpu.parameters(), start))
    print(f"[witness] dpvo@train seed 0, {DPVO_WITNESS_STEPS} steps, the card (float32, K4) against the CPU (float64, "
          f"the twins) on the same batches: losses {json.dumps([round(x, 6) for x in l32])} against "
          f"{json.dumps([round(x, 6) for x in l64])}; relative difference by step "
          f"{json.dumps([float(f'{r:.3e}') for r in rel])}; after the steps the parameters differ by at most "
          f"{diff:.3e}, where the float64 run moved them by at most {moved:.3e}")
    stamp("dpvo@train witness")


class Clock:
    """Host seconds between calls, by name (``laps``)."""

    def __init__(self):
        self.laps, self.t = {}, time.perf_counter()

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        self.laps[name], self.t = now - self.t, now


def neuralrecon_frames(ds):
    """The dataset's frames as NeuralRecon's tracking poses them (the OpenGL
    c2w with y and z flipped, no offset), ground truth attached."""
    from xrdslam_tpu_torch.common.frame import Frame

    frames = []
    for i in range(len(ds)):
        _, rgb, depth, c2w = ds[i]
        cv = np.asarray(c2w, np.float32).copy()
        cv[:3, 1] *= -1
        cv[:3, 2] *= -1
        frames.append(Frame(fid=i, rgb=rgb, depth=depth, init_pose=cv, gt_pose=c2w, rot_rep="quat"))
    return frames


def neuralrecon_fused(cfg, ds, frames, device, params=None):
    """A fresh NeuralRecon over ``frames`` (``do_mapping`` each) on
    ``device``, on ``params`` or its random weights; returns the algorithm."""
    algo = cfg.setup(camera=ds.get_camera(), device=device)
    if params is not None:
        algo.params = params
    for f in frames:
        algo.do_mapping(f)
    return algo


def recon_metrics(ds, mesh, gt_culled, thresh: float):
    """3D metrics of ``mesh`` culled to the frames' frustums against the
    culled exact mesh (``tests/test_neucon_sequence.py``'s protocol), F-score
    and completion ratio at ``thresh``; None without a surface."""
    from xrdslam_tpu_torch.utils.eval_recon import calc_3d_metric
    from xrdslam_tpu_torch.utils.mesh_ops import cull_mesh

    if mesh is None:
        return None
    mesh = cull_mesh(ds, mesh)
    if len(mesh.vertices) == 0:
        return None
    return calc_3d_metric(mesh, gt_culled, n_points=30000, comp_thresh=thresh, f1_thresh=thresh, align=False)


def neuralrecon_test(device) -> dict:
    """``neuralrecon@test``: ``tests/test_neucon_sequence.py`` on ``device``,
    gated at its gates."""
    from xrdslam_tpu_torch.algorithms.neural_recon import NeuralReconConfig
    from xrdslam_tpu_torch.common.synthetic import SyntheticDataset
    from xrdslam_tpu_torch.models.neucon import NeuConModelConfig
    from xrdslam_tpu_torch.utils.mesh_ops import cull_mesh
    from xrdslam_tpu_torch.utils.neucon_train import collect_fragments, scene_sdf_numpy, train_sequence

    ds = SyntheticDataset(NEURALRECON_TEST_DATA, device=str(device))
    cfg = NeuralReconConfig(**NEURALRECON_TEST, model=NeuConModelConfig(**NEURALRECON_TEST_MODEL))
    frames = neuralrecon_frames(ds)
    algo = cfg.setup(camera=ds.get_camera(), device=device)
    clock = Clock()
    frags = collect_fragments(algo, frames)
    if len(frags) < 3:
        raise RuntimeError(f"neuralrecon@test: {len(frags)} fragments, the test wants >= 3")
    clock("fragments")
    reset_all_launches()
    params, losses = train_sequence(algo, frags, scene_sdf_numpy("simple"), epochs=2,
                                    steps_per_fragment=NEURALRECON_TEST_STEPS)
    clock("train")  # the losses' readback waits for the device
    check_neuralrecon_launches("neuralrecon@test", algo, frags, len(losses))
    gt_culled = cull_mesh(ds, ds.gt_mesh())
    clock("gt_cull")
    thresh = NEURALRECON_TEST_MODEL["voxel_size"]
    trained = recon_metrics(ds, neuralrecon_fused(cfg, ds, frames, device, params).get_mesh(), gt_culled, thresh)
    random = recon_metrics(ds, neuralrecon_fused(cfg, ds, frames, device).get_mesh(), gt_culled, thresh)
    clock("fused_and_metrics")
    rep = {"fragments": len(frags), "steps": len(losses), "seconds": clock.laps, "loss_first": losses[0],
           "loss_last": losses[-1], "trained": trained, "random": random}
    print(f"[neuralrecon] test: {json.dumps(rep)}")
    fails = []
    if not (np.isfinite(losses).all() and losses[-1] < NEURALRECON_LOSS_DROP * losses[0]):
        fails.append(f"loss {losses[0]:.4f} -> {losses[-1]:.4f}, not below {NEURALRECON_LOSS_DROP} x")
    if trained is None:
        fails.append("the trained weights gave no surface")
    else:
        fails += [f"{k} {trained[k]:.3f}" for k, lim in NEURALRECON_TEST_GATES.items()
                  if not (trained[k] > lim if k == "f1_pct" else trained[k] < lim)]
        if random is not None and not (trained["f1_pct"] > 1.5 * random["f1_pct"]
                                       or trained["accuracy_cm"] < 0.5 * random["accuracy_cm"]):
            fails.append("no margin over random weights")
    print(f"[gate] neuralrecon@test: loss {losses[0]:.4f} -> {losses[-1]:.4f} (< {NEURALRECON_LOSS_DROP} x); "
          f"trained against {NEURALRECON_TEST_GATES} and 1.5 x random F1 or half its accuracy: "
          f"{'pass' if not fails else fails}")
    if fails:
        raise RuntimeError(f"neuralrecon@test: {fails}")
    return rep


def check_neuralrecon_launches(name: str, algo, frags, steps: int) -> int:
    """A training run's K4 launches (the back-projection's gradient: one a
    view and level a step) against the schedule; returns them."""
    from xrdslam_tpu_torch.ops import scatter as sc

    views = {int(f["imgs"].shape[0]) for f in frags}
    want = steps * views.pop() * algo.model.config.n_layer
    got = sc.LAUNCHES["scatter_add"]
    print(f"[launches] {name}: scatter_add {got}; schedule {want} ({steps} steps); by rows "
          f"{json.dumps({str(k): v for k, v in sorted(sc.LAUNCHES_BY_ROWS.items())})}")
    if got != want or views:
        raise RuntimeError(f"{name}: scatter_add launches {got} != {want}")
    return got


def backproject_calls(model, params, dev, targets):
    """The scatter_add calls of one training step on a fragment's device
    inputs ``dev`` (the step is made): [(idx, g, rows)]."""
    from xrdslam_tpu_torch.ops import scatter as sc

    calls, shipped = [], sc.scatter_add

    def keep(idx, g, rows):
        calls.append((idx.detach().clone(), g.detach().clone(), rows))
        return shipped(idx, g, rows)

    sc.scatter_add = keep
    try:
        model.value_and_grad(params, *dev, None, *targets)
    finally:
        sc.scatter_add = shipped
    return calls


def neuralrecon_fragments(algo, frames) -> int:
    """The fragments the host gating predicts over ``frames``: a fragment
    each time ``mapping_window_size`` + 1 keyframes have gathered."""
    from xrdslam_tpu_torch.algorithms.neural_recon import keyframe_passes

    cfg, n, pending = algo.config, 0, []
    for f in frames:
        if not pending or keyframe_passes(pending[-1].get_pose(), f.get_pose(), cfg.min_angle, cfg.min_distance):
            pending.append(f)
        if len(pending) > cfg.mapping_window_size:
            n, pending = n + 1, []
    return n


def profile_neuralrecon(algo, frames) -> None:
    """One fragment of the run's first fragment's views, whole (the host
    inputs, the uploads, the step, the readback and the host writes) and by
    stage: the host inputs, the uploads, the backbone, then each level's
    back-projection, U-Net and ConvGRU, and the readback and writes; each
    stage on the inputs the step gave it. The writes repeat the fragment's
    into the finished run's volumes."""
    import torch

    from xrdslam_tpu_torch.models import neucon as N
    from xrdslam_tpu_torch.models.vonet import fp32_convolutions
    from xrdslam_tpu_torch.utils.neucon_train import level_targets, scene_sdf_numpy

    from xrdslam_tpu_torch.algorithms.neural_recon import keyframe_passes

    model, params, cfg = algo.model, algo.params, algo.config
    window = []
    for f in frames:  # the first fragment's views, by the run's gating
        if not window or keyframe_passes(window[-1].get_pose(), f.get_pose(), cfg.min_angle, cfg.min_distance):
            window.append(f)
        if len(window) > algo.config.mapping_window_size:
            break
    inputs = algo._fragment_inputs(window)
    imgs, projs, origin, origin_vox, _ = inputs
    dev = algo.upload_fragment(imgs, projs, origin, origin_vox)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = model.fragment_step(params, *dev)
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    keep = []
    with torch.no_grad(), fp32_convolutions():
        model._levels(params, dev[0], dev[1], dev[2], dev[3], keep=keep)

    def fragment():
        algo.write_fragment(origin_vox, *model.fragment_step(params, *algo.upload_fragment(
            *algo._fragment_inputs(window)[:4])))

    def staged(fn):
        def call():
            with torch.no_grad(), fp32_convolutions():
                return fn()
        return call

    phases = {"fragment": fragment, "inputs": lambda: algo._fragment_inputs(window),
              "upload": lambda: algo.upload_fragment(imgs, projs, origin, origin_vox),
              "step": lambda: model.fragment_step(params, *dev),
              "backbone": staged(lambda: N.backbone2d_apply(params["backbone"], dev[0]))}
    for i, k in enumerate(keep):
        phases[f"back_project{i}"] = staged(lambda k=k: N.back_project(k["vox_w"], k["feats"], k["KRcam"]))
        phases[f"unet{i}"] = staged(lambda k=k, i=i: N.unet3d_apply(params[f"unet{i}"], k["vol"]))
        phases[f"gru{i}"] = staged(lambda k=k, i=i: N.convgru_apply(params[f"gru{i}"], k["hidden"], k["feat"]))
    phases["write"] = lambda: algo.write_fragment(origin_vox, *out)
    tsdf_t, occ_t = level_targets(model.config, origin, scene_sdf_numpy("office"), window, algo.camera,
                                  algo.device)
    phases["train_step"] = lambda: model.value_and_grad(params, *dev, None, tsdf_t, occ_t)
    crop_mib = sum(h.numel() * 4 for h in dev[3]) / 2**20
    print(f"[neuralrecon] fragment: {len(window)} views of {tuple(imgs.shape[1:3])}, volumes "
          f"{[k['vol'].shape[2] for k in keep]}^3, hidden crops {crop_mib:.1f} MiB each way, step's peak "
          f"{peak:.3f} GiB above its inputs")
    profile_phases("neuralrecon@registry", phases)


def neuralrecon_runs(office: str) -> tuple:
    """NeuralRecon on the card: ``neuralrecon@test``, then the registry's
    entry at full width through the runner (``neuralrecon@registry``:
    fragments as the host gating predicts, finite volumes, the fragment
    profile, the mesh), then ``neuralrecon@train96``; the training runs'
    K4 launches held to their schedule, and K4 checked at the largest
    shape they give it. Returns (the K4 record, its launches by name)."""
    import torch

    from xrdslam_tpu_torch.configs.registry import algorithm_configs
    from xrdslam_tpu_torch.models.neucon import OUT_CHANNELS
    from xrdslam_tpu_torch.ops import scatter as sc
    from xrdslam_tpu_torch.utils.neucon_train import (collect_fragments, level_targets, scene_sdf_numpy,
                                                      train_sequence)

    device = torch.device("cuda")
    neuralrecon_test(device)
    stamp("neuralrecon@test")
    torch.cuda.empty_cache()
    pipeline, res = run_slam("neuralRecon", f"n_frames={NEURALRECON_FRAMES},{office}", tag="@registry")
    algo, ds = pipeline.algorithm, pipeline.dataset
    frames = neuralrecon_frames(ds)
    want = neuralrecon_fragments(algo, frames)
    vols = [algo.tsdf_vol, algo.occ_vol] + algo.hidden_vols
    finite = all(v.data is not None and np.isfinite(v.data).all() for v in vols)
    t0 = time.perf_counter()
    mesh = algo.get_mesh()
    rep = {"fragments": algo.fragment_id, "host_gating": want, "finite": finite,
           "tsdf_shape": list(algo.tsdf_vol.data.shape) if algo.tsdf_vol.data is not None else None,
           "occupied": int((algo.occ_vol.data > 0).sum()) if algo.occ_vol.data is not None else 0,
           "mesh_vertices": 0 if mesh is None else len(mesh.vertices), "get_mesh_s": time.perf_counter() - t0,
           "peak_mem_gib": res["peak_mem_gib"], "wall_s": res["wall_s"], "mapping": res["phases"].get("mapping")}
    print(f"[neuralrecon] registry: {json.dumps(rep)}")
    print(f"[gate] neuralrecon@registry: {algo.fragment_id} fragments against the host gating's {want}; finite "
          f"volumes {finite}")
    if algo.fragment_id != want or want < 1 or not finite:
        raise RuntimeError(f"neuralrecon@registry: {rep}")
    profile_neuralrecon(algo, frames)
    stamp("neuralrecon@registry run and profile")
    del pipeline, algo
    torch.cuda.empty_cache()

    cfg = copy.deepcopy(algorithm_configs["neuralRecon"].xrdslam.algorithm)
    for path, value in NEURALRECON_TRAIN96.items():
        setattr(cfg, path.split(".")[-1], value)
    algo = cfg.setup(camera=ds.get_camera(), device=device)
    clock = Clock()
    frags = collect_fragments(algo, frames)
    clock("fragments")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    params, losses = train_sequence(algo, frags, scene_sdf_numpy("office"), epochs=1,
                                    steps_per_fragment=NEURALRECON_TRAIN96_STEPS)
    clock("train")
    peak = torch.cuda.max_memory_allocated() / 2**30
    check_neuralrecon_launches("neuralrecon@train96", algo, frags, len(losses))
    by_rows = dict(sc.LAUNCHES_BY_ROWS)
    # K4 at the 96^3 level's shape: the first view's four corner gathers, on
    # a real gradient of the first fragment at the trained weights
    fr = frags[0]
    hiddens = [torch.zeros(d, d, d, c, device=device) for (_, d), c in zip(algo.level_los(fr["origin_vox"]),
                                                                        OUT_CHANNELS)]
    targets = level_targets(algo.model.config, fr["vol_origin"].cpu().numpy(), scene_sdf_numpy("office"),
                            fr["frames"], algo.camera, device)
    calls = backproject_calls(algo.model, params, (fr["imgs"], fr["projs"], fr["vol_origin"], hiddens), targets)
    idx, g, rows = max(calls, key=lambda c: (c[0].shape[0], c[2]))
    name = "scatter_add[neuralrecon@train96 back-projection]"
    per_row = np.bincount(idx.cpu().numpy(), minlength=rows)
    print(f"[neuralrecon] {name}: {idx.shape[0]} ids x {g.shape[1]} into {rows} rows; {int((per_row > 0).sum())} "
          f"rows hit, the longest {int(per_row.max())}; launches at these rows in the run: {by_rows.get(rows, 0)}")
    record = {"name": name, "route": "cuda", "source": "xrdslam_tpu_torch/kernels/scatter.cu",
              "replaces": "xrdslam_tpu/ops/pallas_scatter.py:38", "counter": name,
              "shape": [int(idx.shape[0]), int(g.shape[1]), rows], **scatter_case(name, idx, g, rows, device)}
    del calls, idx, g, targets, frags
    clock("k4_check")
    gt_culled = culled_gt_mesh(ds)
    clock("gt_cull")
    mesh = neuralrecon_fused(cfg, ds, frames, device, params).get_mesh()
    clock("fused_trained")
    trained = recon_metrics(ds, mesh, gt_culled, 0.05)
    clock("metrics_trained")
    random = recon_metrics(ds, neuralrecon_fused(cfg, ds, frames, device).get_mesh(), gt_culled, 0.05)
    clock("fused_and_metrics_random")
    rep = {"fragments": len(losses) // NEURALRECON_TRAIN96_STEPS, "steps": len(losses), "seconds": clock.laps,
           "peak_mem_gib": peak, "losses": losses, "trained": trained, "random": random}
    print(f"[neuralrecon] train96: {json.dumps(rep)}")
    ok = np.isfinite(losses).all() and losses[-1] < losses[0]
    print(f"[gate] neuralrecon@train96: loss {losses[0]:.4f} -> {losses[-1]:.4f}: {'pass' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"neuralrecon@train96: the loss did not fall: {losses}")
    stamp("neuralrecon@train96")
    del algo, params
    torch.cuda.empty_cache()
    return [record], {record["counter"]: by_rows.get(record["shape"][2], 0)}


T0 = time.perf_counter()


def stamp(what: str) -> None:
    print(f"[elapsed] {what}: {time.perf_counter() - T0:.1f} s", flush=True)


# The default run's second process: ``chip_smoke.py --per-frame`` (NICE-SLAM's
# and Vox-Fusion's per-frame A/B runs) on the same card, started before
# Co-SLAM's protocol run and joined before Point-SLAM's runs, so that the
# A/Bs' mostly host-bound frames overlap the protocol row's host work and
# SplaTAM's runs. It has CHILD_TIMEOUT_S to finish once joined.
CHILD_ENV = "XRDSLAM_SMOKE_PARENT"
CHILD_TIMEOUT_S = 600


def start_child(argv):
    """``chip_smoke.py argv`` in a second process, beside this one, its
    output kept in a temporary file for ``join_child``; it ends when this
    process ends (``end_with_parent``, and killed at exit)."""
    out = tempfile.TemporaryFile()
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), *argv], cwd=ROOT, stdout=out,
                            stderr=subprocess.STDOUT, env={**os.environ, CHILD_ENV: str(os.getpid())})
    atexit.register(stop_child, proc)
    return proc, out, time.perf_counter()


def stop_child(proc) -> None:
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def join_child(child, what: str) -> None:
    """Wait for a ``start_child`` process (at most CHILD_TIMEOUT_S), print
    its output after a ``[child]`` line (its wall and the wait), and raise
    unless it exited 0."""
    proc, out, t0 = child
    t_wait = time.perf_counter()
    try:
        rc = proc.wait(timeout=CHILD_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        stop_child(proc)
        rc = None
    now = time.perf_counter()
    out.seek(0)
    text = out.read().decode(errors="replace")
    out.close()
    print(f"[child] {what}: exit {rc} after {now - t0:.1f} s, {now - t_wait:.1f} s of them waited for here; "
          f"its output follows")
    print(text, end="" if text.endswith("\n") else "\n", flush=True)
    if rc != 0:
        raise RuntimeError(f"{what}: the second process exited {rc}")


def end_with_parent() -> None:
    """In a ``start_child`` process: be killed when the parent ends
    (Linux's PR_SET_PDEATHSIG), and exit now if it has ended already."""
    import ctypes
    import signal

    ctypes.CDLL(None).prctl(1, signal.SIGKILL)
    if os.getppid() != int(os.environ[CHILD_ENV]):
        raise SystemExit("chip_smoke.py: the parent process has ended")


def main(argv) -> None:
    import torch

    if os.environ.get(CHILD_ENV):
        end_with_parent()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: CUDA is not available")
    from xrdslam_tpu_torch import kernels
    from xrdslam_tpu_torch.common.synthetic import SyntheticDataset, keep_renders
    from xrdslam_tpu_torch.configs.registry import algorithm_configs
    from xrdslam_tpu_torch.models.joint_encoding import JointEncoding
    from xrdslam_tpu_torch.pipeline.slam import resolve_device

    device = resolve_device("cuda")
    keep_renders()  # a run takes the frames an earlier run of the same scene and size traced
    card = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi)

    sources = ("hashgrid", "gaussian_raster", "scatter", "row_gather")
    t0 = time.perf_counter()
    kernels.build_all(sources)
    print(f"[build] {len(sources)} sources in parallel: {time.perf_counter() - t0:.3f} s")
    for src in sources:
        info = kernels.BUILD_INFO[src]
        print(f"[build] {src}.cu: nvcc {info['seconds']:.3f} s")
        print("\n".join("[ptxas] " + ln for ln in str(info["ptxas"]).splitlines() if ln.strip()))
    if argv == ["--slots-probe"]:
        slots_probe(device)
        return
    if argv == ["--raster-variants"]:
        raster_variants(device)
        return
    if argv == ["--determinism-probe"]:
        determinism_probe()
        return
    if argv == ["--niceslam-protocol"]:
        niceslam_protocol()
        return
    if argv == ["--neuralrecon"]:
        records, launches = neuralrecon_runs(f"height={HEIGHT},width={WIDTH},scene=office")
        for r in records:
            r["launches"] = launches[r.pop("counter")]
        print(json.dumps({"kernels": records}))
        return
    if argv[:1] == ["--dpvo-train-seeds"] and len(argv) == 2:
        dpvo_train_seeds(int(argv[1]))
        return
    if argv == ["--ds-eval"]:
        ds_eval_protocol()
        return
    if argv == ["--pointslam-groups"]:
        pointslam_groups_run(f"height={HEIGHT},width={WIDTH},scene=office")
        return
    if argv == ["--per-frame"]:
        office = f"height={HEIGHT},width={WIDTH},scene=office"
        niceslam_per_frame(office, office_bounds(office))
        voxfusion_per_frame(office)
        return
    if argv in (["--dpvo"], ["--dpvo-train"], ["--dpvo-train-full"]):
        office = f"height={HEIGHT},width={WIDTH},scene=office"
        if argv == ["--dpvo"]:
            records, launches = dpvo_runs(office)
        else:
            records, launches = dpvo_train_runs(office, full=argv == ["--dpvo-train-full"])
        for r in records:
            r["launches"] = launches[r.pop("counter")]
        print(json.dumps({"kernels": records}))
        return
    repeats = dict(zip(argv[::2], argv[1::2]))
    repeat_flags = ("--pointslam-repeat", "--protocol-repeat", "--niceslam-seeds", "--voxfusion-seeds")
    if argv and len(argv) % 2 == 0 and set(repeats) <= set(repeat_flags):
        repeat_runs(*(int(repeats.get(k, 0)) for k in repeat_flags))
        return

    # the office spec, as the Co-SLAM run's model builds it
    model_cfg = algorithm_configs["co-slam"].xrdslam.algorithm.model
    ds = SyntheticDataset(f"n_frames=1,height={HEIGHT},width={WIDTH},scene=office")
    spec = JointEncoding(model_cfg, ds.get_camera(), ds.bounds).spec
    print(f"[spec] levels {spec.n_levels}, T=2^{spec.log2_table_size}, res {spec.resolutions}, "
          f"dense {sum(spec.dense)}, dense entries {[(r + 1) ** 3 for r, d in zip(spec.resolutions, spec.dense) if d]}")
    if argv == ["--scatter-variants"]:
        scatter_variants(spec, device)
        return
    if argv == ["--hashgrid-fwd-variants"]:
        hashgrid_fwd_variants(spec, device)
        return
    if argv:
        raise SystemExit(f"chip_smoke.py: unknown arguments {argv}")
    records = check_hashgrid(spec, device)
    records += check_hashgrid_planes(spec, device)
    records += check_scatter_coslam(spec, device)
    stamp("hash-grid kernels checked")
    records += check_scatter_niceslam(device)
    stamp("K4 at NICE-SLAM's shapes checked")
    records += check_scatter_voxfusion(device)
    stamp("K4 at Vox-Fusion's shape checked")
    records += check_raster(device)
    stamp("rasterizer kernels checked")
    records += check_point_table(device)
    stamp("point-table kernels checked")
    torch.cuda.empty_cache()

    office = f"height={HEIGHT},width={WIDTH},scene=office"
    # the reference benchmark's Co-SLAM settings: the registry's entry with
    # the scene's bounds and a keyframe table sized to the run
    bounds = office_bounds(office)
    coslam_data = f"n_frames={COSLAM_FRAMES},{office}"
    bench = {"algorithm.mapping_bound": bounds, "algorithm.max_keyframes": max(COSLAM_FRAMES // 5 + 2, 8)}
    # the exact hash grid (K1-K3), an option of the registry's entry; K1's
    # launches by N are the wrapper's own count (FWD_LAUNCHES_BY_N), and the
    # first inputs at each N are kept to time K1 on them after the run
    from xrdslam_tpu_torch.ops import hashgrid_fast as hf

    fwd_inputs, shipped_fwd = {}, hf.hashgrid_fwd

    def keep_first_inputs(table, x, spec):
        if x.shape[0] not in fwd_inputs:
            fwd_inputs[x.shape[0]] = (table.detach().clone(), x.detach().clone(), spec)
        return shipped_fwd(table, x, spec)

    hf.hashgrid_fwd = keep_first_inputs
    try:
        pipeline, res = run_slam("co-slam", coslam_data, ("hashgrid_fwd", "hashgrid_bwd_dx", "hashgrid_bwd_dtable",
                                                          "hashgrid_bwd_dx_dtable"),
                                 {**bench, "algorithm.model.hash_packed": False}, ATE_LIMIT_CM, tag="@exact")
    finally:
        hf.hashgrid_fwd = shipped_fwd
    launches = dict(res["launches"])
    through_groups(res)
    by_n = res["hashgrid_fwd_by_n"]
    print(f"[launches] co-slam@exact hashgrid_fwd by N: {json.dumps(by_n)}")
    if sum(by_n.values()) != launches["hashgrid_fwd"] or set(by_n) != {str(n) for n in fwd_inputs}:
        raise RuntimeError(f"co-slam@exact: K1's launches by N {by_n} do not sum to its {launches['hashgrid_fwd']} "
                           f"launches or miss an N it was called at ({sorted(fwd_inputs)})")
    next(r for r in records if r["name"] == "hashgrid_fwd")["by_n"] = fwd_by_n(by_n, fwd_inputs)
    del fwd_inputs
    check_group_replay(pipeline, "co-slam@exact", exact=True)
    steady = {"co-slam@exact": [res["steady_s_per_frame"], res["groups"]["group_frame_s_median"]]}
    profile_coslam(pipeline, "co-slam@exact")
    stamp("co-slam@exact run and profile")
    del pipeline
    torch.cuda.empty_cache()
    # Co-SLAM's main path: the registry's default, the packed hash (K4 as
    # its tables' gradient), and the accuracy protocol's tri-plane
    coslam_runs = (
        ("@packed", coslam_data, None, bench),
        ("@protocol", f"n_frames={PROTOCOL_FRAMES},{office}", protocol_config(bounds), None),
    )
    for tag, data, config, overrides in coslam_runs:
        if tag == "@protocol":
            per_frame = start_child(["--per-frame"])  # NICE-SLAM's and Vox-Fusion's per-frame A/Bs
        pipeline, res = run_slam("co-slam", data, ("scatter_add",), overrides, ATE_LIMIT_CM, tag=tag, config=config,
                                 sweep=tag == "@protocol")
        model = pipeline.algorithm.model
        encoding = "triplane" if model.tp_spec is not None else "packed"
        want = coslam_scatter_schedule(config or algorithm_configs["co-slam"], res["frames"], encoding)
        through_groups(res)
        print(f"[launches] co-slam{tag}: {json.dumps(res['launches'])}; schedule scatter_add {want}")
        if res["launches"]["scatter_add"] != want:
            raise RuntimeError(f"co-slam{tag}: scatter_add launches {res['launches']['scatter_add']} != {want}")
        launches[f"scatter_add[co-slam{tag}]"] = res["launches"]["scatter_add"]
        steady[f"co-slam{tag}"] = [res["steady_s_per_frame"], res["groups"]["group_frame_s_median"]]
        if tag == "@protocol":
            protocol_row(pipeline, res["ate_rmse_cm"])
            ds_eval_run(pipeline, DS_EVAL_VIEWS)
            stamp("co-slam protocol row and ds-eval")
        check_group_replay(pipeline, f"co-slam{tag}", exact=False)
        profile_coslam(pipeline, f"co-slam{tag}")
        stamp(f"co-slam{tag} run and profile")
        del pipeline, model
        torch.cuda.empty_cache()
    # the registry's default again on its first COSLAM_PER_FRAME_FRAMES
    # frames, every frame through the per-frame path (the A/B hatch): the
    # per-frame steady s/frame beside the group path's
    os.environ["XRDSLAM_DISABLE_SUPER"] = "1"
    try:
        pipeline, res = run_slam("co-slam", f"n_frames={COSLAM_PER_FRAME_FRAMES},{office}", ("scatter_add",), bench,
                                 ATE_LIMIT_CM, tag="@packed-per-frame")
    finally:
        del os.environ["XRDSLAM_DISABLE_SUPER"]
    want = coslam_scatter_schedule(algorithm_configs["co-slam"], res["frames"], "packed")
    if res["launches"]["scatter_add"] != want or res["groups"]["groups"]:
        raise RuntimeError(f"co-slam@packed-per-frame: {res['groups']['groups']} groups, scatter_add launches "
                           f"{res['launches']['scatter_add']} (schedule {want})")
    steady["co-slam@packed-per-frame"] = [res["steady_s_per_frame"], None]
    print(f"[steady] s/frame, by the steady rule and the median group frame: {json.dumps(steady)}")
    stamp("co-slam@packed-per-frame run")
    del pipeline
    torch.cuda.empty_cache()
    splatam_data = f"n_frames={SPLATAM_FRAMES},{office}"
    # SplaTAM's accuracy at full width (see SPLATAM_GATE), through the group
    # path (frames 2-18, one CUDA graph replay a frame)
    raster = ("raster_fwd", "raster_bwd", "scatter_add")
    pipeline, res = run_slam("splaTAM", splatam_data, raster, overrides=SPLATAM_GATE, ate_limit_cm=ATE_LIMIT_CM,
                             tag="@k512")
    check_splatam_run(pipeline, res, groups=True)
    launches.update({f"{name}[k512]": n for name, n in res["launches"].items()})
    steady = {"splaTAM@k512": [res["steady_s_per_frame"], res["groups"]["group_frame_s_median"]]}
    check_group_replay(pipeline, "splaTAM@k512", exact=False, spread=True)
    order_choice(pipeline)
    profile_steps(pipeline, "splaTAM@k512")
    stamp("splaTAM@k512 run, replay check and profile")
    del pipeline
    torch.cuda.empty_cache()
    # the same, every frame through the per-frame path (the A/B hatch)
    os.environ["XRDSLAM_DISABLE_SUPER"] = "1"
    try:
        pipeline, res = run_slam("splaTAM", splatam_data, raster, overrides=SPLATAM_GATE, ate_limit_cm=ATE_LIMIT_CM,
                                 tag="@k512-per-frame")
    finally:
        del os.environ["XRDSLAM_DISABLE_SUPER"]
    check_splatam_run(pipeline, res, groups=False)
    steady["splaTAM@k512-per-frame"] = [res["steady_s_per_frame"], None]
    stamp("splaTAM@k512-per-frame run")
    del pipeline
    torch.cuda.empty_cache()
    # the main path: full width, registry settings (ATE reported, not gated)
    pipeline, res = run_slam("splaTAM", splatam_data, raster)
    check_splatam_run(pipeline, res, groups=True)
    launches.update(res["launches"])
    steady["splaTAM"] = [res["steady_s_per_frame"], res["groups"]["group_frame_s_median"]]
    profile_steps(pipeline, "splaTAM")
    stamp("splaTAM run and profile")
    del pipeline
    torch.cuda.empty_cache()
    # clone/split densification through groups (see DENSIFY): finite, and
    # the count grows inside the mapping program
    pipeline, res = run_slam("splaTAM", f"n_frames={DENSIFY_FRAMES},{office}", raster,
                             overrides={**SPLATAM_GATE, **DENSIFY}, tag="@densify")
    check_splatam_run(pipeline, res, groups=True)
    if not np.isfinite(res["ate_rmse_cm"]):
        raise RuntimeError(f"splaTAM@densify: ATE {res['ate_rmse_cm']}")
    densify_check(pipeline)
    print(f"[steady] SplaTAM s/frame, by the steady rule and the median group frame: {json.dumps(steady)}")
    stamp("splaTAM@densify run")
    del pipeline
    torch.cuda.empty_cache()
    join_child(per_frame, "--per-frame")
    stamp("NICE-SLAM's and Vox-Fusion's per-frame A/B runs (second process) joined")
    # Point-SLAM's main path: full width, registry settings
    pipeline, res = run_slam("point-slam", f"n_frames={POINTSLAM_FRAMES},{office}", ("row_gather", "scatter_add"),
                             ate_limit_cm=ATE_LIMIT_CM)
    want = pointslam_schedule(algorithm_configs["point-slam"], POINTSLAM_FRAMES)
    print(f"[launches] point-slam: {json.dumps(res['launches'])}; schedule {json.dumps(want)}")
    if res["launches"] != want:
        raise RuntimeError(f"point-slam: launches {res['launches']} differ from the schedule {want}")
    launches["row_gather"] = res["launches"]["row_gather"]
    launches["scatter_add[point-slam]"] = res["launches"]["scatter_add"]
    stamp("point-slam run")
    pointslam_mesh(pipeline, "point-slam", metrics=False)
    stamp("point-slam mesh")
    pipeline.algorithm.config.mapping_n_iters = POINTSLAM_PROFILE_MAP_ITERS
    check_pointslam_group(pipeline, "point-slam", POINTSLAM_FRAMES, do_kf=True)
    stamp("point-slam group replay")
    profile_pointslam(pipeline)
    stamp("point-slam profile")
    del pipeline
    torch.cuda.empty_cache()
    launches.update(niceslam_runs(office, bounds))
    launches.update(voxfusion_runs(office))
    dpvo_records, dpvo_launches = dpvo_runs(office)
    records += dpvo_records
    launches.update(dpvo_launches)
    train_records, train_launches = dpvo_train_runs(office)
    records += train_records
    launches.update(train_launches)
    neuralrecon_records, neuralrecon_launches = neuralrecon_runs(office)
    records += neuralrecon_records
    launches.update(neuralrecon_launches)
    for r in records:
        counter = r.pop("counter")
        r["launches"] = 0 if counter is None else launches[counter]
        # what a launch costs the host beyond the card's own time
        print(f"[launch] {r['name']}: CUDA events {r['ms']:.4f} ms, device {r['device_ms']:.4f} ms, "
              f"events - device {1e3 * (r['ms'] - r['device_ms']):.1f} us")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main(sys.argv[1:])
