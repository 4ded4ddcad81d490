"""DPVO: sparse patch-graph visual odometry (monocular, no mapping).

Counterpart of ``xrdslam_tpu/algorithms/dpvo.py``. The edge graph lives
on the host as numpy (it changes every frame: appends, removals, frame
shifts), and so do the poses and patches; each update runs on the device
over an edge table padded to a power-of-two bucket:

    reproject -> two-level patch correlation -> update operator ->
    Gauss-Newton bundle adjustment over a window of poses -> point cloud

The feature rings (``fmap1``, ``fmap2``, ``gmap``, ``imap``) and each
edge's hidden state ``net`` live on the device and are written in place
or indexed there. An update uploads its window's poses and patches and
one packed table of the edges' indices, and reads back the window's new
poses, patches and points. Every segment and block sum of the update goes
through ``scatter_add`` (K4 on the card): four in the update operator,
four in each of the bundle adjuster's two iterations.

The pipeline calls ``dispatch_tracking`` and ``finish_tracking``; they
carry the reference's ``do_tracking``: detect the frame's patches, probe
the motion before initialisation, add the frame's edges, initialise with
12 updates at ``init_frame_num`` frames, then one update and the keyframe
test a frame. ``n_updates`` and ``n_probes`` count the device programs,
``buckets`` them by padded edge count.

Patch centres and initial depths come from ``np.random.default_rng(3407)``
in the reference's order, so both packages draw the same patches. The
multi-device path of the reference is not ported.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple, Type

import numpy as np
import torch
from torch.nn import functional as F

from ..common.camera import Camera
from ..common.frame import Frame, upload
from ..models.vonet import VONetConfig
from ..ops import lie_np
from ..ops.ba import bundle_adjust
from ..ops.correlation import bilinear_sample, extract_patches, patch_correlation_chunked
from ..ops.projective import flow_mag, point_cloud, reproject
from .base import Algorithm, AlgorithmConfig

UPDATE_SCATTERS = 12  # scatter_add launches of an update: 4 in the update operator, 4 x 2 in the bundle adjuster
PROBE_SCATTERS = 4  # of a motion probe: the update operator's


@dataclass
class DPVOConfig(AlgorithmConfig):
    """The reference's DPVOConfig."""

    _target: Type = field(default_factory=lambda: DPVO)
    patch_per_frame: int = 96
    patch_lifetime: int = 13
    init_frame_num: int = 8
    gradient_bias: bool = False
    optimization_window: int = 10
    keyframe_index: int = 4
    keyframe_thresh: float = 15.0
    removal_window: int = 22
    motion_damping: float = 0.5
    motion_init_thresh: float = 2.0  # the least median update to accept a frame before initialisation
    buffer_size: int = 2048
    mem: int = 32
    edge_chunk: int = 2048
    model: VONetConfig = field(default_factory=VONetConfig)
    rot_rep: str = "quat"


def _round_bucket(n: int, base: int = 1024) -> int:
    """The least ``base * 2^k`` that holds ``n``."""
    c = base
    while c < n:
        c *= 2
    return c


def neighbors(kk: np.ndarray, jj: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """For each edge, the edge of the same patch whose target is ``jj - 1``
    (``ix``) and ``jj + 1`` (``jx``), -1 where there is none; of equal
    (patch, target) pairs the last edge. The reference's dict loop, by one
    stable sort and two binary searches."""
    if len(kk) == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    span = int(jj.max()) + 3  # target + 1 lies in [0, span)
    keys = kk.astype(np.int64) * span + (jj.astype(np.int64) + 1)
    order = np.argsort(keys, kind="stable")
    ordered = keys[order]

    def find(q):
        pos = np.searchsorted(ordered, q, side="right") - 1
        hit = (pos >= 0) & (ordered[np.maximum(pos, 0)] == q)
        return np.where(hit, order[np.maximum(pos, 0)], -1).astype(np.int64)

    return find(keys - 1), find(keys + 1)


class DPVO(Algorithm):
    config: DPVOConfig

    def __init__(self, config: DPVOConfig, camera: Camera, device: torch.device) -> None:
        super().__init__(config, camera, device)
        self.model = config.model.setup().to(self.device)
        self.P, self.RES, self.DIM = self.model.P, self.model.RES, self.model.DIM
        self.M = config.patch_per_frame
        self.N = config.buffer_size
        self.mem = config.mem
        # the bundle adjuster's window: edges reach back removal_window
        # frames, and 4 more hold the frame just appended
        self.W_BA = config.removal_window + 4
        # the image cropped to a multiple of 16
        self.ht = camera.height - camera.height % 16
        self.wd = camera.width - camera.width % 16
        self.h4, self.w4 = self.ht // self.RES, self.wd // self.RES
        self.intrinsics4 = np.array([camera.fx, camera.fy, camera.cx, camera.cy], np.float32) / self.RES
        self._intr_dev = torch.as_tensor(self.intrinsics4, device=self.device)

        # host state
        self.n = 0  # active frames
        self.m = 0  # active patches
        self.counter = 0  # frames seen
        self.tlist = []
        self.tstamps = np.zeros(self.N, np.int64)
        self.poses_t = np.zeros((self.N, 3), np.float32)
        self.poses_q = np.zeros((self.N, 4), np.float32)
        self.poses_q[:, 0] = 1.0
        self.patches = np.zeros((self.N, self.M, self.P, self.P, 3), np.float32)  # (u, v, inv_depth) at 1/4
        self.colors = np.zeros((self.N, self.M, 3), np.float32)
        self.points = np.zeros((self.N * self.M, 3), np.float32)
        self.delta: Dict[int, Tuple[int, np.ndarray]] = {}  # skipped frames: t -> (t0, T_t T_t0^-1)
        self.ii = np.zeros(0, np.int64)  # the patch's frame
        self.jj = np.zeros(0, np.int64)  # the target frame
        self.kk = np.zeros(0, np.int64)  # the patch
        self.n_updates = 0
        self.n_probes = 0
        self.buckets: Dict[int, int] = {}  # padded edge count -> updates and probes run at it

        # device state
        dev = self.device
        self.net = torch.zeros((0, self.DIM), dtype=torch.float32, device=dev)  # each edge's hidden state
        self.imap_ring = torch.zeros((self.mem, self.M, self.DIM), device=dev)
        self.gmap_ring = torch.zeros((self.mem, self.M, 128, self.P, self.P), device=dev)
        self.fmap1_ring = torch.zeros((self.mem, 128, self.h4, self.w4), device=dev)
        self.fmap2_ring = torch.zeros((self.mem, 128, self.h4 // 4, self.w4 // 4), device=dev)
        self._rng = np.random.default_rng(3407)

    # ------------------------------------------------------------ features
    @torch.no_grad()
    def detect(self, image: torch.Tensor, centers: torch.Tensor):
        """A frame's features and patches: image [3, H, W], centers [M, 2]
        at 1/4 resolution -> (fmap, fmap2, gmap [M, 128, P, P], imap [M,
        DIM], colours [M, 3])."""
        fmap, imap_full = self.model.extract_features(image)
        gmap = extract_patches(fmap, centers, p=3)
        imap = bilinear_sample(imap_full, centers)
        clr = bilinear_sample(image, 4.0 * (centers + 0.5))
        fmap2 = F.avg_pool2d(fmap[None], 4, 4)[0]
        return fmap, fmap2, gmap, imap, clr

    def detect_patches(self, cur_frame: Frame) -> None:
        """Extract the frame's features, draw its patch centres, set their
        depths and predict its pose (damped constant velocity)."""
        img = np.ascontiguousarray(cur_frame.rgb[: self.ht, : self.wd].transpose(2, 0, 1), np.float32)
        if self.config.gradient_bias:
            gray = cur_frame.rgb[: self.ht, : self.wd].sum(-1)
            gx = np.abs(np.diff(gray, axis=1))[:-1]
            gy = np.abs(np.diff(gray, axis=0))[:, :-1]
            g = np.sqrt(gx**2 + gy**2)
            g = g[: self.h4 * 4, : self.w4 * 4].reshape(self.h4, 4, self.w4, 4).mean((1, 3))
            x = self._rng.integers(1, self.w4 - 1, 3 * self.M)
            y = self._rng.integers(1, self.h4 - 1, 3 * self.M)
            order = np.argsort(g[y, x])
            x, y = x[order[-self.M:]], y[order[-self.M:]]
        else:
            x = self._rng.integers(1, self.w4 - 1, self.M)
            y = self._rng.integers(1, self.h4 - 1, self.M)
        centers = upload(np.stack([x, y], -1).astype(np.float32), self.device)
        fmap, fmap2, gmap, imap, clr = self.detect(upload(img, self.device), centers)
        slot = self.n % self.mem
        self.fmap1_ring[slot] = fmap
        self.fmap2_ring[slot] = fmap2
        self.gmap_ring[slot] = gmap
        self.imap_ring[slot] = imap

        self.tlist.append(cur_frame.fid)
        self.tstamps[self.n] = self.counter
        self.colors[self.n] = clr.cpu().numpy()

        d = np.arange(self.P, dtype=np.float32) - self.P // 2
        dy, dx = np.meshgrid(d, d, indexing="ij")
        uv = np.stack([x[:, None, None] + dx, y[:, None, None] + dy], -1)
        patches = np.concatenate([uv, np.ones((self.M, self.P, self.P, 1), np.float32)], -1)
        if self.is_initialized():
            patches[..., 2] = np.median(self.patches[max(self.n - 3, 0): self.n, ..., 2])
        else:
            patches[..., 2] = np.exp(self._rng.uniform(-1.0, 1.0, (self.M, 1, 1)))
        self.patches[self.n] = patches

        if self.n > 1:
            P1 = lie_np.pose_matrix(self.poses_t[self.n - 1], self.poses_q[self.n - 1])
            P2 = lie_np.pose_matrix(self.poses_t[self.n - 2], self.poses_q[self.n - 2])
            xi = self.config.motion_damping * lie_np.se3_log(P1 @ np.linalg.inv(P2))
            self.poses_t[self.n], self.poses_q[self.n] = lie_np.pose_tq(lie_np.se3_exp(xi) @ P1)
        elif self.n == 1:
            self.poses_t[self.n] = self.poses_t[0]
            self.poses_q[self.n] = self.poses_q[0]

    # ------------------------------------------------------------- graph
    def _ix(self, kk: np.ndarray) -> np.ndarray:
        return kk // self.M

    def edges_forw(self):
        r = self.config.patch_lifetime
        t0, t1 = self.M * max(self.n - r, 0), self.M * max(self.n - 1, 0)
        kk, jj = np.meshgrid(np.arange(t0, t1), np.arange(self.n - 1, self.n), indexing="ij")
        return kk.ravel(), jj.ravel()

    def edges_back(self):
        r = self.config.patch_lifetime
        t0, t1 = self.M * max(self.n - 1, 0), self.M * self.n
        kk, jj = np.meshgrid(np.arange(t0, t1), np.arange(max(self.n - r, 0), self.n), indexing="ij")
        return kk.ravel(), jj.ravel()

    def append_factors(self, kk: np.ndarray, jj: np.ndarray) -> None:
        self.jj = np.concatenate([self.jj, jj])
        self.kk = np.concatenate([self.kk, kk])
        self.ii = np.concatenate([self.ii, self._ix(kk)])
        self.net = torch.cat([self.net, self.net.new_zeros((len(kk), self.DIM))])

    def remove_factors(self, m: np.ndarray) -> None:
        keep = ~m
        self.ii, self.jj, self.kk = self.ii[keep], self.jj[keep], self.kk[keep]
        self.net = self.net[upload(np.flatnonzero(keep), self.device)]

    # ------------------------------------------------------------- update
    def update_inputs(self) -> Optional[dict]:
        """The host half of an update: the edge table padded to its bucket,
        its dense segment ids and neighbours, the window's poses and
        patches, uploaded; None without edges."""
        E_real = len(self.ii)
        if E_real == 0:
            return None
        E = _round_bucket(E_real, self.config.edge_chunk)
        W, M, base = self.W_BA, self.M, max(0, self.n - self.W_BA)

        def pad(a, fill=0):
            return np.concatenate([a, np.full((E - E_real,) + a.shape[1:], fill, a.dtype)])

        _, seg_kk = np.unique(self.kk, return_inverse=True)
        _, seg_ij = np.unique(self.ii * 100003 + self.jj, return_inverse=True)
        ix, jx = neighbors(self.kk, self.jj)
        table = np.stack([
            pad(self.ii - base).clip(0, W - 1), pad(self.jj - base).clip(0, W - 1),
            pad(self.kk - base * M).clip(0, W * M - 1), pad(self.kk % (M * self.mem)), pad(self.jj % self.mem),
            pad(seg_kk.reshape(-1), E), pad(seg_ij.reshape(-1), E), pad(ix, -1), pad(jx, -1),
            (np.arange(E) < E_real).astype(np.int64),
        ]).astype(np.int32)
        window = np.concatenate([self.poses_t[base: base + W].ravel(), self.poses_q[base: base + W].ravel(),
                                 self.patches[base: base + W].ravel()])
        if self.is_initialized():
            t0 = max(self.n - self.config.optimization_window, 1)
        else:
            t0 = 1
        table_d, window_d = upload(table, self.device), upload(window, self.device)
        ii_l, jj_l, kk_l, kk_mem, jj_mem, seg_kk, seg_ij, ix, jx, mask = table_d.unbind(0)
        nt, nq = 3 * W, 4 * W
        net = torch.cat([self.net, self.net.new_zeros((E - E_real, self.DIM))])
        return {"E": E, "E_real": E_real, "base": base, "t0": max(t0 - base, 0 if base > 0 else 1),
                "net": net, "ii": ii_l, "jj": jj_l, "kk": kk_l, "kk_mem": kk_mem, "jj_mem": jj_mem,
                "seg_kk": seg_kk, "seg_ij": seg_ij, "ix": ix, "jx": jx, "mask": mask.bool(),
                "poses_t": window_d[:nt].reshape(W, 3), "poses_q": window_d[nt:nt + nq].reshape(W, 4),
                "patches": window_d[nt + nq:].reshape(W, M, self.P, self.P, 3)}

    def correlate(self, inp: dict) -> Tuple[torch.Tensor, torch.Tensor]:
        """The edges' patch grids reprojected into their targets (coords
        [E, P, P, 2]) and their correlation features [E, 882] on both
        pyramid levels. Padded edges get zeros: the reference correlates
        them too, and the update operator's outputs for the real edges do
        not depend on them (their ids, neighbours and segment are apart)."""
        P, E, n = self.P, inp["E"], inp["E_real"]
        grid = inp["patches"].reshape(-1, P * P, 3)
        coords = reproject(inp["poses_t"], inp["poses_q"], grid[inp["kk"].long()], self._intr_dev,
                           inp["ii"].long(), inp["jj"].long()).reshape(E, P, P, 2)
        gp = self.gmap_ring.reshape(self.mem * self.M, 128, P, P)[inp["kk_mem"][:n].long()]
        jj, chunk = inp["jj_mem"][:n], self.config.edge_chunk
        corr1 = patch_correlation_chunked(self.fmap1_ring, gp, coords[:n], jj, radius=3, chunk=chunk)
        corr2 = patch_correlation_chunked(self.fmap2_ring, gp, coords[:n] / 4.0, jj, radius=3, chunk=chunk)
        corr = torch.zeros((E, 2 * P * P * 49), dtype=corr1.dtype, device=corr1.device)
        corr[:n] = torch.stack([corr1, corr2], -1).reshape(n, -1)
        return coords, corr

    def operator(self, inp: dict, corr: torch.Tensor):
        """The update operator on the padded edges: (net, delta, weight)."""
        ctx = self.imap_ring.reshape(self.mem * self.M, -1)[inp["kk_mem"].long()]
        return self.model.update(inp["net"], ctx, corr, inp["seg_kk"], inp["seg_ij"], inp["ix"], inp["jx"],
                                 inp["mask"], num_segments=inp["E"] + 1)

    def adjust(self, inp: dict, coords: torch.Tensor, delta: torch.Tensor, weight: torch.Tensor):
        """Bundle adjustment towards the corrected targets (two iterations),
        the optimised centre depths spread over each patch, and the patch
        centres' world points: (poses_t, poses_q, patches, points)."""
        P, W, M = self.P, self.W_BA, self.M
        patches = inp["patches"]
        mask = inp["mask"].to(torch.float32)
        target = coords[:, P // 2, P // 2] + delta
        new_t, new_q, centers = bundle_adjust(
            inp["poses_t"], inp["poses_q"], patches.reshape(W * M, P * P, 3)[:, (P * P) // 2], target,
            weight * mask[:, None], inp["ii"].long(), inp["jj"].long(), inp["kk"].long(), self._intr_dev,
            t0=inp["t0"], iterations=2, edge_mask=mask)
        depth = centers[:, 2].reshape(W, M, 1, 1).expand(W, M, P, P)
        patches_out = torch.cat([patches[..., :2], depth[..., None]], -1)
        ctr = patches_out.reshape(W * M, P, P, 3)[:, P // 2, P // 2]
        pts = point_cloud(new_t, new_q, ctr, self._intr_dev, torch.arange(W * M, device=ctr.device) // M)
        return new_t, new_q, patches_out, pts

    @torch.no_grad()
    def _run_update(self, probe: bool = False):
        inp = self.update_inputs()
        if inp is None:
            return None
        self.buckets[inp["E"]] = self.buckets.get(inp["E"], 0) + 1
        coords, corr = self.correlate(inp)
        net, delta, weight = self.operator(inp, corr)
        if probe:
            self.n_probes += 1
            return float(torch.quantile(torch.linalg.norm(delta, dim=-1), 0.5))
        self.n_updates += 1
        new_t, new_q, patches_out, pts = self.adjust(inp, coords, delta, weight)
        base, W, E_real = inp["base"], self.W_BA, inp["E_real"]
        self.net = net[:E_real]
        self.poses_t[base: base + W] = new_t.cpu().numpy()
        self.poses_q[base: base + W] = new_q.cpu().numpy()
        self.patches[base: base + W] = patches_out.cpu().numpy()
        self.points[base * self.M: (base + W) * self.M] = pts.cpu().numpy()
        return None

    def update(self) -> None:
        self._run_update(probe=False)

    def motion_probe(self) -> float:
        """The median update of the new frame's patches into it, with the
        frame inside the window."""
        kk = np.arange(self.m - self.M, self.m)
        saved = (self.ii, self.jj, self.kk, self.net)
        self.kk, self.jj, self.ii = kk, np.full_like(kk, self.n), self._ix(kk)
        self.net = self.net.new_zeros((len(kk), self.DIM))
        self.n += 1
        try:
            mag = self._run_update(probe=True)
        finally:
            self.n -= 1
            self.ii, self.jj, self.kk, self.net = saved
        return mag if mag is not None else 0.0

    def motionmag(self, i: int, j: int) -> float:
        """The mean flow of frame i's edges into frame j, on the host."""
        k = (self.ii == i) & (self.jj == j)
        if not k.any():
            return 0.0
        ctr = self.patches.reshape(self.N * self.M, self.P, self.P, 3)[self.kk[k]][:, self.P // 2, self.P // 2]
        fm = flow_mag(torch.from_numpy(self.poses_t[: self.n + 1]), torch.from_numpy(self.poses_q[: self.n + 1]),
                      torch.from_numpy(ctr)[:, None], torch.from_numpy(self.intrinsics4),
                      torch.from_numpy(self.ii[k]), torch.from_numpy(self.jj[k]), beta=0.5)
        return float(fm.mean())

    def keyframe(self) -> None:
        """Drop frame n - keyframe_index if the motion across it is below
        the threshold (its neighbours' mean flow), shifting the later
        frames down; then drop the edges of frames out of the removal window."""
        i = self.n - self.config.keyframe_index - 1
        j = self.n - self.config.keyframe_index + 1
        m = (self.motionmag(i, j) + self.motionmag(j, i)) / 2.0
        if m < self.config.keyframe_thresh:
            k = self.n - self.config.keyframe_index
            t0, t1 = int(self.tstamps[k - 1]), int(self.tstamps[k])
            Pk = lie_np.pose_matrix(self.poses_t[k], self.poses_q[k])
            Pk1 = lie_np.pose_matrix(self.poses_t[k - 1], self.poses_q[k - 1])
            self.delta[t1] = (t0, Pk @ np.linalg.inv(Pk1))

            self.remove_factors((self.ii == k) | (self.jj == k))
            self.kk[self.ii > k] -= self.M
            self.ii[self.ii > k] -= 1
            self.jj[self.jj > k] -= 1
            for a in (self.tstamps, self.poses_t, self.poses_q, self.colors, self.patches):
                a[k: self.n - 1] = a[k + 1: self.n].copy()
            idx = np.arange(k, self.n - 1)
            src = upload((idx + 1) % self.mem, self.device)
            dst = upload(idx % self.mem, self.device)
            for ring in (self.imap_ring, self.gmap_ring, self.fmap1_ring, self.fmap2_ring):
                ring[dst] = ring[src]
            self.n -= 1
            self.m -= self.M
        self.remove_factors(self._ix(self.kk) < self.n - self.config.removal_window)

    # ----------------------------------------------------------- tracking
    def do_tracking(self, cur_frame: Frame) -> Optional[np.ndarray]:
        """The reference's DPVO step for one frame; the frame's c2w, or None
        for a frame skipped before initialisation."""
        if self.n + 1 >= self.N:
            raise RuntimeError("DPVO buffer full; raise buffer_size")
        self.detect_patches(cur_frame)
        self.counter += 1

        if self.n > 0 and not self.is_initialized():
            if self.motion_probe() < self.config.motion_init_thresh:
                self.delta[self.counter - 1] = (self.counter - 2, np.eye(4))
                return None

        self.n += 1
        self.m += self.M
        self.append_factors(*self.edges_forw())
        self.append_factors(*self.edges_back())

        if self.n == self.config.init_frame_num and not self.is_initialized():
            self.set_initialized()
            for _ in range(12):
                self.update()
            poses, fids = self.get_all_poses()
            for t in range(self.counter - 1):
                self.update_framepose(int(fids[t]) if t < len(fids) else t, poses[t])
        elif self.is_initialized():
            self.update()
            self.keyframe()

        # the last frame: the skipped and removed frames from the delta chain
        if cur_frame.is_final_frame:
            poses, _ = self.get_all_poses()
            for t in range(min(self.counter - 1, len(self.estimate_c2w_list))):
                self.update_framepose(t, poses[t])

        T = lie_np.pose_matrix(self.poses_t[self.n - 1], self.poses_q[self.n - 1])
        return np.linalg.inv(T).astype(np.float32)  # poses are world-to-camera

    def dispatch_tracking(self, cur_frame: Frame):
        """The whole step (DPVO reads its poses back inside each update)."""
        return (self.do_tracking(cur_frame),)

    def finish_tracking(self, handle) -> Optional[np.ndarray]:
        return handle[0]

    def get_all_poses(self):
        """Every frame's c2w, the skipped ones from the delta chain; and the
        active frames' ids."""
        traj = {int(self.tstamps[i]): lie_np.pose_matrix(self.poses_t[i], self.poses_q[i]) for i in range(self.n)}

        def get(t):
            if t in traj:
                return traj[t]
            t0, dP = self.delta[t]
            return dP @ get(t0)

        poses = [np.linalg.inv(get(t)) for t in range(self.counter)]
        return np.stack(poses), np.asarray(self.tlist)

    # ---------------------------------------------------------- mapping --
    def do_mapping(self, cur_frame: Frame) -> None:  # VO only
        if cur_frame.is_final_frame:
            poses, _ = self.get_all_poses()
            for t in range(min(self.counter, len(self.estimate_c2w_list))):
                self.update_framepose(t, poses[t])

    def add_keyframe(self, cur_frame: Frame) -> None:
        pass

    def get_cloud(self, c2w_np=None, gt_depth_np=None):
        """The patch centres' world points and colours, without points
        behind the camera or beyond 10x the median depth."""
        pos = self.points[: self.m]
        rgb = np.clip(self.colors[: self.n].reshape(-1, 3), 0, 1)
        if len(pos) == 0:
            return pos, rgb
        med = np.median(pos[:, 2])
        keep = (pos[:, 2] <= med * 10) & (pos[:, 2] > 0)
        return pos[keep], rgb[: len(pos)][keep]
