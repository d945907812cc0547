"""Each covered stage worked out again from the state the port held going
into it.

A run of the port is a chaotic function of rounding, so the reference does
not replay it from frame 0: for one frame it takes the port's carry (the
feature table, the world map, the pose and motion model) and the frame's
images, builds its own pyramids and prior, and runs each stage from the
state the port handed that stage.  Inputs are NumPy arrays; outputs are
NumPy arrays of the same names as the port's.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from portbench.reference import backend, frontend, pyramid, robust, schur, se3, state
from portbench.reference.camera import StereoRig


def _tensors(d: Mapping, cls):
    kw = {}
    for f in dataclasses.fields(cls):
        v = d[f.name]
        kw[f.name] = _tensors(v, state.MargState) if f.name == "marg" else torch.as_tensor(np.asarray(v))
    return cls(**kw)


def features(d: Mapping) -> state.Features:
    return _tensors(d, state.Features)


def world_map(d: Mapping) -> state.WorldMap:
    return _tensors(d, state.WorldMap)


def to_numpy(obj):
    """Tensors (in dataclasses, tuples) as NumPy arrays, dataclasses as dicts."""
    if torch.is_tensor(obj):
        return obj.detach().cpu().numpy()
    if dataclasses.is_dataclass(obj):
        return {f.name: to_numpy(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, tuple):
        return type(obj)(*map(to_numpy, obj)) if hasattr(obj, "_fields") else tuple(map(to_numpy, obj))
    return obj


class Reference:
    """The reference's configuration and rig, from the configuration file's
    settings and camera (never from the port's objects)."""

    def __init__(self, settings: Mapping, P0: np.ndarray, P1: np.ndarray, scale: float):
        self.cfg = frontend.FrontendConfig.from_config(settings)
        self.ba_cfg = backend.BAConfig(
            iterations=settings["ba_solver_iterations"], chi2_threshold=settings["chi2_threshold"],
            max_chi2_doublings=settings["ba_max_chi2_doublings"], inlier_ratio=settings["ba_inlier_ratio"],
            strategy=settings["lm_strategy"], linear_solver=settings["linear_solver"], engine=settings["lm_engine"],
            trace=bool(settings["ba_trace"]), assembly_precision=str(settings["ba_assembly_precision"]))
        self.rig = StereoRig.from_kitti_projections(P0, P1, scale=scale)

    def pyramid(self, img: np.ndarray):
        return tuple(pyramid.build_pyramid(torch.as_tensor(np.asarray(img, np.float32)), self.cfg.klt.levels))

    @staticmethod
    def prior(rel_motion: np.ndarray, T_cur: np.ndarray) -> torch.Tensor:
        """The constant-velocity prior (visual_odometry.constant_velocity_prior)."""
        return se3.se3_orthonormalize(se3.compose(torch.as_tensor(rel_motion), torch.as_tensor(T_cur)))

    def track(self, feats_in: Mapping, wmap_in: Mapping, T_cur, rel_motion, img_prev, img_cur):
        T_prior = self.prior(rel_motion, T_cur)
        out = frontend.track_last_frame(self.cfg, self.rig, self.pyramid(img_prev), self.pyramid(img_cur),
                                        features(feats_in), torch.as_tensor(wmap_in["lm_pos"]), T_prior,
                                        rel_motion=torch.as_tensor(rel_motion))
        return to_numpy(out), T_prior

    def pose(self, feats_tracked: Mapping, wmap_in: Mapping, T_prior: torch.Tensor):
        T, feats, n_in = frontend.estimate_current_pose(self.cfg, self.rig, features(feats_tracked),
                                                        torch.as_tensor(wmap_in["lm_pos"]), T_prior)
        return to_numpy(T), to_numpy(feats), int(n_in)

    def insert(self, feats_in: Mapping, wmap_in: Mapping, T_cur: np.ndarray, img_l, img_r, frame_id: int):
        pyr_l, pyr_r = self.pyramid(img_l), self.pyramid(img_r)
        feats, wmap = frontend.insert_keyframe(self.cfg, self.rig, pyr_l, pyr_r,
                                               torch.as_tensor(np.asarray(img_l, np.float32)), features(feats_in),
                                               world_map(wmap_in), torch.as_tensor(T_cur), frame_id)
        return to_numpy(feats), to_numpy(wmap)

    def init(self, wmap_in: Mapping, img_l, img_r, frame_id: int):
        pyr_l, pyr_r = self.pyramid(img_l), self.pyramid(img_r)
        ok, feats, wmap = frontend.stereo_init(self.cfg, self.rig, pyr_l, pyr_r,
                                               torch.as_tensor(np.asarray(img_l, np.float32)),
                                               world_map(wmap_in), frame_id)
        return bool(ok), to_numpy(feats), to_numpy(wmap)

    def ba(self, wmap_in: Mapping):
        """`ba_step` on the map the port handed it: (map', the cost of
        map' on that problem, `cost`)."""
        wmap, _ = backend.ba_step(self.cfg, self.rig, world_map(wmap_in), self.ba_cfg)
        out = to_numpy(wmap)
        return out, self.cost(wmap_in, out)

    def cost(self, wmap_in: Mapping, wmap_out: Mapping) -> float:
        """Window BA's robust cost (`schur.robust_chi`, float64) of the
        window poses and landmark positions of `wmap_out` on the problem
        built from `wmap_in`: how well a BA answer solves what it was asked."""
        problem, _ = backend.build_problem(self.cfg, self.rig, world_map(wmap_in))
        g = problem.graph
        g64 = g._replace(e_uv=g.e_uv.double(), exts=g.exts.double())
        ids = torch.clamp(problem.active_ids, min=0).long()
        poses = torch.as_tensor(np.asarray(wmap_out["kf_pose"], np.float64))
        points = torch.as_tensor(np.asarray(wmap_out["lm_pos"], np.float64))[ids]
        return float(schur.robust_chi(g64, poses, points, robust.HUBER, self.ba_cfg.chi2_threshold))
