"""Fixed-shape world-model state (twin of legoslam_tpu/pipeline/state.py).

`Features` is the per-frame feature table, `WorldMap` the landmark table
plus the keyframe window, `VOCarry` the frame-to-frame loop state.  They are
dataclasses of tensors with the reference's field names, shapes and dtypes;
`MargState` is the marginalization prior's bookkeeping inside `WorldMap`.  The `*_from_numpy` converters take dicts of NumPy
arrays keyed by the reference's field names (nested for `wmap`, `feats` and
`marg`) and return port state on a given device: this is how reference
state reaches the port in the parity tests; `carry_to_numpy` is their
inverse, which checkpoints write (utils/checkpoint.py).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Mapping, NamedTuple, Tuple

import numpy as np
import torch

from legoslam_tpu_torch.geometry.camera import Camera, StereoRig


class Capacities(NamedTuple):
    """Static capacities."""

    max_features: int = 512        # per-frame feature slots (tracked + detected)
    window: int = 16               # keyframe slots (15 active + insertion slack)
    active_landmarks: int = 2048   # landmark slots in one BA problem
    landmarks: int = 1 << 17       # global landmark table
    ba_edges: int = 5120           # observation edges in one BA problem


class _Tensors:
    """`replace` and `map` for dataclasses whose fields are tensors."""

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    def map(self, fn):
        return dataclasses.replace(
            self, **{f.name: fn(getattr(self, f.name)) for f in dataclasses.fields(self)}
        )

    def to(self, device):
        """A copy on `device` (nested state included)."""
        return self.map(lambda x: x.to(device))


@dataclass(frozen=True)
class Features(_Tensors):
    """Per-frame feature table (index-aligned left/right, frame.h:39-41)."""

    uv: torch.Tensor          # (NF, 2) left-image position
    uv_r: torch.Tensor        # (NF, 2) right-image position
    has_right: torch.Tensor   # (NF,) bool right match exists
    lm: torch.Tensor          # (NF,) int32 global landmark id, -1 = none
    valid: torch.Tensor       # (NF,) bool slot occupied
    anchor: torch.Tensor      # (NF, levels, P+2, P+2) keyframe template patches
    anchor_uv: torch.Tensor   # (NF, 2) template position in its keyframe image

    @staticmethod
    def empty(caps: Capacities, dtype=torch.float32, levels: int = 4, halo: int = 9, device="cpu") -> "Features":
        nf = caps.max_features
        return Features(
            uv=torch.zeros((nf, 2), dtype=dtype, device=device),
            uv_r=torch.zeros((nf, 2), dtype=dtype, device=device),
            has_right=torch.zeros((nf,), dtype=torch.bool, device=device),
            lm=torch.full((nf,), -1, dtype=torch.int32, device=device),
            valid=torch.zeros((nf,), dtype=torch.bool, device=device),
            anchor=torch.zeros((nf, levels, halo, halo), dtype=dtype, device=device),
            anchor_uv=torch.zeros((nf, 2), dtype=dtype, device=device),
        )

    def count(self) -> torch.Tensor:
        return self.valid.sum(dtype=torch.int32)


@dataclass(frozen=True)
class MargState(_Tensors):
    """Marginalization bookkeeping (`use_marg_prior`), slot-major like the
    window: the prior left by the last eviction (frontend._evict_if_full)
    and the window's pose information at the last BA optimum
    (backend.solve_window), each with the poses it was linearized at and the
    keyframe ids its slots held.  Zeros and -1 until the prior is in use."""

    prior_J: torch.Tensor      # (KW*6, KW*6) sqrt-form prior Jacobian
    prior_err: torch.Tensor    # (KW*6,) prior residual at its linearization
    prior_T: torch.Tensor      # (KW, 4, 4) linearization poses of the prior
    prior_kf_id: torch.Tensor  # (KW,) int32 keyframe id per slot, -1 = no prior
    info_S: torch.Tensor       # (KW*6, KW*6) reduced pose information at the last BA optimum
    info_b: torch.Tensor       # (KW*6,) its information vector
    info_T: torch.Tensor       # (KW, 4, 4) the optimum's poses
    info_kf_id: torch.Tensor   # (KW,) int32 keyframe id per slot at that solve

    @staticmethod
    def empty(caps: Capacities, dtype=torch.float32, device="cpu") -> "MargState":
        kw = caps.window

        def eye():
            return torch.eye(4, dtype=dtype, device=device).repeat(kw, 1, 1)

        return MargState(
            prior_J=torch.zeros((kw * 6, kw * 6), dtype=dtype, device=device),
            prior_err=torch.zeros((kw * 6,), dtype=dtype, device=device),
            prior_T=eye(),
            prior_kf_id=torch.full((kw,), -1, dtype=torch.int32, device=device),
            info_S=torch.zeros((kw * 6, kw * 6), dtype=dtype, device=device),
            info_b=torch.zeros((kw * 6,), dtype=dtype, device=device),
            info_T=eye(),
            info_kf_id=torch.full((kw,), -1, dtype=torch.int32, device=device),
        )


@dataclass(frozen=True)
class WorldMap(_Tensors):
    """Landmark table + keyframe window (the reference `Map`)."""

    lm_pos: torch.Tensor       # (ML, 3) world position
    lm_alive: torch.Tensor     # (ML,) bool created and not reset
    lm_obs: torch.Tensor       # (ML,) int32 registered window observations
    lm_next: torch.Tensor      # () int32 allocation cursor
    kf_pose: torch.Tensor      # (KW, 4, 4) T_cw
    kf_id: torch.Tensor        # (KW,) int32 keyframe id, -1 = empty
    kf_frame_id: torch.Tensor  # (KW,) int32 source frame id
    kf_valid: torch.Tensor     # (KW,) bool
    next_kf_id: torch.Tensor   # () int32
    kf_uv: torch.Tensor        # (KW, NF, 2) left measurement
    kf_uv_r: torch.Tensor      # (KW, NF, 2) right measurement
    kf_lm: torch.Tensor        # (KW, NF) int32 landmark id, -1 = none
    kf_obs_left: torch.Tensor  # (KW, NF) bool left obs registered for BA
    kf_obs_right: torch.Tensor  # (KW, NF) bool right obs registered (birth keyframe)
    marg: MargState

    @staticmethod
    def empty(caps: Capacities, dtype=torch.float32, device="cpu") -> "WorldMap":
        ml, kw, nf = caps.landmarks, caps.window, caps.max_features

        def i32(shape, fill):
            return torch.full(shape, fill, dtype=torch.int32, device=device)

        return WorldMap(
            lm_pos=torch.zeros((ml, 3), dtype=dtype, device=device),
            lm_alive=torch.zeros((ml,), dtype=torch.bool, device=device),
            lm_obs=i32((ml,), 0),
            lm_next=i32((), 0),
            kf_pose=torch.eye(4, dtype=dtype, device=device).repeat(kw, 1, 1),
            kf_id=i32((kw,), -1),
            kf_frame_id=i32((kw,), -1),
            kf_valid=torch.zeros((kw,), dtype=torch.bool, device=device),
            next_kf_id=i32((), 0),
            kf_uv=torch.zeros((kw, nf, 2), dtype=dtype, device=device),
            kf_uv_r=torch.zeros((kw, nf, 2), dtype=dtype, device=device),
            kf_lm=i32((kw, nf), -1),
            kf_obs_left=torch.zeros((kw, nf), dtype=torch.bool, device=device),
            kf_obs_right=torch.zeros((kw, nf), dtype=torch.bool, device=device),
            marg=MargState.empty(caps, dtype, device),
        )

    def num_keyframes(self) -> torch.Tensor:
        return self.kf_valid.sum(dtype=torch.int32)

    def lm_active_mask(self) -> torch.Tensor:
        """Active landmark: alive with at least one registered window
        observation (map.cpp:88-100), derived, never stored."""
        return self.lm_alive & (self.lm_obs > 0)


@dataclass(frozen=True)
class VOCarry:
    """Frame-to-frame loop state.  `status` (a FrontendStatus value) and
    `frames_since_kf` are host ints: `process_frame` branches on them in Python."""

    status: int
    feats: Features
    wmap: WorldMap
    T_cur: torch.Tensor       # (4, 4) last processed frame pose T_cw
    rel_motion: torch.Tensor  # (4, 4) constant-velocity model (frontend.h:86)
    pyr_last: Tuple[torch.Tensor, ...]  # left-image pyramid of the last frame
    frames_since_kf: int

    def replace(self, **kw) -> "VOCarry":
        return dataclasses.replace(self, **kw)


# --- converters from reference state (dicts of NumPy arrays) -----------------

def _tensor(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    # ascontiguousarray makes a 0-d array 1-d: keep the shape (scalars stay ()).
    return torch.from_numpy(np.ascontiguousarray(a).reshape(a.shape)).to(device)


def _fields(cls, d: Mapping[str, Any], device, nested=None):
    nested = nested or {}
    kw = {}
    for f in dataclasses.fields(cls):
        kw[f.name] = nested[f.name](d[f.name], device) if f.name in nested else _tensor(d[f.name], device)
    return cls(**kw)


def features_from_numpy(d: Mapping[str, Any], device="cpu") -> Features:
    return _fields(Features, d, device)


def worldmap_from_numpy(d: Mapping[str, Any], device="cpu") -> WorldMap:
    return _fields(WorldMap, d, device, nested={"marg": lambda m, dev: _fields(MargState, m, dev)})


def carry_from_numpy(d: Mapping[str, Any], device="cpu") -> VOCarry:
    return VOCarry(
        status=int(np.asarray(d["status"])),
        feats=features_from_numpy(d["feats"], device),
        wmap=worldmap_from_numpy(d["wmap"], device),
        T_cur=_tensor(d["T_cur"], device),
        rel_motion=_tensor(d["rel_motion"], device),
        pyr_last=tuple(_tensor(p, device) for p in d["pyr_last"]),
        frames_since_kf=int(np.asarray(d["frames_since_kf"])),
    )


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def carry_to_numpy(carry: VOCarry) -> dict:
    """The inverse of `carry_from_numpy`: the carry as nested dicts of NumPy
    arrays in the reference's field order (which is also its `tree_flatten`
    order), the host ints as int32 scalars as the reference stores them.
    This is the state a whole run carries across a checkpoint."""

    def fields(obj):
        return {f.name: (fields(getattr(obj, f.name)) if dataclasses.is_dataclass(getattr(obj, f.name))
                         else _numpy(getattr(obj, f.name))) for f in dataclasses.fields(obj)}

    return {
        "status": np.asarray(carry.status, np.int32),
        "feats": fields(carry.feats),
        "wmap": fields(carry.wmap),
        "T_cur": _numpy(carry.T_cur),
        "rel_motion": _numpy(carry.rel_motion),
        "pyr_last": tuple(_numpy(p) for p in carry.pyr_last),
        "frames_since_kf": np.asarray(carry.frames_since_kf, np.int32),
    }


def rig_from_numpy(d: Mapping[str, Any], device="cpu") -> StereoRig:
    """Rig from {"left": {fx, fy, cx, cy, baseline, pose, ...}, "right": {...}}."""

    def cam(c):
        return Camera.create(
            float(np.asarray(c["fx"])), float(np.asarray(c["fy"])), float(np.asarray(c["cx"])),
            float(np.asarray(c["cy"])), float(np.asarray(c["baseline"])), pose=np.asarray(c["pose"]),
            device=device,
        )

    return StereoRig(left=cam(d["left"]), right=cam(d["right"]))
