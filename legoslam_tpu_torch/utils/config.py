"""YAML configuration with typed access and defaults (twin of
legoslam_tpu/utils/config.py, with the same DEFAULTS).

Replaces the reference's `Config` singleton over cv::FileStorage
(include/legoslam/config.h:26-32, src/config.cpp:5-15), with two upgrades the
SURVEY calls out (section 5): every hard-coded tunable of the reference is a
named key here, and an instance (not a process-global) can be carried around —
though a module-level default is kept for the reference-style static API.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Optional

# Defaults cover every knob the reference reads from YAML plus the constants
# it hard-codes (file:line cites against the reference C++ code, LEGO-SLAM).
DEFAULTS: Dict[str, Any] = {
    # --- dataset / app (config/kitti_00.yaml) ---
    "dataset_dir": "",
    "follow_frame": 1,
    "image_scale": 0.5,            # dataset.cpp:40,76: K*0.5 and half-res resize
    # --- frontend (frontend_g2o.cpp:15-24, frontend.h:100-103) ---
    "num_features": 150,
    "num_features_init": 50,
    "num_features_tracking": 30,   # good/bad/lost thresholds
    "num_features_tracking_bad": 5,
    "num_features_needed_for_keyframe": 80,
    "stereo_depth_superior_limit": 200.0,
    "stereo_depth_inferior_limit": 8.0,
    "ground_y_limit": 2.0,         # frontend_g2o.cpp:329 ground constraint y <= 2 m
    "gftt_quality_level": 0.01,    # frontend_g2o.cpp:16
    "gftt_min_distance": 20,
    "detect_mask_half": 10,        # frontend_g2o.cpp:282 masked re-detection box
    # --- KLT (algorithm.cpp:39-42, 133-137) ---
    "klt_half_patch": 3,
    "klt_iterations": 10,
    "klt_pyramid_levels": 4,
    "klt_pyramid_scale": 0.5,
    "klt_inverse": False,          # frontend_g2o.cpp:473: forward mode default
    "klt_eps": 1e-2,
    # auto: the CUDA kernel for CUDA tensors, the plain PyTorch version for
    # CPU tensors; kernel / eager force one (kernels/klt.py).
    "klt_backend": "auto",
    # forward-backward verification (no reference analogue; 0 disables)
    "stereo_fb_threshold": 0.6,
    "track_fb_threshold": 0.8,
    "stereo_matcher": "scanline",  # "scanline" | "klt" (reference behavior)
    "max_keyframe_gap": 5,         # force a keyframe after N frames (no reference analogue)
    "track_mode": "anchored",      # "anchored" | "frame" (reference behavior)
    "track_min_zncc": 0.5,
    # Pyramid levels for the anchored temporal tracker (0 = all klt levels);
    # see FrontendConfig.track_levels.  3 beats 4 on the 200-frame corridor
    # (ATE 0.043 vs 0.057): the /8 level only mismatches templates.
    "track_levels": 3,
    # --- pose estimation (frontend_g2o.cpp:199-204) ---
    "pose_outer_iterations": 4,
    "pose_solver_iterations": 10,
    "chi2_threshold": 5.991,
    # --- backend BA (backend_lego.cpp:92, 161-184; map.h:82) ---
    "num_active_keyframes": 15,
    "ba_solver_iterations": 10,
    "ba_max_chi2_doublings": 5,
    "ba_inlier_ratio": 0.5,
    # BA scheduling: "inline" (fused into the keyframe branch), "async"
    # (overlapped with tracking — the reference's backend-thread split,
    # backend_lego.cpp:38-54, as pipeline/async_backend.py), or "off".
    "ba_mode": "inline",
    # Device for the async solve: "auto" (a second card when present, else
    # the frame loop's device on a side stream), "none" (the frame loop's
    # device), or a card index.
    "ba_async_device": "auto",
    # Async dispatch cadence in frames (pipeline/async_backend.py banner:
    # host-blind scheduling — keyframe flags are never fetched to the host).
    "ba_async_dispatch_every": 4,
    # --- solver (problem.cpp:470-581) ---
    "lm_strategy": "default",      # "default" (Nielsen) | "strategy1"
    "lm_engine": "soa",            # "soa" (component-major) | "blocks"
    # Precision of window BA's pose-landmark cross terms: "bf16" rounds each
    # edge's term to bfloat16 before the float32 sums, as the reference's
    # one-pass matrix-unit contraction does; chi, the other blocks and the
    # accept/rollback loop stay float32.  "f32" assembles in float32 alone.
    # At 10 iterations bf16 leaves window BA's chi above f32's (ROADMAP C3).
    "ba_assembly_precision": "bf16",
    # Marginalize evicted keyframes into a pose prior (problem.cpp:617-781;
    # shipped but uncalled in the reference pipeline).  Off reproduces the
    # reference's discard-on-evict (map.cpp:34-86).
    "use_marg_prior": False,
    # 0.5, not 1.0: the recursive prior overlaps with re-observed landmarks
    # still in the window, so full weight double-counts their information and
    # measurably biases the window (100-frame tiny-window A/B: ATE 0.049 at
    # w=0.5 vs 0.165 at w=1.0 vs 0.054 with the prior off).
    "marg_prior_weight": 0.5,
    # Loop closure (the reference's declared TODO, CMakeLists.txt:74-77):
    # thumbnail place recognition -> KLT/pose-solve verification -> pose-graph
    # correction (pipeline/loop_closure.py).
    "use_loop_closure": False,
    "loop_zncc_min": 0.5,
    "loop_min_gap": 10,
    "loop_min_inliers": 25,
    "loop_edge_weight": 20.0,
    "lm_tau": 1e-5,
    "lm_diff_chi_threshold": 1e-5,  # problem.h:165 diffChiThreshold_
    "lm_false_cnt_threshold": 10,
    "linear_solver": "cholesky",   # "cholesky" | "pcg" (problem.cpp:584-614)
    # --- capacities (fixed-shape world model; no reference analogue) ---
    "max_features": 512,
    "max_landmarks": 1 << 17,
    "max_active_landmarks": 2048,
    "max_ba_edges": 5120,
    "keyframe_window_capacity": 16,
    # --- misc ---
    "min_dis_th": 0.2,             # map.cpp:56 keyframe eviction distance
    "sing_ratio_threshold": 1e-3,  # algorithm.h:14
    # --- observability (frontend_lego.cpp:87,152,230; problem.cpp:180-184) ---
    "log_every_n_frames": 0,       # 0 = silent; N logs per-frame counters every N frames
    "viewer_every_n": 0,           # 0 = off; N = live viewer stream (overlay
                                   # every N frames + map snapshots + GIF)
    "ba_trace": False,             # record per-iteration chi/lambda of each BA solve
}


class Config:
    """Dict-backed config; `Config.set_parameter_file(path)` + `Config.get(key)`
    mirror the reference's static API, while instances support plain item access."""

    _instance: Optional["Config"] = None

    def __init__(self, values: Optional[Dict[str, Any]] = None):
        self._values = copy.deepcopy(DEFAULTS)
        if values:
            self._values.update(values)

    @classmethod
    def from_yaml(cls, path: str) -> "Config":
        import yaml

        with open(path) as f:
            data = yaml.safe_load(f) or {}
        # Keys that begin with "%" are dropped, as the reference drops them.  A
        # cv::FileStorage file that opens with a `%YAML:1.0` directive does not
        # get here: `safe_load` raises on it, in the reference too (ROADMAP C13).
        return cls({k: v for k, v in data.items() if not str(k).startswith("%")})

    # --- reference-style static API (config.h:26-32) ---
    @classmethod
    def set_parameter_file(cls, path: str) -> bool:
        cls._instance = cls.from_yaml(path)
        return True

    @classmethod
    def get(cls, key: str, default: Any = None) -> Any:
        inst = cls._instance or cls()
        return inst[key] if key in inst else default

    # --- instance API ---
    def __getitem__(self, key: str) -> Any:
        return self._values[key]

    def __setitem__(self, key: str, value: Any) -> None:
        self._values[key] = value

    def __contains__(self, key: str) -> bool:
        return key in self._values

    def as_dict(self) -> Dict[str, Any]:
        return copy.deepcopy(self._values)

    def override(self, **kwargs) -> "Config":
        out = Config(self._values)
        out._values.update(kwargs)
        return out
