"""How far the reference-mode slice's trajectory moves from run to run, and
whether the hand-written kernels move it, on one GPU.

    python3 scripts/modes_spread.py

Renders chip_smoke.py's 40 bench-world frames once and drives
`VisualOdometry` with `track_mode: frame` and `stereo_matcher: klt` over
them: three times on the card with the kernels, twice on the card with the
plain versions in their place (`klt_backend: eager` and the plain pose
estimate), once on the CPU.  Prints every run's keyframe count and ATE, and
the distance between every two trajectories after a rigid alignment.
"""

from __future__ import annotations

import multiprocessing
import os
import sys
from concurrent.futures import ProcessPoolExecutor

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402

RUNS = ("card kernels 1", "card kernels 2", "card kernels 3", "card plain 1", "card plain 2", "cpu")


def main() -> None:
    import torch

    from legoslam_tpu_torch.kernels import pose as pose_k
    from legoslam_tpu_torch.pipeline.visual_odometry import VisualOdometry
    from legoslam_tpu_torch.utils import evaluation
    from legoslam_tpu_torch.utils.config import Config

    if not torch.cuda.is_available():
        raise SystemExit("modes_spread: no CUDA device")
    with ProcessPoolExecutor(8, mp_context=multiprocessing.get_context("spawn")) as pool:
        frames = chip_smoke.render_worlds(pool, 8, ["bench"])()["bench"]
    ds = chip_smoke.world("bench")
    gt = ds.gt_T_wc[: len(frames), :3, 3]
    print(f"card: {torch.cuda.get_device_name(0)}")
    dispatch = pose_k.estimate_pose
    tracks = {}
    for name in RUNS:
        plain = "plain" in name
        config = Config({"stereo_depth_inferior_limit": 2.0, "stereo_depth_superior_limit": 60.0,
                         "track_mode": "frame", "stereo_matcher": "klt", "klt_backend": "eager" if plain else "auto"})
        pose_k.estimate_pose = pose_k.estimate_pose_eager if plain else dispatch
        try:
            vo = VisualOdometry(config=config, dataset=chip_smoke.FrameList(frames, ds.rig),
                                device="cpu" if name == "cpu" else "cuda")
            if not vo.init():
                raise RuntimeError("VisualOdometry.init failed")
            while vo.step():
                pass
        finally:
            pose_k.estimate_pose = dispatch
        tracks[name] = vo.trajectory_T_wc()[:, :3, 3]
        print(f"{name}: keyframes {int(vo.keyframe_flags().sum())}, ATE {evaluation.ate_rmse(tracks[name], gt):.5f} m",
              flush=True)
    print("apart after a rigid alignment (m):")
    for a in RUNS:
        print(f"  {a:>15}: " + " ".join(f"{evaluation.ate_rmse(tracks[a], tracks[b]):.5f}" for b in RUNS))


if __name__ == "__main__":
    main()
