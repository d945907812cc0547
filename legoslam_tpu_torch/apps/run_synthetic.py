"""Run stereo SLAM on the procedural plane-world sequence, no dataset needed
(twin of apps/run_synthetic.py).

Runs the full pipeline on the card and reports ATE against the exact
synthetic ground truth.

Usage:
  python -m legoslam_tpu_torch.apps.run_synthetic --frames 30 --out_dir out_synth
"""

from __future__ import annotations

import argparse
import os
import sys

from legoslam_tpu_torch.apps._common import add_common_flags, apply_flags, device_ok, run_frames


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--speed", type=float, default=0.2)
    ap.add_argument("--out_dir", default="out_synth")
    add_common_flags(ap)
    args = ap.parse_args(argv)

    from legoslam_tpu_torch.pipeline.dataset import SyntheticPlanesDataset
    from legoslam_tpu_torch.pipeline.visual_odometry import VisualOdometry
    from legoslam_tpu_torch.utils import evaluation
    from legoslam_tpu_torch.utils.config import Config
    from legoslam_tpu_torch.utils.logging import get_logger

    log = get_logger("legoslam.app")
    if not device_ok(args.device, log):
        return 2
    ds = SyntheticPlanesDataset(n_frames=args.frames, shape=(160, 240), focal=260.0, baseline=0.54,
                                speed=args.speed)
    config = Config({
        "stereo_depth_inferior_limit": 2.0,
        "stereo_depth_superior_limit": 50.0,
        "detect_mask_half": 6,
        "gftt_min_distance": 6,
    })
    apply_flags(config, args)
    vo = VisualOdometry(config=config, dataset=ds, ba_mode="off" if args.no_ba else None, device=args.device)
    if not vo.init():
        log.error("init failed")
        return 1
    run_frames(vo, args, log)

    est = vo.trajectory_T_wc()
    gt = ds.ground_truth[: len(est)]
    ate = evaluation.ate_rmse(est[:, :3, 3], gt[:, :3, 3])
    log.info("ATE RMSE: %.4f m over %d frames", ate, len(est))
    os.makedirs(args.out_dir, exist_ok=True)
    vo.save_trajectory(os.path.join(args.out_dir, "trajectory_kitti.txt"))
    for p in vo.save_visualization(args.out_dir, ground_truth=gt):
        log.info("wrote %s", p)
    return 0


if __name__ == "__main__":
    sys.exit(main())
