"""Run stereo SLAM on a KITTI odometry sequence (twin of apps/run_kitti.py).

One config file (or flags) runs the full pipeline on the card, exports the
trajectory, prints ATE and RPE when ground truth is available, and writes
viewer artifacts.

Usage:
  python -m legoslam_tpu_torch.apps.run_kitti --dataset_dir /data/kitti/odometry/sequences/00
  python -m legoslam_tpu_torch.apps.run_kitti --config_file config/kitti_00.yaml
  python -m legoslam_tpu_torch.apps.run_kitti --config_file config/kitti_00.yaml \
      --stop_after 500 --save_checkpoint run.npz          # then resume:
  python -m legoslam_tpu_torch.apps.run_kitti --config_file config/kitti_00.yaml --load_checkpoint run.npz
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from legoslam_tpu_torch.apps._common import add_common_flags, apply_flags, device_ok, run_frames


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config_file", default=None, help="YAML config (reference format works)")
    ap.add_argument("--dataset_dir", default=None, help="KITTI sequence directory")
    ap.add_argument("--max_frames", type=int, default=0, help="0 = whole sequence")
    ap.add_argument("--out_dir", default="out", help="trajectory/visualization output")
    add_common_flags(ap)
    args = ap.parse_args(argv)

    from legoslam_tpu_torch.pipeline.dataset import KittiDataset
    from legoslam_tpu_torch.pipeline.visual_odometry import VisualOdometry
    from legoslam_tpu_torch.utils import evaluation
    from legoslam_tpu_torch.utils.config import Config
    from legoslam_tpu_torch.utils.logging import get_logger

    log = get_logger("legoslam.app")
    if not device_ok(args.device, log):
        return 2
    config = Config.from_yaml(args.config_file) if args.config_file else Config()
    if args.dataset_dir:
        config["dataset_dir"] = args.dataset_dir
    apply_flags(config, args)

    dataset = KittiDataset(config["dataset_dir"], scale=config["image_scale"])
    vo = VisualOdometry(config=config, dataset=dataset, ba_mode="off" if args.no_ba else None, device=args.device)
    if not vo.init():
        log.error("init failed (check dataset_dir: %s)", config["dataset_dir"])
        return 1
    t0 = time.perf_counter()
    n = run_frames(vo, args, log, args.max_frames)
    ms = 1e3 * (time.perf_counter() - t0)
    log.info("processed %d frames, %d active keyframes, %.1f ms (%.3f ms/frame)",
             n, vo.num_keyframes(), ms, ms / max(n, 1))

    os.makedirs(args.out_dir, exist_ok=True)
    traj_path = os.path.join(args.out_dir, "trajectory_kitti.txt")
    vo.save_trajectory(traj_path, fmt="kitti")
    log.info("trajectory written to %s", traj_path)

    gt = dataset.ground_truth
    if gt is not None:
        est = vo.trajectory_T_wc()
        m = min(len(est), len(gt))
        ate = evaluation.ate_rmse(est[:m, :3, 3], gt[:m, :3, 3])
        rpe_t, rpe_r = evaluation.rpe_rmse(est[:m], gt[:m])
        log.info("ATE RMSE: %.4f m | RPE: %.4f m / %.4f deg per frame", ate, rpe_t, rpe_r)

    for p in vo.save_visualization(args.out_dir, ground_truth=gt):
        log.info("wrote %s", p)
    return 0


if __name__ == "__main__":
    sys.exit(main())
