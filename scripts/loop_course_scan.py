"""Which course makes loop closure pay at full width, on one GPU.

    python3 scripts/loop_course_scan.py [--repeat N] [--dump DIR] [--deterministic] [course ...]

Renders variants of chip_smoke.py's loop course (188x620, the 40 m wide box)
with chip_smoke's render pool, drives each through `VisualOdometry` on the
card with the detector shut (`loop_zncc_min` 1.1) and open (0.5), `--repeat`
times on the same frames, and prints per arm: the closer's stats and loop
edges, the keyframe ATE, the full ATE (rigidly aligned, and anchored at the
first frame without alignment) and the error of the last frame.  Courses:
`lap1` one lap with a 28-frame tail along the first straight
(tests/test_loop_closure.py's), `lap1_tail80` the same with an 80-frame
tail, which runs on past the revisited straight, `lap2` two laps, `lap3`
three.

Window BA sums its blocks in an order fixed by the graph (solver/schur.py),
so two runs on the same frames give the same bits; `--deterministic` runs
them under `torch.use_deterministic_algorithms(True)` as well, which gave
the same digests on `lap2`.  Each line also says how many leading frames of
the run are bit-equal to the first run's with the detector shut: all of
them for a rerun of that arm, those before the first closure for the other
arm.

With `--dump DIR` the open-detector arm of every run also writes
DIR/loop_records_<course>_<run>.npz: what `VisualOdometry` gave
`LoopCloser.add_keyframe` for every keyframe (frame id, the half-resolution
image, pose, features, landmark positions) and what the closer answered
(the loop edges and stats after each call), with the ground truth, so that
another closer can be run over the same records
(`python -m tests.ba_parity_report --loop-records FILE`).
"""

from __future__ import annotations

import argparse
import hashlib
import multiprocessing
import os
import sys
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402

COURSES = {"lap1": ("lap", 1, 28), "lap1_tail80": ("lap", 1, 80), "lap2": ("lap", 2, 4), "lap3": ("lap", 3, 4)}
WORKERS = 8


def recording(closer, log):
    """Wrap `closer.add_keyframe` so that every call's arguments and outcome
    are appended to `log`."""
    add_keyframe = closer.add_keyframe

    def add(frame_id, img_full, T_cw, uv, p_world):
        out = add_keyframe(frame_id, img_full, T_cw, uv, p_world)
        log.append({"frame_id": frame_id, "img_half": np.asarray(img_full[::2, ::2], np.float32),
                    "T_cw": np.asarray(T_cw, np.float64), "uv": np.asarray(uv, np.float32),
                    "p_world": np.asarray(p_world, np.float32), "closed": out is not None,
                    "n_edges": len(closer.loop_edges), "stats": dict(closer.stats),
                    "edge": closer.loop_edges[-1][:2] if out is not None else (-1, -1),
                    "M": closer.loop_edges[-1][2] if out is not None else np.eye(4)})
        return out

    closer.add_keyframe = add


def save_records(path, log, gt_T_wc) -> None:
    n_max = max(len(r["uv"]) for r in log)

    def padded(key, width):
        out = np.zeros((len(log), n_max, width), np.float32)
        for k, r in enumerate(log):
            out[k, : len(r[key])] = r[key]
        return out

    np.savez_compressed(
        path, frame_id=np.asarray([r["frame_id"] for r in log]), img_half=np.stack([r["img_half"] for r in log]),
        T_cw=np.stack([r["T_cw"] for r in log]), uv=padded("uv", 2), p_world=padded("p_world", 3),
        n_feats=np.asarray([len(r["uv"]) for r in log]), closed=np.asarray([r["closed"] for r in log]),
        edge=np.asarray([r["edge"] for r in log]), M=np.stack([r["M"] for r in log]),
        candidates=np.asarray([r["stats"]["candidates"] for r in log]), gt_T_wc=gt_T_wc)


def main() -> None:
    import torch

    from legoslam_tpu_torch.pipeline.visual_odometry import FrontendStatus, VisualOdometry
    from legoslam_tpu_torch.utils import evaluation
    from legoslam_tpu_torch.utils.config import Config

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeat", type=int, default=1)
    ap.add_argument("--dump", default=None)
    ap.add_argument("--deterministic", action="store_true")
    ap.add_argument("courses", nargs="*", default=list(COURSES))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("loop_course_scan: no CUDA device")
    with ProcessPoolExecutor(WORKERS, mp_context=multiprocessing.get_context("spawn")) as pool:
        frames = chip_smoke.render_worlds(pool, WORKERS, [COURSES[n] for n in args.courses])()
    print(f"card: {torch.cuda.get_device_name(0)}, deterministic algorithms: {args.deterministic}")
    if args.deterministic:
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")  # cuBLAS's condition for reproducible products
        torch.use_deterministic_algorithms(True, warn_only=True)
    for n in args.courses:
        ds = chip_smoke.world(COURSES[n])
        gt = ds.gt_T_wc[:, :3, 3]
        first = None
        for rep in range(args.repeat):
            for zncc in (1.1, 0.5):
                config = Config({"stereo_depth_inferior_limit": 2.0, "stereo_depth_superior_limit": 60.0,
                                 "use_loop_closure": True, "loop_zncc_min": zncc})
                vo = VisualOdometry(config=config, dataset=chip_smoke.FrameList(frames[COURSES[n]], ds.rig))
                if not vo.init():
                    raise RuntimeError("VisualOdometry.init failed")
                log = []
                if args.dump and zncc < 1.0:
                    recording(vo.loop_closer, log)
                t0 = time.perf_counter()
                while vo.step():
                    pass
                est = vo.trajectory_T_wc()[:, :3, 3]
                ids, kf_T_cw = vo.keyframe_trajectory()
                first = est if first is None else first
                same = np.all(est == first[:len(est)], axis=1)
                print(f"{n} run {rep} loop_zncc_min {zncc}: trajectory sha1 {hashlib.sha1(est.tobytes()).hexdigest()[:12]}, "
                      f"{len(est) if same.all() else int(np.argmin(same))} leading frames bit-equal to the first run's")
                print(f"{n} run {rep} loop_zncc_min {zncc}: {len(est)} frames, lost "
                      f"{int((vo.statuses() == FrontendStatus.LOST).sum())}, stats {vo.loop_closer.stats}, edges "
                      f"{[(i, j) for i, j, _ in vo.loop_closer.loop_edges]}, keyframe ATE "
                      f"{evaluation.ate_rmse(np.linalg.inv(kf_T_cw)[:, :3, 3], gt[ids]):.4f} m, full ATE "
                      f"{evaluation.ate_rmse(est, gt[:len(est)]):.4f} m aligned, "
                      f"{evaluation.ate_rmse(est, gt[:len(est)], align=False):.4f} m anchored, last frame off "
                      f"{np.linalg.norm(est[-1] - gt[len(est) - 1]):.3f} m, {time.perf_counter() - t0:.1f} s", flush=True)
                if log:
                    os.makedirs(args.dump, exist_ok=True)
                    save_records(os.path.join(args.dump, f"loop_records_{n}_{rep}.npz"), log, ds.gt_T_wc)


if __name__ == "__main__":
    main()
