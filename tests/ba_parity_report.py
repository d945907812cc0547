"""The numbers behind PERF.md's window-BA parity findings, on the CPU.

    JAX_PLATFORMS=cpu python -m tests.ba_parity_report [--bench-world]

Not a test (pytest does not collect it); it runs what the parity tests
check and prints the values beside their bars:
1. the 14-frame test corridor with window BA inline, port against the JAX
   reference (tests/test_torch_vo.py): per-frame |T_cw| difference, the
   largest position difference, both ATEs;
2. the window's free gauge on the reference's 4-keyframe map with noise
   (tests/test_torch_backend.py): `solve_ba` with the oldest keyframe
   fixed, and the full `ba_step`, whose window may end a rigid motion away
   from the reference's, per LM strategy;
3. with --bench-world: the JAX reference's BA-inline run of the 40-frame
   bench world at `ba_assembly_precision: f32`, the keyframe count and ATE
   that chip_smoke.py holds the port to (about 40 s).
"""

from __future__ import annotations

import argparse

import numpy as np

from legoslam_tpu.pipeline import backend as j_backend
from legoslam_tpu.solver import lm as j_lm
from legoslam_tpu_torch.pipeline import backend, state
from legoslam_tpu_torch.pipeline.visual_odometry import VisualOdometry
from legoslam_tpu_torch.solver import lm
from legoslam_tpu_torch.utils import evaluation
from legoslam_tpu_torch.utils.config import Config
from tests import test_torch_backend as tb
from tests import test_torch_vo as tv
from tests.torch_parity import to_numpy


def corridor() -> None:
    ref = tv.run_reference_inline()
    vo = VisualOdometry(config=Config(tv.OVERRIDES), dataset=tv._dataset(tv.TDataset), device="cpu")
    vo.init()
    vo.run()
    dT = np.abs(vo.trajectory_T_cw() - ref["T_cw"]).max(axis=(1, 2))
    T_wc, gt = vo.trajectory_T_wc(), ref["gt_T_wc"][:, :3, 3]
    print("corridor, BA inline: max |dT_cw| per frame", np.array2string(dT, precision=7))
    print(f"corridor, BA inline: keyframes port {vo.keyframe_flags().astype(int).tolist()} "
          f"reference {ref['kf'].astype(int).tolist()}")
    print(f"corridor, BA inline: max |d position| {np.abs(T_wc[:, :3, 3] - ref['T_wc'][:, :3, 3]).max():.6f} m "
          f"(bar 0.05); ATE port {evaluation.ate_rmse(T_wc[:, :3, 3], gt):.6f} m, reference "
          f"{evaluation.ate_rmse(ref['T_wc'][:, :3, 3], gt):.6f} m (bar 0.15)")


def gauge() -> None:
    ref = tb.reference_maps()
    d = tb._noisy(ref["maps"]["window"])
    wmap = state.worldmap_from_numpy(d)
    valid = d["kf_valid"]
    oldest = int(np.argmax(valid))
    jp, _ = j_backend.build_problem(ref["jcfg"], ref["rig"], tb._jtree(tb.JWorldMap, d))
    p, _ = backend.build_problem(ref["cfg"], ref["port_rig"], wmap)
    jg = jp.graph._replace(pose_fixed=jp.graph.pose_fixed.at[oldest].set(True))
    fixed = p.graph.pose_fixed.clone()
    fixed[oldest] = True
    g = p.graph._replace(pose_fixed=fixed)
    n_obs = np.bincount(to_numpy(g.e_point)[to_numpy(g.e_valid)], minlength=len(g.point_valid))
    seen_twice = to_numpy(g.point_valid) & (n_obs >= 2)
    for strategy in ("default", "strategy1"):
        jst, jres = j_lm.solve_ba(jg, jp.poses, jp.points, cfg=j_lm.LMConfig(strategy=strategy))
        st, res = lm.solve_ba(g, p.poses, p.points, cfg=lm.LMConfig(strategy=strategy))
        print(f"solve_ba, oldest pose fixed, {strategy}: chi port {float(res.chi):.4f} reference "
              f"{float(jres.chi):.4f}; max |d pose| {np.abs(to_numpy(st.poses) - np.asarray(jst.poses))[valid].max():.2e} "
              f"(bar 1e-3); max |d point| seen twice "
              f"{np.abs(to_numpy(st.points) - np.asarray(jst.points))[seen_twice].max():.2e} m (bar 1e-2)")
        jm, jstats = j_backend.ba_step(ref["jcfg"], ref["rig"], tb._jtree(tb.JWorldMap, d),
                                       j_backend.BAConfig(strategy=strategy))
        m, stats = backend.ba_step(ref["cfg"], ref["port_rig"], wmap, backend.BAConfig(strategy=strategy))
        T, jT = to_numpy(m.kf_pose).astype(np.float64), np.asarray(jm.kf_pose, np.float64)
        rigid = np.linalg.inv(jT[oldest]) @ T[oldest]
        rel = np.abs((T @ np.linalg.inv(T[oldest])) - (jT @ np.linalg.inv(jT[oldest])))[valid].max()
        print(f"ba_step, gauge free, {strategy}: chi port {float(stats.chi):.4f} reference {float(jstats.chi):.4f}; "
              f"rigid motion between the windows: largest entry of (motion - I) {np.abs(rigid - np.eye(4)).max():.2e}; "
              f"max |d relative pose| {rel:.2e} (bar 1e-3)")


def bench_world() -> None:
    from legoslam_tpu.pipeline.dataset import SyntheticPlanesDataset
    from legoslam_tpu.pipeline.visual_odometry import VisualOdometry as JVisualOdometry
    from legoslam_tpu.utils.config import Config as JConfig

    n = 40
    ds = SyntheticPlanesDataset(n_frames=n, shape=(188, 620), focal=360.0, baseline=0.54, speed=0.12,
                                half_width=10.0, length=200.0)
    vo = JVisualOdometry(config=JConfig({"stereo_depth_inferior_limit": 2.0, "stereo_depth_superior_limit": 60.0,
                                         "ba_assembly_precision": "f32"}), dataset=ds)
    assert vo.ba_mode == "inline" and vo.init()
    vo.run()
    T = vo.trajectory_T_wc()
    print(f"bench world, JAX reference, BA inline (f32): statuses {vo.statuses().tolist()}, keyframes "
          f"{sum(bool(o.kf_inserted) for o in vo.outputs)}, "
          f"ATE {evaluation.ate_rmse(T[:, :3, 3], ds.gt_T_wc[:n, :3, 3]):.6f} m")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bench-world", action="store_true")
    args = ap.parse_args()
    corridor()
    gauge()
    if args.bench_world:
        bench_world()


if __name__ == "__main__":
    main()
