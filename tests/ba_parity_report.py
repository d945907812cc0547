"""The numbers behind PERF.md's window-BA parity findings, on the CPU.

    JAX_PLATFORMS=cpu python -m tests.ba_parity_report [--bench-world | --only-bench-world | --loop-records FILE]

Not a test (pytest does not collect it); it runs what the parity tests
check and prints the values beside their bars:
1. the 14-frame test corridor with window BA inline, port against the JAX
   reference (tests/test_torch_vo.py): per-frame |T_cw| difference, the
   largest position difference, both ATEs;
2. the window's free gauge on the reference's 4-keyframe map with noise
   (tests/test_torch_backend.py): `solve_ba` with the oldest keyframe
   fixed, and the full `ba_step`, whose window may end a rigid motion away
   from the reference's, per LM strategy;
3. with --bench-world: the JAX reference's BA-inline runs of the 40-frame
   bench world at `ba_assembly_precision: f32`, once with the defaults and
   once with `track_mode: frame` and `stereo_matcher: klt`: the keyframe
   counts and ATEs that chip_smoke.py holds the port to (about 40 s each);
   and the port on the CPU in the second configuration, against that
   reference run: keyframes, both ATEs, and the two trajectories' distance
   after a rigid alignment (what the card's ATE bar there rests on);
4. with --loop-records FILE: the keyframe records that
   `scripts/loop_course_scan.py --dump` wrote on the card go through the
   reference's `LoopCloser` and the port's (on the CPU) in order; prints
   every closure of each beside the card's, with the measured loop
   transform's distance from the ground truth's (--save-pair OUT writes
   the two records of the card's worst closure:
   tests/data/loop_pair_tail80.npz was made so).
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
    for name, modes in (("defaults", {}), ("track_mode frame + stereo_matcher klt",
                                           {"track_mode": "frame", "stereo_matcher": "klt"})):
        ds = SyntheticPlanesDataset(n_frames=n, shape=(188, 620), focal=360.0, baseline=0.54, speed=0.12,
                                    half_width=10.0, length=200.0)
        vo = JVisualOdometry(config=JConfig({"stereo_depth_inferior_limit": 2.0, "stereo_depth_superior_limit": 60.0,
                                             "ba_assembly_precision": "f32", **modes}), dataset=ds)
        assert vo.ba_mode == "inline" and vo.init()
        vo.run()
        T = vo.trajectory_T_wc()
        kf = np.asarray([bool(o.kf_inserted) for o in vo.outputs])
        print(f"bench world, JAX reference, BA inline (f32), {name}: statuses {vo.statuses().tolist()}, keyframes "
              f"{int(kf.sum())}, ATE {evaluation.ate_rmse(T[:, :3, 3], ds.gt_T_wc[:n, :3, 3]):.6f} m")
        if not modes:
            continue
        from legoslam_tpu_torch.pipeline.dataset import SyntheticPlanesDataset as TDataset

        tds = TDataset(n_frames=n, shape=(188, 620), focal=360.0, baseline=0.54, speed=0.12, half_width=10.0,
                       length=200.0)
        port = VisualOdometry(config=Config({"stereo_depth_inferior_limit": 2.0, "stereo_depth_superior_limit": 60.0,
                                             **modes}), dataset=tds, device="cpu")
        assert port.ba_mode == "inline" and port.init()
        port.run()
        P = port.trajectory_T_wc()
        print(f"bench world, port on the CPU, {name}: statuses equal "
              f"{bool((port.statuses() == vo.statuses()).all())}, keyframe flags equal "
              f"{bool((port.keyframe_flags() == kf).all())} ({int(port.keyframe_flags().sum())}), ATE "
              f"{evaluation.ate_rmse(P[:, :3, 3], tds.gt_T_wc[:n, :3, 3]):.6f} m; port against reference, rigidly "
              f"aligned: {evaluation.ate_rmse(P[:, :3, 3], T[:, :3, 3]):.6f} m")


def loop_records(path: str, save_pair: str = None) -> None:
    from legoslam_tpu.pipeline import loop_closure as j_loop
    from legoslam_tpu.pipeline.dataset import SyntheticPlanesDataset as JDataset
    from legoslam_tpu_torch.pipeline import loop_closure
    from legoslam_tpu_torch.pipeline.dataset import SyntheticPlanesDataset as TDataset

    d = np.load(path)
    world = dict(n_frames=1, shape=(188, 620), focal=360.0, baseline=0.54)
    closers = {"reference": j_loop.LoopCloser(JDataset(**world).rig),
               "port on the CPU": loop_closure.LoopCloser(TDataset(**world).rig, device="cpu")}
    gt_cw = np.linalg.inv(d["gt_T_wc"][d["frame_id"]])

    def off_truth(i, j, M):
        return float(np.linalg.norm(M[:3, 3] - (gt_cw[i] @ np.linalg.inv(gt_cw[j]))[:3, 3]))

    card = [(int(i), int(j), off_truth(i, j, M)) for (i, j), M, c in zip(d["edge"], d["M"], d["closed"]) if c]
    print(f"loop records {path}: {len(d['frame_id'])} keyframes; the card closed (i, j, |t(M) - t(M_true)| m): "
          f"{[(i, j, round(e, 3)) for i, j, e in card]}")
    worst = max(card, key=lambda e: e[2])
    for name, lc in closers.items():
        closed = []
        for k in range(len(d["frame_id"])):
            n = int(d["n_feats"][k])
            full = np.repeat(np.repeat(d["img_half"][k], 2, axis=0), 2, axis=1)  # add_keyframe takes every second pixel
            before = dict(lc.stats)
            chain = np.stack([r.T_cw for r in lc.records] + [d["T_cw"][k]])  # the poses `_verify` sees at keyframe k
            out = lc.add_keyframe(int(d["frame_id"][k]), full, d["T_cw"][k], d["uv"][k, :n], d["p_world"][k, :n])
            if out is not None:
                i, j, M = lc.loop_edges[-1]
                closed.append((i, j, round(off_truth(i, j, M), 3)))
                if save_pair and name != "reference" and (i, j) == worst[:2]:
                    ri, rj = lc.records[i], lc.records[j]
                    np.savez_compressed(
                        save_pair, i=i, j=j, T_cw=chain, M_card=d["M"][k], M_true=gt_cw[i] @ np.linalg.inv(gt_cw[j]),
                        **{f"{f}_{w}": getattr(r, f) for w, r in (("i", ri), ("j", rj))
                           for f in ("frame_id", "T_cw_obs", "img", "uv", "p_world", "n_feats")})
                    print(f"  wrote the records of the closure ({i}, {j}) to {save_pair}")
            if (out is not None) != bool(d["closed"][k]):
                # from here on the recorded poses belong to another world epoch than this closer's
                print(f"  {name}: parts from the card at keyframe {k} (frame {int(d['frame_id'][k])}): closed "
                      f"{out is not None}, the card {bool(d['closed'][k])}; candidates tried here "
                      f"{lc.stats['candidates'] - before['candidates']}")
                break
        print(f"  {name}: closed {closed}, stats {lc.stats}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bench-world", action="store_true")
    ap.add_argument("--loop-records", default=None, metavar="FILE")
    ap.add_argument("--save-pair", default=None, metavar="OUT",
                    help="with --loop-records: write the two records of the card's worst closure, for tests/data")
    ap.add_argument("--only-bench-world", action="store_true", help="skip the corridor and gauge reports")
    args = ap.parse_args()
    if args.loop_records:
        loop_records(args.loop_records, args.save_pair)
        return
    if not args.only_bench_world:
        corridor()
        gauge()
    args.bench_world |= args.only_bench_world
    if args.bench_world:
        bench_world()


if __name__ == "__main__":
    main()
