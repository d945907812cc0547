"""The numbers behind PERF.md's window-BA parity findings, on the CPU.

    JAX_PLATFORMS=cpu python -m tests.ba_parity_report [--bench-world | --only-bench-world | --loop-records FILE
                                                        | --isa-spread | --kitti-window SEQ FRAME [--save OUT]
                                                        | --kitti-handover SEQ START END
                                                        | --kitti-stages SEQ START END [--save OUT] [--handover FILE]
                                                          [--card FILE] [--fixture-frame H]
                                                        | --probe-rounding [--save OUT] | --widened [SEQ]]

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
   bench world, once with the defaults and once with `track_mode: frame`
   and `stereo_matcher: klt`, each at `ba_assembly_precision: bf16` (the
   default) and at f32: the keyframe counts and ATEs that chip_smoke.py
   holds the port to (about 40 s each); and the port on the CPU in the same
   configuration, against that reference run: keyframes, both ATEs, and the
   two trajectories' distance after a rigid alignment (what the card's ATE
   bars rest on);
4. with --loop-records FILE: the keyframe records that
   `scripts/loop_course_scan.py --dump` wrote on the card go through the
   reference's `LoopCloser` and the port's (on the CPU) in order; prints
   every closure of each beside the card's, with the measured loop
   transform's distance from the ground truth's (--save-pair OUT writes
   the two records of the card's worst closure:
   tests/data/loop_pair_tail80.npz was made so);
5. with --isa-spread: the reference's own spread across XLA's CPU
   instruction sets (`--xla_cpu_max_isa` unset, AVX2, SSE4_2; each in a
   process of its own, about a minute each), on what the parity tests
   compare: the 14-frame corridor with BA inline (at f32, and at the
   default bf16 with window BA's chi per keyframe), the tiny-window run with
   the prior, one `ba_step` per LM strategy and `solve_window`'s
   information on shared maps (the unset setting's), and the hook run of
   tests/test_torch_loop.py; beside it the port (on the CPU, which no such
   flag moves) against each setting.  The first frame at which the settings
   part and what parts there (the window's poses relative to its oldest
   keyframe, or a count) are printed first.  The parity tests' bars are set
   from these numbers;
6. with --kitti-window SEQ FRAME: on a KITTI sequence (e.g. the soak's, as
   `scripts/kitti_soak_torch.py` renders it) the reference's map just
   before keyframe FRAME's window BA, through both packages' `ba_step` at
   bf16 and f32, whole and cut to its window (--save OUT writes the cut
   map: tests/data/kitti_soak_window_f25.npz was made so);
7. with --kitti-handover SEQ START END: the reference's carry after START
   frames of that sequence, stepped by the port through frame END; window
   BA's chi on each keyframe frame beside the reference's own run's;
8. with --kitti-stages SEQ START END: for each h in START..END the
   reference's carry after h frames (its run under XLA's own instruction
   set), and frame h stepped from it stage by stage (tests/kitti_stages.py:
   pyramids, prior, tracking, pose, keyframe decision, and on a keyframe
   eviction, GFTT, anchors, stereo, triangulation, the BA problem and
   `ba_step`, each stage fed the unset setting's inputs), then one and five
   whole frames, by the reference under each of the three settings (each in
   a process of its own, which loads the carries and loops over h) and by
   the port on the CPU; with --card FILE also the port on a card (what
   `python tests/kitti_stages.py HANDOVER FILE` wrote there from the file
   --handover keeps).  Prints, for each (h, quantity), the settings' spread,
   the port's gap to each setting and its bar (twice the spread, or the
   unit test's bar where the settings agree exactly), then the first (h,
   quantity) at which the port passes its bar.  --save OUT writes the
   fixture of tests/test_torch_kitti_stages.py at --fixture-frame (default:
   that first frame, else 25);
9. with --probe-rounding: how the reference rounds the pose's small
   products, constant divisions, square roots and 6x6 solve under the three
   settings, against the port (tests/rounding_probe.py); --save OUT writes
   tests/test_torch_rounding_frontend.py's fixture;
10. with --widened [SEQ]: chip_smoke.py step 17's three runs, by the JAX
   reference and by the port, on the CPU: (a) and (b) the 40-frame bench
   world with BA inline at its defaults and `klt_half_patch` 5 and 9 with
   `max_features` 8192, (c) the first 30 frames of the KITTI soak at
   376x1240 (SEQ, or rendered into a temporary directory as chip_smoke.py
   writes it) with config/kitti_00.yaml, `image_scale` 1.0, `track_mode:
   frame` and `klt_pyramid_levels` 9; prints each run's statuses,
   keyframes and ATE, and the port's distance from the reference.
"""

from __future__ import annotations

import argparse
import itertools
import os
import pickle
import subprocess
import sys
import tempfile

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
from tests import kitti_stages as ks
from tests.torch_parity import compact_window, step_gap, to_numpy, tree_to_numpy, window_gap


def corridor() -> None:
    ref = tv.run_reference_inline()
    vo = VisualOdometry(config=Config({**tv.OVERRIDES, **tv.F32}), dataset=tv._dataset(tv.TDataset), device="cpu")
    vo.init()
    vo.run()
    dT = np.abs(vo.trajectory_T_cw() - ref["T_cw"]).max(axis=(1, 2))
    T_wc, gt = vo.trajectory_T_wc(), ref["gt_T_wc"][:, :3, 3]
    print("corridor, BA inline: max |dT_cw| per frame", np.array2string(dT, precision=7))
    print(f"corridor, BA inline (both at f32): keyframes port {vo.keyframe_flags().astype(int).tolist()} "
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
    for (name, modes), precision in itertools.product(
            (("defaults", {}), ("track_mode frame + stereo_matcher klt", {"track_mode": "frame", "stereo_matcher": "klt"})),
            ("bf16", "f32")):
        # bf16 is both packages' default; f32 is pinned on both sides.
        pin = {} if precision == "bf16" else {"ba_assembly_precision": "f32"}
        ds = SyntheticPlanesDataset(n_frames=n, shape=(188, 620), focal=360.0, baseline=0.54, speed=0.12,
                                    half_width=10.0, length=200.0)
        vo = JVisualOdometry(config=JConfig({"stereo_depth_inferior_limit": 2.0, "stereo_depth_superior_limit": 60.0,
                                             **pin, **modes}), dataset=ds)
        assert vo.ba_mode == "inline" and vo.init()
        vo.run()
        T = vo.trajectory_T_wc()
        kf = np.asarray([bool(o.kf_inserted) for o in vo.outputs])
        print(f"bench world, JAX reference, BA inline ({precision}), {name}: statuses {vo.statuses().tolist()}, "
              f"keyframes {int(kf.sum())}, ATE {evaluation.ate_rmse(T[:, :3, 3], ds.gt_T_wc[:n, :3, 3]):.6f} m")
        from legoslam_tpu_torch.pipeline.dataset import SyntheticPlanesDataset as TDataset

        tds = TDataset(n_frames=n, shape=(188, 620), focal=360.0, baseline=0.54, speed=0.12, half_width=10.0,
                       length=200.0)
        port = VisualOdometry(config=Config({"stereo_depth_inferior_limit": 2.0, "stereo_depth_superior_limit": 60.0,
                                             **pin, **modes}), dataset=tds, device="cpu")
        assert port.ba_mode == "inline" and port.init()
        port.run()
        P = port.trajectory_T_wc()
        print(f"bench world, port on the CPU ({precision}), {name}: statuses equal "
              f"{bool((port.statuses() == vo.statuses()).all())}, keyframe flags equal "
              f"{bool((port.keyframe_flags() == kf).all())} ({int(port.keyframe_flags().sum())}), ATE "
              f"{evaluation.ate_rmse(P[:, :3, 3], tds.gt_T_wc[:n, :3, 3]):.6f} m; port against reference, rigidly "
              f"aligned: {evaluation.ate_rmse(P[:, :3, 3], T[:, :3, 3]):.6f} m")


def widened(seq: str = None) -> None:
    import multiprocessing
    import shutil
    from concurrent.futures import ProcessPoolExecutor

    import chip_smoke
    from legoslam_tpu.pipeline.dataset import KittiDataset as JKitti
    from legoslam_tpu.pipeline.dataset import SyntheticPlanesDataset as JDataset
    from legoslam_tpu.pipeline.visual_odometry import VisualOdometry as JVisualOdometry
    from legoslam_tpu.utils.config import Config as JConfig
    from legoslam_tpu_torch.pipeline.dataset import KittiDataset as TKitti
    from legoslam_tpu_torch.pipeline.dataset import SyntheticPlanesDataset as TDataset

    tmp = None
    if seq is None:
        tmp = tempfile.mkdtemp(prefix="legoslam_widened_")
        seq = os.path.join(tmp, "07")
        with ProcessPoolExecutor(2, mp_context=multiprocessing.get_context("spawn")) as pool:
            chip_smoke.start_soak_sequence(pool, 2, seq, chip_smoke.WIDE_KITTI_FRAMES)()
    try:
        bench = dict(n_frames=chip_smoke.N_FRAMES, shape=chip_smoke.SHAPE, focal=360.0, baseline=0.54, speed=0.12,
                     half_width=10.0, length=200.0)
        base = {"stereo_depth_inferior_limit": 2.0, "stereo_depth_superior_limit": 60.0}
        yaml = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "config", "kitti_00.yaml")
        runs = [(f"({k}) bench world, {over}", lambda over=over: JConfig({**base, **over}),
                 lambda over=over: Config({**base, **over}), lambda: JDataset(**bench), lambda: TDataset(**bench),
                 chip_smoke.N_FRAMES) for k, over in chip_smoke.WIDE_BENCH.items()]
        runs.append((f"(c) KITTI soak at 376x1240, {chip_smoke.WIDE_KITTI}",
                     lambda: JConfig.from_yaml(yaml).override(**chip_smoke.WIDE_KITTI),
                     lambda: Config.from_yaml(yaml).override(**chip_smoke.WIDE_KITTI),
                     lambda: JKitti(seq, scale=1.0), lambda: TKitti(seq, scale=1.0), chip_smoke.WIDE_KITTI_FRAMES))
        for name, jcfg, tcfg, jds, tds, n in runs:
            out = {}
            for who, vo in (("JAX reference", JVisualOdometry(config=jcfg(), dataset=jds())),
                            ("port", VisualOdometry(config=tcfg(), dataset=tds(), device="cpu"))):
                assert vo.init()
                for _ in range(n):
                    assert vo.step()
                T = vo.trajectory_T_wc()
                gt = vo.dataset.ground_truth[:n]
                kf = np.asarray(vo.keyframe_flags() if who == "port" else [bool(o.kf_inserted) for o in vo.outputs])
                out[who] = (vo.statuses(), kf, T)
                print(f"widened {name}, {who} on the CPU: statuses {vo.statuses().tolist()}, keyframes "
                      f"{int(kf.sum())}, ATE {evaluation.ate_rmse(T[:, :3, 3], gt[:, :3, 3]):.6f} m", flush=True)
            (s_j, k_j, T_j), (s_t, k_t, T_t) = out["JAX reference"], out["port"]
            print(f"widened {name}: statuses equal {bool((s_j == s_t).all())}, keyframe flags equal "
                  f"{bool((k_j == k_t).all())}, port against reference, rigidly aligned: "
                  f"{evaluation.ate_rmse(T_t[:, :3, 3], T_j[:, :3, 3]):.6f} m", flush=True)
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)


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


def kitti_handover(seq: str, start: int, end: int) -> None:
    """The reference's carry after `start` frames of a KITTI sequence (the
    default config) handed to the port, which steps frames `start`..`end`;
    prints window BA's chi on every keyframe frame beside the reference's."""
    from legoslam_tpu.pipeline.dataset import KittiDataset as JKitti
    from legoslam_tpu.pipeline.visual_odometry import VisualOdometry as JVisualOdometry
    from legoslam_tpu.utils.config import Config as JConfig
    from legoslam_tpu_torch.pipeline import frontend
    from legoslam_tpu_torch.pipeline.dataset import KittiDataset
    from legoslam_tpu_torch.pipeline.visual_odometry import process_frame
    from tests.torch_parity import t

    vo = JVisualOdometry(config=JConfig({"dataset_dir": seq}), dataset=JKitti(seq, use_native=False))
    assert vo.init()
    for _ in range(start):
        assert vo.step()
    carry = state.carry_from_numpy(tree_to_numpy(vo.carry))
    for _ in range(start, end + 1):
        assert vo.step()
    ref_chi = {int(i): float(o.ba_chi) for i, o in enumerate(vo.outputs) if bool(o.kf_inserted)}
    ds = KittiDataset(seq, use_native=False)
    assert ds.init()
    config = Config({"dataset_dir": seq})
    cfg = frontend.FrontendConfig.from_config(config)
    ba_cfg = backend.BAConfig(assembly_precision=config["ba_assembly_precision"])
    ds.seek(start)
    for k in range(start, end + 1):
        fr = ds.next_frame()
        carry, o = process_frame(cfg, ds.rig, carry, t(fr.left), t(fr.right), k, ba_cfg)
        if o.kf_inserted:
            print(f"kitti handover after {start} frames: keyframe frame {k}, window BA chi port {float(o.ba_chi):.5f} "
                  f"reference {ref_chi.get(k, float('nan')):.5f}, tracked {int(o.n_tracked)}")


def kitti_window(seq: str, frame: int, out: str = None) -> None:
    """The reference's world map just before keyframe `frame`'s BA on a KITTI
    sequence (the default config, as `scripts/kitti_soak_torch.py` runs it):
    its run to `frame`, then `frame` stepped without BA from a copy of the
    carry.  Prints both packages' `ba_step` at bf16 and f32 on that map and
    on its window cut to the landmarks it sees (`compact_window`); with
    `out`, writes the cut map and the sequence's projections there (what
    tests/test_torch_backend.py's KITTI-window test reads)."""
    import jax
    import jax.numpy as jnp

    from legoslam_tpu.pipeline.dataset import KittiDataset as JKitti
    from legoslam_tpu.pipeline.visual_odometry import VisualOdometry as JVisualOdometry
    from legoslam_tpu.utils.config import Config as JConfig

    conf = JConfig({"dataset_dir": seq})
    vo = JVisualOdometry(config=conf, dataset=JKitti(seq, use_native=False))
    assert vo.init()
    for _ in range(frame):
        assert vo.step()
    carry = jax.tree_util.tree_map(jnp.copy, vo.carry)
    frames = JKitti(seq, use_native=False)
    assert frames.init()
    for _ in range(frame + 1):
        fr = frames.next_frame()
    assert fr.frame_id == frame
    pre = JVisualOdometry(config=conf, dataset=JKitti(seq, use_native=False), inline_ba=False)
    assert pre.init()
    carry, o = pre._step_fn(carry, jnp.asarray(fr.left, jnp.float32), jnp.asarray(fr.right, jnp.float32),
                             jnp.asarray(frame, jnp.int32))
    assert bool(o.kf_inserted), f"frame {frame} is not a keyframe"
    full = tree_to_numpy(carry.wmap)
    cut = compact_window(full)
    with open(os.path.join(seq, "calib.txt")) as f:
        P = [np.asarray([float(v) for v in line.split()[1:]]).reshape(3, 4) for line in f if line[:2] in ("P0", "P1")]
    if out:
        np.savez_compressed(out, P0=P[0], P1=P[1], frame=frame, **ks.flat(cut, "wmap/"))
        print(f"kitti window: wrote {out} ({os.path.getsize(out)} bytes)")
    for name, d in (("the run's map", full), ("cut to its window", cut)):
        for precision in ("bf16", "f32"):
            chi = tb.kitti_window_solves(d, P, precision)
            print(f"kitti window, frame {frame}, {name} ({len(d['lm_pos'])} landmark slots), {precision}: "
                  f"ba_step chi reference {chi['reference']:.5f} port {chi['port']:.5f} (relative "
                  f"{abs(chi['port'] - chi['reference']) / chi['reference']:.5f}); relative poses apart "
                  f"{chi['window_gap']:.2e}; LM iterations {chi['iterations']}")


ISAS = ("", "AVX2", "SSE4_2")  # "": XLA's own choice for the host
ISA_NAMES = tuple(isa or "unset" for isa in ISAS)


def _run_isa(isa, *args) -> None:
    """This module with `args` in a process of its own, under XLA's CPU
    instruction set `isa` ("" leaves it unset)."""
    flags = os.environ.get("XLA_FLAGS", "") + (f" --xla_cpu_max_isa={isa}" if isa else "")
    subprocess.run([sys.executable, "-m", "tests.ba_parity_report", *args], check=True,
                   env={**os.environ, "XLA_FLAGS": flags.strip(), "JAX_PLATFORMS": "cpu"})


def _hook_closers():
    from tests import test_torch_loop as tl

    return {"plain": tl._StubCloser, "corrected": lambda: tl._FixedCorrection(7, tl._yaw_pose(4.0, [0.3, -0.1, 0.5]))}


def _isa_runs(out: str) -> None:
    """The reference's runs for --isa-spread under this process's XLA_FLAGS,
    and the maps the map-level tests start from, pickled to `out`."""
    from tests import test_torch_loop as tl
    from tests import test_torch_marg as tm

    res = {}
    r = tv.run_reference_inline()
    res["corridor"] = {k: r[k] for k in ("statuses", "kf", "T_wc", "final_window", "ba_chi")}
    r = tv.run_reference_inline(tv.DEFAULT)
    res["corridor_bf16"] = {k: r[k] for k in ("statuses", "kf", "T_wc", "final_window", "ba_chi")}
    r = tm.run_reference_tiny()
    res["tiny"] = {k: r[k] for k in ("statuses", "kf", "T_wc", "final_window", "final_marg")}
    res["maps"] = {"window": tb.reference_maps()["maps"]["window"], "carry5": r["carries"][5]["wmap"]}
    res["hook"] = {name: tl.reference_hook_run(make()) for name, make in _hook_closers().items()}
    with open(out, "wb") as f:
        pickle.dump(res, f)


def _map_solves(maps, jax_side: bool):
    """One `ba_step` per LM strategy on tests/test_torch_backend.py's noisy
    window map, and `solve_window`'s information on tests/test_torch_marg.py's
    map after frame 5: by the reference (`jax_side`) or the port."""
    from legoslam_tpu.pipeline.dataset import SyntheticPlanesDataset as JDataset
    from legoslam_tpu.utils.config import Config as JConfig
    from legoslam_tpu_torch.pipeline.dataset import SyntheticPlanesDataset as TDataset
    from tests import test_torch_marg as tm

    rig = (JDataset if jax_side else TDataset)(n_frames=1, shape=(160, 240), focal=260.0, baseline=0.54).rig
    noisy = tb._noisy(maps["window"])
    out = {}
    for strategy in ("default", "strategy1"):
        if jax_side:
            m, st = j_backend.ba_step(tb.j_frontend.FrontendConfig.from_config(JConfig(tb.CONFIG)), rig,
                                      tb._jtree(tb.JWorldMap, noisy), j_backend.BAConfig(strategy=strategy, trace=True))
        else:
            m, st = backend.ba_step(tb.frontend.FrontendConfig.from_config(Config(tb.CONFIG)), rig,
                                    state.worldmap_from_numpy(noisy), backend.BAConfig(strategy=strategy, trace=True))
        out[strategy] = {"kf_pose": to_numpy(m.kf_pose), "kf_valid": noisy["kf_valid"], "kf_id": noisy["kf_id"],
                         "chi": float(st.chi)}
    if jax_side:
        res = j_backend.solve_window(tm.j_frontend.FrontendConfig.from_config(JConfig(tm.TINY)), rig,
                                     tb._jtree(tb.JWorldMap, maps["carry5"]),
                                     j_backend.BAConfig(assembly_precision="f32"))
    else:
        res = backend.solve_window(tm.frontend.FrontendConfig.from_config(Config(tm.TINY)), rig,
                                   state.worldmap_from_numpy(maps["carry5"]))
    out["info"] = {"S": to_numpy(res.info[0]), "b": to_numpy(res.info[1]), "chi": float(res.stats.chi)}
    return out


def _isa_map_solves(out: str, runs: str) -> None:
    """The reference's `_map_solves` under this process's XLA_FLAGS on every
    setting's maps (`runs`: the pickled `_isa_runs` outputs, by setting)."""
    with open(runs, "rb") as f:
        maps = pickle.load(f)
    with open(out, "wb") as f:
        pickle.dump({name: _map_solves(m, True) for name, m in maps.items()}, f)


def _port_runs():
    from legoslam_tpu_torch.pipeline.dataset import SyntheticPlanesDataset as TDataset
    from tests import test_torch_loop as tl
    from tests import test_torch_marg as tm

    port = {}
    for name, conf in (("corridor", {**tv.OVERRIDES, **tv.F32}), ("tiny", {**tm.TINY, **tv.F32}),
                       ("corridor_bf16", tv.OVERRIDES)):
        vo = VisualOdometry(config=Config(conf), dataset=tv._dataset(TDataset), device="cpu")
        vo.init()
        vo.run()
        window = {k: to_numpy(getattr(vo.carry.wmap, k)) for k in ("kf_pose", "kf_valid", "kf_id")}
        port[name] = {"statuses": vo.statuses(), "kf": vo.keyframe_flags(), "T_wc": vo.trajectory_T_wc(),
                      "final_window": window, "ba_chi": np.asarray([float(o.ba_chi) for o in vo.outputs]),
                      "final_marg": {k: to_numpy(v) for k, v in vars(vo.carry.wmap.marg).items()}}
    port["hook"] = {}
    for name, make in _hook_closers().items():
        vo = VisualOdometry(config=Config({**tl.HOOK_CONFIG, **tv.F32}), dataset=tl._hook_dataset(TDataset),
                            device="cpu")
        vo.init()
        vo.loop_closer = make()
        vo.run()
        port["hook"][name] = (vo.trajectory_T_cw(), vo.keyframe_flags())
    return port


def _run_gaps(a, b):
    """What the parity tests of whole runs compare, between two runs `a` and
    `b` (two reference settings, or the port and a setting)."""
    from legoslam_tpu_torch.utils import evaluation as ev

    g = {}
    for name in ("corridor", "tiny"):
        x, y = a[name], b[name]
        g[f"{name}: statuses, keyframes equal"] = float((x["statuses"] == y["statuses"]).all()
                                                        and (x["kf"] == y["kf"]).all())
        g[f"{name}: max |d position| (m)"] = float(np.abs(x["T_wc"][:, :3, 3] - y["T_wc"][:, :3, 3]).max())
        g[f"{name}: rigidly aligned distance (m)"] = ev.ate_rmse(x["T_wc"][:, :3, 3], y["T_wc"][:, :3, 3])
        g[f"{name}: final window, relative poses"] = window_gap(x["final_window"], y["final_window"])
    g["corridor: frame-to-frame motion, non-keyframe steps (m)"] = step_gap(
        a["corridor"]["T_wc"], b["corridor"]["T_wc"], a["corridor"]["kf"])
    H = [np.asarray(r["tiny"]["final_marg"]["prior_J"], np.float64) for r in (a, b)]
    H = [J.T @ J for J in H]
    g["tiny: final prior H, of its largest entry"] = float(np.abs(H[0] - H[1]).max() / np.abs(H[1]).max())
    (Ta, kfa), (Tb, _) = a["hook"]["corrected"], b["hook"]["corrected"]
    g["hook corrected: max |d T_cw|"] = float(np.abs(Ta - Tb).max())
    g["hook corrected: frame-to-frame motion, non-keyframe steps (m)"] = step_gap(
        np.linalg.inv(Ta), np.linalg.inv(Tb), kfa)
    for name, r in (("a", a), ("b", b)):  # each package's own timing: frame 9 corrected, frame 8 not
        (T, _), (P, _) = r["hook"]["corrected"], r["hook"]["plain"]
        G = _hook_closers()["corrected"]().G
        g[f"hook {name}: frame 8 against its plain run"] = float(np.abs(T[8] - P[8]).max())
        g[f"hook {name}: frame 9 against its plain run, corrected"] = float(
            np.abs(T[9] - P[9] @ np.linalg.inv(G)).max())
    return g


def _default_gaps(x, y):
    """What tests/test_torch_vo.py's default-path tests compare, between two
    corridor runs at the default precision (`y` a reference setting)."""
    from legoslam_tpu_torch.utils import evaluation as ev

    g = {"statuses, keyframes equal": float((x["statuses"] == y["statuses"]).all() and (x["kf"] == y["kf"]).all())}
    for k in np.nonzero(y["kf"])[0][1:]:  # the first BA, one keyframe, ends at a chi at the rounding level
        g[f"window BA chi at keyframe frame {k}, relative"] = abs(x["ba_chi"][k] - y["ba_chi"][k]) / abs(y["ba_chi"][k])
    g["final window, relative poses"] = window_gap(x["final_window"], y["final_window"])
    g["rigidly aligned distance (m)"] = ev.ate_rmse(x["T_wc"][:, :3, 3], y["T_wc"][:, :3, 3])
    g["frame-to-frame motion, non-keyframe steps (m)"] = step_gap(x["T_wc"], y["T_wc"], y["kf"])
    return g


def _solve_gaps(a, b):
    g = {}
    for strategy in ("default", "strategy1"):
        x, y = a[strategy], b[strategy]
        g[f"ba_step {strategy}: relative poses"] = window_gap(x, y)
        g[f"ba_step {strategy}: chi, relative"] = abs(x["chi"] - y["chi"]) / abs(y["chi"])
    for k in ("S", "b"):
        x, y = a["info"][k], b["info"][k]
        g[f"solve_window info {k}, of its largest entry"] = float(np.abs(x - y).max() / np.abs(y).max())
    return g


def _table(title, pairs, versus) -> None:
    print(title)
    names = list(next(iter(pairs.values())))
    print(f"  {'quantity':60s} " + " ".join(f"{k:>14s}" for k in [*pairs, "ref spread", *versus]))
    for n in names:
        spread = max(p[n] for p in pairs.values())
        cells = [p[n] for p in pairs.values()] + [spread] + [v[n] for v in versus.values()]
        print(f"  {n:60s} " + " ".join(f"{c:14.6f}" for c in cells))


def isa_spread() -> None:
    names = list(ISA_NAMES)
    with tempfile.TemporaryDirectory() as tmp:
        def load(path):
            with open(os.path.join(tmp, path), "rb") as f:
                return pickle.load(f)

        for isa, name in zip(ISAS, names):
            _run_isa(isa, "--isa-runs", os.path.join(tmp, f"runs-{name}.pkl"))
        runs = {name: load(f"runs-{name}.pkl") for name in names}
        with open(os.path.join(tmp, "maps.pkl"), "wb") as f:
            pickle.dump({name: r["maps"] for name, r in runs.items()}, f)
        for isa, name in zip(ISAS, names):
            _run_isa(isa, "--isa-map-solves", os.path.join(tmp, f"solves-{name}.pkl"), os.path.join(tmp, "maps.pkl"))
        solves = {name: load(f"solves-{name}.pkl") for name in names}  # [setting][map's setting]

    T = [r["corridor"]["T_wc"] for r in runs.values()]
    d = np.max([np.abs(a[:, :3, 3] - b[:, :3, 3]).max(-1) for a, b in itertools.combinations(T, 2)], axis=0)
    print(f"corridor: largest |d position| between settings per frame (m): {np.array2string(d, precision=5)}")
    print(f"corridor: the settings first part (> 1e-3 m) at frame {int(np.argmax(d > 1e-3))}; keyframe flags "
          f"{runs['unset']['corridor']['kf'].astype(int).tolist()}")
    for name in names[1:]:
        a, b = runs["unset"], runs[name]
        k = 1
        print(f"corridor, frame {k}'s window BA, unset against {name}: chi {a['corridor']['ba_chi'][k]:.5f} / "
              f"{b['corridor']['ba_chi'][k]:.5f}")

    port = _port_runs()
    for key, precision in (("corridor_bf16", "the default (bf16)"), ("corridor", "f32")):
        for name, r in [*((n, runs[n][key]) for n in names), ("port", port[key])]:
            print(f"corridor at {precision}, {name}: window BA chi at keyframe frames "
                  f"{np.nonzero(r['kf'])[0].tolist()}: {np.array2string(r['ba_chi'][r['kf']], precision=5)}")
    _table("corridor at the default (bf16 on both sides; the last columns: the port at bf16, then at f32, against "
           "each setting):",
           {f"{a}/{b}": _default_gaps(runs[a]["corridor_bf16"], runs[b]["corridor_bf16"])
            for a, b in itertools.permutations(names, 2)},
           {**{f"port/{a}": _default_gaps(port["corridor_bf16"], runs[a]["corridor_bf16"]) for a in names},
            **{f"f32 port/{a}": _default_gaps(port["corridor"], runs[a]["corridor_bf16"]) for a in names}})
    _table("whole runs (the port on the CPU against each setting in the last columns):",
           {f"{a}/{b}": _run_gaps(runs[a], runs[b]) for a, b in itertools.combinations(names, 2)},
           {f"port/{a}": _run_gaps(port, runs[a]) for a in names})
    for m in names:
        port_m = _map_solves(runs[m]["maps"], False)
        _table(f"map-level solves on the {m} setting's maps:",
               {f"{a}/{b}": _solve_gaps(solves[a][m], solves[b][m]) for a, b in itertools.combinations(names, 2)},
               {f"port/{a}": _solve_gaps(port_m, solves[a][m]) for a in names})


def _kitti_stages_ref(seq: str, start: int, end: int, steps: int, out: str, feed: str = None) -> None:
    """The reference's side of --kitti-stages under this process's XLA_FLAGS.
    Without `feed`: its run of the sequence, the carries after START..END
    frames, the frames they step, and each carry's stage chain and whole
    steps, written to `out` (the handover file).  With `feed` (a handover
    file): each carry's stages fed by that file's chains, and whole steps."""
    if feed is not None:
        d = dict(np.load(feed))
        ops = ks.RefOps({}, d["P0"], d["P1"])
        res = {}
        for h in d["handovers"].tolist():
            carry = ks.unflat(d, f"carry{h}/")
            frames = [(d[f"frame{k}/left"], d[f"frame{k}/right"]) for k in range(h, h + steps)]
            res.update(ks.flat(ks.stage_outputs(ops, carry, *frames[0], h, feed=ks.sub(d, f"ref{h}/")), f"stages{h}/"))
            res.update(ks.flat(ks.step_outputs(ops, carry, frames, h, steps), f"steps{h}/"))
        np.savez(out, **res)
        return
    from legoslam_tpu.pipeline.dataset import KittiDataset as JKitti

    with open(os.path.join(seq, "calib.txt")) as f:
        P = [np.asarray([float(v) for v in line.split()[1:]]).reshape(3, 4) for line in f if line[:2] in ("P0", "P1")]
    ops = ks.RefOps({}, *P)
    ds = JKitti(seq, use_native=False)
    assert ds.init()
    frames = []
    for _ in range(end + steps):
        fr = ds.next_frame()
        frames.append(tuple(np.asarray(x) for x in (fr.left, fr.right)))
    assert all(np.array_equal(x, np.round(x)) and 0 <= x.min() and x.max() <= 255 for f in frames for x in f)
    frames = [tuple(x.astype(np.uint8) for x in f) for f in frames]
    # the reference's run, as its VisualOdometry steps it (the same jitted step)
    carry = ops.j_vo.initial_carry(ops.cfg, frames[0][0].shape)
    carries = {0: tree_to_numpy(carry)}
    for k in range(end):
        carry, _ = ops.step(carry, ops.dev(frames[k][0]), ops.dev(frames[k][1]), k)
        carries[k + 1] = tree_to_numpy(carry)
    res = {"P0": P[0], "P1": P[1], "handovers": np.arange(start, end + 1), "steps": np.asarray(steps)}
    for k in range(start, end + steps):
        res[f"frame{k}/left"], res[f"frame{k}/right"] = frames[k]
    for h in range(start, end + 1):
        res.update(ks.flat(carries[h], f"carry{h}/"))
        chain = ks.stage_outputs(ops, carries[h], *frames[h], h)
        res.update(ks.flat(chain, f"ref{h}/"))
        res.update(ks.flat(chain, f"stages{h}/"))
        res.update(ks.flat(ks.step_outputs(ops, carries[h], frames[h:h + steps], h, steps), f"steps{h}/"))
    np.savez(out, **res)


def _print_handover(h: int, settings: dict, port: dict, gaps_fn, first: dict) -> None:
    """One handover's table of stages or steps (`gaps_fn`): per quantity the
    settings' spread, the port's gap to each setting (and the card's, where
    `port` has it) and the bar; records in `first[p]` the first frame at
    which each quantity of port `p` passes its bar."""
    spread = ks.spread(gaps_fn, settings)
    cols = {(p, n): gaps_fn(port[p], settings[n]) for p in port for n in settings}
    for q in ks.UNIT_BARS:
        if q not in spread:
            continue
        bar = ks.bar(q, spread[q])
        stage = q not in ks.FIVE_STEPS + ks.BA_SOLVE  # how a gap grows, and BA's own solve: not stages
        past = {p for (p, _), c in cols.items() if c[q] > bar}
        flag = ("  PARTS" if stage else "  (past twice the spread)") if past else ""
        for p in past if stage else ():
            first.setdefault(p, {}).setdefault(q, h)
        print(f"  h={h:3d} {q:28s} spread {spread[q]:11.4g}  "
              + "  ".join(f"{p}/{n} {c[q]:11.4g}" for (p, n), c in cols.items()) + f"  bar {bar:.4g}{flag}")


def kitti_stages(seq: str, start: int, end: int, save: str = None, handover: str = None, card: str = None,
                 fixture_frame: int = None, steps: int = 5) -> None:
    with tempfile.TemporaryDirectory() as tmp:
        hfile = handover or os.path.join(tmp, "handover.npz")
        _run_isa("", "--kitti-stages-ref", seq, str(start), str(end), str(steps), hfile)
        d = dict(np.load(hfile))
        runs = {"unset": d}
        for isa, name in zip(ISAS[1:], ISA_NAMES[1:]):
            path = os.path.join(tmp, f"{name}.npz")
            _run_isa(isa, "--kitti-stages-ref", seq, str(start), str(end), str(steps), path, "--feed", hfile)
            runs[name] = dict(np.load(path))
    ops = ks.port_ops({}, d["P0"], d["P1"], "cpu")
    ports = {"port": ks.run_handover(d, ops, steps)}
    if card:
        ports["card"] = dict(np.load(card))
    first = {}
    for h in d["handovers"].tolist():
        print(f"kitti stages: carry after {h} frames, frame {h} stage by stage (each stage fed the unset chain):")
        _print_handover(h, {n: ks.sub(r, f"stages{h}/") for n, r in runs.items()},
                        {p: ks.sub(r, f"stages{h}/") for p, r in ports.items()}, ks.stage_gaps, first)
        _print_handover(h, {n: ks.sub(r, f"steps{h}/") for n, r in runs.items()},
                        {p: ks.sub(r, f"steps{h}/") for p, r in ports.items()}, ks.step_gaps, first)
        if f"ref{h}/pose/T" in d:
            jit = np.abs(d[f"ref{h}/pose/T"] - d[f"steps{h}/T_cw"][0]).max()
            print(f"  h={h:3d} the unset chain's pose against its whole step (functions jitted alone against the "
                  f"fused step): {jit:.3g}")
    if card:
        card_against_port(ports["port"], ports["card"], d["handovers"].tolist())
    order = list(ks.UNIT_BARS)
    for p in ports:
        if first.get(p):
            h, q = min((h, order.index(q), q) for q, h in first[p].items())[::2]
            print(f"kitti stages: the {p} first passes its bar at h={h}, {q}; first frame per quantity: {first[p]}")
        else:
            print(f"kitti stages: the {p} stays within its bars at every stage over frames {start}..{end}")
    if save:
        h = fixture_frame if fixture_frame is not None else min(first.get("port", {}).values(), default=25)
        write_stage_fixture(save, d, runs, h)


def card_against_port(cpu: dict, card: dict, handovers) -> None:
    """Print the stage outputs in which the card's run of the handovers
    differs from the port's on the CPU, bit for bit, with the handovers
    where they do, and the whole steps' largest position gap per h."""
    differ = {}
    for k in cpu:
        if k.startswith("stages") and k in card and not np.array_equal(cpu[k], card[k], equal_nan=True):
            h, q = k[len("stages"):].split("/", 1)
            differ.setdefault(q, []).append(int(h))
    print(f"kitti stages: the card against the port on the CPU, stage outputs that differ bit for bit (at h): "
          f"{differ if differ else 'none'}")
    gaps = {h: np.abs(ks.centres(cpu[f"steps{h}/T_cw"]) - ks.centres(card[f"steps{h}/T_cw"])).max(axis=-1)
            for h in handovers}
    print("kitti stages: the card against the port on the CPU, largest position gap (m) per h after one whole "
          "step / after all: " + ", ".join(f"{h}: {g[0]:.3g} / {g.max():.3g}" for h, g in gaps.items()))


def write_stage_fixture(path: str, d: dict, runs: dict, h: int) -> None:
    """tests/test_torch_kitti_stages.py's fixture: the unset setting's carry
    after `h` frames and frame h (uint8), the inputs its stages are fed,
    and each setting's stage outputs and one whole step.  Kept small: the
    anchors and pyramids are not stored, since the port rebuilds them bit for
    bit (checked here: the carry's anchors from the last keyframe's left
    image, the frame's pyramids and anchors against the unset chain's);
    `pyr_last` is zeroed (anchored tracking never reads it); an output that
    every setting gives alike is stored once ("all/...")."""
    import hashlib

    from legoslam_tpu_torch.ops import klt, pyramid

    carry = ks.unflat(d, f"carry{h}/")
    wmap = carry["wmap"]
    kf_frame = int(wmap["kf_frame_id"][wmap["kf_valid"]].max())
    ops = ks.port_ops({}, d["P0"], d["P1"], "cpu")
    kf_left = d[f"frame{kf_frame}/left"]
    rebuilt = ops.np(klt.extract_anchors(tuple(pyramid.build_pyramid(ops.dev(kf_left), ks.LEVELS)),
                                         ops.dev(carry["feats"]["anchor_uv"]), ops.cfg.klt))
    assert np.array_equal(rebuilt, carry["feats"]["anchor"]), "the carry's anchors are not rebuilt bit for bit"
    feed = ks.sub(d, f"ref{h}/")
    left, right = d[f"frame{h}/left"], d[f"frame{h}/right"]
    for name, img in (("pyr_l", left), ("pyr_r", right)):
        for i, lvl in enumerate(pyramid.build_pyramid(ops.dev(img), ks.LEVELS)):
            assert np.array_equal(ops.np(lvl), feed[f"{name}/{i}"]), f"{name} level {i} is not rebuilt bit for bit"
    if "detect/uv" in feed:
        pyr = tuple(ops.dev(feed[f"pyr_l/{i}"]) for i in range(ks.LEVELS))
        anchors = ops.np(klt.extract_anchors(pyr, ops.dev(feed["detect/uv"]), ops.cfg.klt))
        assert np.array_equal(anchors, feed["anchors/anchor"]), "the frame's anchors are not rebuilt bit for bit"

    def rebuilt_key(k):
        return k.startswith(("pyr_l/", "pyr_r/", "anchors/"))

    def digest(a):
        return hashlib.sha1(np.ascontiguousarray(a).tobytes()).hexdigest()

    carry["feats"]["anchor"] = np.zeros_like(carry["feats"]["anchor"])
    carry["pyr_last"] = [np.zeros_like(p) for p in carry["pyr_last"]]
    out = {"P0": d["P0"], "P1": d["P1"], "h": np.asarray(h), "kf_frame": np.asarray(kf_frame), "kf_left": kf_left,
           "left": left, "right": right, **ks.flat(carry, "carry/"),
           **{f"feed/{k}": v for k, v in feed.items() if not rebuilt_key(k) and not k.startswith(("ba/", "insert/"))}}
    outputs = {name: {**{f"stages/{k}": v for k, v in ks.sub(r, f"stages{h}/").items()
                         if not rebuilt_key(k) and not k.startswith(("wmapk/", "ba/", "insert/"))},
                      **{f"steps/{k}": v[:1] for k, v in ks.sub(r, f"steps{h}/").items()}}
               for name, r in runs.items()}
    for k in outputs["unset"]:
        values = [outputs[name][k] for name in runs]
        if all(np.array_equal(values[0], v) for v in values[1:]):
            out[f"all/{k}"] = values[0]
        else:
            out.update({f"{name}/{k}": v for name, v in zip(runs, values)})
    for name, r in runs.items():
        for k in ("pyr_l", "pyr_r"):
            out[f"digest/{name}/{k}"] = np.asarray(digest(np.concatenate([r[f"stages{h}/{k}/{i}"].ravel()
                                                                           for i in range(ks.LEVELS)])))
    np.savez_compressed(path, **out)
    print(f"kitti stages: wrote the fixture at h={h} to {path} ({os.path.getsize(path)} bytes)")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bench-world", action="store_true")
    ap.add_argument("--loop-records", default=None, metavar="FILE")
    ap.add_argument("--save-pair", default=None, metavar="OUT",
                    help="with --loop-records: write the two records of the card's worst closure, for tests/data")
    ap.add_argument("--only-bench-world", action="store_true", help="skip the corridor and gauge reports")
    ap.add_argument("--isa-spread", action="store_true")
    ap.add_argument("--kitti-window", nargs=2, default=None, metavar=("SEQ", "FRAME"),
                    help="the reference's map before keyframe FRAME's BA on the KITTI sequence SEQ")
    ap.add_argument("--save", default=None, metavar="OUT",
                    help="with --kitti-window: write the cut map; with --kitti-stages or --probe-rounding: write "
                         "the test's fixture")
    ap.add_argument("--kitti-handover", nargs=3, default=None, metavar=("SEQ", "START", "END"),
                    help="the reference's carry after START frames stepped by the port to frame END")
    ap.add_argument("--kitti-stages", nargs=3, default=None, metavar=("SEQ", "START", "END"),
                    help="the reference's carries after START..END frames stepped stage by stage")
    ap.add_argument("--handover", default=None, metavar="FILE",
                    help="with --kitti-stages: keep the reference's carries, frames and chains (the card's input)")
    ap.add_argument("--card", default=None, metavar="FILE",
                    help="with --kitti-stages: the port's outputs on a card (python tests/kitti_stages.py)")
    ap.add_argument("--fixture-frame", type=int, default=None, metavar="H",
                    help="with --kitti-stages --save: the handover the fixture holds")
    ap.add_argument("--probe-rounding", action="store_true",
                    help="how the reference rounds the pose's small products under XLA's CPU settings")
    ap.add_argument("--widened", nargs="?", const="", default=None, metavar="SEQ")
    ap.add_argument("--kitti-stages-ref", nargs=5, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--feed", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--isa-runs", default=None, metavar="OUT", help=argparse.SUPPRESS)
    ap.add_argument("--isa-map-solves", nargs=2, default=None, metavar=("OUT", "MAPS"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.probe_rounding:
        from tests import rounding_probe

        rounding_probe.probe_rounding(args.save)
        return
    if args.widened is not None:
        widened(args.widened or None)
        return
    if args.kitti_stages_ref:
        seq, start, end, steps, out = args.kitti_stages_ref
        _kitti_stages_ref(seq, int(start), int(end), int(steps), out, args.feed)
        return
    if args.kitti_stages:
        kitti_stages(args.kitti_stages[0], *map(int, args.kitti_stages[1:]), save=args.save, handover=args.handover,
                     card=args.card, fixture_frame=args.fixture_frame)
        return
    if args.isa_runs:
        _isa_runs(args.isa_runs)
        return
    if args.isa_map_solves:
        _isa_map_solves(*args.isa_map_solves)
        return
    if args.isa_spread:
        isa_spread()
        return
    if args.kitti_handover:
        kitti_handover(args.kitti_handover[0], *map(int, args.kitti_handover[1:]))
        return
    if args.kitti_window:
        kitti_window(args.kitti_window[0], int(args.kitti_window[1]), args.save)
        return
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
