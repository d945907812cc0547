"""What summing the BA blocks in a fixed order costs, on one GPU.

    python3 scripts/ba_order_bench.py [--widths 2048 4096] [--reps 10]

`solver/schur.py` sums the per-edge blocks into the pose, landmark and
cross blocks in an order fixed by the graph (padded gathers, `BAOrder`); it
used to sum them with `index_add_`, which on a card adds duplicate indices
in no fixed order.  For each BA width L (`max_active_landmarks`) this
script drives chip_smoke's 40-frame bench world through `VisualOdometry`
(the default path, BA inline, K=16, E=5120, 512 lanes) twice on the card
and prints both trajectories' digests, keeps the map just before the last
keyframe's BA, and times `backend.ba_step` on it with the fixed order and
with the old `index_add_` assembly (a copy of it below, with no order
tables), alternating A B B A, `--reps` calls each: wall ms per call (CUDA
events; median), and whether two calls give the same bits.
"""

from __future__ import annotations

import argparse
import hashlib
import multiprocessing
import os
import sys
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from legoslam_tpu_torch.pipeline import backend  # noqa: E402
from legoslam_tpu_torch.pipeline.visual_odometry import VisualOdometry  # noqa: E402
from legoslam_tpu_torch.solver import robust, schur  # noqa: E402
from legoslam_tpu_torch.utils.config import Config  # noqa: E402


def index_add_build_blocks(graph, poses, points, kernel, delta, with_chi=False, order=None, assembly_precision="f32"):
    """The assembly as it was: the same per-edge blocks (the cross terms
    rounded to bfloat16 where `assembly_precision` says so, as
    `schur.build_blocks` does), summed by `index_add_`."""
    K, L = poses.shape[0], points.shape[0]
    r, J = schur._edge_core(graph, poses, schur._finite(points), jacobians=True)
    vm = schur.edge_mask(graph)
    r = torch.where(vm[:, None], r, 0.0)
    e2 = (r * r).sum(-1)
    rho0, rho1, rho2 = robust.rho(kernel, e2, delta)
    keep = rho1 + 2.0 * rho2 * e2 > 1e-5 * rho1
    two_r2 = torch.where(keep, 2.0 * rho2, 0.0)
    eye2 = torch.eye(2, dtype=r.dtype, device=r.device)
    W = rho1[:, None, None] * eye2 + two_r2[:, None, None] * (r[:, :, None] * r[:, None, :])
    W = torch.where(vm[:, None, None], W, 0.0)
    drho = torch.where(vm, rho1, 0.0)
    pose_m = vm & ~graph.pose_fixed[graph.e_pose]
    col_m = torch.cat([pose_m[:, None].expand(-1, 6), vm[:, None].expand(-1, 3)], dim=1)
    J = torch.where(col_m[:, None, :], J, 0.0)
    H_e = (J.transpose(1, 2) @ W) @ J
    b_e = -drho[:, None] * (J * r[:, :, None]).sum(1)
    e_pose, e_point = graph.e_pose.long(), graph.e_point.long()
    dt, dev = r.dtype, r.device
    Hpp = torch.zeros((K, 6, 6), dtype=dt, device=dev).index_add_(0, e_pose, H_e[:, :6, :6])
    Hll = torch.zeros((L, 3, 3), dtype=dt, device=dev).index_add_(0, e_point, H_e[:, 6:, 6:])
    cross = H_e[:, :6, 6:]
    if assembly_precision == "bf16":
        cross = cross.to(torch.bfloat16).to(dt)
    Hpl = torch.zeros((K * L, 6, 3), dtype=dt, device=dev).index_add_(0, e_pose * L + e_point, cross)
    bp = torch.zeros((K, 6), dtype=dt, device=dev).index_add_(0, e_pose, b_e[:, :6])
    bl = torch.zeros((L, 3), dtype=dt, device=dev).index_add_(0, e_point, b_e[:, 6:])
    blocks = schur.BABlocks(Hpp=Hpp, Hll=Hll, Hpl=Hpl.view(K, L, 6, 3), bp=bp, bl=bl)
    if with_chi:
        return blocks, 0.5 * torch.where(vm, rho0, 0.0).sum()
    return blocks


FIXED = (schur.build_blocks, schur.order_for)
INDEX_ADD = (index_add_build_blocks, lambda graph, K, L, widths=None: None)


def use(assembly) -> None:
    schur.build_blocks, schur.order_for = assembly


def digest(a: np.ndarray) -> str:
    return hashlib.sha1(np.ascontiguousarray(a).tobytes()).hexdigest()[:12]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--widths", type=int, nargs="*", default=[2048, 4096])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ba_order_bench: no CUDA device")
    with ProcessPoolExecutor(8, mp_context=multiprocessing.get_context("spawn")) as pool:
        frames = chip_smoke.render_worlds(pool, 8, ("bench",))()["bench"]
    ds = chip_smoke.bench_world(chip_smoke.N_FRAMES)
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader").read().strip()
    print(f"card: {smi}; torch {torch.__version__}; deterministic algorithms "
          f"{torch.are_deterministic_algorithms_enabled()}", flush=True)
    ba_step = backend.ba_step
    for L in args.widths:
        config = Config({"stereo_depth_inferior_limit": 2.0, "stereo_depth_superior_limit": 60.0,
                         "max_active_landmarks": L})
        captured, digests = [], []
        for run in range(2):
            backend.ba_step = lambda *a: (captured.append(a), ba_step(*a))[1]
            try:
                vo = VisualOdometry(config=config, dataset=chip_smoke.FrameList(frames, ds.rig))
                assert vo.init()
                while vo.step():
                    pass
            finally:
                backend.ba_step = ba_step
            digests.append(digest(vo.trajectory_T_cw()))
        cfg, rig, wmap, ba_cfg = captured[-1]
        n_edges = int(backend.build_problem(cfg, rig, wmap)[0].graph.e_valid.sum())
        print(f"L={L}: default path twice, trajectory sha1 {digests[0]} {digests[1]}, bit-equal "
              f"{digests[0] == digests[1]}; last BA map: K={cfg.caps.window} E={cfg.caps.ba_edges}, "
              f"{n_edges} valid edges", flush=True)
        times = {"fixed": [], "index_add": []}
        bits = {}
        for name in ("fixed", "index_add", "index_add", "fixed"):
            use(FIXED if name == "fixed" else INDEX_ADD)
            try:
                outs = [ba_step(cfg, rig, wmap, ba_cfg) for _ in range(2)]  # warm, and two calls' bits
                times[name].append(chip_smoke.wall_ms(lambda: ba_step(cfg, rig, wmap, ba_cfg), args.reps))
            finally:
                use(FIXED)
            same = all(torch.equal(getattr(outs[0][0], f), getattr(outs[1][0], f))
                       for f in ("kf_pose", "lm_pos", "kf_obs_left", "kf_obs_right"))
            bits.setdefault(name, []).append(same)
            st = outs[0][1]
            print(f"L={L} {name}: {times[name][-1]:.3f} ms per ba_step (wall, median of {args.reps}), chi "
                  f"{float(st.chi):.6f}, iterations {st.iterations}, attempts {st.attempts}, two calls bit-equal "
                  f"{same}", flush=True)
        print(f"L={L}: fixed order {np.mean(times['fixed']):.3f} ms vs index_add_ {np.mean(times['index_add']):.3f} "
              f"ms per ba_step (mean of the two medians each), on {smi}", flush=True)


if __name__ == "__main__":
    main()
