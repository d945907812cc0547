"""Rank processes for tests/test_torch_dist_ba.py (not collected by pytest).

    python -m tests.dist_ba_ranks PROBLEM.npz OUT.npz WORLD

Starts WORLD processes on this machine, joined over gloo at
tcp://127.0.0.1:<a free port>, each with one torch thread.  Every rank
loads the same problem (a BA graph with its start values, and a world map
with the backend's configuration), runs the port's distributed LM solve
(`parallel.dist_ba.make_dist_solve_fn`) on the graph and `backend.ba_step`
with that solve on the map, and rank 0 writes what every rank got to OUT.
Imports torch and the port only.
"""

from __future__ import annotations

import json
import socket
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from legoslam_tpu_torch.parallel import dist_ba, mesh as mesh_mod
from legoslam_tpu_torch.pipeline import backend, frontend, state
from legoslam_tpu_torch.pipeline.dataset import SyntheticPlanesDataset
from legoslam_tpu_torch.solver import lm, reprojection, schur
from legoslam_tpu_torch.utils.config import Config


def _unflatten(d, prefix):
    out = {}
    for k, v in d.items():
        if k.startswith(prefix):
            node, *path = k[len(prefix):].split("/")
            cur = out
            for p in [node, *path][:-1]:
                cur = cur.setdefault(p, {})
            cur[([node, *path])[-1]] = v
    return out


def load_problem(path):
    d = dict(np.load(path))
    g = _unflatten(d, "graph/")
    graph = schur.BAGraph(
        e_pose=torch.from_numpy(g["e_pose"]), e_point=torch.from_numpy(g["e_point"]),
        e_cam=torch.from_numpy(g["e_cam"]), e_uv=torch.from_numpy(g["e_uv"]), e_valid=torch.from_numpy(g["e_valid"]),
        exts=torch.from_numpy(g["exts"]), intr=reprojection.Intrinsics(*(float(v) for v in g["intr"])),
        pose_fixed=torch.from_numpy(g["pose_fixed"]), point_valid=torch.from_numpy(g["point_valid"]))
    cfg = lm.LMConfig(**json.loads(str(d["lm_cfg"])))
    return graph, torch.from_numpy(d["poses0"]), torch.from_numpy(d["points0"]), cfg, d


def _rank(rank, world, port, problem, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world, rank=rank)
    try:
        mesh = mesh_mod.make_mesh()
        assert (mesh.rank, mesh.world_size, mesh.device.type) == (rank, world, "cpu")
        solve_fn = dist_ba.make_dist_solve_fn(mesh)
        graph, poses0, points0, cfg, d = load_problem(problem)
        st, res = solve_fn(graph, poses0, points0, cfg)
        fcfg = frontend.FrontendConfig.from_config(Config(json.loads(str(d["vo_config"]))))
        rig = SyntheticPlanesDataset(n_frames=1, shape=(160, 240), focal=260.0, baseline=0.54).rig
        wmap = state.worldmap_from_numpy(_unflatten(d, "wmap/"))
        m, stats = backend.ba_step(fcfg, rig, wmap, backend.BAConfig(), solve_fn=solve_fn)
        mine = torch.cat([st.poses.reshape(-1), st.points.reshape(-1), res.chi.reshape(1),
                          m.kf_pose.reshape(-1), m.lm_pos.reshape(-1), stats.chi.reshape(1)])
        every = [torch.empty_like(mine) for _ in range(world)]
        dist.all_gather(every, mine)
        if rank == 0:
            np.savez(out, poses=st.poses.numpy(), points=st.points.numpy(), chi=res.chi.numpy(),
                     iterations=res.iterations, attempts=res.attempts, ba_kf_pose=m.kf_pose.numpy(),
                     ba_lm_pos=m.lm_pos.numpy(), ba_chi=stats.chi.numpy(), ba_n_inlier=stats.n_inlier.numpy(),
                     ba_obs_left=m.kf_obs_left.numpy(), every=torch.stack(every).numpy())
    finally:
        dist.destroy_process_group()


def main(problem, out, world):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mp.start_processes(_rank, args=(world, port, problem, out), nprocs=world, join=True, start_method="spawn")


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2], int(sys.argv[3]))
