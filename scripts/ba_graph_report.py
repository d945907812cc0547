"""Window BA's LM attempt as one captured CUDA graph against the eager loop,
on a card (solver/ba_graph.py).

    python3 scripts/ba_graph_report.py [--frames 38] [--active-landmarks 4096]

Runs the corridor on the card (160x240, a keyframe every second frame) and
takes its last window BA call, 15 keyframes, at the given landmark width
(4,096 is the benchmark's `kitti00` width; K=16, E=5,120).  On that window,
at bf16 assembly as the default path, it prints:
- whether `lm.solve_ba` through the graphs gives the eager `lm_optimize`'s
  bits (poses, points, chi, lambda, iterations, attempts);
- the first solve's time, capture included, and the solve times after it,
  eager and through the graphs (host clock, each ended by a synchronize);
- per attempt: the host time issuing it (eager: `lm.lm_select` op by op;
  graph: one `replay()`, also under a `torch.profiler` as a traced run
  has it), and its device time (CUDA events);
- kernels per attempt in a `torch.profiler` trace of an eager solve and of
  a graph solve (whether the profiler sees a graph's kernels one by one);
- the attempt graph's nodes by type (`cudaGraphGetNodes`).
"""

from __future__ import annotations

import argparse
import collections
import os
import statistics
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from legoslam_tpu_torch.pipeline import backend  # noqa: E402
from legoslam_tpu_torch.pipeline.dataset import SyntheticPlanesDataset  # noqa: E402
from legoslam_tpu_torch.pipeline.visual_odometry import VisualOdometry  # noqa: E402
from legoslam_tpu_torch.solver import ba_graph, lm, robust, schur  # noqa: E402
from legoslam_tpu_torch.utils.config import Config  # noqa: E402


def last_window(frames: int, active_landmarks: int):
    calls = []
    ba_step = backend.ba_step
    backend.ba_step = lambda *a, **kw: (calls.append(a), ba_step(*a, **kw))[1]
    try:
        ds = SyntheticPlanesDataset(n_frames=frames, shape=(160, 240), focal=260.0, baseline=0.54, speed=0.25)
        vo = VisualOdometry(config=Config({"stereo_depth_inferior_limit": 2.0, "stereo_depth_superior_limit": 50.0,
                                           "detect_mask_half": 6, "gftt_min_distance": 6, "max_keyframe_gap": 2,
                                           "max_active_landmarks": active_landmarks}), dataset=ds)
        assert vo.init()
        vo.run()
    finally:
        backend.ba_step = ba_step
    return calls[-1]


def timed(fn):
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t)


def kernels_in(fn) -> int:
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)


def graph_nodes(g) -> collections.Counter:
    """A captured graph's nodes by type (`cudaGraphGetNodes`, `cudaGraphNodeGetType`)."""
    import ctypes

    rt = ctypes.CDLL("libcudart.so.12")
    graph, n = ctypes.c_void_p(g.raw_cuda_graph()), ctypes.c_size_t(0)
    assert rt.cudaGraphGetNodes(graph, None, ctypes.byref(n)) == 0
    nodes = (ctypes.c_void_p * n.value)()
    assert rt.cudaGraphGetNodes(graph, nodes, ctypes.byref(n)) == 0
    names = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "graph", 5: "empty", 6: "wait_event",
             7: "event_record"}
    kinds = collections.Counter()
    for node in nodes:
        kind = ctypes.c_int()
        rt.cudaGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind))
        kinds[names.get(kind.value, str(kind.value))] += 1
    return kinds


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=38)
    ap.add_argument("--active-landmarks", type=int, default=4096)
    args = ap.parse_args(argv)
    print(f"card: {torch.cuda.get_device_name()}, torch {torch.__version__}, CUDA {torch.version.cuda}")

    cfg_f, rig, wmap, ba_cfg = last_window(args.frames, args.active_landmarks)
    p, _ = backend.build_problem(cfg_f, rig, wmap)
    KW, NF = cfg_f.caps.window, cfg_f.caps.max_features
    order = schur.order_for(p.graph, KW, p.points.shape[0], widths=(2 * NF, 2 * KW, 2))
    cfg = lm.LMConfig(assembly_precision=ba_cfg.assembly_precision)
    print(f"window: {int(wmap.num_keyframes())} keyframes, K={p.poses.shape[0]}, L={p.points.shape[0]},"
          f" E={p.graph.e_pose.shape[0]}, tables {[tuple(t.shape) for t in order]}, {cfg.assembly_precision}")
    fns = lm.ba_functions(p.graph, order, None, robust.HUBER, 5.991, cfg)
    state0 = lm.BAState(p.poses, p.points)

    def eager():
        return lm.lm_optimize(fns, state0, cfg)

    def graphed():
        return lm.solve_ba(p.graph, p.poses, p.points, cfg=cfg, order=order)[1]

    ba_graph._SOLVERS.clear()
    ref, ms_eager0 = timed(eager)
    res, ms_first = timed(graphed)
    same = all(torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))
               for a, b in zip((*ref.state, ref.chi, ref.lam), (*res.state, res.chi, res.lam)))
    same = same and (ref.iterations, ref.attempts) == (res.iterations, res.attempts)
    print(f"bits equal: {same} (iterations {res.iterations}, attempts {res.attempts}, chi {float(res.chi):.6f})")
    ms_e = [timed(eager)[1] for _ in range(5)]
    ms_g = [timed(graphed)[1] for _ in range(5)]
    print(f"solve ms: eager first {ms_eager0:.3f}, graph first (capture included) {ms_first:.3f};"
          f" then eager {' '.join(f'{x:.3f}' for x in ms_e)}, graph {' '.join(f'{x:.3f}' for x in ms_g)}")
    print(f"solve ms medians: eager {statistics.median(ms_e):.3f}, graph {statistics.median(ms_g):.3f};"
          f" per attempt {statistics.median(ms_e) / res.attempts:.4f} against {statistics.median(ms_g) / res.attempts:.4f}")

    # One attempt: host time issuing it, and its device time.
    solver = next(iter(ba_graph._SOLVERS.values()))
    first, attempt = solver.graphs
    host_e, host_g, dev_e, dev_g = [], [], [], []
    c0 = lm.lm_begin(fns, state0, cfg)
    for _ in range(10):
        for kind in ("eager", "graph"):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            t = time.perf_counter()
            if kind == "eager":
                lm.lm_select(fns, c0, cfg)
            else:
                attempt.replay()
            host = 1e3 * (time.perf_counter() - t)
            end.record()
            torch.cuda.synchronize()
            (host_e if kind == "eager" else host_g).append(host)
            (dev_e if kind == "eager" else dev_g).append(start.elapsed_time(end))
    med = statistics.median
    print(f"attempt host ms: eager {med(host_e):.4f}, graph replay {med(host_g):.4f};"
          f" device ms (events): eager {med(dev_e):.4f}, graph {med(dev_g):.4f}")

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        traced = []
        for _ in range(10):
            torch.cuda.synchronize()
            t = time.perf_counter()
            attempt.replay()
            traced.append(1e3 * (time.perf_counter() - t))
        torch.cuda.synchronize()
    print(f"attempt host ms under torch.profiler: graph replay {med(traced):.4f}")

    n_e, n_g = kernels_in(eager), kernels_in(graphed)
    print(f"profiler kernels per attempt: eager {n_e / ref.attempts:.1f}, graph {n_g / res.attempts:.1f}"
          f" ({n_e} and {n_g} over a solve of {res.attempts} attempts)")

    g = torch.cuda.CUDAGraph(keep_graph=True)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    sfns = lm.ba_functions(solver.inputs[0], solver.inputs[3], None, robust.HUBER, 5.991, cfg)
    with torch.cuda.graph(g, stream=side, capture_error_mode="thread_local"):  # as ba_graph's, never replayed
        ba_graph._copy((solver.carry, solver.flags), lm.lm_select(sfns, solver.carry, cfg))
    print(f"attempt graph nodes: {dict(graph_nodes(g))}")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
