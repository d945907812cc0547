"""One run of one cell: set-up, the measured window, the traced slice's
per-layer metrics, and the comparison with the reference.

Everything that belongs to a configuration, a traffic mix or a per-layer
metric is a file of its own, found by the names in BENCHMARK.json:
`configs/<config>.json` (as the cell's configuration entry names it),
`traffic/<traffic>.json`, and `metrics/<metric>.py` with a `read(ctx)`.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "legoslam_tpu")
LOST, INITING = 3, 0


class Cell:
    """A workload of BENCHMARK.json with its configuration, traffic and metrics."""

    def __init__(self, bench: dict, workload: str, root: Path = ROOT):
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json ({', '.join(cells)})")
        self.entry = cells[workload]
        self.name = workload
        configs = {c["name"]: c for c in bench["configs"]}
        self.config = json.loads((root / configs[self.entry["config"]]["file"]).read_text())
        self.traffic = json.loads((HERE / "traffic" / f"{self.entry['traffic']}.json").read_text())
        self.chips = int(self.entry["chips"])

        def mine(m):
            return "workloads" not in m or workload in m["workloads"]

        self.end_to_end = [m for m in bench["end_to_end"] if mine(m)]
        self.per_layer = [m for m in bench["per_layer"] if mine(m)]


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def reader(name: str):
    """The per-layer metric's reader, `metrics/<name>.py`."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def frames_to_render(cell: Cell, seconds: float) -> int:
    t = cell.traffic
    return min(int(cell.config["sequence_frames"]),
               int(t["warmup_max_frames"]) + int(math.ceil(float(t["max_frames_per_s"]) * seconds)) + 1)


def sample_plan(cell: Cell, seed: int, seconds: float, cap: Optional[int] = None):
    """Window frames and window keyframes (by their order) whose stages are
    compared, drawn from the seed among the frames the window is sure to
    reach (at most `cap`)."""
    s = cell.traffic["sample"]
    n_lo = max(1, int(float(s["min_frames_per_s"]) * seconds))
    n_lo = min(n_lo, cap) if cap else n_lo
    k_lo = max(1, n_lo // int(cell.config["settings"]["max_keyframe_gap"]))
    rng = np.random.default_rng([seed, 2])
    frames = set(rng.choice(n_lo, size=min(int(s["frames"]), n_lo), replace=False).tolist())
    keyframes = set(rng.choice(k_lo, size=min(int(s["keyframes"]), k_lo), replace=False).tolist())
    return frames, keyframes


def _record_to_numpy(rec: dict) -> dict:
    from portbench.reference.stages import to_numpy

    carry = rec["carry_in"]
    return {"frame_id": rec["frame_id"],
            "carry_in": {"feats": to_numpy(carry.feats), "wmap": to_numpy(carry.wmap),
                         "T_cur": to_numpy(carry.T_cur), "rel_motion": to_numpy(carry.rel_motion)},
            "stages": {tag: (to_numpy(a), to_numpy(kw), to_numpy(out))
                       for tag, (a, kw, out) in rec.get("stages", {}).items()}}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_start: Optional[float] = None, out_dir: Optional[Path] = None, log=print,
             control: bool = False) -> dict:
    """One run; returns the result line's fields and the numbers compared.
    With `control`, also the control's numbers (the reference in TF32 in
    the port's place, `reference.lowp`) on the same samples."""
    t_start = time.perf_counter() if t_start is None else t_start
    import torch

    from legoslam_tpu_torch.pipeline.visual_odometry import VisualOdometry
    from legoslam_tpu_torch.utils.config import Config
    from portbench import check
    from portbench.hooks import Hooks
    from portbench.reference.stages import Reference, to_numpy
    from portbench.stats import ate_rmse, latencies, percentile
    from portbench.world.source import DriveSource

    cfg, traffic = cell.config, cell.traffic
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    parts = {"imports": time.perf_counter() - t_start}
    t = time.perf_counter()
    n = frames_to_render(cell, seconds)
    if cuda:
        from legoslam_tpu_torch.kernels import _build

        with ThreadPoolExecutor(2) as pool:  # both sources build at once on a checkout's first run
            builds = [pool.submit(_build.load, name) for name in ("klt_anchored", "pose")]
            source = DriveSource(cfg["camera"], traffic["drive"], float(cfg["speed_m_per_frame"]), n, seed, dev)
            for b in builds:
                b.result()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    else:
        source = DriveSource(cfg["camera"], traffic["drive"], float(cfg["speed_m_per_frame"]), n, seed, dev)
    parts["build_and_render"] = time.perf_counter() - t

    t = time.perf_counter()
    hooks = Hooks().install()
    settings = cfg["settings"]
    vo = VisualOdometry(config=Config(settings), dataset=source, device=dev)
    if not vo.init():
        raise RuntimeError("VisualOdometry.init() failed")
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        with profile(activities=acts):  # the profiler's own first start, outside the window
            (torch.ones(8, device=dev) * 2).sum().item()
        prof = profile(activities=acts)
    samples = []
    # Warm-up: frame 0's stereo bootstrap is a sample (the start), then
    # until the keyframe window is full and one keyframe has evicted another.
    n_active = int(settings["num_active_keyframes"])
    warm, full = 0, False
    while True:
        hooks.record = {} if warm == 0 else None
        if not vo.step():
            raise RuntimeError("the course ran out of frames in the warm-up")
        if warm == 0:
            samples.append(hooks.record)
        hooks.record = None
        warm += 1
        out = vo.outputs[-1]
        if out.kf_inserted:
            if full:
                break
            full = int(vo.carry.wmap.num_keyframes()) >= n_active
        if warm >= int(traffic["warmup_max_frames"]):
            raise RuntimeError(f"the keyframe window did not fill in {warm} frames")
    # The set-up's garbage is collected and what survives it is frozen, so
    # no collection in the window walks the set-up's objects.
    gc.collect()
    gc.freeze()
    if cuda:
        torch.cuda.synchronize()
    parts["warmup"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t_start

    # --- the window -------------------------------------------------------
    # A traced run's window is its traced slice: `trace_frames` whole
    # frames of the same loop.
    trace_frames = int(traffic["trace_frames"]) if trace else 0
    pick_frames, pick_keyframes = sample_plan(cell, seed, seconds, trace_frames or None)
    open_loop = traffic["loop"] == "open"
    rate = float(traffic["rate_hz"]) if open_loop else None
    rows: List[dict] = []
    kf_ord = 0
    t0 = time.perf_counter() + (0.01 if open_loop else 0.0)
    prev_done = t0
    i = 0
    while True:
        if open_loop:
            due = t0 + i / rate
            if due >= t0 + seconds:
                break
            while time.perf_counter() < due:
                pass  # spin, so the host is as awake at each hand-over as in a closed loop
        else:
            due = prev_done
            if i > 0 and due - t0 >= seconds:
                break
        if trace and i == trace_frames:
            break
        if trace and i == 0:
            hooks.spans, hooks.sync, hooks.kernel_log = True, cuda, []
            prof.start()
        hooks.record = {}
        start = time.perf_counter()
        if trace:
            with torch.profiler.record_function("portbench.frame"):
                ok = vo.step()
                T = vo.outputs[-1].T_cw.cpu() if ok else None
        else:
            ok = vo.step()
            T = vo.outputs[-1].T_cw.cpu() if ok else None
        done = time.perf_counter()
        if not ok:
            raise RuntimeError("the course ran out of frames in the window")
        out = vo.outputs[-1]
        if i in pick_frames or (out.kf_inserted and kf_ord in pick_keyframes):
            samples.append(hooks.record)
        hooks.record = None
        rows.append({"due": due, "start": start, "done": done, "kf": bool(out.kf_inserted), "status": out.status,
                     "frame_id": int(vo.frame_ids[-1]), "T_cw": T.numpy(), "attempts": int(out.ba.attempts),
                     "dropped": out.ba.n_dropped_landmarks})
        kf_ord += int(out.kf_inserted)
        prev_done = done
        i += 1
    window_s = rows[-1]["done"] - t0
    if trace:
        prof.stop()
        hooks.spans = hooks.sync = False
        kernel_log, hooks.kernel_log = hooks.kernel_log, None
    if cuda:
        torch.cuda.synchronize()
        memory_peak = int(torch.cuda.max_memory_allocated(dev))
    else:
        memory_peak = 0
    found = forbidden_modules()

    # --- results of the window ------------------------------------------------
    lat = latencies([r["due"] for r in rows], [r["done"] for r in rows])
    values = {"frames_per_s": len(rows) / window_s, "frame_ms_p50": 1e3 * percentile(lat, 50),
              "frame_ms_p95": 1e3 * percentile(lat, 95), "setup_s": setup_s}
    failed = sum(1 for r in rows if r["status"] in (LOST, INITING))
    n_kf = sum(r["kf"] for r in rows)
    attempts = sum(r["attempts"] for r in rows)
    dropped = int(sum(int(r["dropped"]) for r in rows))
    ids = np.asarray([r["frame_id"] for r in rows])
    T_wc = np.linalg.inv(np.stack([r["T_cw"] for r in rows]).astype(np.float64))
    ate = ate_rmse(T_wc[:, :3, 3], source.ground_truth[ids, :3, 3])
    loop = f"open loop at {rate:g} Hz, latest hand-over {1e3 * max(r['start'] - r['due'] for r in rows):.3f} ms after due" \
        if open_loop else "closed loop"
    slowest = sorted(range(len(lat)), key=lambda k: -lat[k])[:5]
    log(f"window: {len(rows)} frames in {window_s:.6f} s ({loop}), {n_kf} keyframes, {attempts} LM attempts,"
        f" {dropped} dropped BA slots, {failed} LOST or re-initialising, ATE {ate:.6f} m over frames"
        f" {ids[0]}..{ids[-1]}; slowest frames (ms, keyframe): "
        + ", ".join(f"{1e3 * lat[k]:.3f}{' kf' if rows[k]['kf'] else ''}" for k in slowest))
    log("set-up: " + ", ".join(f"{k} {v:.3f} s" for k, v in parts.items()) + f", total {setup_s:.3f} s;"
        f" {warm} warm-up frames, {n} frames rendered")

    per_layer, device_extra, breakdown = {}, {}, None
    if trace:
        from portbench import traced

        path = (out_dir or Path.cwd()) / f"{cell.name}.{seed}.trace.json.gz"
        path.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(path))
        ctx = traced.Context(path, rows, [(tag, to_numpy(a), to_numpy(kw), to_numpy(o))
                                          for tag, a, kw, o in kernel_log])
        for m in cell.per_layer:
            v = reader(m["name"])(ctx)
            if v is not None:
                per_layer[m["name"]] = v
        device_extra = {"busy_s": ctx.busy_s, "window_s": ctx.window_s}
        breakdown = ctx.breakdown()
        log(f"traced slice: {len(ctx.frames)} frames, {ctx.window_s:.6f} s, device busy {ctx.busy_s:.6f} s,"
            f" trace {path}")

    # --- correct: the reference on the samples, the port's state freed ---------
    gc.unfreeze()
    samples = [_record_to_numpy(r) for r in samples]
    hooks.remove()
    del vo
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    ref = Reference(settings, np.asarray(cfg["camera"]["P0"]).reshape(3, 4),
                    np.asarray(cfg["camera"]["P1"]).reshape(3, 4), float(cfg["camera"]["image_scale"]))
    per_sample = [check.replay(ref, s, source.left, source.right) for s in samples]
    gaps = check.worst(per_sample)
    ok, rows_checked = check.verdict(gaps, cfg.get("limits", {}))
    stage_counts = {k: sum(k in s["stages"] for s in samples) for k in ("init", "track", "insert", "ba")}
    log(f"reference: {len(samples)} samples ({', '.join(f'{k} {v}' for k, v in stage_counts.items())}) in"
        f" {time.perf_counter() - t:.3f} s")
    control_gaps = None
    if control:
        from portbench.reference.lowp import Control

        low = Control(Reference(settings, np.asarray(cfg["camera"]["P0"]).reshape(3, 4),
                                np.asarray(cfg["camera"]["P1"]).reshape(3, 4), float(cfg["camera"]["image_scale"])))
        control_gaps = check.worst(check.replay(ref, s, source.left, source.right, control=low) for s in samples)
    return {"correct": ok and not found, "control": control_gaps, "attempted": len(rows), "failed": failed, "values": values,
            "per_layer": per_layer, "memory_peak": memory_peak, "device_extra": device_extra,
            "breakdown": breakdown, "checks": rows_checked, "forbidden": found, "per_sample": per_sample}
