"""What the two apps share: the device check, the config flags, the
checkpoint flags and `--profile`."""

from __future__ import annotations

import argparse
import os

import torch


def add_common_flags(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--no_ba", action="store_true", help="disable sliding-window BA")
    ap.add_argument("--stop_after", type=int, default=0,
                    help="process only this many frames, then save --save_checkpoint and exit")
    ap.add_argument("--save_checkpoint", default="",
                    help="path to write a VO checkpoint (.npz) at the end of the run")
    ap.add_argument("--load_checkpoint", default="",
                    help="resume from a VO checkpoint written by --save_checkpoint")
    ap.add_argument("--log_every", type=int, default=0,
                    help="log per-frame counters every N frames (0 = silent)")
    ap.add_argument("--verbose", action="store_true",
                    help="per-frame counters + per-iteration BA chi/lambda trace "
                         "(the reference's problem.cpp:180-184 solver log)")
    ap.add_argument("--viz_every", type=int, default=0,
                    help="live viewer stream: keep a feature-overlay + "
                         "follow-mode map frame every N frames and assemble "
                         "a tracking.gif (0 = final-state rendering only)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; cpu runs the kernels' plain versions)")
    ap.add_argument("--profile", default="", metavar="A:B",
                    help="run frames A..B-1 of this run under torch.profiler, write "
                         "<out_dir>/profile.trace.json.gz and log the program's spans")


def apply_flags(config, args) -> None:
    if args.verbose:
        config["log_every_n_frames"] = 1
        config["ba_trace"] = True
    elif args.log_every:
        config["log_every_n_frames"] = args.log_every
    if args.viz_every:
        config["viewer_every_n"] = args.viz_every


def device_ok(device: str, log) -> bool:
    """False (and an error logged) where a CUDA device is asked for and none is present."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        log.error("no CUDA device for --device %s; pass --device cpu to run on the CPU", device)
        return False
    return True


def _profile_window(spec: str):
    """`--profile A:B` as (A, B), or None where the flag is not given."""
    if not spec:
        return None
    a, _, b = spec.partition(":")
    try:
        window = int(a), int(b)
    except ValueError:
        raise SystemExit(f"--profile takes A:B, two frame counts; got {spec!r}") from None
    if not 0 <= window[0] < window[1]:
        raise SystemExit(f"--profile A:B needs 0 <= A < B; got {spec!r}")
    return window


class _FrameProfiler:
    """`torch.profiler` over frames A..B-1 of a run (counted from its first
    step), on the CPU and, where the run is on a card, the card.  At B, or
    at the run's end, writes the trace to `path` and logs the program's
    spans (utils/timer.py `summary`)."""

    def __init__(self, window, device: str, path: str, log):
        from torch.profiler import ProfilerActivity, profile

        cuda = torch.device(device).type == "cuda"
        self.window, self.path, self.log = window, path, log
        self.prof = profile(activities=[ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else []))
        self.on = False

    def before(self, n: int) -> None:
        if n == self.window[0]:
            self.prof.start()
            self.on = True

    def after(self, n: int) -> None:
        if self.on and n + 1 >= self.window[1]:
            self.stop()

    def stop(self) -> None:
        if not self.on:
            return
        self.prof.stop()
        self.on = False
        from legoslam_tpu_torch.utils import timer

        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        self.prof.export_chrome_trace(self.path)
        self.log.info("profile of frames %d..%d written to %s; the program's spans:\n%s",
                      self.window[0], self.window[1] - 1, self.path, timer.summary(timer.records()))


def run_frames(vo, args, log, max_frames: int = 0) -> int:
    """Resume if asked, step the sequence (at most `--stop_after` or
    `max_frames` frames), profiling `--profile`'s frames, and save a
    checkpoint if asked; returns the number of frames processed in this
    call."""
    if args.load_checkpoint:
        vo.load_checkpoint(args.load_checkpoint)
        log.info("resumed from %s at frame index %d", args.load_checkpoint, vo.dataset.current_index)
    limit = args.stop_after or max_frames
    window = _profile_window(args.profile)
    n = 0
    if limit or window:
        path = os.path.join(args.out_dir, "profile.trace.json.gz")
        prof = _FrameProfiler(window, args.device, path, log) if window else None
        while not limit or n < limit:
            if prof:
                prof.before(n)
            if not vo.step():
                break
            if prof:
                prof.after(n)
            n += 1
        if prof:
            prof.stop()
        if not limit:
            vo.flush_ba()
    else:
        n0 = len(vo.outputs)
        vo.run()
        n = len(vo.outputs) - n0
    if args.save_checkpoint:
        path = vo.save_checkpoint(args.save_checkpoint)
        log.info("checkpoint written to %s", path)
    return n
