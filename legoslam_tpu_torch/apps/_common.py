"""What the two apps share: the device check, the config flags and the
checkpoint flags."""

from __future__ import annotations

import argparse

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


def run_frames(vo, args, log, max_frames: int = 0) -> int:
    """Resume if asked, step the sequence (at most `--stop_after` or
    `max_frames` frames), save a checkpoint if asked; returns the number of
    frames processed in this call."""
    if args.load_checkpoint:
        vo.load_checkpoint(args.load_checkpoint)
        log.info("resumed from %s at frame index %d", args.load_checkpoint, vo.dataset.current_index)
    limit = args.stop_after or max_frames
    n = 0
    if limit:
        while n < limit and vo.step():
            n += 1
    else:
        n0 = len(vo.outputs)
        vo.run()
        n = len(vo.outputs) - n0
    if args.save_checkpoint:
        path = vo.save_checkpoint(args.save_checkpoint)
        log.info("checkpoint written to %s", path)
    return n
