"""The port's KITTI ingestion (pipeline/dataset.py `KittiDataset`, the
native loader in legoslam_tpu_torch/native, utils/png.py) and its command
line (legoslam_tpu_torch/apps/run_kitti.py) against the JAX package.

- Decoding: PNGs written here with each of the five row filters (one filter
  for a whole image, and all five in turn row by row), 1-, 2-, 4-, 8- and
  16-bit gray, RGB, RGBA, gray+alpha and palette files go through the port's
  native decoder and its zlib decoder; both must equal PIL's decoding,
  converted to gray as libpng converts it for the JAX package's loader (16-bit
  samples cut to their high byte, colour by 15-bit BT.601 weights), and the
  JAX package's libpng loader itself, exactly.
- `KittiDataset` on tests/test_kitti_path.py's fabricated 10-frame sequence
  (192x320 written, read at half resolution): the rig, the ground truth,
  every frame and `seek` equal the JAX reader's, through either decoder.
  The JAX package's native loader reopened by `seek` waits for frame 0
  forever (its consumer cursor starts at 0 whatever the start index), so
  there the port after `seek` is held to the frames it read before.
- The CLI with `--device cpu` against `apps/run_kitti.py` on that sequence,
  with the same YAML config: statuses equal frame by frame (from the
  per-frame log) and both trajectories under that file's ATE bar of 0.2 m.
"""

import os
import re
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest
from PIL import Image

from legoslam_tpu.native import loader as j_loader
from legoslam_tpu.pipeline.dataset import KittiDataset as JKitti
from legoslam_tpu_torch.native import loader as t_loader
from legoslam_tpu_torch.pipeline.dataset import KittiDataset
from legoslam_tpu_torch.utils import evaluation, png
from tests.test_kitti_path import FULL_SHAPE, N_FRAMES, kitti_dir  # noqa: F401  (the sequence fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _filter_rows(raw: np.ndarray, bpp: int, types) -> bytes:
    """PNG-filter (H, stride) uint8 rows, row y with filter types[y % len(types)]."""
    out, prior = [], np.zeros(raw.shape[1], np.int32)
    for y, row in enumerate(raw.astype(np.int32)):
        f = types[y % len(types)]
        left = np.concatenate([np.zeros(bpp, np.int32), row[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int32), prior[:-bpp]])
        if f == 0:
            pred = np.zeros_like(row)
        elif f == 1:
            pred = left
        elif f == 2:
            pred = prior
        elif f == 3:
            pred = (left + prior) // 2
        else:
            pa, pb, pc = np.abs(prior - ul), np.abs(left - ul), np.abs(left + prior - 2 * ul)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prior, ul))
        out.append(bytes([f]) + ((row - pred) & 0xFF).astype(np.uint8).tobytes())
        prior = row
    return b"".join(out)


def _png(samples: np.ndarray, color: int, depth: int, types, width=None, interlace=0) -> bytes:
    """A PNG of (H, W, C) samples (uint8, or uint16 for 16-bit; for depths
    under 8, packed rows of `width` pixels)."""
    H, W, C = samples.shape
    raw = samples.astype(">u2").view(np.uint8).reshape(H, -1) if depth == 16 else samples.reshape(H, W * C)
    bpp = max(1, C * depth // 8)
    ihdr = struct.pack(">IIBBBBB", width or W, H, depth, color, 0, 0, interlace)
    return (png.SIGNATURE + png._chunk(b"IHDR", ihdr)
            + png._chunk(b"IDAT", zlib.compress(_filter_rows(raw, bpp, types))) + png._chunk(b"IEND", b""))


def _decoders(path):
    """The port's native and zlib decoders and the JAX package's libpng loader."""
    with open(path, "rb") as f:
        data = f.read()
    return t_loader.decode_png(path), png.decode_png_gray(data), j_loader.decode_png(path)


def _libpng_gray(rgb: np.ndarray, depth: int) -> np.ndarray:
    """libpng's rgb_to_gray_fixed(1, 29900, 58700) on integer RGB."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    rw, gw = 29900 * 32768 // 100000, 58700 * 32768 // 100000
    s = rw * r + gw * g + (32768 - rw - gw) * b
    s = (s + 16384) >> 15 if depth == 16 else s >> 15
    gray = np.where((r == g) & (r == b), r, s)
    return gray >> 8 if depth == 16 else gray


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(11)


@pytest.mark.parametrize("types", [(0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4)], ids=str)
def test_decoders_undo_every_filter(tmp_path, rng, types):
    img = rng.integers(0, 256, (23, 41), dtype=np.uint8)
    img[5:15, 10:30] = np.arange(20, dtype=np.uint8) * 9   # runs the predictors on smooth rows too
    path = str(tmp_path / "f.png")
    with open(path, "wb") as f:
        f.write(_png(img[..., None], 0, 8, types))
    ref = np.asarray(Image.open(path))
    np.testing.assert_array_equal(ref, img)
    for got in _decoders(path):
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("kind", ["gray16", "rgb8", "rgb16", "rgba8", "gray_alpha8", "palette", "gray1", "gray2",
                                  "gray4"])
def test_decoders_convert_like_libpng(tmp_path, rng, kind):
    path = str(tmp_path / f"{kind}.png")
    H, W = 19, 37
    if kind == "gray16":
        s = rng.integers(0, 65536, (H, W, 1)).astype(np.uint16)
        with open(path, "wb") as f:
            f.write(_png(s, 0, 16, (4, 1)))
        want = np.asarray(Image.open(path)).astype(np.int64) >> 8
    elif kind in ("rgb8", "rgb16"):
        depth = 16 if kind == "rgb16" else 8
        s = rng.integers(0, 1 << depth, (H, W, 3)).astype(np.uint16 if depth == 16 else np.uint8)
        s[0, :5] = s[0, :5, :1]                        # gray pixels keep their value
        with open(path, "wb") as f:
            f.write(_png(s, 2, depth, (3, 4, 1)))
        decoded = s if depth == 16 else np.asarray(Image.open(path).convert("RGB"))
        np.testing.assert_array_equal(decoded, s)
        want = _libpng_gray(decoded, depth)
    elif kind == "rgba8":
        s = rng.integers(0, 256, (H, W, 4)).astype(np.uint8)
        Image.fromarray(s, "RGBA").save(path)
        want = _libpng_gray(np.asarray(Image.open(path))[..., :3], 8)
    elif kind == "gray_alpha8":
        s = rng.integers(0, 256, (H, W, 2)).astype(np.uint8)
        Image.fromarray(s, "LA").save(path)
        want = np.asarray(Image.open(path))[..., 0]
    elif kind == "palette":
        Image.fromarray(rng.integers(0, 256, (H, W, 3)).astype(np.uint8), "RGB").quantize(37).save(path)
        want = _libpng_gray(np.asarray(Image.open(path).convert("RGB")), 8)
    else:
        depth = int(kind[-1])
        v = rng.integers(0, 1 << depth, (H, W)).astype(np.uint8)
        packed = np.packbits(np.unpackbits(v[..., None], axis=-1)[..., 8 - depth:].reshape(H, -1), axis=1)
        with open(path, "wb") as f:
            f.write(_png(packed[..., None], 0, depth, (1, 4), width=W))
        want = v.astype(np.int64) * (255 // ((1 << depth) - 1))
        np.testing.assert_array_equal(np.asarray(Image.open(path).convert("L")), want)
    for got in _decoders(path):
        np.testing.assert_array_equal(np.asarray(got, np.int64), want)


def test_decoders_refuse_what_they_cannot_read(tmp_path):
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"not a png")
    inter = tmp_path / "interlaced.png"
    inter.write_bytes(_png(np.zeros((8, 8, 1), np.uint8), 0, 8, (0,), interlace=1))
    for path in (bad, inter, tmp_path / "missing.png"):
        assert t_loader.decode_png(str(path)) is None and png.read_png_gray(str(path)) is None


def test_encoder_round_trip(tmp_path, rng):
    img = rng.uniform(-20, 300, (17, 29))
    path = str(tmp_path / "e.png")
    png.write_png_gray(path, img)
    want = np.clip(img, 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), want)
    np.testing.assert_array_equal(png.read_png_gray(path), want)


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "zlib"])
def test_kitti_dataset_equals_reference(kitti_dir, use_native):  # noqa: F811
    root, gt = kitti_dir
    ds, ref = KittiDataset(root, use_native=use_native), JKitti(root, use_native=use_native)
    assert ds.init() and ref.init()
    assert ds.decoder == ("native" if use_native else "zlib")
    for cam, jcam in ((ds.rig.left, ref.rig.left), (ds.rig.right, ref.rig.right)):
        for k in ("fx", "fy", "cx", "cy", "baseline"):
            assert getattr(cam, k) == float(getattr(jcam, k)), k
        np.testing.assert_array_equal(cam.pose.numpy(), np.asarray(jcam.pose))
    np.testing.assert_array_equal(ds.ground_truth, ref.ground_truth)
    np.testing.assert_array_equal(ds.ground_truth, gt)
    frames = []
    while (fr := ds.next_frame()) is not None:
        jf = ref.next_frame()
        assert fr.frame_id == jf.frame_id and fr.left.dtype == np.float32
        np.testing.assert_array_equal(fr.left, jf.left)
        np.testing.assert_array_equal(fr.right, jf.right)
        frames.append(fr)
    assert ref.next_frame() is None and len(frames) == N_FRAMES and ds.current_index == N_FRAMES
    assert frames[0].left.shape == (FULL_SHAPE[0] // 2, FULL_SHAPE[1] // 2)
    ds.seek(4)
    fr = ds.next_frame()
    assert fr.frame_id == 4 and ds.current_index == 5
    np.testing.assert_array_equal(fr.left, frames[4].left)
    np.testing.assert_array_equal(fr.right, frames[4].right)
    if not use_native:  # the reference's native loader reopened at 4 waits for frame 0 (ROADMAP C)
        ref.seek(4)
        jf = ref.next_frame()
        assert jf.frame_id == 4
        np.testing.assert_array_equal(fr.left, jf.left)


def test_kitti_dataset_missing_calib(tmp_path):
    assert not KittiDataset(str(tmp_path)).init()


CLI_CONFIG = """# tests/test_kitti_path.py's configuration
max_features: 256
keyframe_window_capacity: 8
max_active_landmarks: 1024
max_landmarks: 8192
num_active_keyframes: 7
stereo_depth_inferior_limit: 2.0
stereo_depth_superior_limit: 50.0
detect_mask_half: 5
gftt_min_distance: 5
ba_assembly_precision: f32
"""
STATUS = re.compile(r"frame (\d+): (\w+) tracked=")


def _cli(args, tmp_path, name):
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, *args, "--out_dir", str(tmp_path / name), "--log_every", "1"],
                          capture_output=True, text=True, timeout=600, cwd=REPO, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    statuses = [m.group(2) for m in STATUS.finditer(proc.stderr)]
    T = np.loadtxt(tmp_path / name / "trajectory_kitti.txt").reshape(-1, 3, 4)
    return proc.stderr, statuses, T


def test_cli_equals_reference_app(kitti_dir, tmp_path):  # noqa: F811
    root, gt = kitti_dir
    cfg = tmp_path / "kitti_test.yaml"
    cfg.write_text(CLI_CONFIG)
    common = ["--config_file", str(cfg), "--dataset_dir", root]
    log, statuses, T = _cli(["-m", "legoslam_tpu_torch.apps.run_kitti", "--device", "cpu", *common], tmp_path, "port")
    _, ref_statuses, T_ref = _cli([os.path.join("apps", "run_kitti.py"), *common], tmp_path, "ref")
    assert "decoder native" in log and "ATE RMSE" in log
    assert statuses == ref_statuses and len(statuses) == N_FRAMES
    assert set(statuses) == {"TRACKING_GOOD"}
    for traj in (T, T_ref):
        assert len(traj) == N_FRAMES
        assert evaluation.ate_rmse(traj[:, :, 3], gt[:, :3, 3]) < 0.2


def test_cli_refuses_without_a_card(kitti_dir, tmp_path, monkeypatch):  # noqa: F811
    """Without a card and without `--device cpu` the app exits non-zero
    before it reads the sequence."""
    import torch

    from legoslam_tpu_torch.apps import run_kitti

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run_kitti.main(["--dataset_dir", kitti_dir[0], "--out_dir", str(tmp_path)]) != 0
    assert not os.listdir(tmp_path)
