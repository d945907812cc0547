"""The corridor rendered on the device: a PyTorch rewrite of the port's
`SyntheticPlanesDataset` (pipeline/dataset.py), many frames per call.

A ground plane y = ground_y, side walls x = +-half_width and an end wall
z = length carry multi-octave value noise in world coordinates (scaled by
3), occluders (scaled by 4) overwrite what lies behind them, and a pixel no
surface covers is 12.  The intensity is 25 + 205 v with v in [0, 1], plus
Gaussian sensor noise of `noise` grey levels, independent per frame and
camera, rounded and clipped to 8 bits as a camera delivers it.  The noise's
lattice hash is integer mixing, not the port's float sin hash, so the
texture differs from the port's renderer; its octaves, scales and
smoothstep are the same.  Float32 throughout (a metre at 1.4 km from
the start is resolved to 0.1 mm), on any device.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

_MASK = 0xFFFFFFFF
CHUNK = 48  # frames per call; each chunk and camera draws its noise from its own generator


def _mix(seed: int, salt: int) -> int:
    """A 32-bit key from a seed of any size and a salt."""
    h = (int(seed) * 0x9E3779B97F4A7C15 + salt * 0xBF58476D1CE4E5B9) & ((1 << 64) - 1)
    h ^= h >> 31
    h = (h * 0x94D049BB133111EB) & ((1 << 64) - 1)
    return (h ^ (h >> 29)) & _MASK


def _hash01(ix: torch.Tensor, iy: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """Uniform [0, 1) per integer lattice point (int64 in, `key` per point)."""
    h = ((ix * 0x27D4EB2D) ^ (iy * 0x165667B1) ^ key) & _MASK
    h = ((h ^ (h >> 15)) * 0x2C1B3C6D) & _MASK
    h = ((h ^ (h >> 12)) * 0x297A2D39) & _MASK
    h = h ^ (h >> 15)
    return h.to(torch.float32) * (1.0 / 4294967296.0)


def _value_noise(px: torch.Tensor, py: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    x0, y0 = torch.floor(px), torch.floor(py)
    fx, fy = px - x0, py - y0
    sx, sy = fx * fx * (3 - 2 * fx), fy * fy * (3 - 2 * fy)
    ix, iy = x0.to(torch.int64), y0.to(torch.int64)
    v00, v10 = _hash01(ix, iy, key), _hash01(ix + 1, iy, key)
    v01, v11 = _hash01(ix, iy + 1, key), _hash01(ix + 1, iy + 1, key)
    return (1 - sx) * (1 - sy) * v00 + sx * (1 - sy) * v10 + (1 - sx) * sy * v01 + sx * sy * v11


def _texture(pa: torch.Tensor, pb: torch.Tensor, keys: torch.Tensor, surface: torch.Tensor) -> torch.Tensor:
    """Four octaves of value noise at texture coordinates (pa, pb), float32;
    `keys` (surfaces, 4) are each surface's hash keys, `surface` the index
    of the surface each pixel shows."""
    out = torch.zeros_like(pa)
    amp, freq = 0.55, 0.7
    for octave in range(4):
        out = out + amp * _value_noise(pa * freq, pb * freq, keys[surface, octave])
        amp *= 0.55
        freq *= 2.7
    return out


def _render(origin: torch.Tensor, R: torch.Tensor, uv: torch.Tensor, world: dict, occ, seed: int) -> torch.Tensor:
    """Intensities (F, H, W) of cameras at `origin` (F, 3) with
    world-from-camera rotations `R` (F, 3, 3); `uv` (H, W, 3) are the pixel
    rays in the camera frame (z = 1), so a hit's t is its depth.  Each
    surface's hit is tested in turn and the nearest kept with its texture
    coordinates; the texture is then sampled once per pixel."""
    d = torch.einsum("hwk,fjk->fhwj", uv, R)  # (F, H, W, 3)
    o = origin[:, None, None, :]
    best = torch.full(d.shape[:3], float("inf"), dtype=d.dtype, device=d.device)
    surface = torch.zeros(d.shape[:3], dtype=torch.int64, device=d.device)
    ta_c, tb_c = torch.zeros_like(best), torch.zeros_like(best)
    hw, gy, length, z_min = world["half_width"], world["ground_y"], world["length"], world["z_min"]
    planes = ((1, gy, (0, 2), 11), (0, -hw, (2, 1), 23), (0, hw, (2, 1), 37), (2, length, (0, 1), 53))
    salts = []
    for axis, offset, (ta, tb), salt in planes:
        dn = d[..., axis]
        t = torch.where(dn.abs() > 1e-9, (offset - o[..., axis]) / torch.where(dn.abs() > 1e-9, dn, 1.0),
                        float("inf"))
        pts = o + t[..., None] * d
        ok = (t > 0.05) & (t < best) & (pts[..., 2] > z_min) & (pts[..., 2] < length + 1e-3)
        ok &= (pts[..., 0].abs() <= hw + 1e-3) & (pts[..., 1] <= gy + 1e-3)
        best = torch.where(ok, t, best)
        surface = torch.where(ok, len(salts), surface)
        ta_c = torch.where(ok, pts[..., ta] * 3.0, ta_c)
        tb_c = torch.where(ok, pts[..., tb] * 3.0, tb_c)
        salts.append(salt)
    dz = d[..., 2]
    safe_dz = torch.where(dz.abs() > 1e-9, dz, 1.0)
    z_near = float(origin[:, 2].min())
    for xc, yc, zc, w, h, salt in occ:
        if zc < z_near - 1.0:  # behind every camera of the chunk
            continue
        t = torch.where(dz.abs() > 1e-9, (zc - o[..., 2]) / safe_dz, float("inf"))
        px, py = o[..., 0] + t * d[..., 0], o[..., 1] + t * d[..., 1]
        ok = (t > 0.05) & (t < best) & ((px - xc).abs() <= w / 2) & ((py - yc).abs() <= h / 2)
        best = torch.where(ok, t, best)
        surface = torch.where(ok, len(salts), surface)
        ta_c = torch.where(ok, px * 4.0, ta_c)
        tb_c = torch.where(ok, py * 4.0, tb_c)
        salts.append(salt)
    keys = torch.tensor([[_mix(seed, salt * 16 + octave) for octave in range(4)] for salt in salts],
                        dtype=torch.int64, device=d.device)
    value = _texture(ta_c, tb_c, keys, surface)
    img = 25.0 + 205.0 * value
    return torch.where(torch.isfinite(best), img, torch.full_like(img, 12.0))


def render(T_wc: np.ndarray, intr: Tuple[float, float, float, float], baseline: float, shape: Tuple[int, int],
           world: dict, occ: Sequence, seed: int, noise: float, device) -> Tuple[np.ndarray, np.ndarray]:
    """Left and right frames (N, H, W) uint8 on the host of the rig at the
    poses `T_wc` (N, 4, 4): left camera at the pose, right camera
    `baseline` m along its x axis; `intr` = (fx, fy, cx, cy) at `shape`."""
    H, W = shape
    fx, fy, cx, cy = intr
    dev = torch.device(device)
    f32 = torch.float32
    vs, us = np.meshgrid(np.arange(H, dtype=np.float64), np.arange(W, dtype=np.float64), indexing="ij")
    uv = torch.as_tensor(np.stack([(us - cx) / fx, (vs - cy) / fy, np.ones_like(us)], axis=-1), dtype=f32,
                         device=dev)
    Tw = torch.as_tensor(np.asarray(T_wc, np.float64), dtype=f32, device=dev)
    n = Tw.shape[0]
    left = np.empty((n, H, W), np.uint8)
    right = np.empty((n, H, W), np.uint8)
    for c0 in range(0, n, CHUNK):
        R = Tw[c0:c0 + CHUNK, :3, :3]
        o_l = Tw[c0:c0 + CHUNK, :3, 3]
        o_r = o_l + baseline * R[:, :, 0]
        f = R.shape[0]
        # Both cameras of the chunk's frames in one call.
        img = _render(torch.cat([o_l, o_r]), torch.cat([R, R]), uv, world, occ, seed)
        for cam, out in ((0, left), (1, right)):
            part = img[cam * f:(cam + 1) * f]
            if noise > 0:
                gen = torch.Generator(device=dev)
                gen.manual_seed(_mix(seed, 1_000_003 + 2 * (c0 // CHUNK) + cam))
                part = part + noise * torch.randn(part.shape, generator=gen, dtype=part.dtype, device=dev)
            out[c0:c0 + f] = torch.clamp(torch.round(part), 0, 255).to(torch.uint8).cpu().numpy()
    return left, right
