"""Parity of the port's geometry (legoslam_tpu_torch/geometry) with the JAX
reference on the same NumPy inputs.  Tolerance 1e-5: both sides compute in
float32 from the same formulas; only the order of a few sums differs."""

import numpy as np
import pytest

from legoslam_tpu.geometry import camera as j_camera
from legoslam_tpu.geometry import se3 as j_se3
from legoslam_tpu.geometry import triangulation as j_tri
from legoslam_tpu_torch.geometry import camera as t_camera
from legoslam_tpu_torch.geometry import se3 as t_se3
from legoslam_tpu_torch.geometry import triangulation as t_tri
from tests.torch_parity import assert_close, both, j, t, to_numpy

ATOL = 1e-5


def _tangents(rng, n=64):
    xi = rng.normal(0.0, 0.4, (n, 6))
    xi[: n // 4, 3:] *= 1e-3      # small-angle (Taylor) branch
    xi[n // 4 : n // 2, 3:] *= 4  # large rotations
    return xi.astype(np.float32)


@pytest.mark.parametrize("fn", ["se3_exp", "so3_exp"])
def test_exp(fn):
    xi = _tangents(np.random.default_rng(1))
    arg = xi if fn == "se3_exp" else xi[:, 3:]
    ref, port = both(getattr(j_se3, fn), getattr(t_se3, fn), arg)
    assert_close(port, ref, ATOL)


@pytest.mark.parametrize("fn", ["se3_log", "se3_inv", "se3_orthonormalize"])
def test_pose_maps(fn):
    rng = np.random.default_rng(2)
    T = np.asarray(j_se3.se3_exp(j(_tangents(rng))))
    T = T + rng.normal(0.0, 1e-4, T.shape).astype(np.float32) * np.asarray([1, 1, 1, 0], np.float32)
    ref, port = both(getattr(j_se3, fn), getattr(t_se3, fn), T)
    assert_close(port, ref, ATOL)


def test_retract_and_transform():
    rng = np.random.default_rng(3)
    T = np.asarray(j_se3.se3_exp(j(_tangents(rng))))
    d = _tangents(rng) * 0.1
    d[0, 2] = np.nan  # the NaN guard leaves the pose unchanged
    ref, port = both(j_se3.retract, t_se3.retract, T, d)
    assert_close(port, ref, ATOL)
    p = rng.normal(0.0, 5.0, (64, 3)).astype(np.float32)
    ref, port = both(j_se3.transform, t_se3.transform, T, p)
    assert_close(port, ref, 1e-4)


def test_camera():
    rng = np.random.default_rng(4)
    pose = np.eye(4)
    pose[0, 3] = -0.54
    jc = j_camera.Camera.create(359.428, 361.1, 310.5, 94.25, 0.54, pose=pose)
    tc = t_camera.Camera.create(359.428, 361.1, 310.5, 94.25, 0.54, pose=pose)
    assert (tc.fx, tc.fy, tc.cx, tc.cy) == tuple(float(v) for v in (jc.fx, jc.fy, jc.cx, jc.cy))
    assert_close(to_numpy(tc.K()), np.asarray(jc.K()), 0.0)
    T = np.asarray(j_se3.se3_exp(j(_tangents(rng, 1)[0] * 0.1)))
    pw = np.stack([rng.uniform(-5, 5, 50), rng.uniform(-2, 2, 50), rng.uniform(3, 40, 50)], -1)
    pw = pw.astype(np.float32)
    assert_close(to_numpy(tc.world2pixel(t(pw), t(T))), np.asarray(jc.world2pixel(j(pw), j(T))), 1e-3)
    px = rng.uniform(0, 600, (50, 2)).astype(np.float32)
    assert_close(to_numpy(tc.pixel2world(t(px), t(T), 7.0)), np.asarray(jc.pixel2world(j(px), j(T), 7.0)), 1e-4)


def test_triangulate_stereo():
    """Closed-form gate and points on a stereo rig, incl. degenerate rows."""
    rng = np.random.default_rng(5)
    n = 256
    fx, cx, cy, b = 360.0, 310.0, 94.0, 0.54
    z = rng.uniform(2.0, 80.0, n)
    pts = np.stack([rng.uniform(-10, 10, n), rng.uniform(-2, 2, n), z], -1)
    uvl = pts[:, :2] / pts[:, 2:]
    uvr = np.stack([(pts[:, 0] - b) / pts[:, 2], pts[:, 1] / pts[:, 2]], -1)
    uvr += rng.normal(0, 0.3 / fx, uvr.shape)
    uvr[:8] = uvl[:8]  # zero disparity: rank-deficient, must be rejected
    left = np.eye(4, dtype=np.float32)
    right = np.eye(4, dtype=np.float32)
    right[0, 3] = -b
    ref, port = both(j_tri.triangulate_stereo, t_tri.triangulate_stereo, left, right, uvl, uvr)
    (p_ref, ok_ref), (p_port, ok_port) = ref, port
    assert not ok_port[:8].any()
    np.testing.assert_array_equal(ok_port, ok_ref)
    p_port, p_ref = p_port[ok_ref], p_ref[ok_ref]
    rel = np.abs(p_port - p_ref) / np.abs(p_ref).max(axis=1, keepdims=True)
    assert rel.max() < ATOL, rel.max()
