"""The frame source: one seed gives the same frames twice, two seeds give
different ones, and every occluder clears the course."""

import numpy as np
import pytest

from portbench.world import course, render

INTR = (718.856 / 8, 718.856 / 8, 607.1928 / 8, 185.2157 / 8)
SHAPE = (47, 155)


def _world(T):
    return {"half_width": 12.0, "ground_y": 1.6, "z_min": -20.0, "length": float(T[-1, 2, 3]) + 60.0}


def _frames(seed, n=3):
    T = course.poses(n, 0.3, "level")
    occ = course.occluders(T, seed, 6 / 360.0, 1.5, 12.0, 1.6)
    return render.render(T, INTR, 0.537, SHAPE, _world(T), occ, seed, 1.5, "cpu")


def test_same_seed_same_frames():
    a, b = _frames(2**31 + 12345), _frames(2**31 + 12345)
    assert a[0].dtype == np.uint8 and a[0].shape == (3, *SHAPE)
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


def test_two_seeds_differ():
    a, b = _frames(1), _frames(2)
    assert (a[0] != b[0]).mean() > 0.5


def test_left_and_right_differ_by_the_baseline():
    left, right = _frames(7)
    assert not np.array_equal(left, right)
    assert 20.0 < left.mean() < 235.0 and left.std() > 10.0


@pytest.mark.parametrize("seed", [0, 1, 99, 2**31 + 7, 2**40 + 3])
def test_every_occluder_clears_the_course(seed):
    T = course.poses(4541, 0.3, "level")
    occ = course.occluders(T, seed, 6 / 360.0, 1.5, 12.0, 1.6)
    assert len(occ) == round(6 / 360.0 * (T[-1, 2, 3] + 20.0 - 8.0))
    assert course.min_clearance(T, occ) >= 1.5
    assert occ == course.occluders(T, seed, 6 / 360.0, 1.5, 12.0, 1.6)


def test_level_course_stays_in_the_corridor():
    T = course.poses(4541, 0.3, "level")
    assert np.abs(T[:, 0, 3]).max() < 12.0 - 1.5
    assert np.allclose(np.linalg.norm(np.diff(T[:, :3, 3], axis=0), axis=1), 0.3)


def test_source_rig_and_shapes():
    torch = pytest.importorskip("torch")
    from portbench.world.source import DriveSource

    cam = {"P0": [718.856, 0, 607.1928, 0, 0, 718.856, 185.2157, 0, 0, 0, 1, 0],
           "P1": [718.856, 0, 607.1928, -386.1448, 0, 718.856, 185.2157, 0, 0, 0, 1, 0],
           "shape": [376, 1241], "image_scale": 0.125}
    drive = {"course": "level", "half_width_m": 12.0, "ground_y_m": 1.6, "z_min_m": -20.0,
             "far_wall_beyond_m": 60.0, "occluders_per_m": 6 / 360.0, "occluder_clearance_m": 1.5,
             "photometric_noise": 1.5}
    src = DriveSource(cam, drive, 0.3, 2, 5, torch.device("cpu"))
    assert src.shape == (47, 155) and len(src) == 2
    assert abs(src.rig.left.fx - 718.856 / 8) < 1e-4 and abs(src.rig.right.baseline - 0.53715) < 1e-4
    fr = src.next_frame()
    assert fr.frame_id == 0 and fr.left.dtype == np.float32 and fr.left.shape == (47, 155)
    assert src.next_frame().frame_id == 1 and src.next_frame() is None
