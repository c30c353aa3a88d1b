"""The port's camera-path utilities (tgtc_torch/data/poses.py) against
tgtc/data/poses.py on seeded traces, to 1e-12, on every branch: the
min-line-distance centre with converging and with parallel camera axes (the
``pinv`` branch), ``_slerp`` across a general rotation, a small one (the
linear branch) and a half-turn (the ``w < 1e-8`` branch), ``interpolate_poses``
at factors 0.5 and 0.25 and ``normalize_cps``; and the JAX package's own
oracles (tests/test_aux_components.py:48-92) on the port."""

import numpy as np
import pytest
import torch

from tgtc.data import poses as jp
from tgtc_torch.data import poses as tp

torch.set_num_threads(1)

TOL = 1e-12


def _rotation(rng, angle=None):
    """A rotation about a random axis, by ``angle`` (random if None)."""
    axis = rng.standard_normal(3)
    axis /= np.linalg.norm(axis)
    th = rng.uniform(0, np.pi) if angle is None else angle
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(th) * k + (1 - np.cos(th)) * k @ k


def _trace(rng, n=5, dtype=np.float64):
    cps = np.tile(np.eye(4)[None], (n, 1, 1))
    for i in range(n):
        cps[i, :3, :3] = _rotation(rng)
        cps[i, :3, 3] = rng.uniform(-2, 2, 3)
    return cps.astype(dtype)


def _close(got, want, tol=TOL):
    err = float(np.max(np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))))
    print(f"[parity] poses: max|err| {err:.3e} (tol {tol:g})")
    assert np.shape(got) == np.shape(want) and err <= tol


def test_min_line_dist_center_matches_jax():
    rng = np.random.default_rng(0)
    o, d = rng.standard_normal((7, 3)), rng.standard_normal((7, 3))
    _close(tp.min_line_dist_center(o, d), jp.min_line_dist_center(o, d))


def test_min_line_dist_center_parallel_axes_take_pinv():
    """Every axis along z: the normal matrix is singular, and both
    packages take its pseudo-inverse."""
    rng = np.random.default_rng(1)
    o = rng.standard_normal((6, 3))
    d = np.tile([0.0, 0.0, -1.0], (6, 1))
    got, want = tp.min_line_dist_center(o, d), jp.min_line_dist_center(o, d)
    assert np.all(np.isfinite(got))
    _close(got, want)


@pytest.mark.parametrize("case", ["general", "small", "half_turn"])
def test_slerp_matches_jax(case):
    rng = np.random.default_rng(2)
    r0 = _rotation(rng)
    turn = {"general": None, "small": 1e-8, "half_turn": np.pi}[case]
    r1 = _rotation(rng, turn) @ r0
    if case == "half_turn":  # to_quat's w < 1e-8 branch, for r1 itself
        r0, r1 = np.eye(3), _rotation(rng, np.pi)
        w = np.sqrt(max(0.0, 1 + np.trace(r1))) / 2
        assert w < 1e-8
    for t in (0.0, 0.25, 0.5, 0.9):
        got, want = tp._slerp(r0, r1, t), jp._slerp(r0, r1, t)
        _close(got, want)
        _close(got @ got.T, np.eye(3), 1e-12)


@pytest.mark.parametrize("factor", [0.5, 0.25])
def test_interpolate_poses_matches_jax(factor):
    for dtype in (np.float64, np.float32):
        cps = _trace(np.random.default_rng(3), dtype=dtype)
        got, want = tp.interpolate_poses(cps, factor), jp.interpolate_poses(cps, factor)
        assert got.dtype == want.dtype == dtype
        assert got.shape == ((len(cps) - 1) * round(1 / factor) + 1, 4, 4)
        _close(got, want)


def test_normalize_cps_matches_jax():
    cps = _trace(np.random.default_rng(4), n=6)
    for scale in (1.0, 2.5):
        got, want = tp.normalize_cps(cps, scale), jp.normalize_cps(cps, scale)
        _close(got, want)
        assert np.max(np.linalg.norm(got[:, :3, 3], axis=-1)) == pytest.approx(scale)
    assert not np.shares_memory(tp.normalize_cps(cps), cps)


def test_jax_oracles_hold_on_the_port():
    # tests/test_aux_components.py:48-92, on the port's functions
    cps = np.tile(np.eye(4, dtype=np.float32)[None], (3, 1, 1))
    cps[1, :3, 3] = [1, 0, 0]
    cps[2, :3, 3] = [2, 0, 0]
    out = tp.interpolate_poses(cps, 0.5)
    assert out.shape == (5, 4, 4)
    np.testing.assert_allclose(out[0], cps[0], atol=1e-6)
    np.testing.assert_allclose(out[-1], cps[2], atol=1e-6)
    np.testing.assert_allclose(out[1][:3, 3], [0.5, 0, 0], atol=1e-6)

    th, th2 = np.pi / 2, np.pi / 4
    r1 = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1]])
    expect = np.array([[np.cos(th2), -np.sin(th2), 0], [np.sin(th2), np.cos(th2), 0],
                       [0, 0, 1]])
    np.testing.assert_allclose(tp._slerp(np.eye(3), r1, 0.5), expect, atol=1e-6)

    rays_o, rays_d = [], []
    for i in range(8):
        a = 2 * np.pi * i / 8
        o = np.array([3 * np.cos(a), 3 * np.sin(a), 0.5])
        rays_o.append(o)
        rays_d.append(-o / np.linalg.norm(o))
    np.testing.assert_allclose(tp.min_line_dist_center(np.stack(rays_o), np.stack(rays_d)),
                               0.0, atol=1e-6)

    cps = np.tile(np.eye(4, dtype=np.float32)[None], (4, 1, 1))
    for i, t in enumerate([[2, 0, 5], [0, 3, 5], [-4, 0, 5], [0, -1, 5]]):
        cps[i, :3, 3] = t
        cps[i, :3, 2] = [0, 0, -1]
    r = np.linalg.norm(tp.normalize_cps(cps, scale=1.0)[:, :3, 3], axis=-1)
    np.testing.assert_allclose(r.max(), 1.0, rtol=1e-5)
