"""The port's point-splat rasterizer (tgtc_torch.ops.rasterize) against
tgtc's, on numpy-seeded point clouds.

* Camera math (projection matrix, NDC → world, world → cvv, cvv → pixel)
  to 1e-6.
* ``splat_winners`` / ``rasterize_warp`` / ``rasterize_pyramid`` against
  JAX's on a tilted plane and a random cloud with occlusions, two views
  each (one of them moved and turned), ~64² points into 120x160, at radii
  0.7 to 2.2. The two sides project with f32 sums in another order (XLA's
  dot against four explicit products) and invert the poses with other LU
  codes, so a candidate that lies on a rounding or radius boundary, or two
  points whose depths tie, may go either way. The winners and masks must
  equal JAX's except at pixels where one side's winner lies within 1e-4 px
  of such a boundary or the two winners' depths lie within 1e-6 relative
  of each other (f64 projection); those are counted, printed under
  ``parity`` and held to <= 0.1% of the hit pixels, and the warped
  features equal JAX's bit for bit everywhere else.
* The feature gradient against ``jax.grad``'s, to 1e-6.
* Port counterparts of tests/test_rasterize.py's cases.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tgtc.ops.rasterize as jr
import tgtc_torch.ops.rasterize as tr
from test_torch_ops import close

torch.set_num_threads(1)

H, W, FOCAL = 120, 160, 100.0
TOL_CAMERA, TOL_GRAD = 1e-6, 1e-6
EDGE_PX, TIE_REL, MAX_EXEMPT = 1e-4, 1e-6, 1e-3


def _cams():
    """Camera-to-world poses: the identity and a camera moved by (0.06,
    -0.03, 0.02) and turned by 0.03 rad about y."""
    a = 0.03
    moved = np.array([[np.cos(a), 0, np.sin(a), 0.06], [0, 1, 0, -0.03],
                      [-np.sin(a), 0, np.cos(a), 0.02], [0, 0, 0, 1]], np.float32)
    return np.stack([np.eye(4, dtype=np.float32), moved])


def _cloud(kind, n_side=64):
    """``[n_side², 3]`` world points in front of the identity camera and
    their colours. ``plane``: a tilted plane through one point per pixel of
    a 64x64 grid spread over the frame; ``random``: uniform points at depths
    1.5 to 3.5, many behind each other."""
    rng = np.random.default_rng(0 if kind == "plane" else 1)
    n = n_side * n_side
    if kind == "plane":
        ys, xs = np.meshgrid(np.linspace(0, H - 1, n_side), np.linspace(0, W - 1, n_side),
                             indexing="ij")
        x_cam, y_cam = xs - (W - 1) / 2, -(ys - (H - 1) / 2)
        z = -2.0 - 0.003 * x_cam - 0.002 * y_cam
        pts = np.stack([x_cam / FOCAL * -z, y_cam / FOCAL * -z, z], -1).reshape(n, 3)
    else:
        z = -rng.uniform(1.5, 3.5, n)
        pts = np.stack([rng.uniform(-0.8, 0.8, n) * -z * W / 2 / FOCAL,
                        rng.uniform(-0.8, 0.8, n) * -z * H / 2 / FOCAL, z], -1)
    rgb = rng.uniform(0, 1, (n, 3))
    return pts.astype(np.float32), rgb.astype(np.float32)


def _proj():
    return tr.llff_projection_matrix(H, W, FOCAL)


def _np_project(pts, cams, proj):
    """f64 ``(px, py, depth)`` ``[B, N]`` of the points in each view."""
    hom = np.concatenate([pts, np.ones_like(pts[:, :1])], -1).astype(np.float64)
    clip = np.einsum("vc,bcw,nw->bnv", proj.astype(np.float64),
                     np.linalg.inv(cams.astype(np.float64)), hom)
    cvv = clip[..., :3] / clip[..., 3:]
    return ((1 - (cvv[..., 0] + 1) / 2) * (W - 1), (1 - (cvv[..., 1] + 1) / 2) * (H - 1),
            cvv[..., 2])


def _jax_winners(pts, cams, proj, radius):
    """JAX's winners, read through its splat of each point's index."""
    n = pts.shape[0]
    idx = jnp.arange(n, dtype=jnp.float32)[:, None]
    warped, mask = jr.splat_points(jnp.asarray(pts), idx, jnp.linalg.inv(jnp.asarray(cams)),
                                   jnp.asarray(proj), H, W, radius)
    return np.where(np.asarray(mask[..., 0]) > 0, np.asarray(warped[..., 0]).astype(np.int64), n)


def _exempt(got, want, pts, cams, proj, radius):
    """Per pixel where ``got`` and ``want`` winners differ: whether one of
    them lies within EDGE_PX of a rounding or radius boundary, or their
    depths tie within TIE_REL. Returns (differing, exempt) boolean maps."""
    n = pts.shape[0]
    px, py, depth = _np_project(pts, cams, proj)
    diff = got != want
    exempt = np.zeros_like(diff)
    for b, y, x in zip(*np.nonzero(diff)):
        near, ds = False, []
        for i in (got[b, y, x], want[b, y, x]):
            if i == n:
                continue
            u, v = px[b, i], py[b, i]
            dist = np.hypot(x - u, y - v)
            near |= (abs(dist - radius) < EDGE_PX or abs(abs(u - np.floor(u)) - 0.5) < EDGE_PX
                     or abs(abs(v - np.floor(v)) - 0.5) < EDGE_PX)
            ds.append(depth[b, i])
        tie = len(ds) == 2 and abs(ds[0] - ds[1]) <= TIE_REL * max(abs(ds[0]), abs(ds[1]))
        exempt[b, y, x] = near or tie
    return diff, exempt


def _check_winners(got, want, pts, cams, proj, radius, what):
    n = pts.shape[0]
    diff, exempt = _exempt(got, want, pts, cams, proj, radius)
    hits = int((want < n).sum())
    test = os.environ.get("PYTEST_CURRENT_TEST", "?").split(" ")[0]
    print(f"[parity] {test} {what}: {hits} hit pixels, {int(diff.sum())} differ from JAX, "
          f"{int(exempt.sum())} of them at a boundary or depth tie")
    assert not (diff & ~exempt).any(), np.argwhere(diff & ~exempt)[:5]
    assert exempt.sum() <= MAX_EXEMPT * hits
    return ~diff


class TestCameraMath:
    def test_projection_matrix_equals_jax(self):
        for cx, cy in ((None, None), (70.0, 55.0)):
            assert np.array_equal(tr.llff_projection_matrix(H, W, FOCAL, cx=cx, cy=cy),
                                  jr.llff_projection_matrix(H, W, FOCAL, cx=cx, cy=cy))

    def test_ndc_world_cvv_pixel_match_jax(self):
        rng = np.random.default_rng(2)
        ndc = np.stack([rng.uniform(-1, 1, 500), rng.uniform(-1, 1, 500),
                        rng.uniform(-0.9, 0.9, 500)], -1).astype(np.float32)
        close(tr.ndc_to_world(torch.from_numpy(ndc), H, W, FOCAL),
              np.asarray(jr.ndc_to_world(jnp.asarray(ndc), H, W, FOCAL)), TOL_CAMERA, 1e-6)
        pts, _ = _cloud("random")
        w2c = np.linalg.inv(_cams()[1])
        cvv, w_clip = tr.world_to_cvv(torch.from_numpy(pts), torch.from_numpy(w2c),
                                      torch.from_numpy(_proj()))
        j_cvv, j_w = jr.world_to_cvv(jnp.asarray(pts), jnp.asarray(w2c), jnp.asarray(_proj()))
        close(cvv, np.asarray(j_cvv), TOL_CAMERA, 1e-6)
        close(w_clip, np.asarray(j_w), TOL_CAMERA, 1e-6)
        px, py = tr.cvv_to_pixel(cvv, H, W)
        j_px, j_py = jr.cvv_to_pixel(j_cvv, H, W)
        close(px, np.asarray(j_px), 1e-4, 1e-6)  # pixels: 1e-6 of ~160
        close(py, np.asarray(j_py), 1e-4, 1e-6)

    def test_center_point_projects_to_center(self):
        proj = torch.from_numpy(tr.llff_projection_matrix(40, 60, 50.0))
        cvv, w_clip = tr.world_to_cvv(torch.tensor([[0.0, 0.0, -2.0]]), torch.eye(4), proj)
        assert float(w_clip[0]) > 0
        px, py = tr.cvv_to_pixel(cvv, 40, 60)
        assert abs(float(px[0]) - 29.5) <= 1.0 and abs(float(py[0]) - 19.5) <= 1.0

    def test_behind_camera_flagged_and_depth_monotonic(self):
        proj = torch.from_numpy(tr.llff_projection_matrix(10, 10, 10.0))
        _, w_clip = tr.world_to_cvv(torch.tensor([[0.0, 0.0, 5.0]]), torch.eye(4), proj)
        assert float(w_clip[0]) < 0
        pts = torch.tensor([[0.0, 0.0, -1.0], [0.0, 0.0, -2.0], [0.0, 0.0, -5.0]])
        z = tr.world_to_cvv(pts, torch.eye(4), proj)[0][:, 2]
        assert z[0] < z[1] < z[2]


@pytest.mark.parametrize("radius", [0.7, 1.5, 2.2])
@pytest.mark.parametrize("kind", ["plane", "random"])
def test_splat_and_warp_match_jax(kind, radius):
    pts, rgb = _cloud(kind)
    cams, proj = _cams(), _proj()
    tp, trgb, tcams, tproj = (torch.from_numpy(a) for a in (pts, rgb, cams, proj))
    got = tr.splat_winners(tp, torch.linalg.inv(tcams), tproj, H, W, radius).numpy()
    want = _jax_winners(pts, cams, proj, radius)
    assert got.dtype == np.int32 and got.shape == (2, H, W)
    same = _check_winners(got.astype(np.int64), want, pts, cams, proj, radius, "winners")
    rgb_map, coor_map, mask = tr.rasterize_warp(tp, trgb, tcams, tproj, H, W, radius)
    j_rgb, j_coor, j_mask = jr.rasterize_warp(jnp.asarray(pts), jnp.asarray(rgb),
                                              jnp.asarray(cams), jnp.asarray(proj), H, W, radius)
    for a, b in ((rgb_map, j_rgb), (coor_map, j_coor), (mask, j_mask)):
        assert np.array_equal(a.numpy()[same], np.asarray(b)[same])
    # the warp's winners are splat_winners' on the same poses
    n = pts.shape[0]
    hit = got < n
    assert np.array_equal(mask.numpy()[..., 0] > 0, hit)
    assert np.array_equal(rgb_map.numpy()[hit], rgb[got[hit]])


@pytest.mark.parametrize("kind", ["plane", "random"])
def test_pyramid_matches_jax(kind):
    pts, rgb = _cloud(kind)
    cams, proj = _cams(), _proj()
    img, mask = tr.rasterize_pyramid(*(torch.from_numpy(a) for a in (pts, rgb, cams)),
                                     torch.from_numpy(proj), H, W)
    j_img, j_mask = jr.rasterize_pyramid(*(jnp.asarray(a) for a in (pts, rgb, cams)),
                                         jnp.asarray(proj), H, W)
    same = np.ones((2, H, W), bool)
    for r in (0.7, 1.2, 1.7, 2.2):  # a pixel is compared where every radius agrees
        got = tr.splat_winners(torch.from_numpy(pts), torch.linalg.inv(torch.from_numpy(cams)),
                               torch.from_numpy(proj), H, W, r).numpy().astype(np.int64)
        same &= _check_winners(got, _jax_winners(pts, cams, proj, r), pts, cams, proj, r,
                               f"radius {r}")
    assert np.array_equal(img.numpy()[same], np.asarray(j_img)[same])
    assert np.array_equal(mask.numpy()[same], np.asarray(j_mask)[same])


def test_feature_gradient_matches_jax():
    pts, rgb = _cloud("random")
    cams, proj = _cams(), _proj()
    g = np.random.default_rng(3).standard_normal((2, H, W, 3)).astype(np.float32)

    def j_loss(c):
        out, _, _ = jr.rasterize_warp(jnp.asarray(pts), c, jnp.asarray(cams), jnp.asarray(proj),
                                      H, W)
        return jnp.sum(out * g)

    want = np.asarray(jax.grad(j_loss)(jnp.asarray(rgb)))
    feats = torch.from_numpy(rgb).requires_grad_(True)
    out, _, _ = tr.rasterize_warp(torch.from_numpy(pts), feats, torch.from_numpy(cams),
                                  torch.from_numpy(proj), H, W)
    (got,) = torch.autograd.grad((out * torch.from_numpy(g)).sum(), feats)
    assert np.abs(want).max() > 0
    close(got, want, TOL_GRAD)


# ---- counterparts of tests/test_rasterize.py


def _warp(pts, rgb, cams, h, w, f, radius=1.5):
    proj = torch.from_numpy(tr.llff_projection_matrix(h, w, f))
    return tr.rasterize_warp(torch.tensor(pts), torch.tensor(rgb), torch.tensor(cams), proj,
                             h, w, radius)


EYE = np.eye(4, dtype=np.float32)[None]


class TestSplat:
    def test_single_point_lands_at_projection(self):
        rgb_map, coor_map, mask = _warp([[0.0, 0.0, -2.0]], [[1.0, 0.5, 0.25]], EYE, 21, 21, 20.0)
        ys, xs = np.nonzero(mask[0, ..., 0].numpy())
        assert len(ys) >= 1 and np.all(np.abs(ys - 10) <= 2) and np.all(np.abs(xs - 10) <= 2)
        close(rgb_map[0, ys[0], xs[0]], [1.0, 0.5, 0.25], 1e-6)
        close(coor_map[0, ys[0], xs[0]], [0.0, 0.0, -2.0], 1e-5)

    def test_occlusion_nearest_wins(self):
        rgb_map, _, _ = _warp([[0.0, 0.0, -3.0], [0.0, 0.0, -1.5]],
                              [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], EYE, 21, 21, 20.0)
        assert rgb_map[0, 10, 10].tolist() == [0.0, 1.0, 0.0]

    def test_empty_pixels_masked(self):
        rgb_map, _, mask = _warp([[0.0, 0.0, -2.0]], [[1.0, 1.0, 1.0]], EYE, 15, 15, 14.0)
        m = mask[0, ..., 0].numpy()
        assert m.sum() < 10
        assert not rgb_map[0].numpy()[m == 0].any()

    def test_batch_views(self):
        moved = EYE[0].copy()
        moved[0, 3] = 0.5
        rgb_map, _, mask = _warp([[0.0, 0.0, -2.0]], [[1.0, 1.0, 1.0]],
                                 np.stack([EYE[0], moved]), 11, 11, 10.0)
        assert rgb_map.shape == (2, 11, 11, 3)
        (_, x0), (_, x1) = (np.argwhere(mask[b, ..., 0].numpy())[0] for b in (0, 1))
        assert x0 != x1

    def test_feature_gradients_flow(self):
        rgb = torch.full((2, 3), 0.5, requires_grad=True)
        proj = torch.from_numpy(tr.llff_projection_matrix(11, 11, 10.0))
        out, _, _ = tr.rasterize_warp(torch.tensor([[0.0, 0.0, -2.0], [0.2, 0.1, -2.5]]), rgb,
                                      torch.from_numpy(EYE), proj, 11, 11)
        (g,) = torch.autograd.grad((out ** 2).sum(), rgb)
        assert bool((g != 0).any()) and bool(torch.isfinite(g).all())

    def test_warp_roundtrip_consistency(self):
        """A dense tilted plane warped into its own view: >95% coverage, the
        colours close, and the warped coor map passes the 5e-2 test."""
        h, w, f = 24, 32, 30.0
        ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        x_cam, y_cam = xs - (w - 1) / 2, -(ys - (h - 1) / 2)
        z = -2.0 - 0.003 * x_cam - 0.002 * y_cam
        pts = np.stack([x_cam / f * -z, y_cam / f * -z, z], -1).reshape(-1, 3).astype(np.float32)
        rgb = np.stack([xs / w, ys / h, 0.5 * np.ones_like(xs)], -1).reshape(-1, 3)
        rgb_map, coor_map, mask = _warp(pts, rgb.astype(np.float32), EYE, h, w, f)
        m = mask[0, ..., 0].numpy().reshape(-1) > 0
        assert m.mean() > 0.95
        got = rgb_map[0].numpy().reshape(-1, 3)
        assert np.all(np.abs(got[m] - rgb[m]) < 0.08, axis=-1).mean() > 0.9
        dist2 = np.sum((coor_map[0].numpy().reshape(-1, 3)[m] - pts[m]) ** 2, -1)
        assert np.mean(dist2 < (2 * 2.0 / f) ** 2) > 0.95


def test_splat_is_deterministic_and_ignores_far_points():
    """Two splats are bitwise equal; points at w_clip ~ 0 or projecting
    far outside the frame hit nothing."""
    pts, rgb = _cloud("random", 16)
    odd = np.array([[0.0, 0.0, 0.0], [1e6, 1e6, -1e-9], [0.3, 0.2, 1e-12]], np.float32)
    pts = np.concatenate([pts, odd])
    args = (torch.from_numpy(pts), torch.linalg.inv(torch.from_numpy(_cams())),
            torch.from_numpy(_proj()), H, W)
    a, b = tr.splat_winners(*args), tr.splat_winners(*args)
    assert torch.equal(a, b)
    n = pts.shape[0]
    assert not bool(((a >= n - 3) & (a < n)).any())
