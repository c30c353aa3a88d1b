"""Camera-path utilities: pose interpolation and normalization — port of
tgtc/data/poses.py (``min_line_dist_center`` :17-29, ``_slerp`` :32-71,
``interpolate_poses`` :74-93, ``normalize_cps`` :96-110).

Host-side camera math in numpy, as in the JAX package: ``interpolate_poses``
densifies a camera trace (rotation slerp, translation lerp) and
``normalize_cps`` recenters a trace on the point nearest to every camera
axis and rescales it. A copy of the JAX module's math, not an import.
"""

from __future__ import annotations

import numpy as np


def min_line_dist_center(rays_o: np.ndarray, rays_d: np.ndarray) -> np.ndarray:
    """The point minimizing the summed squared distance to every camera
    axis (``rays_o`` origins, ``rays_d`` directions, any leading shape)."""
    d = rays_d.reshape(-1, 3)
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    o = rays_o.reshape(-1, 3)
    a_i = np.eye(3)[None] - d[:, :, None] * d[:, None, :]
    b_i = -np.einsum("nij,nj->ni", a_i, o)
    m = (np.transpose(a_i, (0, 2, 1)) @ a_i).mean(0)
    # pinv: parallel camera axes make m singular
    return -np.linalg.pinv(m) @ b_i.mean(0)


def _slerp(r0: np.ndarray, r1: np.ndarray, t: float) -> np.ndarray:
    """The rotation a fraction ``t`` of the way from ``r0`` to ``r1``, by
    quaternion slerp."""
    def to_quat(m):
        w = np.sqrt(max(0.0, 1 + m[0, 0] + m[1, 1] + m[2, 2])) / 2
        if w < 1e-8:  # a half-turn: build from the largest diagonal entry
            i = int(np.argmax([m[0, 0], m[1, 1], m[2, 2]]))
            j, k = (i + 1) % 3, (i + 2) % 3
            s = np.sqrt(max(1e-12, 1 + m[i, i] - m[j, j] - m[k, k])) * 2
            q = np.zeros(4)
            q[1 + i] = s / 4
            q[0] = (m[k, j] - m[j, k]) / s
            q[1 + j] = (m[j, i] + m[i, j]) / s
            q[1 + k] = (m[k, i] + m[i, k]) / s
            return q
        return np.array([w, (m[2, 1] - m[1, 2]) / (4 * w), (m[0, 2] - m[2, 0]) / (4 * w),
                         (m[1, 0] - m[0, 1]) / (4 * w)])

    def to_mat(q):
        w, x, y, z = q
        return np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ])

    q0, q1 = to_quat(r0), to_quat(r1)
    if np.dot(q0, q1) < 0:
        q1 = -q1
    theta = np.arccos(np.clip(np.dot(q0, q1), -1.0, 1.0))
    if theta < 1e-6:
        q = (1 - t) * q0 + t * q1
    else:
        q = (np.sin((1 - t) * theta) * q0 + np.sin(t * theta) * q1) / np.sin(theta)
    return to_mat(q / np.linalg.norm(q))


def interpolate_poses(cps: np.ndarray, factor: float) -> np.ndarray:
    """Densify a camera trace ``cps [N, 4, 4]`` (or ``[N, 3, 4]``) to ``[(N
    − 1)·steps + 1, 4, 4]``: ``steps = round(1/factor)`` poses a gap, the
    rotation slerped and the translation lerped, the last pose kept."""
    steps = max(1, int(round(1.0 / factor)))
    out = []
    for i in range(len(cps) - 1):
        r0, r1 = cps[i, :3, :3], cps[i + 1, :3, :3]
        t0, t1 = cps[i, :3, 3], cps[i + 1, :3, 3]
        for s in range(steps):
            t = s / steps
            m = np.eye(4, dtype=cps.dtype)
            m[:3, :3] = _slerp(r0, r1, t)
            m[:3, 3] = (1 - t) * t0 + t * t1
            out.append(m)
    out.append(np.eye(4, dtype=cps.dtype))
    out[-1][:3, :4] = cps[-1, :3, :4]
    return np.stack(out, 0)


def normalize_cps(cps: np.ndarray, scale: float = 1.0) -> np.ndarray:
    """A copy of the trace recentered on :func:`min_line_dist_center` of its
    camera axes (the third rotation column) and rescaled so that the
    farthest camera sits at ``scale``."""
    cps = cps.copy()
    center = min_line_dist_center(cps[:, :3, 3], cps[:, :3, 2])
    cps[:, :3, 3] -= center
    radius = np.max(np.linalg.norm(cps[:, :3, 3], axis=-1))
    if radius > 0:
        cps[:, :3, 3] *= scale / radius
    return cps
