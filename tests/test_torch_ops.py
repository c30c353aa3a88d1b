"""tgtc_torch.ops against tgtc.ops on the same inputs (f32, atol 1e-5).

Re-runs the case list of tests/test_ops.py on the port: encoding,
sigma_weights (with and without deltas), alpha_composite (white background,
injected noise), uniform/harmony sampling with injected jitter, sample_pdf
(deterministic and injected u), merge_and_resample_fine and the losses.
JAX's random draws are made with its keys and handed to the port.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgtc import ops as jops
from tgtc.ops.composite import sigma_weights as j_sigma_weights
from tgtc_torch import ops as tops

torch.set_num_threads(1)
ATOL = 1e-5


def close(got, want, atol=ATOL, rtol=0.0):
    """assert_allclose that also prints the observed max error, tagged with
    the test's id (``pytest -s tests/test_torch_*.py | grep parity``).
    The other port test files import it from here."""
    if isinstance(got, torch.Tensor):
        got = got.detach().float().cpu().numpy()
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    test = os.environ.get("PYTEST_CURRENT_TEST", "?").split(" ")[0]
    print(f"[parity] {test}: max|err| {err:.3e} (atol {atol:g})")
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


def T(x):
    return torch.from_numpy(np.array(x, np.float32))


class TestEncoding:
    @pytest.mark.parametrize("L", [0, 4, 10])
    def test_matches_jax(self, L):
        x = np.random.default_rng(0).normal(size=(5, 3)).astype(np.float32)
        got = tops.positional_encoding(T(x), L)
        assert got.shape == (5, tops.encoding_dim(3, L))
        assert tops.encoding_dim(3, L) == jops.encoding_dim(3, L)
        close(got, jops.positional_encoding(jnp.asarray(x), L))

    def test_values_and_order(self):
        x = np.array([[0.3, -0.7, 1.2]], np.float32)
        out = tops.positional_encoding(T(x), 3).numpy()
        expect = [x[0]]
        for f in [1.0, 2.0, 4.0]:
            expect += [np.sin(x[0] * f), np.cos(x[0] * f)]
        np.testing.assert_allclose(out[0], np.concatenate(expect), rtol=1e-6)

    def test_grad_finite(self):
        x = torch.ones(4, 3, requires_grad=True)
        (tops.positional_encoding(x, 10) ** 2).sum().backward()
        assert torch.isfinite(x.grad).all()


class TestSigmaWeights:
    @pytest.mark.parametrize("with_deltas", [False, True])
    def test_matches_jax(self, with_deltas):
        rng = np.random.default_rng(1)
        sigma = rng.normal(size=(16, 12)).astype(np.float32) * 2
        t = np.sort(rng.uniform(0.1, 3.0, (16, 12)).astype(np.float32), axis=1)
        deltas = rng.uniform(0.01, 0.5, (16, 12)).astype(np.float32) if with_deltas else None
        got = tops.sigma_weights(T(sigma), T(t), None if deltas is None else T(deltas))
        want = j_sigma_weights(jnp.asarray(sigma), jnp.asarray(t),
                                  None if deltas is None else jnp.asarray(deltas))
        close(got, want)


class TestAlphaComposite:
    def _inputs(self, seed=0):
        rng = np.random.default_rng(seed)
        rgb = rng.uniform(size=(16, 12, 3)).astype(np.float32)
        sigma = rng.normal(size=(16, 12)).astype(np.float32) * 2
        t = np.sort(rng.uniform(0.1, 3.0, (16, 12)).astype(np.float32), axis=1)
        return rgb, sigma, t

    @pytest.mark.parametrize("white", [False, True])
    def test_matches_jax(self, white):
        rgb, sigma, t = self._inputs()
        got = tops.alpha_composite(T(rgb), T(sigma), T(t), white_bkgd=white)
        want = jops.alpha_composite(jnp.asarray(rgb), jnp.asarray(sigma),
                                    jnp.asarray(t), white_bkgd=white)
        for g, w in zip(got, want):
            close(g, w)

    def test_injected_noise_matches_jax_key(self):
        rgb, sigma, t = self._inputs(2)
        key = jax.random.PRNGKey(3)
        noise = np.asarray(jax.random.normal(key, sigma.shape, jnp.float32))
        got = tops.alpha_composite(T(rgb), T(sigma), T(t), noise_std=1.0, noise=T(noise))
        want = jops.alpha_composite(jnp.asarray(rgb), jnp.asarray(sigma),
                                    jnp.asarray(t), noise_std=1.0, key=key)
        for g, w in zip(got, want):
            close(g, w)
        plain = tops.alpha_composite(T(rgb), T(sigma), T(t))
        assert not torch.allclose(plain.rgb, got.rgb)

    def test_opaque_first_sample_wins(self):
        rgb = torch.tensor([[[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]]).repeat(3, 1, 1)
        out = tops.alpha_composite(rgb, torch.full((3, 2), 1e8),
                                   torch.tensor([[0.5, 1.0]]).repeat(3, 1))
        close(out.rgb, [[1, 0, 0]] * 3)
        close(out.t_exp, [0.5] * 3)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16])
    def test_capturable_cumprod_is_cumprods_bit_for_bit(self, dtype):
        """The transmittance's product without autograd's check for zeros (a
        sync, which a CUDA graph's capture refuses) and its gradient equal
        ``torch.cumprod``'s under autograd bit for bit, an opaque sample
        (alpha 1: a factor of 1e-10) included; so does the exclusive
        transmittance built on it."""
        from tgtc_torch.ops.composite import _CumprodNonzero, _exclusive_trans

        alpha = torch.rand((16, 64), generator=torch.Generator().manual_seed(4)).to(dtype)
        alpha[0, 5] = alpha[3, 0] = 1.0
        x1, x2 = ((1.0 - alpha + 1e-10).requires_grad_(True) for _ in range(2))
        got, want = _CumprodNonzero.apply(x1), torch.cumprod(x2, dim=-1)
        g = torch.randn(got.shape, generator=torch.Generator().manual_seed(5)).to(dtype)
        assert torch.equal(got, want)
        assert torch.equal(torch.autograd.grad(got, x1, g)[0], torch.autograd.grad(want, x2, g)[0])
        a1, a2 = (alpha.clone().requires_grad_(True) for _ in range(2))
        trans = torch.cumprod(1.0 - a2 + 1e-10, dim=-1)
        got, want = _exclusive_trans(a1), torch.cat([torch.ones_like(trans[:, :1]),
                                                     trans[:, :-1]], dim=-1)
        assert torch.equal(got, want)
        assert torch.equal(torch.autograd.grad(got, a1, g)[0], torch.autograd.grad(want, a2, g)[0])

    def test_white_background_transparent(self):
        t = torch.linspace(0, 1, 4).expand(2, 4)
        out = tops.alpha_composite(torch.zeros(2, 4, 3), torch.full((2, 4), -10.0), t,
                                   white_bkgd=True)
        close(out.rgb, np.ones((2, 3)))


class TestUniformSampling:
    def test_deterministic_matches_jax(self):
        rng = np.random.default_rng(4)
        o = rng.normal(size=(7, 3)).astype(np.float32)
        d = rng.normal(size=(7, 3)).astype(np.float32)
        pts, ts = tops.sample_along_rays_uniform(T(o), T(d), 16, near=0.5, far=2.5)
        jp, jt = jops.sample_along_rays_uniform(jnp.asarray(o), jnp.asarray(d), 16,
                                                near=0.5, far=2.5)
        close(ts, jt)
        close(pts, jp)

    def test_perturb_with_injected_u(self):
        o, d = np.zeros((64, 3), np.float32), np.ones((64, 3), np.float32)
        key = jax.random.PRNGKey(0)
        u = np.asarray(jax.random.uniform(key, (64, 32), jnp.float32))
        pts, ts = tops.sample_along_rays_uniform(T(o), T(d), 32, near=0.0, far=1.0, u=T(u))
        jp, jt = jops.sample_along_rays_uniform(jnp.asarray(o), jnp.asarray(d), 32,
                                                near=0.0, far=1.0, key=key)
        close(ts, jt)
        close(pts, jp)

    def test_harmony_matches_jax(self):
        o, d = np.zeros((2, 3), np.float32), np.ones((2, 3), np.float32)
        _, ts = tops.sample_along_rays_uniform(T(o), T(d), 8, near=1.0, far=4.0, harmony=True)
        _, jt = jops.sample_along_rays_uniform(jnp.asarray(o), jnp.asarray(d), 8,
                                               near=1.0, far=4.0, harmony=True)
        close(ts, jt)
        np.testing.assert_allclose(1.0 / ts[0].numpy(), np.linspace(1.0, 0.25, 8), rtol=1e-5)


class TestSamplePdf:
    def test_deterministic_matches_jax(self):
        rng = np.random.default_rng(5)
        bins = np.sort(rng.uniform(0, 1, (8, 17)).astype(np.float32), axis=1)
        w = rng.uniform(size=(8, 16)).astype(np.float32)
        got = tops.sample_pdf(T(bins), T(w), 24)
        close(got, jops.sample_pdf(jnp.asarray(bins), jnp.asarray(w), 24))

    def test_deterministic_quantiles(self):
        bins = torch.linspace(0.0, 1.0, 5).expand(1, 5)
        s = tops.sample_pdf(bins, torch.ones(1, 4), 9)
        close(s[0], np.linspace(0.0, 1.0, 9))

    def test_injected_u_matches_jax_key(self):
        bins = np.broadcast_to(np.linspace(0.0, 1.0, 11, dtype=np.float32), (4, 11))
        w = np.full((4, 10), 1e-4, np.float32)
        w[:, 7] = 1.0
        key = jax.random.PRNGKey(1)
        u = np.asarray(jax.random.uniform(key, (4, 128), jnp.float32))
        got = tops.sample_pdf(T(bins), T(w), 128, u=T(u))
        want = jops.sample_pdf(jnp.asarray(bins), jnp.asarray(w), 128, key=key)
        close(got, want)
        s = got.numpy()
        assert np.mean((s >= 0.7) & (s <= 0.8)) > 0.95

    def test_shape_mismatch_raises(self):
        with pytest.raises(ValueError):
            tops.sample_pdf(torch.zeros(2, 5), torch.zeros(2, 5), 4)


class TestMergeResample:
    def test_matches_jax_and_sorted(self):
        rng = np.random.default_rng(6)
        o = rng.normal(size=(8, 3)).astype(np.float32)
        d = rng.normal(size=(8, 3)).astype(np.float32)
        _, jts = jops.sample_along_rays_uniform(jnp.asarray(o), jnp.asarray(d), 16)
        w = rng.uniform(size=(8, 16)).astype(np.float32)
        pts, t_all = tops.merge_and_resample_fine(T(o), T(d), T(jts), T(w), 16)
        jp, jt = jops.merge_and_resample_fine(jnp.asarray(o), jnp.asarray(d), jts,
                                              jnp.asarray(w), 16)
        assert t_all.shape == (8, 32) and pts.shape == (8, 32, 3)
        close(t_all, jt)
        close(pts, jp)
        assert (t_all[:, 1:] >= t_all[:, :-1]).all()

    def test_no_gradient_through_sampling(self):
        _, ts = tops.sample_along_rays_uniform(torch.zeros(4, 3), torch.ones(4, 3), 8)
        w = torch.ones(4, 8, requires_grad=True)
        _, t_all = tops.merge_and_resample_fine(torch.zeros(4, 3), torch.ones(4, 3), ts, w, 8)
        assert not t_all.requires_grad


class TestLosses:
    def test_psnr_mse(self):
        close(tops.mse2psnr(torch.tensor(0.01)), float(jops.mse2psnr(jnp.asarray(0.01))))
        np.testing.assert_allclose(float(tops.mse2psnr(torch.tensor(0.01))), 20.0, rtol=1e-5)
        assert float(tops.img2mse(torch.ones(4), torch.zeros(4))) == 1.0

    def test_cosine_similarity_matches_jax(self):
        rng = np.random.default_rng(7)
        a = rng.normal(size=(6, 5)).astype(np.float32)
        b = rng.normal(size=(6, 5)).astype(np.float32)
        a[0] = 0.0  # zero vector: the eps inside the sqrt keeps it finite
        close(tops.cosine_similarity(T(a), T(b)),
              jops.cosine_similarity(jnp.asarray(a), jnp.asarray(b)))
        x = torch.zeros(1, 3, requires_grad=True)
        tops.cosine_similarity(x, torch.ones(1, 3)).sum().backward()
        assert torch.isfinite(x.grad).all()
