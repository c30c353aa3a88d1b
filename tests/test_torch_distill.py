"""The distilled proposal (tgtc_torch.render.distill) and K2 at its width.

* ``proposal_config`` as JAX's: the fine net's encodings, skips and dtype.
* 20 steps of ``distill_proposal`` in f32 (a D2/W32 fine trunk, a D2/W16
  proposal) from JAX's initial parameters (converted with
  ``nerf_state_dict_from_flax``) and JAX's draws: every parameter within
  1e-5 of JAX's relative to its leaf's largest value (floored at the
  learning rate), the reported loss and bias within 1e-5 relative.
* K2's plain twin at width 128 and depths 1-3 and 6 (D2 is the proposal's
  shape on the card; K2-W128 takes the others at run time; 6 reaches the
  skip layer), every bias seeded, against JAX's
  ``fused_nerf_sigma_apply_t(width=128)`` in interpret mode: σ within the
  bf16 kernel tolerance, 1e-1 (ROADMAP.md, Tolerances); the wrapper takes
  width 128 for K2 only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tgtc.models.nerf import NerfConfig as JNerfConfig, make_nerf as j_make_nerf
from tgtc.render import distill as jd
from tgtc_torch.convert import nerf_state_dict_from_flax
from tgtc_torch.models.nerf import NerfConfig, NerfMLP
from tgtc_torch.ops.kernels import nerf_mlp as tk
from tgtc_torch.render import distill as td
from test_torch_ops import close

torch.set_num_threads(1)
FINE = dict(depth=2, width=32, embed_freq_coor=4, embed_freq_dir=2)
STEPS, BATCH, LR = 20, 256, 5e-3


def _rays(n=128, seed=0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.2, 0.2, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2]) - 1.0
    return o, d / np.linalg.norm(d, axis=-1, keepdims=True)


def test_proposal_config_matches_jax():
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = td.proposal_config(NerfConfig(compute_dtype=dtype, skips=(3,), **FINE), 3, 16)
        want = jd.proposal_config(JNerfConfig(compute_dtype=jdtype, skips=(3,), **FINE), 3, 16)
        for f in ("depth", "width", "embed_freq_coor", "embed_freq_dir", "use_viewdir",
                  "act_type", "skips"):
            assert getattr(got, f) == getattr(want, f), f
        assert got.compute_dtype == dtype
    assert (td.proposal_config(NerfConfig()).depth, td.proposal_config(NerfConfig()).width) \
        == (2, 128)


def test_distill_proposal_matches_jax_f32():
    key = jax.random.PRNGKey(7)
    j_fine_cfg = JNerfConfig(compute_dtype=jnp.float32, **FINE)
    _, fine_params = j_make_nerf(j_fine_cfg, jax.random.PRNGKey(1))
    # raise the fine σ so the clip and both signs of the error take part
    fine_params = jax.tree.map(np.asarray, fine_params)
    fine_params["params"]["sigma"]["bias"] = fine_params["params"]["sigma"]["bias"] + 1.0
    ro, rd = _rays()
    kw = dict(depth=2, width=16, steps=STEPS, batch=BATCH, lr=LR, tau=0.85,
              sigma_clip=(-20.0, 1.5))
    want, j_stats = jd.distill_proposal(key, j_fine_cfg, fine_params, jnp.asarray(ro),
                                        jnp.asarray(rd), 0.0, 1.0, **kw)

    # JAX's initial proposal and its draws (one scan chunk: fold_in(key, 1))
    _, init = j_make_nerf(jd.proposal_config(j_fine_cfg, depth=2, width=16), key)
    keys = jax.random.split(jax.random.fold_in(key, 1), STEPS)

    def draws(step):
        k1, k2 = jax.random.split(keys[step])
        idx = jax.random.randint(k1, (BATCH,), 0, ro.shape[0])
        t = jax.random.uniform(k2, (BATCH, 1), minval=0.0, maxval=1.0)
        return torch.from_numpy(np.array(idx)).long(), torch.from_numpy(np.array(t))

    fine = NerfMLP(NerfConfig(compute_dtype=torch.float32, **FINE))
    fine.load_state_dict(nerf_state_dict_from_flax(fine_params))
    got, stats = td.distill_proposal(
        0, fine, torch.from_numpy(ro), torch.from_numpy(rd), 0.0, 1.0,
        init=nerf_state_dict_from_flax(jax.tree.map(np.asarray, init)), draws=draws, **kw)
    ref = nerf_state_dict_from_flax(jax.tree.map(np.asarray, want))
    worst = 0.0
    for name, p in got.items():
        rel = float((p - ref[name]).abs().max()) / max(float(ref[name].abs().max()), LR)
        worst = max(worst, rel)
        assert rel <= 1e-5, (name, rel)
    for k in ("loss", "relu_sigma_bias"):
        close(stats[k], j_stats[k], atol=1e-5 * max(1.0, abs(j_stats[k])))
    assert {k: stats[k] for k in ("depth", "width", "steps")} == dict(depth=2, width=16,
                                                                      steps=STEPS)
    print(f"[parity] distill {STEPS} steps vs JAX: max rel param err {worst:.3e}, loss "
          f"{stats['loss']:.6f} vs {j_stats['loss']:.6f}, bias {stats['relu_sigma_bias']:+.6f} "
          f"vs {j_stats['relu_sigma_bias']:+.6f}")


def test_distill_proposal_draws_from_its_seed():
    fine = NerfMLP(NerfConfig(compute_dtype=torch.float32, **FINE))
    ro, rd = (torch.from_numpy(a) for a in _rays())
    runs = [td.distill_proposal(s, fine, ro, rd, 0.0, 1.0, width=16, steps=3, batch=64)
            for s in (3, 3, 4)]
    assert all(torch.equal(runs[0][0][k], runs[1][0][k]) for k in runs[0][0])
    assert not all(torch.equal(runs[0][0][k], runs[2][0][k]) for k in runs[0][0])
    assert np.isfinite(runs[0][1]["loss"]) and runs[0][0]["base_layers.0.weight"].shape == (16, 27)
    with pytest.raises(ValueError, match="tau"):
        td.distill_proposal(0, fine, ro, rd, 0.0, 1.0, tau=0.3, steps=1)


@pytest.mark.parametrize("depth", [1, 2, 3, 6])
def test_k2_twin_at_the_proposal_width_matches_pallas(depth):
    from tgtc.ops.pallas.nerf_mlp import fused_nerf_sigma_apply_t, pack_nerf_params

    cfg = JNerfConfig(depth=depth, width=128)
    _, params = j_make_nerf(cfg, jax.random.PRNGKey(3))
    params = jax.tree.map(np.asarray, params)
    brng = np.random.default_rng(5)
    for layer in params["params"].values():  # every bias seeded, of bf16 values
        shape = layer["bias"].shape
        mag = brng.uniform(0.25, 0.5, shape) * brng.choice((-1.0, 1.0), shape)
        layer["bias"] = torch.from_numpy(mag.astype(np.float32)).bfloat16().float().numpy()
    rng = np.random.default_rng(4)
    pts = rng.uniform(-1, 1, (3, 384)).astype(np.float32)
    want = fused_nerf_sigma_apply_t(*pack_nerf_params(params, depth=depth, width=128),
                                    jnp.asarray(pts), depth=depth, width=128, tile=128,
                                    interpret=True)
    packed = tk.pack_nerf_params(nerf_state_dict_from_flax(params), depth=depth, width=128)
    assert packed.layers()[:depth + 2] == [(128, 64)] + [
        (128, 192 if i == 5 else 128) for i in range(1, depth)] + [(256, 128), (1, 128)]
    got = tk.fused_nerf_sigma_apply_t(packed, torch.from_numpy(pts))  # the twin on the CPU
    assert got.shape == (1, 384)
    close(got, np.asarray(want), atol=1e-1)
    # K2 takes width 128; K1 (and K3) do not
    meta = torch.empty(3, 64, device="meta")
    with pytest.raises(TypeError):
        tk.fused_nerf_sigma_apply_t(packed, meta)  # past the width check: a non-CUDA tensor
    with pytest.raises(NotImplementedError, match="width 256 .* or 128 \\(K2\\)"):
        tk.fused_nerf_apply_t(packed, meta, meta)
