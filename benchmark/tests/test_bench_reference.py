"""The plain reference agrees with the port's plain CPU paths (float32
modules, no kernels) at a tiny size: the trunk, the exact render, Phase A's
first steps, the stylized pass and Phase E's first steps."""

import dataclasses

import pytest
import torch

from benchmark.drivers import common as C
from benchmark.harness import traffic as T
from benchmark.reference import compare
from benchmark.reference import nerf as ref_nerf
from benchmark.reference import stylefield as ref_style
from benchmark.tests.tiny import tiny_cell

R = 24  # rays


@pytest.fixture(scope="module")
def nerf_case():
    cfg = tiny_cell("nerf-fern.train").config
    gen = torch.Generator().manual_seed(5)
    trunks = C.draw_trunks(cfg, gen, "cpu")
    ro, rd = T.rays(cfg["H"], cfg["W"], cfg["focal"], T.train_poses(cfg), "cpu")
    return cfg, trunks, ro.reshape(-1, 3)[:R], rd.reshape(-1, 3)[:R], gen


def port_module(cfg, state):
    from tgtc_torch.models.nerf import NerfMLP

    m = NerfMLP(dataclasses.replace(C.nerf_config(cfg), compute_dtype=torch.float32))
    m.load_state_dict(state)
    return m


def test_trunk(nerf_case):
    from tgtc_torch.models.nerf import nerf_apply

    cfg, trunks, ro, rd, _ = nerf_case
    pts = ro[:, None] + torch.linspace(0, 1, 5)[:, None] * rd[:, None]
    dirs = rd[:, None].expand(pts.shape)
    port = nerf_apply(port_module(cfg, trunks["fine"]), pts, dirs)
    ref = ref_nerf.nerf(trunks["fine"], cfg, pts, dirs, remap=True)
    for k in ("rgb", "sigma", "base_remap", "pts_embed"):
        torch.testing.assert_close(ref[k], port[k], rtol=1e-5, atol=1e-5)


def test_exact_render(nerf_case):
    from tgtc_torch.render.volume import RenderSettings, render_rays

    cfg, trunks, ro, rd, _ = nerf_case
    s = RenderSettings(n_samples=cfg["N_samples"], n_samples_fine=cfg["N_samples_fine"],
                       sigma_noise_std=0.0, perturb=False)
    port = render_rays(port_module(cfg, trunks["coarse"]), port_module(cfg, trunks["fine"]),
                       ro, rd, s)["fine"]
    ref = ref_nerf.render(trunks["coarse"], trunks["fine"], cfg, ro, rd)
    torch.testing.assert_close(ref, torch.cat([port.rgb, port.t_exp[:, None],
                                               port.acc[:, None]], 1), rtol=1e-4, atol=1e-5)


def test_phase_a_steps(nerf_case):
    from tgtc_torch.train.nerf_trainer import (
        NerfTrainConfig, NerfTrainState, StepDraws, make_optimizer, make_train_step)

    cfg, trunks, ro, rd, gen = nerf_case
    nc, nf = cfg["N_samples"], cfg["N_samples_fine"]
    tcfg = NerfTrainConfig(batch_size=R, n_samples=nc, n_samples_fine=nf,
                           sigma_noise_std=cfg["sigma_noise_std"], lrate=cfg["lrate"],
                           lrate_decay=cfg["lrate_decay"])
    coarse, fine = port_module(cfg, trunks["coarse"]), port_module(cfg, trunks["fine"])
    opt, sched = make_optimizer(tcfg, list(coarse.parameters()) + list(fine.parameters()))
    state = NerfTrainState(0, coarse, fine, opt, sched)
    step = make_train_step(tcfg, device="cpu")
    rgb = torch.rand((R, 3), generator=gen)
    batches, losses, grad0 = [], [], None
    for _ in range(3):
        d = StepDraws(torch.randperm(R, generator=gen), torch.rand((R, nc), generator=gen),
                      torch.randn((R, nc), generator=gen), torch.randn((R, nc + nf), generator=gen))
        if grad0 is None:
            grad0 = step.loss_and_grad(coarse, fine, ro, rd, rgb, d)[1]
        _, m = step(state, ro, rd, rgb, draws=d)
        losses.append(float(m["loss"]))
        batches.append({"ro": ro[d.idx], "rd": rd[d.idx], "rgb": rgb[d.idx], "u": d.perturb_u,
                        "noise_c": d.noise_coarse, "noise_f": d.noise_fine})
    ref = ref_nerf.train(trunks, cfg, batches)
    assert ref["losses"] == pytest.approx(losses, rel=1e-4)
    for g, (k, v) in zip(grad0, ref["grad0"].items()):
        torch.testing.assert_close(v, g, rtol=1e-4, atol=1e-4 * float(v.abs().max()))
    # Adam's first updates are about lr · sign(g): where a gradient sums to
    # almost nothing, the two sums' rounding flips it, so leaves are held by
    # the norms of their change, as the benchmark's check holds them
    port = {f"{n}.{k}": v for n, mod in (("coarse", coarse), ("fine", fine))
            for k, v in mod.state_dict().items()}
    for k, v in ref["params"].items():
        p0 = trunks[k.split(".")[0]][k.split(".", 1)[1]]
        assert float((port[k] - p0).norm()) == pytest.approx(float((v - p0).norm()), rel=2e-3)


@pytest.fixture(scope="module")
def style_case():
    cfg = tiny_cell("stylefield-fern.distill").config
    gen = torch.Generator().manual_seed(7)
    return (cfg, C.draw_trunks(cfg, gen, "cpu"), C.draw_style(cfg, gen, "cpu"),
            C.draw_table(cfg, gen, "cpu"), gen)


def port_style(cfg, style):
    from tgtc_torch.models.style_field import (
        StyleFieldConfig, StyleMLPBeforeConcat, StyleMLPWildMultilayers)

    f = StyleFieldConfig(style_d=cfg["style_D"], width=cfg["netwidth"],
                         latent_dim=cfg["vae_latent"], embed_dim=3 + 6 * cfg["multires"])
    concat, sty = StyleMLPBeforeConcat(f), StyleMLPWildMultilayers(f)
    concat.load_state_dict(C.sub(style, "concat."))
    sty.load_state_dict(C.sub(style, "style."))
    return concat, sty


def test_stylized_pass(style_case):
    from tgtc_torch.render.style import style_forward

    cfg, trunks, style, table, gen = style_case
    ro, rd = T.rays(cfg["H"], cfg["W"], cfg["focal"], T.train_poses(cfg), "cpu")
    ro, rd = ro.reshape(-1, 3)[:R], rd.reshape(-1, 3)[:R]
    t = ref_nerf.depths(R, 6, 0.0, 1.0, torch.rand((R, 6), generator=gen), "cpu")
    sid = torch.zeros(R, dtype=torch.long)
    fid = torch.arange(R) % table["latents"].shape[1]
    concat, sty = port_style(cfg, style)
    comp, _ = style_forward(port_module(cfg, trunks["fine"]), concat, sty, table, ro, rd, t,
                            sid, fid)
    rgb, t_exp, _ = ref_style.stylized_pass(trunks["fine"], style, cfg, ro, rd, t,
                                            table["latents"][0, fid], "f32")
    torch.testing.assert_close(rgb, comp.rgb, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(t_exp, comp.t_exp, rtol=1e-5, atol=1e-6)


def test_phase_e_steps(style_case, monkeypatch):
    """The benchmark's own Phase-E driver, on f32 trunks, against the
    reference: losses, coherence losses and the trained leaves."""
    from benchmark.drivers import style_distill

    cfg, *_ = style_case
    cell = tiny_cell("stylefield-fern.distill")
    monkeypatch.setattr(C, "nerf_module", lambda c, s, d: port_module(c, s))
    sut = style_distill.build(cell.config, cell.workload["traffic"], 3, "cpu")
    ref = ref_style.train(sut.trunks, sut.style0, sut.table, sut.config, sut._steps())
    assert ref["losses"] == pytest.approx(sut.first["losses"], rel=1e-4)
    assert ref["coh_losses"] == pytest.approx(sut.first["coh_losses"], rel=1e-4, abs=1e-6)
    # f32 sums in two orders, held by the benchmark's own numbers
    r = compare.train_readings(sut.first, ref, {**sut.style0, "latents": sut.table["latents"]})
    assert r["grad_diff"] <= 1e-3 and r["grad_gap"] <= 1e-3 and r["change_gap"] <= 1e-2, r
