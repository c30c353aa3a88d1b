"""The work counts equal counts taken from the layers of the port's own
modules at the configurations' shapes, and the trace's arithmetic."""

import json

import pytest
import torch

from benchmark.drivers import common as C
from benchmark.harness import spec as S
from benchmark.harness import trace as TR
from benchmark.harness import work as W

NERF = json.loads((S.ROOT / "benchmark/configs/nerf-fern-d8w256.json").read_text())
STYLE = json.loads((S.ROOT / "benchmark/configs/stylefield-fern-d8w256-l32.json").read_text())


def linears(module):
    return {n: m for n, m in module.named_modules() if isinstance(m, torch.nn.Linear)}


def test_trunk_counts_from_the_module():
    from tgtc_torch.models.nerf import NerfMLP

    lin = linears(NerfMLP(C.nerf_config(NERF)))
    macs = {n: m.in_features * m.out_features for n, m in lin.items()}
    trunk = sum(v for n, v in macs.items() if n.startswith("base_layers.")) + macs["sigma_layer"]
    t = W.trunk_flop(NERF)
    assert t["sigma"] == 2 * trunk == 982_528
    assert t["full"] == 2 * sum(macs.values()) == 1_186_816
    assert t["remap"] == 2 * (trunk + macs["base_remap_layer"])
    # K3: weight gradients of every layer, input gradients of every layer
    # but the first, without the encoding columns of the skip layer and rgb_0
    enc_c, enc_d = 3 + 6 * NERF["multires"], 3 + 6 * NERF["multires_views"]
    dx = (sum(macs.values()) - macs["base_layers.0"] - lin["base_layers.5"].out_features * enc_c
          - lin["rgb_layers.0"].out_features * enc_d)
    assert t["backward"] == 2 * sum(macs.values()) + 2 * dx == 2_302_208


def test_style_counts_from_the_modules():
    from tgtc_torch.models.style_field import (
        StyleFieldConfig, StyleMLPBeforeConcat, StyleMLPWildMultilayers)

    f = StyleFieldConfig(style_d=STYLE["style_D"], width=STYLE["netwidth"],
                         latent_dim=STYLE["vae_latent"], embed_dim=3 + 6 * STYLE["multires"])
    concat = sum(m.in_features * m.out_features for m in linears(StyleMLPBeforeConcat(f)).values())
    # the style MLP's latent columns hold the per-ray mean: one term a ray, not a point
    style = sum((m.in_features - f.latent_dim) * m.out_features
                for m in linears(StyleMLPWildMultilayers(f)).values())
    assert W.style_flop(STYLE) == 2 * (concat + style)
    assert W.k4_flop(STYLE) == 2_898_944


def test_kernel_bytes_count_inputs_outputs_and_weights_once():
    flop, nbytes = W.kernel_work("K2", NERF, 1000, 10, 2)
    assert flop == 982_528 * 1000
    assert nbytes == 16 * 1000 + 2 * W.trunk_weight_bytes(NERF, sigma_only=True)
    with pytest.raises(KeyError):
        W.kernel_work("K9", NERF, 1, 1, 1)


def fake_trace():
    dev = [TR.Event("void (anonymous namespace)::nerf_fwd_kernel<8>(x)", 0, 10),
           TR.Event("elementwise", 5, 12), TR.Event("nerf_fwd_kernel", 20, 30),
           TR.Event("Memcpy DtoH (Device -> Pageable)", 40, 42)]
    host = [TR.Event("bench.step", 0, 18), TR.Event("aten::linear", 12, 16),
            TR.Event("bench.step", 18, 36), TR.Event("bench.copy", 36, 44)]
    return TR.Trace(units=2, window_s=44e-6, device=dev, host=host,
                    scale={e.name: 1.0 for e in dev})


def test_busy_union_and_breakdown():
    tr = fake_trace()
    assert TR.busy([(e.start, e.end) for e in tr.device]) == 12 + 10 + 2
    b = TR.breakdown(tr)
    assert b["device_ops"][0][0] == "void (anonymous namespace)::nerf_fwd_kernel<8>(x)"
    assert b["device_ops"][0][1] == pytest.approx(10e-6)
    assert [g[0] for g in b["idle_gaps"]] == ["bench.step", "bench.step > aten::linear"]
    assert [g[1] for g in b["idle_gaps"]] == pytest.approx([10e-6, 8e-6])


def test_context_shares():
    tr = fake_trace()
    work = {"model_flop": 989e12 * 20e-6 * 0.5, "kernels": {"K1": (989e12 * 5e-6, 0.0)}}
    ctx = TR.Context(NERF, work, unit_s=20e-6, trace=tr)
    assert ctx.device_s(("nerf_fwd_kernel",)) == pytest.approx(10e-6)
    assert ctx.roofline("K1", ("nerf_fwd_kernel",)) == pytest.approx(50.0)
    assert ctx.roofline("K1", ("absent",)) is None
    assert ctx.mfu() == pytest.approx(50.0)
    assert ctx.idle_share() == pytest.approx(100 * (1 - 12e-6 / 20e-6))
    glue = S.metric_reader("glue_device_ms.view").read(ctx)
    assert glue == pytest.approx(1e3 * 7e-6 / 2)
