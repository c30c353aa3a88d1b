"""The port's C1 step against the benchmark's plain StyTr² reference
(``benchmark/reference/stytr2.py``) on the CPU, dropout masks and all.

Narrow network: d_model 64, 2 heads, 1 + 1 + 1 layers, FFN 128, the
truncated VGG and the CNN decoder at their full channel widths; batch 2 of
32x32 crops; the benchmark's seeded weights (``benchmark/drivers/
stytr2_train.draw_weights``). The program is ``TransformerTrainStep`` on
``make_stytrans`` in f32 with ``attn_impl="flash"``, which on CPU tensors
runs K6/K7/K8's plain twins; it seeds its own dropout generator a step,
and the reference draws the same masks from a generator seeded alike.

* Each positional pattern's transformer call (Ics, Icc, Iss) at dropout
  0.1: the stylized tokens to 1e-5 (f32 sums of one value in two orders).
* Three steps at dropout 0.1 and 0, each tolerance 5-10 times the largest
  reading. The CNN decoder's and the VGG's ReLUs hold inputs within f32
  rounding of zero, which take either side on either side's rounding and
  reroute their elements' gradients: the reference reads 3e-4 from a
  float64 run of itself, the program 3e-5, and neither errs. So: the
  first loss to 1e-5 relative and the later ones to 1e-4 (measured 2e-5:
  they follow the updates); each trained leaf's first gradient, as Adam
  got it, within 3e-3 of the larger of its norm and the median leaf's
  (measured 3.2e-4); each leaf's change over the steps within 5e-2 of the
  reference's change (measured 1.7e-2): Adam's first updates are ~lr ·
  sign(g), so an element whose gradient is near nothing moves by up to lr
  on either side of such a rerouting. The key bias (``in_proj_bias[d:2d]``)
  has an analytically zero gradient and is left out of the change; its
  gradient is held with the leaf's.
* The reference with its masks drawn from another seed differs from the
  program in the losses by far more than their tolerance.
"""

import copy
import functools
import statistics

import pytest
import torch

from benchmark.drivers import stytr2_train as D
from benchmark.harness import spec as S
from benchmark.reference import stytr2 as R
from tgtc_torch.models.stytrans import make_stytrans
from tgtc_torch.models.transformer import TransformerConfig
from tgtc_torch.train import transformer2d as t2

torch.set_num_threads(1)

STEPS, SEED, BATCH, CROP = 3, 7, 2, 32
NARROW = {"d_model": 64, "nhead": 2, "num_encoder_layers": 1, "num_decoder_layers": 1,
          "dim_feedforward": 128, "batch_size": BATCH, "crop": CROP}


def narrow_config(dropout):
    cfg = copy.deepcopy(S.load_cell("stytr2.c1-train").config)
    cfg.update(NARROW, dropout=dropout)
    cfg["decoder_convs"] = [[NARROW["d_model"], cfg["decoder_convs"][0][1]]] + cfg[
        "decoder_convs"][1:]
    return cfg


def program(cfg, params0):
    mcfg = TransformerConfig(
        d_model=cfg["d_model"], nhead=cfg["nhead"], num_encoder_layers=cfg["num_encoder_layers"],
        num_decoder_layers=cfg["num_decoder_layers"], dim_feedforward=cfg["dim_feedforward"],
        dropout=cfg["dropout"], dtype=torch.float32, attn_impl="flash")
    model = make_stytrans(mcfg, torch.Generator().manual_seed(0), device="cpu")
    model.load_state_dict(params0)
    return model


def batches():
    g = torch.Generator().manual_seed(1)
    draw = lambda: torch.randint(0, 256, (BATCH, CROP, CROP, 3), generator=g, dtype=torch.uint8)
    return [(draw(), draw()) for _ in range(STEPS)]


def leaf_scale(grads):
    return statistics.median(float(g.norm()) for g in grads.values())


@functools.lru_cache(maxsize=None)
def three_steps(dropout):
    """The program's three steps and the reference's, from the same weights
    and batches."""
    cfg = narrow_config(dropout)
    params0 = D.draw_weights(cfg, torch.Generator().manual_seed(3), "cpu")
    model = program(cfg, params0)
    tcfg = t2.TransformerTrainConfig(batch_size=BATCH, patch=CROP)
    state = t2.init_transformer_train(model, tcfg)
    step = t2.make_transformer_train_step(model, tcfg)
    names, params = zip(*t2.trained_parameters(model))
    losses, grad0 = [], None
    data = batches()
    for content, style in data:
        _, m = step(state, content, style, seed=SEED)
        losses.append(float(m["loss"]))
        if grad0 is None:
            grad0 = {n: state.optimizer.state[p]["exp_avg"] / 0.1 for n, p in zip(names, params)}
    floats = [{"content": c.float() / 255.0, "style": s.float() / 255.0} for c, s in data]
    prog = {"losses": losses, "grad0": grad0,
            "params": {n: p.detach().clone() for n, p in zip(names, params)}}
    return cfg, params0, floats, prog, R.train(params0, cfg, floats, SEED)


@pytest.fixture(params=[0.1, 0.0], ids=["dropout", "no_dropout"])
def run(request):
    return three_steps(request.param)


def test_losses_match(run):
    _, _, _, prog, ref = run
    assert prog["losses"][0] == pytest.approx(ref["losses"][0], rel=1e-5)
    assert prog["losses"] == pytest.approx(ref["losses"], rel=1e-4)


def test_first_gradients_match(run):
    _, _, _, prog, ref = run
    scale = leaf_scale(ref["grad0"])
    for k, g in ref["grad0"].items():
        err = float((prog["grad0"][k] - g).norm())
        assert err <= 3e-3 * max(float(g.norm()), scale), (k, err)


def test_parameters_after_the_steps_match(run):
    _, params0, _, prog, ref = run
    for k, p in ref["params"].items():
        a, b, z = prog["params"][k].flatten(), p.flatten(), params0[k].flatten()
        if k.endswith("in_proj_bias"):
            d = a.shape[0] // 3
            kept = torch.cat([torch.arange(d), torch.arange(2 * d, 3 * d)])
            a, b, z = a[kept], b[kept], z[kept]
        assert float((a - b).norm()) <= 5e-2 * float((b - z).norm()), k


def test_masks_from_another_seed_do_not_match():
    cfg, params0, floats, prog, _ = three_steps(0.1)
    other = R.train(params0, cfg, floats[:1], SEED, mask_seed=True)
    assert abs(other["losses"][0] - prog["losses"][0]) > 1e-3 * abs(prog["losses"][0])


@pytest.mark.parametrize("mode", ["ics", "icc", "iss"])
def test_transformer_call_matches_for_each_positional_pattern(mode):
    cfg = narrow_config(0.1)
    params0 = D.draw_weights(cfg, torch.Generator().manual_seed(4), "cpu")
    model = program(cfg, params0)
    g = torch.Generator().manual_seed(5)
    n, d = 4, cfg["d_model"]
    style, content = (torch.randn((BATCH, n, n, d), generator=g) for _ in range(2))
    with torch.no_grad():
        got = model.transformer(style, content, mode, deterministic=False,
                                generator=torch.Generator().manual_seed(6))
        draws = R.Draws(torch.Generator().manual_seed(6), 0.1, BATCH, BATCH)
        want = R.transformer(params0, cfg, style.reshape(BATCH, n * n, d),
                             content.reshape(BATCH, n * n, d), mode, draws, "f32")
    torch.testing.assert_close(got.reshape(BATCH, n * n, d), want, rtol=1e-5, atol=1e-5)
