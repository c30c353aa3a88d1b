"""The port's profiler spans (``tgtc_torch.utils.logging.span``) on the CPU.

* With the profiler off a span enters no ``record_function``: the op that
  opens one is counted while a step and a frame run.
* Under ``torch.profiler`` the fused Phase-A step (the kernels' plain
  twins), the Phase-E step and the C1 step (K6-K8's twins, dropout on),
  each inside a ``bench.step`` range, record
  ``tgtc.step.forward``, ``.backward`` and ``.optimizer`` once each, in that
  order, as direct children of ``bench.step`` (``tgtc.step.draw`` first when
  the step draws for itself). Siblings: a trace that keeps one level under
  its own range keeps them all.
* ``FusedNerfRenderer.render_image`` and ``FusedStyleRenderer.render_image``
  inside a ``bench.frame`` range record ``tgtc.render.coarse``,
  ``.resample`` and ``.fine`` once a ray block, as its direct children.
* A step's new state and metrics, and a frame's outputs, are bit for bit
  the same with the profiler on and off.
"""

import copy

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from tgtc_torch.data.style_dataset import StyleSceneData
from tgtc_torch.models.nerf import NerfConfig, make_nerf
from tgtc_torch.models.style_field import StyleFieldConfig, init_latents, make_style_mlps
from tgtc_torch.models.stytrans import make_stytrans
from tgtc_torch.models.transformer import TransformerConfig
from tgtc_torch.render.fast import FusedNerfRenderer
from tgtc_torch.render.fast_style import FusedStyleRenderer
from tgtc_torch.render.volume import RenderSettings
from tgtc_torch.train import nerf_trainer as tt
from tgtc_torch.train import style3d as ts
from tgtc_torch.train import transformer2d as t2
from tgtc_torch.utils.logging import SPANS, span

torch.set_num_threads(1)

STEP = ("tgtc.step.forward", "tgtc.step.backward", "tgtc.step.optimizer")
RENDER = ("tgtc.render.coarse", "tgtc.render.resample", "tgtc.render.fine")
RAYS, BLOCK = 40, 16  # three blocks, the last one padded
S, F, H, W = 2, 3, 6, 6


def _rays(n, seed):
    g = torch.Generator().manual_seed(seed)
    ro = torch.rand((n, 3), generator=g) - 0.5
    rd = torch.randn((n, 3), generator=g)
    return ro, rd / rd.norm(dim=-1, keepdim=True)


class PhaseA:
    """The fused Phase-A step at D8/W256 (K1/K3's twins), batch 16, 8+8."""

    def __init__(self):
        self.cfg = NerfConfig()
        self.tc = tt.NerfTrainConfig(batch_size=16, n_samples=8, n_samples_fine=8,
                                     sigma_noise_std=1.0)
        self.step = tt.make_fused_train_step(self.cfg, self.tc, device="cpu")
        self.ro, self.rd = _rays(64, 1)
        self.rgb = torch.rand((64, 3), generator=torch.Generator().manual_seed(2))

    def fresh(self):
        return tt.init_state(torch.Generator().manual_seed(0), self.cfg, self.tc, device="cpu")

    def draws(self):
        return self.step.draw(64, torch.Generator().manual_seed(3))

    def __call__(self, state, draws):
        gen = torch.Generator().manual_seed(3)
        return self.step(state, self.ro, self.rd, self.rgb, generator=gen, draws=draws)

    @staticmethod
    def snapshot(state):
        return ([p.detach().clone() for p in state.parameters()], state.step,
                state.scheduler.get_last_lr())


class PhaseE:
    """The Phase-E step on D2/W32 trunks, style_d 2, width 32, latent 8;
    batch 16 a stream, 8+8, the coherence term active."""

    def __init__(self):
        g = torch.Generator().manual_seed(0)
        trunk = NerfConfig(depth=2, width=32, compute_dtype=torch.float32)
        coarse, fine = make_nerf(trunk, g, device="cpu"), make_nerf(trunk, g, device="cpu")
        self.tc = ts.StyleTrainConfig(batch_size=16, n_samples=8, n_samples_fine=8,
                                      origin_step=0, coh_until_step=1000)
        field = StyleFieldConfig(style_d=2, width=32, latent_dim=8, embed_dim=trunk.input_ch)
        self.state = ts.init_style_state(g, field, self.tc, S, F, device="cpu")
        self.step = ts.make_style_train_step(coarse, fine, self.tc)
        u = lambda *shape: torch.rand(shape, generator=g)
        self.data = StyleSceneData(rays_o=u(F, H, W, 3) - 0.5, rays_d=torch.randn(
            (F, H, W, 3), generator=g), images=u(F, H, W, 3), stylized=u(S, F, H, W, 3),
            style_features=torch.randn((S, 1024), generator=g))
        self.step(self.state, self.data, seed=5)  # the coherence buffers filled

    def fresh(self):
        return copy.deepcopy(self.state)

    def draws(self):
        return self.step.draw(self.data, self.state, seed=5)

    def __call__(self, state, draws):
        return self.step(state, self.data, draws=draws, seed=5)

    @staticmethod
    def snapshot(state):
        return ([p.detach().clone() for p in state.parameters()], state.step, state.cnt,
                state.coh_x.clone(), state.coh_y.clone(), state.coh_x_origin.clone())


class PhaseC1:
    """The C1 step on a d_model 32 StyTrans (2 heads, 1 + 1 layers, FFN 64,
    dropout 0.1, flash attention's twins), batch 2 of 16x16 uint8 crops.
    Its draws are a generator seed: without one the step seeds its own."""

    def __init__(self):
        cfg = TransformerConfig(d_model=32, nhead=2, num_encoder_layers=1, num_decoder_layers=1,
                                dim_feedforward=64, dropout=0.1, attn_impl="flash")
        self.model = make_stytrans(cfg, torch.Generator().manual_seed(0), device="cpu")
        self.tc = t2.TransformerTrainConfig(batch_size=2, patch=16)
        self.step = t2.make_transformer_train_step(self.model, self.tc)
        g = torch.Generator().manual_seed(1)
        self.content, self.style = (torch.randint(0, 256, (2, 16, 16, 3), generator=g,
                                                  dtype=torch.uint8) for _ in range(2))

    def fresh(self):
        return t2.init_transformer_train(copy.deepcopy(self.model), self.tc)

    def draws(self):
        return 9

    def __call__(self, state, draws):
        gen = None if draws is None else torch.Generator().manual_seed(draws)
        return self.step(state, self.content, self.style, seed=5, generator=gen)

    @staticmethod
    def snapshot(state):
        return ([p.detach().clone() for p in state.model.parameters()], state.step,
                state.scheduler.get_last_lr())


@pytest.fixture(scope="module", params=["phase_a", "phase_e", "phase_c1"])
def trainer(request):
    return {"phase_a": PhaseA, "phase_e": PhaseE, "phase_c1": PhaseC1}[request.param]()


def _nerf_frame():
    g = torch.Generator().manual_seed(0)
    sd = [make_nerf(NerfConfig(), g, device="cpu").state_dict() for _ in range(2)]
    settings = RenderSettings(n_samples=8, n_samples_fine=8, sigma_noise_std=0.0)
    renderer = FusedNerfRenderer.from_params(*sd, settings, coarse_rgb=False, device="cpu")
    ro, rd = _rays(RAYS, 1)
    return lambda: renderer.render_image(ro, rd, block=BLOCK)


def _style_frame():
    g = torch.Generator().manual_seed(0)
    sd = [make_nerf(NerfConfig(), g, device="cpu").state_dict() for _ in range(2)]
    concat, style = make_style_mlps(StyleFieldConfig(), g, device="cpu")
    settings = RenderSettings(n_samples=8, n_samples_fine=8, sigma_noise_std=0.0)
    renderer = FusedStyleRenderer.from_params(
        *sd, concat.state_dict(), style.state_dict(), init_latents(g, S, F, 32, device="cpu"),
        settings, coarse_rgb=False, device="cpu")
    ro, rd = _rays(RAYS, 1)
    return lambda: renderer.render_image(ro, rd, style_id=1, frame_id=2, block=BLOCK, seed=4)


@pytest.fixture(scope="module", params=["nerf", "style"])
def frame(request):
    return {"nerf": _nerf_frame, "style": _style_frame}[request.param]()


def _traced(fn, outer):
    """``fn()`` inside an ``outer`` range under the CPU profiler: its result
    and the program's span events, ordered by their start."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(outer):
            out = fn()
    spans = sorted((e for e in prof.events() if e.name in SPANS),
                   key=lambda e: e.time_range.start)
    return out, spans


def _same(a, b):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert a == b


@pytest.fixture
def entered(monkeypatch):
    """The names of the ``record_function`` ranges opened from here on."""
    names = []
    inner = torch.ops.profiler._record_function_enter_new

    def count(name, *args):
        names.append(name)
        return inner(name, *args)

    monkeypatch.setattr(torch.ops.profiler, "_record_function_enter_new", count)
    return names


def test_spans_are_listed_once():
    assert len(set(SPANS)) == len(SPANS)
    assert set(STEP + RENDER + ("tgtc.step.draw",)) == set(SPANS)


def test_span_records_only_under_the_profiler(entered):
    with span("tgtc.step.forward"):
        pass
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        with span("tgtc.step.forward"):
            pass
    assert entered == ["tgtc.step.forward"]


def test_step_and_frame_enter_no_span_with_the_profiler_off(trainer, frame, entered):
    trainer(trainer.fresh(), None)
    frame()
    assert not [n for n in entered if n in SPANS]


@pytest.mark.parametrize("own_draws", [False, True])
def test_step_records_its_phases_once_in_order(trainer, own_draws):
    draws = None if own_draws else trainer.draws()
    _, spans = _traced(lambda: trainer(trainer.fresh(), draws), "bench.step")
    want = (("tgtc.step.draw",) if own_draws else ()) + STEP
    assert tuple(e.name for e in spans) == want
    assert all(e.cpu_parent is not None and e.cpu_parent.name == "bench.step" for e in spans)


def test_step_is_bit_identical_under_the_profiler(trainer):
    draws = trainer.draws()
    plain = trainer.fresh()
    _, m_plain = trainer(plain, draws)
    (traced, m_traced), _ = _traced(lambda: trainer(trainer.fresh(), draws),
                                    "bench.step")
    _same(m_plain, m_traced)
    _same(trainer.snapshot(plain), trainer.snapshot(traced))
    _same(plain.optimizer.state_dict()["state"], traced.optimizer.state_dict()["state"])


def test_frame_records_three_spans_a_block(frame):
    _, spans = _traced(frame, "bench.frame")
    blocks = -(-RAYS // BLOCK)
    assert tuple(e.name for e in spans) == RENDER * blocks
    assert all(e.cpu_parent is not None and e.cpu_parent.name == "bench.frame" for e in spans)


def test_frame_is_bit_identical_under_the_profiler(frame):
    traced, _ = _traced(frame, "bench.frame")
    _same(frame(), traced)
