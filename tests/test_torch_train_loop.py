"""The Phase-A loop's parts: checkpoints (tgtc_torch.train.checkpoint), the
metrics log (tgtc_torch.utils.logging) and ``train_nerf`` on the synthetic
LLFF scene (tests/synthetic_scene.py), all on the CPU at a tiny width.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from synthetic_scene import make_synthetic_llff_scene
from tgtc_torch.data.llff import load_llff_data
from tgtc_torch.models.nerf import NerfConfig
from tgtc_torch.train import nerf_trainer as tt
from tgtc_torch.train.checkpoint import CheckpointManager
from tgtc_torch.utils.logging import MetricsLogger, fetch_scalars

torch.set_num_threads(1)

TINY = NerfConfig(depth=2, width=32, embed_freq_coor=4, embed_freq_dir=2,
                  compute_dtype=torch.float32)
TCFG = tt.NerfTrainConfig(batch_size=256, n_samples=8, n_samples_fine=8, lrate=5e-3)


def _state(seed=0):
    return tt.init_state(torch.Generator().manual_seed(seed), TINY, TCFG, device="cpu")


def _rays(n=256):
    rng = np.random.default_rng(0)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2]) - 1.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return (torch.zeros(n, 3), torch.from_numpy(d), torch.from_numpy(d * 0.5 + 0.5))


def _params(state):
    return [p.detach().clone() for p in state.parameters()]


def test_checkpoint_round_trip_is_bitwise(tmp_path):
    step = tt.make_train_step(TCFG, device="cpu")
    rays = _rays()
    state = _state()
    for s in range(3):
        state, _ = step(state, *rays, generator=torch.Generator().manual_seed(s))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(state.step, state.state_dict())
    restored = _state(seed=9)
    restored.load_state_dict(mgr.restore())
    assert restored.step == state.step == 3
    assert all(torch.equal(a, b) for a, b in zip(_params(state), _params(restored)))
    for st in (state, restored):
        step(st, *rays, generator=torch.Generator().manual_seed(3))
    assert all(torch.equal(a, b) for a, b in zip(_params(state), _params(restored)))
    assert restored.scheduler.last_epoch == state.scheduler.last_epoch == 4


def test_checkpoint_retention_and_async_saves(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore()
    for s in range(1, 6):
        mgr.save_device_async(s, {"step": s, "w": torch.full((4,), float(s))})
    assert mgr.latest_step() == 5  # waits for the pending saves
    assert mgr.steps() == [4, 5]
    assert torch.equal(mgr.restore(4)["w"], torch.full((4,), 4.0))
    # the snapshot is taken at the call: a later in-place update is not saved
    w = torch.zeros(3)
    mgr.save_device_async(6, {"w": w})
    w.add_(1.0)
    mgr.wait()
    assert torch.equal(mgr.restore(6)["w"], torch.zeros(3))
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    mgr.close()


def test_metrics_log_is_read_by_jsonl2tb(tmp_path):
    from tgtc.tools.jsonl2tb import export_dir

    log = MetricsLogger(str(tmp_path), name="nerf", print_fn=None)
    for s in (10, 20):
        log.log(s, {"loss": torch.tensor(0.5 / s), "psnr": torch.tensor(20.0 + s),
                    "model": 0.25, "note": "not a scalar"})
    log.close()
    lines = [json.loads(x) for x in open(tmp_path / "nerf.jsonl")]
    assert lines[0] == {"step": 10, "loss": pytest.approx(0.05), "psnr": 30.0, "model": 0.25}
    assert export_dir(str(tmp_path), str(tmp_path / "tb")) == {"nerf": 6}


def test_fetch_scalars_keeps_numbers_and_drops_the_rest():
    got = fetch_scalars({"a": torch.tensor([2.0]), "b": 3, "c": torch.ones(2), "d": "x"})
    assert got == {"a": 2.0, "b": 3.0}


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = make_synthetic_llff_scene(tmp_path_factory.mktemp("scene"), n=4, h=16, w=20,
                                     focal=20.0)
    return load_llff_data(root, factor=1)


def test_train_nerf_learns_checkpoints_and_resumes(scene, tmp_path, monkeypatch):
    monkeypatch.setattr(tt, "CKPT_EVERY", 20)
    kw = dict(i_print=10, device="cpu", print_fn=None)
    state, hist = tt.train_nerf(scene, TINY, TCFG, 30, str(tmp_path / "a"), **kw)
    assert state.step == 30 and len(hist["loss"]) == 30
    assert all(np.isfinite(hist["loss"]))
    assert np.mean(hist["loss"][-5:]) < 0.5 * np.mean(hist["loss"][:5])
    assert hist["records"][-1]["psnr_fine"] > hist["records"][0]["psnr_fine"]
    ckpts = CheckpointManager(str(tmp_path / "a" / "nerf_ckpt"))
    assert ckpts.steps() == [20, 30]
    lines = open(tmp_path / "a" / "logs" / "nerf.jsonl").read().splitlines()
    assert [json.loads(x) for x in lines] == hist["records"]
    assert [r["step"] for r in hist["records"]] == [10, 20, 30]

    # a second call resumes at the saved step and draws what an
    # uninterrupted run draws
    state, hist2 = tt.train_nerf(scene, TINY, TCFG, 50, str(tmp_path / "a"), **kw)
    assert state.step == 50 and len(hist2["loss"]) == 20
    whole, hist3 = tt.train_nerf(scene, TINY, TCFG, 50, str(tmp_path / "b"), **kw)
    assert hist3["loss"] == hist["loss"] + hist2["loss"]
    assert all(torch.equal(a, b) for a, b in zip(_params(state), _params(whole)))
    # nothing left to do
    _, hist4 = tt.train_nerf(scene, TINY, TCFG, 50, str(tmp_path / "a"), **kw)
    assert hist4 == {"loss": [], "records": []}


def test_train_nerf_switches_budget_at_segment_boundaries(scene, tmp_path, monkeypatch):
    """``budget_schedule`` ("12@3" on 8+8 samples): steps 0-2 evaluate every
    merged sample, steps 3-5 the budget, with one step function a budget,
    as the JAX pipeline's Phase-A loop switches them; a resumed run picks
    the segment of its step."""
    seen = []
    call = tt.TrainStep.__call__

    def record(self, state, *a, **k):
        seen.append((state.step, self.cfg.train_fine_budget))
        return call(self, state, *a, **k)

    monkeypatch.setattr(tt.TrainStep, "__call__", record)
    kw = dict(i_print=10, device="cpu", print_fn=None, budget_schedule="12@3")
    state, hist = tt.train_nerf(scene, TINY, TCFG, 6, str(tmp_path), **kw)
    assert seen == [(0, None), (1, None), (2, None), (3, 12), (4, 12), (5, 12)]
    assert all(np.isfinite(hist["loss"])) and state.step == 6
    seen.clear()
    tt.train_nerf(scene, TINY, TCFG, 8, str(tmp_path), **kw)
    assert seen == [(6, 12), (7, 12)]
    with pytest.raises(ValueError, match="tighten"):
        tt.train_nerf(scene, TINY, TCFG, 9, str(tmp_path), **{**kw, "budget_schedule":
                                                               "12@1,14@2"})
    with pytest.raises(ValueError, match="budget_schedule"):  # one source of the budget
        tt.train_nerf(scene, TINY, dataclasses.replace(TCFG, train_fine_budget=12), 9,
                      str(tmp_path), **kw)


def test_render_image_pads_the_tail_block():
    state = _state()
    ro, rd, _ = _rays(100)
    fn = tt.make_render_fn(TCFG)
    whole = fn(state.coarse, state.fine, ro, rd)
    blocked = tt.render_image(fn, state.coarse, state.fine, ro, rd, block=64)
    assert set(whole) == {"rgb", "rgb_coarse", "t_exp", "acc"}
    for k in whole:
        assert blocked[k].shape == whole[k].shape
        torch.testing.assert_close(blocked[k], whole[k], atol=1e-6, rtol=0)


@pytest.mark.parametrize("step", [0, 5, 1000])
def test_step_seed_gives_each_seed_its_own_draws(step):
    """Two seeds draw different batches, jitter and noise at one step on a
    CPU generator, which keeps only a seed's low 32 bits."""
    pairs = [(s, n) for s in (0, 1, 7, 2 ** 31) for n in (0, 1, 5, 1000)]
    low = {tt.step_seed(s, n) & 0xFFFFFFFF for s, n in pairs}
    assert len(low) == len(pairs)
    step_fn = tt.TrainStep(None, tt.NerfTrainConfig(batch_size=64, n_samples=8,
                                                    n_samples_fine=8, sigma_noise_std=1.0),
                           device="cpu")
    draws = [step_fn.draw(4096, torch.Generator().manual_seed(tt.step_seed(s, step)))
             for s in (0, 1, 7)]
    for i, a in enumerate(draws):
        for b in draws[i + 1:]:
            for field in ("idx", "perturb_u", "noise_coarse", "noise_fine"):
                assert not torch.equal(getattr(a, field), getattr(b, field)), field
    again = step_fn.draw(4096, torch.Generator().manual_seed(tt.step_seed(1, step)))
    assert torch.equal(again.idx, draws[1].idx) and torch.equal(again.perturb_u,
                                                                draws[1].perturb_u)
