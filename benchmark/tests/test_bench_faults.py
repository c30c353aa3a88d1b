"""The check catches a broken program: each cell driven on the CPU at a tiny
size (the harness's look for a card skipped, the kernels' plain twins in
their place) with the timed path broken underneath comes out not correct
under the cell's own limits, and the unbroken run comes out correct.

Faults, as they would be planted: a step that leaves the state unchanged;
half of the batch left out and the mean taken over the rest; an answer
altered where it is produced; half of a frame's rays left out. The cells
run on one chip, so no exchange between chips can be left out."""

import time

import pytest
import torch

from benchmark.run import judge, run_cell
from benchmark.tests.tiny import tiny_cell


def verdict(name: str, seed: int = 2**31 + 11) -> bool:
    cell = tiny_cell(name)
    res = run_cell(cell, seed, 0.3, False, "cpu", time.perf_counter())
    return judge(res["readings"]["program"], cell.workload["limits"])[1]


def unchanged_state(mp):
    mp.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)


def half_batch_nerf(mp):
    from tgtc_torch.train import nerf_trainer as nt

    inner = nt.TrainStep.loss_and_grad

    def half(self, coarse, fine, ro, rd, rgb, draws):
        b = len(draws.idx) // 2
        return inner(self, coarse, fine, ro, rd, rgb,
                     nt.StepDraws(draws.idx[:b], draws.perturb_u[:b], draws.noise_coarse[:b],
                                  draws.noise_fine[:b]))
    mp.setattr(nt.TrainStep, "loss_and_grad", half)


def half_batch_style(mp):
    from tgtc_torch.train import style3d as s3

    inner = s3.StyleTrainStep.local_draws

    def half(self, draws):
        d = inner(self, draws)
        b = len(d.main_ids) // 2
        return s3.StyleStepDraws(d.main_ids[:b], d.coh_pix, d.u_main[:b], d.u_coh,
                                 tuple(x[:b] for x in d.noise_main), d.noise_coh)
    mp.setattr(s3.StyleTrainStep, "local_draws", half)


def altered(mp, cls_path: str, change):
    import importlib

    mod_name, cls_name = cls_path.rsplit(".", 1)
    cls = getattr(importlib.import_module(mod_name), cls_name)
    inner = cls.render

    def render(self, *a, **k):
        out = inner(self, *a, **k)
        return {**out, "rgb": change(out["rgb"])}
    mp.setattr(cls, "render", render)


def shifted(rgb):
    return rgb + 0.05


def half_left_out(rgb):
    out = rgb.clone()
    out[: len(rgb) // 2] = 0.0
    return out


NERF_R = "tgtc_torch.render.fast.FusedNerfRenderer"
STYLE_R = "tgtc_torch.render.fast_style.FusedStyleRenderer"
FAULTS = {
    "nerf-fern.train": {"unchanged_state": unchanged_state, "half_batch": half_batch_nerf},
    "stylefield-fern.distill": {"unchanged_state": unchanged_state,
                                "half_batch": half_batch_style},
    "nerf-fern.view": {"answer_altered": lambda mp: altered(mp, NERF_R, shifted),
                       "half_left_out": lambda mp: altered(mp, NERF_R, half_left_out)},
    "stylefield-fern.view": {"answer_altered": lambda mp: altered(mp, STYLE_R, shifted),
                             "half_left_out": lambda mp: altered(mp, STYLE_R, half_left_out)},
}


@pytest.mark.parametrize("name", list(FAULTS))
def test_sound_run_is_correct_and_the_control_is_not(name):
    """The control: the reference one precision below the configuration's,
    put in the program's place (on the card at the cell's own size:
    ``benchmark/calibrate.py``)."""
    cell = tiny_cell(name)
    res = run_cell(cell, 2**31 + 13, 0.3, False, "cpu", time.perf_counter(), extra=True)
    assert judge(res["readings"]["program"], cell.workload["limits"])[1]
    assert not judge(res["readings"]["control"], cell.workload["limits"])[1]


@pytest.mark.parametrize("name,fault", [(n, f) for n, fs in FAULTS.items() for f in fs])
def test_broken_run_is_not_correct(name, fault, monkeypatch):
    FAULTS[name][fault](monkeypatch)
    assert not verdict(name)
