"""The port's JSONL → TensorBoard exporter (tgtc_torch/tools/jsonl2tb.py)
against the JAX package's (tgtc/tools/jsonl2tb.py): on the same log
directory, in its port's layout (``nerf``, ``style``, ``temporal`` and the
pipeline's ``train`` streams), both export the same scalars, and both skip
the same malformed lines and torn tails."""

import json
import os

import pytest

tb = pytest.importorskip("tensorboard")

from tgtc.tools.jsonl2tb import export_dir as jax_export_dir
from tgtc_torch.tools.jsonl2tb import export_dir, main


def _write_jsonl(path, rows):
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")


def _written_order(name):
    """An event file's (second, writer counter): ``events.out.tfevents.
    <time>.<host>.<pid>.<counter>``. TensorBoard reads a directory's files
    by name, so two files of one second whose counters cross a power of
    ten (``.7``, ``.10``) would read out of the order they were written."""
    parts = name.split(".")
    return int(parts[3]), int(parts[-1])


def _read_scalars(run_dir):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    out = {}
    names = [n for n in os.listdir(run_dir) if n.startswith("events.out.tfevents.")]
    for name in sorted(names, key=_written_order):
        acc = EventAccumulator(os.path.join(run_dir, name))
        acc.Reload()
        for tag in acc.Tags()["scalars"]:
            out.setdefault(tag, []).extend((e.step, e.value) for e in acc.Scalars(tag))
    return out


def _runs(out):
    return {r: _read_scalars(os.path.join(out, r)) for r in sorted(os.listdir(out))}


def _logdir(root):
    os.makedirs(root)
    _write_jsonl(os.path.join(root, "nerf.jsonl"),
                 [{"step": 50, "loss": 0.5, "psnr": 20.0, "steps_per_s": 80.5},
                  {"step": 100, "loss": 0.25, "psnr": 23.0, "steps_per_s": 81.25}])
    _write_jsonl(os.path.join(root, "style.jsonl"),
                 [{"step": 300, "coh_grad_ratio": 549.18},
                  {"step": 310, "loss_coh": 1.5, "loss_rgb": 0.03}])
    _write_jsonl(os.path.join(root, "train.jsonl"), [{"step": 300, "holdout_view": 2,
                                                      "psnr": 31.5}])
    with open(os.path.join(root, "temporal.jsonl"), "w") as f:
        f.write('{"step": 20, "loss_t": 1.0, "note": "ignored"}\n')
        f.write("not json\n")
        f.write('{"step": 40, "lo')  # a live run's torn tail
    return root


def test_exports_the_same_scalars_as_jax(tmp_path):
    ours, theirs = (_logdir(str(tmp_path / n)) for n in ("port", "jax"))
    written = export_dir(ours, os.path.join(ours, "tb"))
    assert written == jax_export_dir(theirs, os.path.join(theirs, "tb"))
    assert written == {"nerf": 6, "style": 3, "temporal": 1, "train": 2}
    assert _runs(os.path.join(ours, "tb")) == _runs(os.path.join(theirs, "tb"))
    # incremental: nothing new, then the torn line completes and exports
    assert export_dir(ours, os.path.join(ours, "tb")) == {
        "nerf": 0, "style": 0, "temporal": 0, "train": 0}
    for root in (ours, theirs):
        with open(os.path.join(root, "temporal.jsonl"), "a") as f:
            f.write('ss_t": 2.0}\n')
    assert export_dir(ours, os.path.join(ours, "tb"))["temporal"] == 1
    assert jax_export_dir(theirs, os.path.join(theirs, "tb"))["temporal"] == 1
    scalars = _read_scalars(os.path.join(ours, "tb", "temporal"))
    assert scalars["loss_t"] == [(20, 1.0), (40, 2.0)]
    assert scalars == _read_scalars(os.path.join(theirs, "tb", "temporal"))


def test_main_writes_under_logdir_tb(tmp_path, capsys):
    root = _logdir(str(tmp_path / "logs"))
    assert main([root]) == 0
    assert "wrote 12 scalars across 4 run(s)" in capsys.readouterr().out
    assert sorted(os.listdir(os.path.join(root, "tb"))) == ["nerf", "style", "temporal",
                                                             "train"]
