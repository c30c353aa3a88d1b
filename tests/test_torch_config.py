"""The run configuration on the CPU: tgtc_torch.config against tgtc.config.

* Every ``configs/*.txt`` parses to the same dict and loads to the same
  ``Config`` fields (and the same ``exp_dir``) on both sides.
* The same CLI overrides (a number, a string, a bare flag) over a config
  file give the same fields; an unknown file key is dropped on both.
* The port's ``Config`` has JAX's field names, types and defaults.
"""

import dataclasses
import glob
import os

import pytest

from tgtc import config as jc
from tgtc_torch import config as tc

CONFIGS = sorted(glob.glob(os.path.join(os.path.dirname(__file__), "..", "configs", "*.txt")))


def test_fields_and_defaults_match_jax():
    got = [(f.name, f.type, f.default) for f in dataclasses.fields(tc.Config)]
    want = [(f.name, f.type, f.default) for f in dataclasses.fields(jc.Config)]
    assert got == want


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_config_files_parse_like_jax(path):
    assert tc.parse_config_file(path) == jc.parse_config_file(path)
    got, want = tc.load_config(["--config", path]), jc.load_config(["--config", path])
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.exp_dir == want.exp_dir


def test_cli_overrides_match_jax(tmp_path):
    path = tmp_path / "run.txt"
    path.write_text("expname = t  # a comment\nN_samples = 32\nuse_viewdir\nnot_a_field = 3\n"
                    "loss_coh_lambda = 1e2\n")
    argv = ["--config", str(path), "--N_samples", "16", "--expname", "u", "--no_ndc",
            "--lrate", "1e-3", "--total_step", "1.2e5", "--train_fine_budget", "80@10"]
    got, want = tc.load_config(argv), jc.load_config(argv)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.N_samples, got.expname, got.no_ndc, got.use_viewdir, got.total_step) == (
        16, "u", True, True, 120000)
    assert tc.load_config([]) == tc.Config()
