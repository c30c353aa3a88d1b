"""A cell of the benchmark at a size the CPU runs in seconds: the same
driver, traffic and checks, at tiny views, batches and sample counts, on
the program's plain twins of the kernels."""

from __future__ import annotations

import copy

from benchmark.harness import spec as S

CONFIG = {"H": 12, "W": 16, "focal": 12.0, "batch_size": 256, "batch_size_style": 256,
          "N_samples": 32, "N_samples_fine": 32, "style_num": 2}
TRAFFIC = {"block": 32, "sample_frames": 2, "sample_rays": 16, "fetch_every": 2}


def tiny_cell(name: str) -> S.Cell:
    cell = S.load_cell(name)
    cell.config = copy.deepcopy(cell.config)
    cell.config.update(CONFIG)
    cell.config["train_views"]["n_views"] = 3
    cell.config["render_path"]["n_views"] = 4
    traffic = cell.workload["traffic"]
    traffic.update({k: v for k, v in TRAFFIC.items() if k in traffic})
    return cell
