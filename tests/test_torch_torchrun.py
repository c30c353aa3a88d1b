"""The port's multi-process launch through torchrun's own launcher on the CPU:
``python -m torch.distributed.run --standalone --nproc_per_node=2`` runs this
file as a script. Each rank joins through
``maybe_initialize_distributed(device="cpu")`` (which reads torchrun's
``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``) over gloo,
renders a narrow seeded frame with ``make_sharded_fused_render_fn`` (the
plain twins; 293 rays in blocks of 48, not a multiple of 2 x 48) and holds it
bit for bit against the same render in one process, then writes what it saw.
The launch has its own timeout, so a hung rank fails the test instead of
stalling the suite."""

import json
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
WORLD, TIMEOUT = 2, 120  # s
RAYS, BLOCK = 293, 48


def _render(group):
    from tgtc_torch.models.nerf import NerfConfig, make_nerf
    from tgtc_torch.ops.kernels.nerf_mlp import pack_nerf_params
    from tgtc_torch.render.fast import make_sharded_fused_render_fn
    from tgtc_torch.render.volume import RenderSettings

    gen = torch.Generator().manual_seed(4)
    cfg = dict(depth=2, width=16, embed_freq_coor=2, embed_freq_dir=1)
    packed = [pack_nerf_params(make_nerf(NerfConfig(**cfg), gen, device="cpu").state_dict(),
                               depth=2, num_freq_coor=2, num_freq_dir=1, width=16)
              for _ in range(2)]
    ro = torch.rand((RAYS, 3), generator=gen) * 2 - 1
    rd = torch.nn.functional.normalize(torch.randn((RAYS, 3), generator=gen), dim=-1)
    settings = RenderSettings(n_samples=4, n_samples_fine=4, sigma_noise_std=0.0)
    return make_sharded_fused_render_fn(settings, group, BLOCK)(*packed, ro, rd)


def main(out_dir: str) -> None:
    """One rank: join from torchrun's environment, render, compare, report."""
    import torch.distributed as dist

    from tgtc_torch.parallel import DataGroup, maybe_initialize_distributed

    torch.set_num_threads(1)
    assert maybe_initialize_distributed(device="cpu"), "torchrun's environment started no group"
    group = DataGroup.world_group()
    sharded, single = _render(group), _render(DataGroup())
    same = {k: bool(torch.equal(sharded[k], single[k])) for k in single}
    report = {"rank": group.rank, "world": group.world, "backend": dist.get_backend(),
              "rows": sharded["rgb"].shape[0], "same": same}
    with open(os.path.join(out_dir, f"rank{group.rank}.json"), "w") as f:
        json.dump(report, f)
    dist.destroy_process_group()


def test_torchrun_launches_the_sharded_render(tmp_path):
    env = {k: v for k, v in os.environ.items() if not k.startswith(("TGTC_", "MASTER_"))}
    env.update(GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([REPO, env.get("PYTHONPATH", "")]))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={WORLD}", os.path.abspath(__file__), str(tmp_path)]
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=TIMEOUT)
    assert proc.returncode == 0, (proc.stdout[-3000:], proc.stderr[-3000:])
    reports = [json.load(open(tmp_path / f"rank{r}.json")) for r in range(WORLD)]
    for r, rep in enumerate(reports):
        print(f"[parity] torchrun rank {r}: {rep}")
        assert rep["rank"] == r and rep["world"] == WORLD and rep["backend"] == "gloo"
        assert rep["rows"] == RAYS and rep["same"] and all(rep["same"].values())


if __name__ == "__main__":
    main(sys.argv[1])
