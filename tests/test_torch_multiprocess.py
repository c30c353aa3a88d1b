"""The port's multi-process training (tgtc_torch.parallel over
torch.distributed) on the CPU: ONE spawn of 2 processes (gloo, a localhost
coordinator through ``TGTC_COORDINATOR``/``TGTC_NUM_PROCESSES``/
``TGTC_PROCESS_ID``, the launch environment the CLI reads) runs every proof,
as the JAX package's worker's ``all`` mode does
(tests/multihost_worker.py:190). :func:`worker` is what each process runs;
the workloads are shared with the 1-process side, which runs here on
``DataGroup()``, at the same global batch. The 2-process results must equal
the 1-process ones within rtol 1e-5, JAX's own tolerance for this proof
(tests/test_multihost.py): each step's loss, and each parameter leaf's
max |error| over its max |value| (floored at the learning rate, as
tests/test_torch_train.py floors it: a leaf Adam moved less than one step
from 0 has no scale of its own).

(a) The eager Phase-A step (D4/W32, batch 64 = 2 x 32, 8+8 samples, σ
    noise 1.0), 6 steps from JAX's initial weights with JAX's draws fed in;
    the 1-process side is also held to JAX's ``make_train_step`` over
    ``cpu_mesh8`` on the same weights and draws, to
    tests/test_torch_train.py's bounds (every step's loss to 1e-5, the
    trunks after 3 steps to 1e-5 of a leaf floored at the learning rate).
(b) The Phase-E step, 6 steps with the coherence term on (active at steps
    1, 2, 4 and 5 of the 3-frame cycle): the term is a norm over the whole
    batch, so a per-rank norm would fail here.
(c) The C1 step at dropout 0.1 (d_model 32, 2 heads, 1+1 layers, batch
    4 = 2 x 2 of 32² crops), through the plain attention with ``bh_offset``:
    both steps' losses, the first step's averaged gradients (each leaf), and
    the sum of the trained parameters after both steps (JAX's
    ``param_fingerprint``). The parameters are not held leaf by leaf, nor the
    second step's gradients: Adam divides each element by its own size, and
    the random VGG's max-pool near-ties (see tests/test_torch_c1.py) leave
    elements whose first gradient is f32 noise (the gradients agree to
    ~4e-7 of a leaf's largest), which then move by up to ±lr either way
    (measured 4.8e-2 of a leaf floored at 5e-4 after 2 steps, and 1.5e-4 of
    a leaf's largest in the second step's gradients).
(d) ``Pipeline.run()`` under the launch environment, on a tiny config:
    Phase A reaches ``origin_step``, rank 0 alone writes ``ckpt_nerf`` and
    the logs, the guidance line is in rank 0's output only; a second launch
    with the 2D artifacts in place (written here, copied in by rank 0
    between the launches) runs Phase E over both ranks, and rank 0 alone
    writes ``ckpt_style``.
(e) The sharded renders, at tests/test_pallas_kernel.py:147-180's narrow
    trunks (D2/W16, L 2/1, 4+4 samples, JAX's initial weights) on 293 rays
    in blocks of 48 (7 blocks, 4 + 3 over the ranks, the tail 5 rays: not a
    multiple of 2 x 48): ``make_sharded_fused_render_fn`` (the plain twins;
    also with σ-only coarse, ``fine_budget`` 6 and ``coarse_share`` 2),
    ``make_render_fn(group=)`` (eager f32 trunks) and
    ``make_stylized_render_fn(group=)`` (a narrow style field, jitter from a
    seeded generator) each equal their 1-process render bit for bit on both
    ranks; the 1-process fused render is within 1e-5 of JAX's
    ``make_sharded_fused_render_fn`` over ``cpu_mesh8`` (interpret mode) on
    the 256 rays JAX's test draws.
(f) ``train_transformer(group=)``: C1's loop at (c)'s network and dropout,
    2 steps of batch 4 (2 a rank) of 32² crops from two image directories,
    held to the 1-process loop at (c)'s bounds (each logged loss, the sum of
    the trained parameters); rank 0 alone writes the log, the collage and
    the checkpoints.
"""

import json
import os
import shutil
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
WORLD = 2
SPAWN_TIMEOUT = 300  # s: a hung rank fails the test instead of stalling the suite
RTOL = 1e-5
TOL_JAX_LOSS, TOL_JAX_STATE = 1e-5, 1e-5  # tests/test_torch_train.py's, after 3 steps

SMALL = dict(depth=4, width=32, embed_freq_coor=4, embed_freq_dir=2, skips=(2,))
TCFG = dict(batch_size=64, n_samples=8, n_samples_fine=8, sigma_noise_std=1.0)
A_STEPS, E_STEPS, C1_STEPS = 6, 6, 2
JAX_STEPS = 3  # Phase A's steps held to JAX (tests/test_torch_train.py's count)
PIPE = dict(expname="mp", factor=1.0, use_viewdir=True, netdepth=2, netwidth=32,
            netdepth_fine=2, netwidth_fine=32, embed_freq_coor=2, embed_freq_dir=1,
            N_samples=4, N_samples_fine=4, batch_size=128, batch_size_style=32,
            origin_step=20, total_step=25, style_D=4, vae_latent=8, vae_w=16, vae_d=2,
            style_feature_dim=64, i_print=10, sigma_noise_std=0.0, use_pallas=False)
GUIDANCE = "Run phases B-D single-process"
# (e): tests/test_pallas_kernel.py:147-180's trunks and samples; the port's rays
RENDER_CFG = dict(depth=2, width=16, embed_freq_coor=2, embed_freq_dir=1, use_viewdir=True)
RENDER_BLOCK, RENDER_RAYS, JAX_RAYS = 48, 293, 8 * 16 * 2
TOL_JAX_RENDER = 1e-5


# ---------------------------------------------------------------- workloads


def phase_a_workload(group, job):
    """``A_STEPS`` eager Phase-A steps from ``job``'s weights on its draws."""
    from tgtc_torch.models.nerf import NerfConfig
    from tgtc_torch.train import nerf_trainer as tt

    cfg = NerfConfig(compute_dtype=torch.float32, **SMALL)
    tc = tt.NerfTrainConfig(**TCFG)
    state = tt.init_state(torch.Generator().manual_seed(0), cfg, tc, device="cpu")
    state.coarse.load_state_dict(job["coarse"])
    state.fine.load_state_dict(job["fine"])
    step = tt.make_train_step(tc, device="cpu", group=group)
    losses, out = [], {}
    for draws in job["draws"]:
        state, m = step(state, job["ro"], job["rd"], job["rgb"], draws=draws)
        losses.append(float(group.mean_scalars({"loss": m["loss"]})["loss"]))
        if state.step == JAX_STEPS:
            out["jax_steps"] = _trunks(state.coarse.state_dict(), state.fine.state_dict())
    return {"loss": losses, **out, **_trunks(state.coarse.state_dict(), state.fine.state_dict())}


def _trunks(coarse, fine):
    return {"coarse": {k: v.clone() for k, v in coarse.items()},
            "fine": {k: v.clone() for k, v in fine.items()}}


def phase_e_workload(group):
    """``E_STEPS`` Phase-E steps on a seeded scene, trunks and state."""
    from tgtc_torch.data.style_dataset import synthetic_style_scene
    from tgtc_torch.models.nerf import NerfConfig, make_nerf
    from tgtc_torch.models.style_field import StyleFieldConfig
    from tgtc_torch.train import style3d as s3

    gen = torch.Generator().manual_seed(5)
    data = synthetic_style_scene(gen, 2, 3, 8, 8, device="cpu")
    trunks = [make_nerf(NerfConfig(depth=2, width=32), gen, device="cpu") for _ in range(2)]
    with torch.no_grad():
        for t in trunks:  # a density, as tests/test_torch_style3d.py raises it
            t.sigma_layer.bias += 2.0
    field = StyleFieldConfig(style_d=2, width=32, latent_dim=8, embed_dim=trunks[0].cfg.input_ch)
    scfg = s3.StyleTrainConfig(batch_size=16, n_samples=8, n_samples_fine=8, origin_step=0,
                               coh_until_step=1000, loss_coh_lambda=1e2)
    state = s3.init_style_state(gen, field, scfg, 2, 3, device="cpu", group=group)
    step = s3.make_style_train_step(*trunks, scfg, group)
    losses = []
    for _ in range(E_STEPS):
        state, m = step(state, data, seed=3)
        losses.append({k: float(v) for k, v in group.mean_scalars(m).items()})
    return {"loss": losses, "params": [p.detach().clone() for p in state.parameters()],
            "coh_x": group.gather_rows(state.coh_x)}


def c1_workload(group):
    """``C1_STEPS`` C1 steps of a narrow StyTrans at dropout 0.1."""
    from tgtc_torch.models.stytrans import make_stytrans
    from tgtc_torch.models.transformer import TransformerConfig
    from tgtc_torch.train import transformer2d as t2

    cfg = TransformerConfig(d_model=32, nhead=2, num_encoder_layers=1, num_decoder_layers=1,
                            dim_feedforward=32, dropout=0.1, attn_impl="flash")
    model = make_stytrans(cfg, torch.Generator().manual_seed(21), device="cpu")
    tcfg = t2.TransformerTrainConfig(batch_size=4, patch=32)
    state = t2.init_transformer_train(model, tcfg)
    step = t2.make_transformer_train_step(model, tcfg, group=group)
    rng = np.random.default_rng(24)
    losses, grads = [], []
    for _ in range(C1_STEPS):  # the step's own sequence, the averaged gradients kept
        content, style = (torch.from_numpy(rng.integers(0, 256, (4, 32, 32, 3), dtype=np.uint8))
                          for _ in range(2))
        m, g = step.loss_and_grad(model, content, style, step.generator(5, state.step))
        step.apply(state, g)
        state.step += 1
        losses.append(float(group.mean_scalars({"loss": m["loss"]})["loss"]))
        grads = grads or [x.clone() for x in g]
    params = [p.detach() for _, p in t2.trained_parameters(model)]
    return {"loss": losses, "grads": grads,
            "fingerprint": float(sum(p.double().sum() for p in params))}


def pipeline_workload(job, group):
    """Two launches of ``Pipeline.run()``; what each rank saw and wrote."""
    import tgtc_torch.train.checkpoint as ck
    from tgtc_torch.config import Config
    from tgtc_torch.train import pipeline as P

    writes = []
    original = ck.CheckpointManager._write

    def counted(self, step, state, ready=None):
        writes.append(f"{os.path.basename(self._dir)}/{step}")
        return original(self, step, state, ready)

    ck.CheckpointManager._write = counted
    out = {}
    try:
        for launch in ("A", "E"):
            if launch == "E":  # the 2D artifacts, as B-D single-process leave them
                group.barrier()
                if group.rank == 0:
                    shutil.copytree(job["artifacts"], job["root"], dirs_exist_ok=True)
                group.barrier()
            writes.clear()
            pipe = P.Pipeline(Config(**job["cfg"]), device="cpu")
            try:
                pipe.run()
            finally:
                pipe.close()
            out[launch] = {"nerf": pipe.nerf_ckpt.latest_step(),
                           "style": pipe.style_ckpt.latest_step(), "writes": list(writes)}
    finally:
        ck.CheckpointManager._write = original
    return out


def render_workload(group, job):
    """(e): the three renders, each through ``group``, on ``job``'s trunks and
    rays."""
    from tgtc_torch.models.nerf import NerfConfig, make_nerf
    from tgtc_torch.models.style_field import StyleFieldConfig, init_latents, make_style_mlps
    from tgtc_torch.ops.kernels.nerf_mlp import pack_nerf_params
    from tgtc_torch.render.fast import make_sharded_fused_render_fn
    from tgtc_torch.render.volume import RenderSettings
    from tgtc_torch.train.nerf_trainer import NerfTrainConfig, make_render_fn
    from tgtc_torch.train.render_style import make_stylized_render_fn

    ro, rd = job["ro"], job["rd"]
    settings = RenderSettings(n_samples=4, n_samples_fine=4, sigma_noise_std=0.0)
    c = RENDER_CFG
    pack = lambda sd: pack_nerf_params(sd, depth=c["depth"], num_freq_coor=c["embed_freq_coor"],
                                       num_freq_dir=c["embed_freq_dir"], width=c["width"])
    pc, pf = pack(job["coarse"]), pack(job["fine"])
    out = {"fused": make_sharded_fused_render_fn(settings, group, RENDER_BLOCK)(pc, pf, ro, rd),
           "fast": make_sharded_fused_render_fn(
               settings, group, RENDER_BLOCK, coarse_rgb=False, fine_budget=6,
               coarse_share=2)(pc, pf, ro, rd)}
    gen = torch.Generator().manual_seed(9)
    trunks = []
    for which in ("coarse", "fine"):
        t = make_nerf(NerfConfig(compute_dtype=torch.float32, **c), gen, device="cpu")
        t.load_state_dict(job[which])
        trunks.append(t)
    tc = NerfTrainConfig(n_samples=4, n_samples_fine=4)
    out["eager"] = make_render_fn(tc, group=group, block=RENDER_BLOCK)(*trunks, ro, rd)
    field = StyleFieldConfig(style_d=2, width=16, latent_dim=4, embed_dim=trunks[0].cfg.input_ch)
    concat, style = make_style_mlps(field, gen, device="cpu")
    latents = init_latents(gen, 1, 2, field.latent_dim, device="cpu")
    n = ro.shape[0]
    fn = make_stylized_render_fn(*trunks, concat, style, 4, 4, 0.0, 1.0, group=group,
                                 block=RENDER_BLOCK)
    out["stylized"] = fn(latents, ro, rd, torch.zeros(n, dtype=torch.long),
                         torch.arange(n) % 2, generator=torch.Generator().manual_seed(3))
    return out


def c1_loop_workload(group, job, name):
    """(f): ``train_transformer`` over ``group`` into ``job["root"]/name``;
    the logged lines and the sum of the trained parameters."""
    from tgtc_torch.models.stytrans import make_stytrans
    from tgtc_torch.models.transformer import TransformerConfig
    from tgtc_torch.train import transformer2d as t2
    from tgtc_torch.train.checkpoint import CheckpointManager

    cfg = TransformerConfig(d_model=32, nhead=2, num_encoder_layers=1, num_decoder_layers=1,
                            dim_feedforward=32, dropout=0.1, attn_impl="flash")
    model = make_stytrans(cfg, torch.Generator().manual_seed(21), device="cpu")
    tcfg = t2.TransformerTrainConfig(batch_size=4, patch=32, max_iter=C1_STEPS)
    state = t2.init_transformer_train(model, tcfg)
    root = os.path.join(job["root"], name)
    ckpt = CheckpointManager(os.path.join(root, "ckpt"))
    try:
        t2.train_transformer(state, tcfg, job["content"], job["style"], ckpt,
                             log_dir=os.path.join(root, "log"),
                             collage_dir=os.path.join(root, "collage"), print_interval=1,
                             save_interval=1, dropout_seed=5, data_seed=3, workers=1,
                             group=group)
    finally:
        ckpt.close()
    params = [p.detach() for _, p in t2.trained_parameters(model)]
    return {"fingerprint": float(sum(p.double().sum() for p in params)), "root": root}


def worker(job_path: str, out_path: str) -> None:
    """One rank of the spawn: join the group from the launch environment,
    run (a)-(d), save what it saw to ``out_path % rank``."""
    import torch.distributed as dist

    from tgtc_torch.parallel import DataGroup, maybe_initialize_distributed

    assert maybe_initialize_distributed(device="cpu"), "the environment did not start a group"
    assert not maybe_initialize_distributed(device="cpu")  # idempotent
    group = DataGroup.world_group()
    assert group.world == WORLD
    job = torch.load(job_path, weights_only=False)
    out = {"a": phase_a_workload(group, job["a"]), "b": phase_e_workload(group),
           "c": c1_workload(group), "d": pipeline_workload(job["d"], group),
           "e": render_workload(group, job["e"]), "f": c1_loop_workload(group, job["f"], "group")}
    torch.save(out, out_path % group.rank)
    print(f"[worker {group.rank}] done", flush=True)
    dist.destroy_process_group()


# ---------------------------------------------------------------- the spawn


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(job_path: str, out_path: str):
    """Both ranks of :func:`worker`; their outputs (stdout and stderr)."""
    port = _free_port()
    code = (f"import sys; sys.path[:0] = [{HERE!r}, {REPO!r}]; "
            f"import test_torch_multiprocess as t; t.worker({job_path!r}, {out_path!r})")
    procs = []
    for r in range(WORLD):
        env = dict(os.environ, TGTC_COORDINATOR=f"127.0.0.1:{port}",
                   TGTC_NUM_PROCESSES=str(WORLD), TGTC_PROCESS_ID=str(r),
                   GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen([sys.executable, "-c", code], cwd=REPO, env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=SPAWN_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(
        f"=== rank {r} ===\n{log[-4000:]}" for r, log in enumerate(logs))
    return logs


def _phase_a_job():
    """JAX's initial weights, its draws for ``A_STEPS`` steps and the rays;
    and JAX's own run over ``cpu_mesh8`` from them."""
    import jax
    import jax.numpy as jnp

    from tgtc.models.nerf import NerfConfig as JNerfConfig
    from tgtc.parallel import get_mesh
    from tgtc.train import nerf_trainer as jt
    from tgtc_torch.convert import nerf_state_dict_from_flax
    from test_torch_train import _jax_draws, _toy_rays

    j_tc = jt.NerfTrainConfig(**TCFG)
    cm, fm, j_state = jt.init_state(jax.random.PRNGKey(0),
                                    JNerfConfig(compute_dtype=jnp.float32, **SMALL), j_tc)
    sd = lambda p: nerf_state_dict_from_flax(jax.tree.map(np.asarray, p))
    ro, rd, rgb = _toy_rays()
    key = jax.random.PRNGKey(7)
    from tgtc_torch.train.nerf_trainer import NerfTrainConfig

    tc = NerfTrainConfig(**TCFG)
    job = {"coarse": sd(j_state.params_coarse), "fine": sd(j_state.params_fine),
           "draws": [_jax_draws(key, s, ro.shape[0], tc) for s in range(A_STEPS)],
           "ro": torch.from_numpy(ro), "rd": torch.from_numpy(rd), "rgb": torch.from_numpy(rgb)}
    step = jt.make_train_step(cm, fm, j_tc, mesh=get_mesh())
    losses = []
    for _ in range(A_STEPS):
        j_state, m = step(j_state, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(rgb), key)
        losses.append(float(m["loss"]))
        if int(j_state.step) == JAX_STEPS:
            trunks = {"coarse": sd(j_state.params_coarse), "fine": sd(j_state.params_fine)}
    return job, {"loss": losses, **trunks}


def _pipeline_job(root: str, scene: str, styles: str):
    """The tiny run configuration and, under ``root/artifacts`` in the run's
    layout, what phases B-D leave: the geometry dump's renders, one style's
    stylized frames with their npz, and a VAE checkpoint."""
    from PIL import Image

    from tgtc_torch.config import Config
    from tgtc_torch.data.llff import load_llff_data
    from tgtc_torch.models.vae import VaeConfig
    from tgtc_torch.train.checkpoint import CheckpointManager
    from tgtc_torch.train.vae_trainer import VaeTrainConfig, init_vae_train

    cfg = dict(PIPE, basedir=os.path.join(root, "logs"), datadir=scene, styledir=styles)
    c = Config(**cfg)
    art = os.path.join(root, "artifacts")
    at = lambda path: os.path.join(art, os.path.relpath(path, root))
    n = load_llff_data(scene, 1).images.shape[0]
    rng = np.random.default_rng(3)
    gen = at(os.path.join(c.exp_dir, "nerf_gen_data2"))
    style = os.path.join(scene, f"stylized_gen_{c.factor}", "style_00")
    os.makedirs(gen)
    os.makedirs(at(style))
    np.savez(os.path.join(gen, "geometry.npz"), cps=np.zeros((n, 3, 4), np.float32))
    for i in range(n):
        img = Image.fromarray(rng.integers(0, 255, (32, 40, 3), np.uint8))
        img.save(os.path.join(gen, f"rgb_{i:05d}.png"))
        img.save(os.path.join(at(style), f"{i + 1:03d}.jpg"))
    np.savez(os.path.join(os.path.dirname(at(style)), "stylized_data.npz"),
             style_paths=np.array([style]),
             style_features=rng.standard_normal((1, c.style_feature_dim)).astype(np.float32))
    _, vstate = init_vae_train(torch.Generator().manual_seed(5),
                               VaeConfig(data_dim=c.style_feature_dim, latent_dim=c.vae_latent,
                                         width=c.vae_w, depth=c.vae_d),
                               VaeTrainConfig(max_iter=3), device="cpu")
    vstate.step = 3
    mgr = CheckpointManager(at(os.path.join(c.exp_dir, "ckpt_vae")))
    mgr.save(3, vstate.state_dict())
    mgr.close()
    return {"cfg": cfg, "root": root, "artifacts": art}, c


def _render_job():
    """tests/test_pallas_kernel.py:147-180's trunks (JAX's initial weights)
    and rays, with ``RENDER_RAYS - JAX_RAYS`` more drawn from numpy; and
    JAX's ``make_sharded_fused_render_fn`` over ``cpu_mesh8`` on its rays."""
    import jax
    import jax.numpy as jnp

    from tgtc.models.nerf import NerfConfig as JNerfConfig
    from tgtc.ops.pallas.nerf_mlp import pack_nerf_params
    from tgtc.parallel import get_mesh
    from tgtc.render.fast import make_sharded_fused_render_fn
    from tgtc.render.volume import RenderSettings
    from tgtc.train.nerf_trainer import NerfTrainConfig, init_state
    from tgtc_torch.convert import nerf_state_dict_from_flax

    _, _, state = init_state(jax.random.PRNGKey(0), JNerfConfig(**RENDER_CFG), NerfTrainConfig())
    kw = dict(depth=2, num_freq_coor=2, num_freq_dir=1, width=16)
    pc, pf = (pack_nerf_params(p, **kw) for p in (state.params_coarse, state.params_fine))
    key = jax.random.PRNGKey(1)
    ro = jax.random.uniform(key, (JAX_RAYS, 3), minval=-1, maxval=1)
    rd = jax.random.normal(jax.random.fold_in(key, 1), (JAX_RAYS, 3))
    rd = rd / jnp.linalg.norm(rd, axis=-1, keepdims=True)
    settings = RenderSettings(n_samples=4, n_samples_fine=4, sigma_noise_std=0.0)
    want = make_sharded_fused_render_fn(settings, get_mesh(), tile=16, interpret=True, **kw)(
        *pc, *pf, ro, rd)
    rng = np.random.default_rng(11)
    extra_d = rng.standard_normal((RENDER_RAYS - JAX_RAYS, 3))
    extra_d /= np.linalg.norm(extra_d, axis=-1, keepdims=True)
    cat = lambda a, b: torch.from_numpy(np.concatenate([np.asarray(a), b]).astype(np.float32))
    job = {"ro": cat(ro, rng.uniform(-1, 1, (RENDER_RAYS - JAX_RAYS, 3))),
           "rd": cat(rd, extra_d),
           "coarse": nerf_state_dict_from_flax(jax.tree.map(np.asarray, state.params_coarse)),
           "fine": nerf_state_dict_from_flax(jax.tree.map(np.asarray, state.params_fine))}
    return job, {k: np.asarray(v) for k, v in want.items()}


def _c1_loop_job(root):
    """Two directories of seeded images for (f)."""
    from PIL import Image

    job = {"root": root}
    for name, seed in (("content", 12), ("style", 13)):
        d = os.path.join(root, f"c1_{name}")
        os.makedirs(d)
        rng = np.random.default_rng(seed)
        for i in range(3):
            Image.fromarray(rng.integers(0, 255, (40, 40, 3), np.uint8)).save(
                os.path.join(d, f"{i}.png"))
        job[name] = sorted(os.path.join(d, f) for f in os.listdir(d))
    return job


@pytest.fixture(scope="module")
def runs(tmp_path_factory, cpu_mesh8):
    """The spawn's per-rank outputs and logs, the 1-process results, JAX's."""
    from tgtc_torch.parallel import DataGroup
    from tests.synthetic_scene import make_synthetic_llff_scene

    root = str(tmp_path_factory.mktemp("multiprocess"))
    scene = make_synthetic_llff_scene(os.path.join(root, "scene"))
    styles = os.path.join(root, "styles")
    os.makedirs(styles)
    from PIL import Image

    Image.fromarray(np.random.default_rng(7).integers(0, 255, (64, 64, 3), np.uint8)).save(
        os.path.join(styles, "style0.png"))
    a_job, jax_a = _phase_a_job()
    d_job, cfg = _pipeline_job(root, scene, styles)
    e_job, jax_e = _render_job()
    f_job = _c1_loop_job(root)
    job_path = os.path.join(root, "job.pt")
    torch.save({"a": a_job, "d": d_job, "e": e_job, "f": f_job}, job_path)
    out_path = os.path.join(root, "rank%d.pt")
    logs = _spawn(job_path, out_path)
    ranks = [torch.load(out_path % r, weights_only=False) for r in range(WORLD)]
    one = DataGroup()
    single = {"a": phase_a_workload(one, a_job), "b": phase_e_workload(one),
              "c": c1_workload(one), "e": render_workload(one, e_job),
              "f": c1_loop_workload(one, f_job, "single")}
    return dict(ranks=ranks, logs=logs, single=single, jax_a=jax_a, jax_e=jax_e, cfg=cfg)


def _leaf_rel(got, want, floor):
    got, want = got.detach().double(), want.detach().double()
    return float((got - want).abs().max() / max(float(want.abs().max()), floor))


def _assert_close_runs(got, want, floor, tol, what):
    worst = 0.0
    for g, w in zip(got, want):
        worst = max(worst, _leaf_rel(g, w, floor))
    print(f"[parity] {what}: worst leaf max|err| / max|value| {worst:.3e} (tol {tol:g})")
    assert worst <= tol, (what, worst)


def _assert_losses(got, want, tol, what):
    rel = max(abs(g - w) / max(abs(w), 1e-30) for g, w in zip(got, want))
    print(f"[parity] {what}: worst loss relative error {rel:.3e} (tol {tol:g})")
    assert len(got) == len(want) and rel <= tol, (what, got, want)


def test_phase_a_two_processes_equal_one(runs):
    want = runs["single"]["a"]
    lr = 5e-4
    for r, out in enumerate(runs["ranks"]):
        got = out["a"]
        _assert_losses(got["loss"], want["loss"], RTOL, f"Phase A rank {r} loss")
        for which in ("coarse", "fine"):
            _assert_close_runs(list(got[which].values()), list(want[which].values()), lr, RTOL,
                               f"Phase A rank {r} {which} trunk after {A_STEPS} steps")


def test_phase_a_one_process_equals_jax_over_the_mesh(runs):
    got, want = runs["single"]["a"], runs["jax_a"]
    for g, w in zip(got["loss"], want["loss"]):
        assert abs(g - w) <= TOL_JAX_LOSS * max(1.0, abs(w)), (got["loss"], want["loss"])
    for which in ("coarse", "fine"):
        _assert_close_runs([got["jax_steps"][which][k] for k in want[which]],
                           list(want[which].values()), 5e-4, TOL_JAX_STATE,
                           f"Phase A 1-process {which} after {JAX_STEPS} steps vs JAX cpu_mesh8")


def test_phase_e_with_coherence_two_processes_equal_one(runs):
    want = runs["single"]["b"]
    coh = [s["loss_coh"] for s in want["loss"]]
    assert coh[0] == 0.0 and coh[3] == 0.0 and all(c > 0 for c in coh[1:3] + coh[4:])
    for r, out in enumerate(runs["ranks"]):
        got = out["b"]
        for k in ("loss", "loss_rgb", "loss_logp", "loss_coh"):
            _assert_losses([s[k] for s in got["loss"]], [s[k] for s in want["loss"]], RTOL,
                           f"Phase E rank {r} {k}")
        _assert_close_runs(got["params"], want["params"], 5e-4, RTOL,
                           f"Phase E rank {r} style MLPs and latents after {E_STEPS} steps")
        _assert_close_runs([got["coh_x"]], [want["coh_x"]], 1e-30, RTOL,
                           f"Phase E rank {r} coherence buffer")


def test_c1_with_dropout_two_processes_equal_one(runs):
    want = runs["single"]["c"]
    for r, out in enumerate(runs["ranks"]):
        got = out["c"]
        _assert_losses(got["loss"], want["loss"], RTOL, f"C1 rank {r} loss")
        _assert_close_runs(got["grads"], want["grads"], 1e-30, RTOL,
                           f"C1 rank {r} first step's averaged gradients")
        _assert_losses([got["fingerprint"]], [want["fingerprint"]], RTOL,
                       f"C1 rank {r} parameter sum after {C1_STEPS} steps")


def test_pipeline_writes_from_rank_zero_and_runs_e_when_the_2d_artifacts_exist(runs):
    cfg = runs["cfg"]
    (r0, r1), (log0, log1) = [out["d"] for out in runs["ranks"]], runs["logs"]
    for d in (r0, r1):  # both ranks read the shared directory
        assert d["A"]["nerf"] == cfg.origin_step and d["A"]["style"] is None
        assert d["E"]["nerf"] == cfg.origin_step and d["E"]["style"] == cfg.total_step
    assert r0["A"]["writes"] == [f"ckpt_nerf/{cfg.origin_step}"]
    assert r0["E"]["writes"] == [f"ckpt_style/{cfg.total_step}"]  # A skipped: nothing to do
    assert r1["A"]["writes"] == [] and r1["E"]["writes"] == []
    assert GUIDANCE in log0 and GUIDANCE not in log1
    assert "[ORIGIN TRAIN]" in log0 and "[ORIGIN TRAIN]" not in log1
    logs = os.path.join(cfg.exp_dir, "logs")
    nerf = [json.loads(line) for line in open(os.path.join(logs, "nerf.jsonl"))]
    assert [r["step"] for r in nerf] == [10, 20]  # one rank's lines
    style = [json.loads(line) for line in open(os.path.join(logs, "style.jsonl"))]
    assert [r["step"] for r in style] == [cfg.origin_step, cfg.total_step]
    assert "coh_grad_ratio" in style[0] and style[1]["steps_per_s"] > 0
    assert sorted(os.listdir(os.path.join(cfg.exp_dir, "ckpt_style"))) == [
        f"ckpt_{cfg.total_step:08d}.pt"]


@pytest.mark.parametrize("render", ["fused", "fast", "eager", "stylized"])
def test_sharded_render_two_processes_equal_one_bit_for_bit(runs, render):
    want = runs["single"]["e"][render]
    for r, out in enumerate(runs["ranks"]):
        got = out["e"][render]
        assert set(got) == set(want)
        for k, v in want.items():
            assert v.shape[0] == RENDER_RAYS and torch.equal(got[k], v), (render, r, k)
    print(f"[parity] sharded {render} render over {WORLD} processes ({RENDER_RAYS} rays in "
          f"blocks of {RENDER_BLOCK}): bit for bit on every rank, keys {sorted(want)}")


def test_one_process_fused_render_matches_jax_sharded_render(runs):
    got, want = runs["single"]["e"]["fused"], runs["jax_e"]
    assert set(got) == set(want)
    for k, v in want.items():
        err = float(np.abs(got[k][:JAX_RAYS].numpy() - v).max())
        print(f"[parity] fused render {k} vs JAX's make_sharded_fused_render_fn over "
              f"cpu_mesh8: max|err| {err:.3e} (tol {TOL_JAX_RENDER})")
        assert err <= TOL_JAX_RENDER, (k, err)


def test_grouped_c1_loop_equals_one_process_loop(runs):
    want = runs["single"]["f"]
    read = lambda root: [json.loads(line) for line in open(os.path.join(root, "log",
                                                                       "transformer.jsonl"))]
    want_lines = read(want["root"])
    root = runs["ranks"][0]["f"]["root"]
    assert runs["ranks"][1]["f"]["root"] == root
    got_lines = read(root)  # rank 0's alone: one line a step
    assert [g["step"] for g in got_lines] == [w["step"] for w in want_lines] == [1, 2]
    for k in ("loss", "loss_c", "loss_s", "l_id1", "l_id2"):
        _assert_losses([g[k] for g in got_lines], [w[k] for w in want_lines], RTOL,
                       f"grouped C1 loop {k}")
    for r, out in enumerate(runs["ranks"]):
        _assert_losses([out["f"]["fingerprint"]], [want["fingerprint"]], RTOL,
                       f"grouped C1 loop rank {r} parameter sum after {C1_STEPS} steps")
    assert sorted(os.listdir(os.path.join(root, "ckpt"))) == sorted(
        os.listdir(os.path.join(want["root"], "ckpt"))) == ["ckpt_00000001.pt",
                                                            "ckpt_00000002.pt"]
    assert os.listdir(os.path.join(root, "collage")) == [f"{C1_STEPS}.png"]
