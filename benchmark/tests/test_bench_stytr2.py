"""The StyTr² cell (``stytr2.c1-train``) on the CPU: the attention kernels'
floors and the step's FLOP against hand counts, the benchmark's weights
against the program's modules, the driver built, stepped and checked at a
tiny size, and the new per-layer readers on fabricated traces."""

import copy
import json
import time

import pytest
import torch

from benchmark.drivers import stytr2_train as D
from benchmark.harness import attention_work as AW
from benchmark.harness import spec as S
from benchmark.harness.trace import Context, Event, Trace
from benchmark.run import judge, run_cell

SPEC = json.loads((S.ROOT / "BENCHMARK.json").read_text())
CELL = "stytr2.c1-train"
CONFIG = S.load_cell(CELL).config
ATTENTION = ("K6_roofline.train", "K7_roofline.train", "K8_roofline.train")
NEW = ATTENTION + ("launches_per_step.train",)
# the tiny cell: f32 (the program then runs K6-K8's plain twins, as on any
# CPU tensors), d_model 64, 2 heads, 1 + 1 + 1 layers, batch 2 of 32x32 crops
TINY = {"dtype": "float32", "d_model": 64, "nhead": 2, "num_encoder_layers": 1,
        "num_decoder_layers": 1, "dim_feedforward": 128, "batch_size": 2, "crop": 32,
        "resize": 48, "content_pool": {"n_views": 3, "H": 40, "W": 56},
        "style_pool": {"n_images": 2, "size": 48, "grid": 4}}


def tiny_cell():
    cell = S.load_cell(CELL)
    cell.config = copy.deepcopy(cell.config)
    cell.config.update(TINY)
    cell.config["decoder_convs"] = [[TINY["d_model"], 256]] + cell.config["decoder_convs"][1:]
    cell.workload["traffic"]["fetch_every"] = 2
    return cell


# ---------------------------------------------------------------- work


def test_attention_floors_at_c1_with_dropout():
    """8 images x 8 heads x 1,024^2 at D 64: the hash's 6 ALU operations an
    element (its 2 multiplies on the FMA pipe beside them) at 64 a clock on
    132 SMs at 1.98 GHz bind K6; K7's and K8's products bind them."""
    elems = 64 * 1024 * 1024
    assert (AW.HASH_ALU_OPS, AW.HASH_IMAD_OPS) == (6, 2)
    int32 = elems * 6 / (132 * 64 * 1.98e9)
    assert int32 == pytest.approx(2.4072e-5, rel=1e-4)
    for k, products in (("K6", 2), ("K7", 3), ("K8", 4)):
        f = AW.floors_s(k, 64, 1024, 1024, 64, True)
        assert f["tensor"] == pytest.approx(products * 2 * elems * 64 / 989e12)
        assert f["sfu"] == pytest.approx(elems / (132 * 16 * 1.98e9))
        assert f["int32"] == pytest.approx(int32)
        binding = "int32" if k == "K6" else "tensor"
        assert AW.bound_s(k, 64, 1024, 1024, 64, True) == f[binding]
    # the SFU and INT32 floors follow the clock they are given
    slow = AW.floors_s("K6", 64, 1024, 1024, 64, True, clock_hz=0.99e9)
    assert slow["int32"] == pytest.approx(2 * int32)
    # HBM: K8 reads q, k, v, dO (bf16), lse and delta (f32), writes dk, dv
    assert AW.io_bytes("K8", 64, 1024, 1024, 64) == 64 * (2 * 6 * 1024 * 64 + 4 * 2 * 1024)


def test_attention_floors_at_c3_without_dropout():
    """8 heads x 11,970^2 at D 64 (a 756x1008 view): K6's tensor floor,
    0.297 ms, above its SFU floor, 0.274 ms; no INT32 floor."""
    f = AW.floors_s("K6", 8, 11970, 11970, 64, False)
    assert f["tensor"] == pytest.approx(4 * 8 * 11970 ** 2 * 64 / 989e12)
    assert f["tensor"] == pytest.approx(0.2967e-3, rel=1e-3)
    assert f["sfu"] == pytest.approx(0.2742e-3, rel=1e-3)
    assert f["int32"] == 0.0
    assert AW.bound_s("K6", 8, 11970, 11970, 64, False) == f["tensor"]


def test_model_flop_by_hand():
    """Per image at 256x256 (1,024 tokens): the VGG to relu4_1 15.82 G
    multiply-adds, the CNN decoder 15.82 G, a patch embedding 100.7 M, the
    transformer calls (ics, icc, iss) from their layers' products."""
    n, d, f = 1024, 512, 2048
    vgg = (256 ** 2 * 3 * 3 + 256 ** 2 * 9 * (3 * 64 + 64 * 64) + 128 ** 2 * 9 * (64 * 128 + 128 * 128)
           + 64 ** 2 * 9 * (128 * 256 + 3 * 256 * 256) + 32 ** 2 * 9 * 256 * 512)
    dec = 9 * (32 ** 2 * 512 * 256 + 64 ** 2 * (3 * 256 * 256 + 256 * 128)
               + 128 ** 2 * (128 * 128 + 128 * 64) + 256 ** 2 * (64 * 64 + 64 * 3))
    assert vgg == D.vgg_macs(CONFIG, 256, 256) == 15_817_310_208
    assert dec == D.decoder_macs(CONFIG, 32, 32) == 15_816_720_384
    emb = n * 3 * 64 * d
    attn = n * 4 * d * d + 2 * n * n * d     # in- and out-projections, q kᵀ and p v
    enc = 3 * (attn + 2 * n * d * f)        # three layers without the fused projection
    dec_layers = 3 * (2 * attn + 2 * n * d * f)
    fused = {"ics": 5, "icc": 4, "iss": 6}    # qkv (3 d²) and qk (2 d²) a token, both encoders
    calls = {m: 2 * enc + dec_layers + 3 * k * n * d * d for m, k in fused.items()}
    for m, v in calls.items():
        assert D.transformer_macs(CONFIG, n, m) == v
    trans = sum(calls.values())
    per_image = (5 * vgg + trans + 6 * emb + 3 * dec) + (2 * trans + 6 * emb + 3 * dec + 3 * vgg)
    assert D.model_flop(CONFIG) == 2 * 8 * per_image
    assert D.model_flop(CONFIG) == pytest.approx(10.636e12, rel=1e-4)


def test_attention_launches_and_shape():
    assert D.attention_launches(CONFIG) == 36
    assert D.attention_launch(CONFIG) == (64, 1024, 1024, 64)


def test_weights_are_the_program_s_parameters():
    """The benchmark's state dict loads into the program's model, name for
    name and shape for shape, at the published widths."""
    from tgtc_torch.models.stytrans import make_stytrans
    from tgtc_torch.models.transformer import TransformerConfig

    model = make_stytrans(TransformerConfig(), torch.Generator().manual_seed(0), device="cpu")
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert {n: s for n, s, _ in D.shapes(CONFIG)} == want


# ---------------------------------------------------------------- the driver


def test_driver_builds_steps_and_checks():
    """The tiny cell in f32: the window's steps and losses, the program held
    correct under the cell's limits, the fp8 control and both faults not."""
    cell = tiny_cell()
    res = run_cell(cell, 2 ** 31 + 11, 0.3, False, "cpu", time.perf_counter(), extra=True)
    assert res["attempted"] >= 1 and res["metrics"]["train_steps_per_s"] > 0
    assert len(res["window"]["losses"]) == res["attempted"]
    limits = cell.workload["limits"]
    assert judge(res["readings"]["program"], limits)[1]
    for name in ("control", "half_batch", "mask_seed"):
        assert not judge(res["readings"][name], limits)[1], name


def test_feed_is_seeded_and_uint8():
    cell = tiny_cell()
    a = D.build(cell.config, cell.workload["traffic"], 5, "cpu")
    c0, s0 = a.feed(0)
    assert c0.dtype == torch.uint8 and c0.shape == (2, 32, 32, 3) and s0.shape == c0.shape
    assert torch.equal(a.feed(0)[0], c0) and not torch.equal(a.feed(1)[0], c0)
    assert a.k == 3  # set-up took the check's three steps


def test_sign_flips_count_only_the_attention_projections():
    """The share of flipped signs is over the elements of every
    ``in_proj_weight``, ``qkv`` and ``qk`` weight together; other leaves and
    exact zeros on both sides count nothing."""
    ref = {"grad0": {"a.self_attn.in_proj_weight": torch.ones(6, 2),
                     "a.qkv.weight": -torch.ones(6, 2), "a.qk.weight": torch.zeros(4, 2),
                     "a.linear1.weight": torch.ones(5),
                     "a.self_attn.in_proj_bias": torch.ones(6)}}
    cand = {"grad0": {k: v.clone() for k, v in ref["grad0"].items()}}
    assert D.sign_flips(cand, ref) == 0.0
    cand["grad0"]["a.self_attn.in_proj_weight"][0, :] = -1.0  # 2 flipped
    cand["grad0"]["a.qkv.weight"][1, 1] = 1.0  # 1 flipped
    cand["grad0"]["a.qk.weight"][0, 0] = 1e-9  # 1 flipped: 0 against positive
    cand["grad0"]["a.linear1.weight"][:] = -1.0  # not a projection
    cand["grad0"]["a.self_attn.in_proj_bias"][:] = -1.0  # nor a bias
    assert D.sign_flips(cand, ref) == pytest.approx(4 / 32)


def test_change_gap_no_key_bias_leaves_out_the_key_third():
    """A key bias moved by ~lr a step in the candidate and not at all in
    the reference is ``compare``'s whole ``change_gap`` and none of this
    one; a query bias moved so is in both."""
    from benchmark.reference import compare

    d = 4
    p0 = {"x.in_proj_bias": torch.zeros(3 * d), "x.linear1.weight": torch.zeros(8)}
    grads = {k: torch.ones_like(v) for k, v in p0.items()}
    ref = {"losses": [1.0], "grad0": grads, "params": {"x.in_proj_bias": torch.cat(
        [torch.full((d,), 1e-3), torch.zeros(d), torch.full((d,), 1e-3)]),
        "x.linear1.weight": torch.full((8,), 1e-3)}}
    cand = {"losses": [1.0], "grad0": grads,
            "params": {k: v.clone() for k, v in ref["params"].items()}}
    cand["params"]["x.in_proj_bias"][d: 2 * d] = 1e-3
    assert compare.train_readings(cand, ref, p0)["change_gap"] > 0.2
    assert D.change_gap_no_key_bias(cand, ref, p0) == pytest.approx(0.0, abs=1e-12)
    cand["params"]["x.in_proj_bias"][:d] = 2e-3
    assert D.change_gap_no_key_bias(cand, ref, p0) > 0.2


# ---------------------------------------------------------------- the readers


def ctx(device, work=None, units=2):
    tr = Trace(units, 1.0, device, [], {e.name: 1.0 for e in device})
    return Context(CONFIG, work or {}, 1.0, tr, [1.0])


FWD = "void (anonymous namespace)::flash_fwd_kernel<true>(CUtensorMap_st, ...)"


@pytest.mark.parametrize("name", ATTENTION)
def test_attention_readers_read_none_without_their_kernel(name):
    work = {"attention_s": {"K6": 1e-6, "K7": 1e-6, "K8": 1e-6}}
    assert S.metric_reader(name).read(ctx([Event("nerf_fwd_kernel", 0, 10)], work)) is None
    kernels = [Event(FWD, 0, 10), Event(FWD.replace("fwd", "bwd_dq"), 10, 20),
               Event(FWD.replace("fwd", "bwd_dkv"), 20, 30)]
    assert S.metric_reader(name).read(ctx(kernels)) is None  # a cell that runs none


def test_attention_readers_match_their_own_kernel():
    kernels = [Event(FWD, 0, 10), Event(FWD.replace("fwd", "bwd_dq"), 10, 30),
               Event(FWD.replace("fwd", "bwd_dkv"), 30, 70)]
    work = {"attention_s": {"K6": 2.5e-6, "K7": 2.5e-6, "K8": 2.5e-6}}  # a unit
    got = [S.metric_reader(n).read(ctx(kernels, work)) for n in ATTENTION]
    # device time a unit: 5, 10 and 20 µs over 2 units
    assert got == pytest.approx([50.0, 25.0, 12.5])


def test_launches_per_step():
    reader = S.metric_reader("launches_per_step.train")
    assert reader.read(ctx([])) is None
    ops = [Event("a", 0, 1), Event("b", 1, 2), Event("a", 2, 3), Event("b", 3, 4),
           Event("c", 4, 5)]
    c = ctx(ops)
    c.trace.scale["c"] = 2.0  # recorded once in 2 units: counted once a unit
    assert reader.read(c) == pytest.approx(3.0)


@pytest.mark.parametrize("name", NEW)
def test_each_new_metric_has_its_entry(name):
    entry = {m["name"]: m for m in SPEC["per_layer"]}[name]
    layers = {m["layer"] for m in SPEC["per_layer"] if m["name"] not in NEW}
    assert entry["layer"] in layers and entry["moves"] == "train_steps_per_s"
    moved = {m["name"]: m for m in SPEC["end_to_end"]}["train_steps_per_s"]
    assert CELL in entry["workloads"] and set(entry["workloads"]) <= set(moved["workloads"])
    assert entry["source"] == "device_trace"


@pytest.mark.cuda
def test_traced_tiny_cell_on_the_card():
    """On the card at d_model 128 and 2 heads (the kernels' head width 64),
    bf16: the traced path, each new metric read, the shares at most 100%."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell = tiny_cell()
    cell.config.update({"dtype": "bfloat16", "d_model": 128})
    cell.config["decoder_convs"][0] = [128, 256]
    res = run_cell(cell, 2 ** 31 + 17, 0.5, True, "cuda", time.perf_counter())
    assert set(NEW) <= set(res["metrics"])
    for k in ATTENTION + ("mfu.train",):
        assert 0 < res["metrics"][k] <= 100, (k, res["metrics"][k])
