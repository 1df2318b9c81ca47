"""DeepLabV3+/resnet50's plain reference (``reference/deeplabv3p.py``), its
configuration, its cell's check and the ``depthwise_roofline.train``
reader, on the CPU at 64².

The parametrised float32 cases of ``test_bench_reference.py`` take this
configuration too, at bounds set for resnet18 that this model does not
meet with the seeded weights: in eval mode its logits reach ~10^4 (the
seeded running statistics do not normalize the residual stream), so a
probability near 0.5 moves 1e-3 on float32 rounding; in a train step a
rounding of the input (3e-7) moves the first gradients by percents.  The
cases here hold the program to the reference at this model's own
scale: logits to 1e-5 of their largest, the train steps at the cell's
limits, which compare gradient norms (``grad_gap_median``) and not
gradient directions alone."""

from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import harness
from benchmark.counts import flops
from benchmark.counts.bytes import least_seconds
from benchmark.reference import train as ref_train
from benchmark.tests.conftest import configs, small_cell
from benchmark.tests.test_bench_faults import (
    plant_train_half_batch,
    plant_train_state_unchanged,
)

NAME = "deeplabv3p_r50"
CELL = "deeplabv3p_r50.train_b128"
SEED = 2 ** 31 + 91


def _cfg(tile=64, **kw):
    return dict(configs()[NAME], img_size=tile,
                reference=str(harness.ROOT / configs()[NAME]["reference"]),
                **kw)


@pytest.mark.parametrize("train", [False, True])
def test_forward_matches_the_program_in_float32(train):
    """The port's model and the plain one on one input and one seeded
    ``state_dict``: eval mode (running statistics), and train mode (batch
    statistics, the ASPP dropout drawn by each from one generator state)."""
    cfg = _cfg(compute_dtype="float32")
    sd = harness.weights(cfg, SEED, "cpu")
    _, model = harness.program_model(cfg, sd, "cpu")
    ref = harness.reference_model(cfg, sd, "cpu")
    model.train(train)
    ref.train(train)
    x = torch.randn(3, 3, 64, 64, generator=torch.Generator().manual_seed(4))
    g = torch.Generator().manual_seed(SEED)
    keep = ref.draw_dropout(3, torch.Generator().manual_seed(SEED), "cpu")
    with torch.no_grad():
        got = model(x, g if train else None)
        want = ref(x, keep if train else None)
    assert got.shape == want.shape == (3, 1, 64, 64)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def _plant_answer_altered(monkeypatch):
    """The logits shifted by 1 where the port's model produces them."""
    from pdac_pathological_image_segmentation_tpu_torch.models.deeplabv3plus import (  # noqa: E501
        DeepLabV3Plus,
    )

    forward = DeepLabV3Plus.forward
    monkeypatch.setattr(
        DeepLabV3Plus, "forward",
        lambda self, x, generator=None: forward(self, x, generator) + 1.0)


@pytest.mark.parametrize("plant", [None, plant_train_state_unchanged,
                                   plant_train_half_batch,
                                   _plant_answer_altered])
def test_train_faults(monkeypatch, plant):
    """The program's float32 steps pass the cell's limits; each planted
    fault fails them."""
    if plant is not None:
        plant(monkeypatch)
    cell = small_cell(CELL, seed=2 ** 32 + 19, dtype="float32")
    out = harness.driver(cell.traffic).run(cell)
    assert out.correct is (plant is None), out.checks
    assert [c[0] for c in out.checks] == list(cell.limits["limits"])


@pytest.mark.chip
def test_control_and_fault_fail_at_the_cells_size(card):
    """At 128 rows of 512² on a card, the program passes, and the step
    wholly in fp8 and the loss over half of each batch each fail the
    cell's limits (at the CPU's sizes the batch of 4 is too small for
    gradient norms to tell bf16 from fp8)."""
    cell = harness.cell(harness.benchmark(), CELL, 0, 0.0, False)
    tools = harness.load_module(harness.HERE / "tools" / "limits.py",
                                "bench_tools_limits")
    rows = {r["side"]: r for r in tools.train_readings(cell, 2 ** 31 + 103)}
    for side, fails in (("program", False), ("control_fp8", True),
                        ("fault_half_batch", True)):
        _, failed = harness.judge(cell.limits, [rows[side]])
        assert failed == int(fails), (side, rows[side])


def test_seeded_weights_load_strictly_into_the_program():
    cfg = _cfg()
    sd = harness.weights(cfg, SEED, "cpu")
    _, model = harness.program_model(cfg, sd, "cpu")
    got = model.state_dict()
    assert list(got) == list(sd)
    assert all(torch.equal(got[k], sd[k]) for k in sd)
    assert sum(t.numel() for k, t in sd.items()
               if "running" not in k and "num_batches" not in k) == 26677585


def test_draw_dropout_is_the_programs_mask():
    """The reference's draw and the port's ``Dropout`` from one generator
    state: the same mask, and the generator left in the same state."""
    from pdac_pathological_image_segmentation_tpu_torch.models.dropout import (
        Dropout,
    )

    cfg = _cfg()
    ref = harness.reference_model(cfg, harness.weights(cfg, SEED, "cpu"),
                                  "cpu")
    g_ref = torch.Generator().manual_seed(SEED)
    g_prog = torch.Generator().manual_seed(SEED)
    keep = ref.draw_dropout(3, g_ref, "cpu")
    assert keep.shape == (3, 256, 4, 4) and keep.dtype == torch.bool
    drop = Dropout(0.5).train()
    ones = torch.ones(3, 256, 4, 4)
    assert torch.equal(drop(ones, g_prog) != 0, keep)
    assert torch.equal(g_ref.get_state(), g_prog.get_state())
    assert 0.4 < float(keep.float().mean()) < 0.6


def _steps(checkpointed: bool):
    cell = small_cell(CELL, SEED)
    drv = harness.driver(cell.traffic)
    tr, cfg = cell.traffic, cell.config
    sd = harness.weights(cfg, SEED, "cpu")
    images, masks = drv.make_patches(tr, SEED, "cpu")
    feed = drv.Feed(tr, SEED, "cpu", images.shape[0])
    batches = drv.checked_batches(images, masks, [
        feed.next() for _ in range(tr["check_steps"])])
    model = harness.reference_model(cfg, sd, "cpu")
    model.checkpointed = checkpointed
    out = ref_train.run_steps(model, cfg, batches)
    return out, {k: b.clone() for k, b in model.named_buffers()}


def test_checkpointed_steps_are_bit_equal_to_plain_ones():
    """Checkpointing the train step changes no loss, first gradient,
    3-step change or BatchNorm buffer by a bit."""
    (a, buf_a), (b, buf_b) = _steps(True), _steps(False)
    assert a["losses"] == b["losses"]
    for key in ("grad1", "change"):
        assert all(torch.equal(a[key][k], b[key][k]) for k in b[key]), key
    assert all(torch.equal(buf_a[k], buf_b[k]) for k in buf_b)
    assert int(buf_a["encoder.bn1.num_batches_tracked"]) == 3


def test_forward_flops_are_the_programs_count():
    """73.12 GFLOP a 512² tile, counted alike over the reference and over
    the port's model; the backward counts both gradients of every
    convolution once (no recompute, the depthwise weight gradients at
    their size) but the stem's input gradient."""
    from pdac_pathological_image_segmentation_tpu_torch.models import (
        build_model,
    )

    cfg = _cfg(512, compute_dtype="float32")
    with torch.device("meta"):
        model = build_model(harness.program_config(cfg))
        x = torch.empty(1, 3, 512, 512)
    with FlopCounterMode(display=False) as count:
        model(x)
    fwd = flops.forward_flops(cfg, 512)
    assert fwd == count.get_total_flops() == 73122447360
    stem = 2 * 3 * 64 * 49 * 256 * 256
    assert flops.train_flops(cfg, 512) == 3 * fwd - stem


def _reader():
    return harness.load_module(
        harness.HERE / "metrics" / "depthwise_roofline.train.py",
        "bench_metric_depthwise_roofline_train")


DW_KERNELS = {
    "void at::native::(anonymous namespace)::conv_depthwise2d_forward_kernel"
    "<3, c10::BFloat16, int>(...)": 0.004,
    "void at::native::(anonymous namespace)::conv_depthwise2d_backward_kernel"
    "<3, 1, c10::BFloat16, int>(...)": 0.005,
    "void at::native::(anonymous namespace)::conv_depthwise2d_grad_weight_"
    "kernel<c10::BFloat16, float, int>(...)": 0.011,
    "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32": 0.5,
}


def test_depthwise_roofline_by_hand():
    """Five sites at 512²: three of 2048 channels and one of 256 at 32²,
    one of 304 at 128²: 11,534,336 elements a tile, 12 bytes each over
    the three passes; 2 steps of 128 patches over 20 ms of the kernels."""
    cfg = configs()[NAME]
    elems = 3 * 2048 * 32 ** 2 + 256 * 32 ** 2 + 304 * 128 ** 2
    assert elems == 11534336
    summary = {"work": {"patches": 256, "steps": 2}, "config": cfg,
               "kernels": DW_KERNELS}
    want = 100.0 * 12 * elems * 256 / 3.35e12 / 0.020
    assert _reader().read(summary) == pytest.approx(want, rel=1e-12)
    assert least_seconds(12 * elems * 256, 6 * 9 * elems * 256) \
        == 12 * elems * 256 / 3.35e12  # bytes bind


def test_depthwise_roofline_reads_nothing_without_its_sites_or_kernels():
    read = _reader().read
    summary = {"work": {"patches": 256, "steps": 2}, "kernels": DW_KERNELS}
    assert read(dict(summary, config=configs()["fpn_r18"])) is None
    other = {k: v for k, v in DW_KERNELS.items() if "depthwise" not in k}
    assert read(dict(summary, config=configs()[NAME],
                     kernels=other)) is None
