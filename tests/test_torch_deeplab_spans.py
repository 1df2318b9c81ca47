"""The spans of the port's DeepLabV3+ (``models/deeplabv3plus.py``,
``utils/profiling.py::span``) under the CPU profiler, on a small model at
64² (resnet18 and resnet50 encoders, float32):

* one forward opens ``deeplab.aspp`` and ``deeplab.decoder`` once each,
  the ASPP's before the decoder's and neither inside the other, in eval
  mode and in train mode (batch statistics, the ASPP dropout drawn from
  the step's generator);
* the logits are bit-equal with and without a profiler running;
* with no profiler, ``span`` returns the one shared no-op context.
"""

import contextlib

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pdac_pathological_image_segmentation_tpu_torch.models.deeplabv3plus import (
    DeepLabV3Plus,
)
from pdac_pathological_image_segmentation_tpu_torch.utils import profiling

SPANS = ("deeplab.aspp", "deeplab.decoder")


def _model(backbone):
    torch.manual_seed(5)
    return DeepLabV3Plus(output_size=64, backbone=backbone)


def _forward(model, x, train):
    model.train(train)
    generator = torch.Generator().manual_seed(11) if train else None
    with torch.no_grad():
        return model(x, generator)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("backbone", ["resnet18", "resnet50"])
def test_one_forward_opens_each_span_once(backbone, train):
    model = _model(backbone)
    x = torch.randn(2, 3, 64, 64, generator=torch.Generator().manual_seed(3))
    plain = _forward(model, x, train)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = _forward(model, x, train)
    assert torch.equal(traced, plain)
    spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                   for e in prof.profiler.kineto_results.events()
                   if e.name() in SPANS)
    assert [name for *_, name in spans] == list(SPANS)
    (_, aspp_end, _), (decoder_start, _, _) = spans
    assert aspp_end <= decoder_start


def test_span_is_the_shared_no_op_without_a_profiler():
    assert not torch.autograd.profiler._is_profiler_enabled
    off = profiling.span("deeplab.aspp")
    assert isinstance(off, contextlib.nullcontext)
    assert off is profiling.span("deeplab.decoder")
