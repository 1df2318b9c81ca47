"""The trace summary and the readers on made-up events."""

from __future__ import annotations

import pytest
import torch

from benchmark import harness, trace
from benchmark.tests.conftest import configs

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class Event:
    def __init__(self, name, start, dur, device=CPU, annotation=False,
                 thread=1):
        self._v = (name, start, dur, device, annotation, thread)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return self._v[3]

    def is_user_annotation(self):
        return self._v[4]

    def start_thread_id(self):
        return self._v[5]


def test_busy_is_the_union_and_gaps_are_labelled():
    s = 1_000_000_000
    events = [
        Event(trace.WINDOW, 0, 10 * s, annotation=True),
        Event("slide.run", 0, 8 * s, annotation=True),
        Event("aten::copy_", 6 * s, 2 * s),
        Event("aten::copy_", 1 * s, s // 2, thread=2),  # another thread
        Event("k1", 1 * s, 3 * s, CUDA),
        Event("k2", 2 * s, 3 * s, CUDA),  # overlaps k1: counted once
        Event("k1", 7 * s, 1 * s, CUDA),
        Event("slide.run", 5 * s, s, CUDA, annotation=True),  # not an op
    ]
    got = trace.summarize(events)
    assert got["window_s"] == 10.0 and got["busy_s"] == 5.0
    assert got["kernels"] == {"k1": 4.0, "k2": 3.0}
    assert got["breakdown"]["device_ops"] == [["k1", 4.0], ["k2", 3.0]]
    # gaps [0, 1], [5, 7] and [8, 10], labelled at their midpoints
    assert got["breakdown"]["idle_gaps"] == [
        ["slide.run > aten::copy_", 2.0],
        ["outside spans > python", 2.0],
        ["slide.run > python", 1.0]]


def _reader(name):
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py",
                               "r_" + name.replace(".", "_"))


def test_readers_read_their_work_and_nothing_else():
    fpn = configs()["fpn_r18"]
    slide = {"tile": 512, "precision": "bf16"}
    summary = {"window_s": 10.0, "busy_s": 6.0, "config": fpn,
               "traffic": slide,
               "kernels": {"void gn_fwd_cluster_kernel<bf16>(...)": 0.5,
                           "cudnn conv": 5.5},
               "work": {"windows": 25281, "batches": 206}}
    assert _reader("idle_share.slide").read(summary) == pytest.approx(40.0)
    mfu = 100 * 25281 * 35.513171968e9 / 10.0 / 989e12
    assert _reader("mfu.slide").read(summary) == pytest.approx(mfu)
    assert 0 < _reader("gn_roofline.slide").read(summary) < 100
    # a train window's summary has nothing for the slide readers, and a
    # window without the kernel gives no roofline
    train = dict(summary, work={"patches": 128, "steps": 1},
                 traffic={"tile": 512}, kernels={"cudnn conv": 1.0})
    assert _reader("idle_share.slide").read(train) is None
    assert _reader("mfu.slide").read(train) is None
    assert _reader("augment_roofline.train").read(train) is None
    assert _reader("gn_roofline.train").read(
        dict(train, config=configs()["resunet_r18"])) is None
