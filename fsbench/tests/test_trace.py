"""The trace reduction on synthetic profiler events."""

from __future__ import annotations

import pytest
import torch

from fsbench.trace import DeviceTrace

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class Event:
    def __init__(self, name, start_us, end_us, device=CPU,
                 annotation=False):
        self._n, self._a, self._b = name, start_us * 1000, end_us * 1000
        self._d, self._ann = device, annotation

    def name(self):
        return self._n

    def start_ns(self):
        return self._a

    def end_ns(self):
        return self._b

    def device_type(self):
        return self._d

    def is_user_annotation(self):
        return self._ann


class Fake(DeviceTrace):
    def __init__(self, events):
        super().__init__("cell/window")
        self._events = events

    def events(self):
        return self._events


def test_busy_gaps_and_names():
    ev = [Event("cell/window", 0, 1000),
          Event("cell/call", 0, 1000),
          Event("api/run_stack", 100, 400),
          Event("aten::item", 300, 400),
          Event("api/run_experiment/csv", 500, 1000),
          # device: two overlapping kernels, a copy, and the call's
          # device-side annotation range, which is no operation
          Event("k1", 100, 200, CUDA), Event("k1", 150, 300, CUDA),
          Event("Memcpy DtoH", 400, 450, CUDA),
          Event("cell/call", 100, 450, CUDA, annotation=True),
          Event("k2", 1200, 1300, CUDA)]       # after the window
    t = Fake(ev).summary(host_spans=("cell/call", "api/"))
    assert t["window_s"] == pytest.approx(1e-3)
    assert t["busy_s"] == pytest.approx(250e-6)     # 100-300, 400-450
    assert t["kernels"] == pytest.approx({"k1": 250e-6,
                                          "Memcpy DtoH": 50e-6})
    assert t["device_ops"][0][0] == "k1"
    gaps = sorted((round(s * 1e6), n) for n, s in t["idle_gaps"])
    assert gaps == [(100, "api/run_stack > aten::item"),   # 300-400
                    (100, "cell/call"),                     # 0-100
                    (550, "api/run_experiment/csv")]        # 450-1000


def test_no_device_activity_reads_nothing():
    assert Fake([Event("cell/window", 0, 10)]).summary() is None
