"""The profiled-replay launch check (``bench.replay_launches``) and the
trace-based launch count (``bench.trace_kernel_launches``), on the CPU with
the profiler's record faked.

A CUDA graph replays what its capture recorded, so the check re-profiles
the replay when the profiler records too few launches (up to three
attempts), fails at once on too many, and fails when no attempt records the
capture's count.
"""

import pytest
from torch.autograd import DeviceType

from simpletuner_tpu_torch.bench import LAUNCH_CHECK_ATTEMPTS, replay_launches, trace_kernel_launches

CAPTURED = {"flash_fwd": 112, "flash_bwd_dq": 56, "flash_bwd_dkv": 56, "int_mm": 1069}
BUCKETS = {"flash_fwd": "flash_fwd", "flash_bwd_dq": "flash_bwd_dq", "flash_bwd_dkv": "flash_bwd_dkv",
           "int_mm": "int8_gemm"}


class _Profiler:
    """Each call gives the next recorded count (as bucket launches) and counts the replays it ran."""

    def __init__(self, *records):
        self.records = list(records)
        self.calls = 0

    def __call__(self, step):
        step()
        self.calls += 1
        fwd, dq, dkv, int_mm = self.records.pop(0)
        return {"bucket_launches": {"flash_fwd": fwd, "flash_bwd_dq": dq, "flash_bwd_dkv": dkv, "int8_gemm": int_mm,
                                    "other": 7}, "device_ms": 1.0}


def _check(profiler):
    replays = []
    result = replay_launches(lambda: replays.append(1), CAPTURED, BUCKETS, profile=profiler)
    return result, replays


@pytest.mark.parametrize("records, attempts", [
    ([(112, 56, 56, 1069)], 1),
    ([(108, 56, 56, 1069), (112, 56, 56, 1069)], 2),  # PR 16's dropped forward events, then exact
    ([(112, 56, 56, 1068), (111, 56, 56, 1069), (112, 56, 56, 1069)], 3),  # 1,068 of 1,069 int8 products
])
def test_too_few_then_exact_passes(records, attempts):
    """An attempt that records exactly the capture's launches passes; every
    attempt's counts are kept, and no replay runs after the exact one."""
    profiler = _Profiler(*records)
    result, replays = _check(profiler)
    assert profiler.calls == len(replays) == attempts and result["device_ms"] == 1.0
    assert result["launch_attempts"][-1] == CAPTURED and len(result["launch_attempts"]) == attempts
    assert result["launch_attempts"][0] == dict(zip(BUCKETS, records[0]))


@pytest.mark.parametrize("records", [
    [(113, 56, 56, 1069)],
    [(108, 56, 56, 1069), (112, 57, 56, 1069)],
])
def test_too_many_fails_at_once(records):
    """An attempt that records more launches than the capture fails there, with no further attempt."""
    profiler = _Profiler(*records, (112, 56, 56, 1069))
    with pytest.raises(RuntimeError, match="more launches than the capture"):
        _check(profiler)
    assert profiler.calls == len(records)


def test_too_few_every_time_fails():
    """Three attempts that each record too few fail, naming every attempt's counts."""
    assert LAUNCH_CHECK_ATTEMPTS == 3
    profiler = _Profiler((108, 56, 56, 1069), (112, 55, 56, 1069), (112, 56, 56, 1068), (112, 56, 56, 1069))
    with pytest.raises(RuntimeError, match="no profiled replay recorded the capture's launches in 3 attempts") as info:
        _check(profiler)
    assert profiler.calls == 3 and "108" in str(info.value) and "1068" in str(info.value)


class _Event:
    def __init__(self, name, device):
        self._name, self._device = name, device

    def name(self):
        return self._name

    def device_type(self):
        return self._device


class _Trace:
    def __init__(self, events):
        self.profiler = type("P", (), {"kineto_results": type("R", (), {"events": lambda _self: events})()})()


def test_trace_kernel_launches_reads_the_device_records_by_name():
    """The trace's device-side records are counted by their kernel's name
    into the buckets (the host-side launch calls are not counted)."""
    events = [_Event("void flash_fwd_kernel<128, true>(Params)", DeviceType.CUDA),
              _Event("void flash_fwd_kernel<128, true>(Params)", DeviceType.CUDA),
              _Event("flash_bwd_dq_kernel<64, false>", DeviceType.CUDA),
              _Event("cudaLaunchKernel", DeviceType.CPU), _Event("flash_fwd_kernel<128, true>", DeviceType.CPU),
              _Event("sm90_xmma_gemm_s8s8_bf16", DeviceType.CUDA), _Event("nvjet_tst_bf16", DeviceType.CUDA),
              _Event("vectorized_elementwise_kernel", DeviceType.CUDA)]
    counts = trace_kernel_launches(_Trace(events))
    assert counts == {"flash_fwd": 2, "flash_bwd_dq": 1, "flash_bwd_dkv": 0, "int8_gemm": 1, "conv": 0,
                      "bf16_gemm": 1, "other": 1}
