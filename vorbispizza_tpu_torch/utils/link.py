"""Device->host link rate, for the dpack wire's rice choice.

Port of vorbispizza_tpu/utils/link.py. The rice mode trades device work
for fewer wire bytes, which pays only on thin links;
``config.s16_rice="auto"`` turns it on below ``s16_rice_threshold_mbps``
of measured device->host rate. ``d2h_rate_estimate`` measures that rate
once per process and device with a timed pull of an incompressible int16
tensor into pinned memory (the way the corpus pulls its wire).

Unlike the reference, a probe that fails raises: caching a failed probe as
0.0 bytes/s would force rice on a fast link for the whole process.
"""

from __future__ import annotations

import threading
import time

import torch

#: probe size: 2 Mi int16 values (4 MiB), as in the reference
PROBE_VALUES = 2 << 20

_lock = threading.Lock()
_cached: dict = {}


def d2h_rate_estimate(device="cpu", force: float | None = None) -> float:
    """Measured device->host rate of ``device`` in bytes/s, cached per
    process and device; +inf for the CPU (host == device). ``force`` sets
    the cached value for ``device`` (tests)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key = str(dev)
    with _lock:
        if force is not None:
            _cached[key] = float(force)
            return _cached[key]
        if key in _cached:
            return _cached[key]
        if dev.type == "cpu":
            _cached[key] = float("inf")
            return _cached[key]
        # int16 wrapping multiply of random values: every byte stays
        # random, so a link that compresses in flight cannot inflate it
        gen = torch.Generator(device="cpu").manual_seed(0)
        x = torch.randint(-30000, 30000, (PROBE_VALUES,), generator=gen,
                          dtype=torch.int16).to(dev)
        y = x * 31337 + 77
        host = torch.empty(y.shape, dtype=y.dtype, pin_memory=True)
        # x and y were made on the current stream: wait for it alone, so a
        # probe from the corpus's dispatch thread leaves other streams be
        torch.cuda.current_stream(dev).synchronize()
        t0 = time.perf_counter()
        host.copy_(y)
        dt = time.perf_counter() - t0
        if dt <= 0:
            raise RuntimeError("d2h probe measured no time")
        _cached[key] = y.numel() * y.element_size() / dt
        return _cached[key]
