"""Device timings and the card's peak, copied from the repository's
``bench_torch.py`` (``queued_ms``'s cold branch, its spin kernel and
flush buffer, and its HBM table).

A kernel's L2-cold time: before each launch a 256 MB buffer (over 5x the
50 MB L2) is written and read, every launch sits between its own CUDA
events, and all of them queue behind a spin kernel that must outlast the
host's enqueueing, so the host's time does not count.  The median over
the launches is returned.
"""

from __future__ import annotations

import numpy as np
import torch

# the card's HBM rate by torch.cuda.get_device_name; an unknown card raises
HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,  # H100 SXM5, NVIDIA H100 Tensor Core GPU data sheet
}
FLUSH_BYTES = 256 << 20
HEAT_FLUSHES = 50  # buffer writes before a cold timing bring the clocks up
COLD_ITERS = 20


def hbm_bytes_per_s(name: str) -> float:
    """The card's HBM rate in bytes/s; raises for a card not in the table."""
    if name not in HBM_BYTES_PER_S:
        raise ValueError(f"no HBM rate for device {name!r}; known: {sorted(HBM_BYTES_PER_S)}")
    return HBM_BYTES_PER_S[name]


def _spin(ms: float) -> torch.cuda.Event:
    """Launch a spin kernel of about ``ms`` and return an event recorded
    after it (the spin's cycles per ms are measured first)."""
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(1000)
    start.record()
    torch.cuda._sleep(20_000_000)
    stop.record()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(ms * 20_000_000 / start.elapsed_time(stop)))
    done = torch.cuda.Event()
    done.record()
    return done


def cold_ms(fn, *, iters: int = COLD_ITERS, cover_ms: float = 20.0) -> float:
    """L2-cold device time of one ``fn()`` in ms on the current card (see
    module docstring); raises when the host's enqueueing outlasts the
    spin (a host read in ``fn``)."""
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    fn()
    for _ in range(HEAT_FLUSHES):
        flush.fill_(0.0)
        flush.sum()
    torch.cuda.synchronize()
    spin_done = _spin(cover_ms)
    pairs = []
    for i in range(iters):
        flush.fill_(float(i))
        flush.sum()
        pair = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        pair[0].record()
        fn()
        pair[1].record()
        pairs.append(pair)
    covered = not spin_done.query()
    torch.cuda.synchronize()
    if not covered:
        raise RuntimeError(f"the host's enqueueing outlasted the {cover_ms:.1f} ms spin: "
                           "the timed call reads the host")
    return float(np.median([a.elapsed_time(b) for a, b in pairs]))
