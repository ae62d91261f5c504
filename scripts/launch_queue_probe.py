"""How many kernel launches queue on the card behind a spin kernel before
the host blocks: why ``bench_torch.py`` times a 600k W-cycle (1,065
device operations) by a profiler trace and not by CUDA events behind a
spin, and checks that the spin outlasts the enqueueing where it does.

For each count, a 2 s spin is launched, then that many tiny kernels; the
line reports the host's enqueueing seconds and whether the spin had
already ended when the host was done (true: the host blocked on a full
queue).

    python3 scripts/launch_queue_probe.py        # needs one CUDA card
"""

import json
import time

import torch


def main() -> dict:
    x = torch.zeros(1024, device="cuda")
    for _ in range(10):
        x.add_(1.0)
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(100_000_000)
    stop.record()
    torch.cuda.synchronize()
    cycles_per_ms = 1e8 / start.elapsed_time(stop)
    out = {"device": torch.cuda.get_device_name(0), "torch": torch.__version__}
    for n in (500, 1000, 2000, 4000, 8000, 16000):
        torch.cuda.synchronize()
        torch.cuda._sleep(int(2000 * cycles_per_ms))
        done = torch.cuda.Event()
        done.record()
        t0 = time.perf_counter()
        for _ in range(n):
            x.add_(1.0)
        out[n] = {"enqueue_s": time.perf_counter() - t0, "spin_ended_first": done.query()}
        torch.cuda.synchronize()
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
