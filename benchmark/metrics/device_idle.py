"""device_idle: 1 - the union of device intervals over the traced window
(torch.profiler, a few requests after the measured window)."""


def read(run):
    if run.trace is None or run.device.type != "cuda" or run.trace["window_s"] <= 0:
        return None
    return 1.0 - run.trace["busy_s"] / run.trace["window_s"]
