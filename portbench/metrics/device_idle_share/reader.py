"""device_idle_share: the share of the traced span (one steady wave's
reads, prefill and first decode steps) in which no operation ran on the
device, in percent."""


def read(rec):
    tr = rec.get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
