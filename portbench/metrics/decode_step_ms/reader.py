"""decode_step_ms: the engine's decode_s over its decode steps, in the
waves that started in the window."""
from portbench.stats import window_waves


def read(rec):
    waves = window_waves(rec)
    steps = sum(w["steps"] for w in waves)
    return 1e3 * sum(w["decode_s"] for w in waves) / steps if steps else None
