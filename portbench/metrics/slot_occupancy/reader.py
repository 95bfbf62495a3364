"""slot_occupancy: the engine's active_slot_steps over its slot_steps, in
the waves that started in the window, in percent."""
from portbench.stats import window_waves


def read(rec):
    waves = window_waves(rec)
    slots = sum(w["slot_steps"] for w in waves)
    return 100.0 * sum(w["active_slot_steps"] for w in waves) / slots \
        if slots else None
