"""prefill_wave_ms: the engine's prefill_s over the waves that started in
the window, a wave."""
from portbench.stats import window_waves


def read(rec):
    waves = window_waves(rec)
    return 1e3 * sum(w["prefill_s"] for w in waves) / len(waves) \
        if waves else None
