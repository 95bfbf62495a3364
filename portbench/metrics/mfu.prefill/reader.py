"""mfu.prefill: the prefill step's share of the bf16 peak: the FLOPs of
the prefills of the waves that started in the window (portbench/flops.py,
each served prompt with its last logits) over the engine's prefill_s of
those waves, in percent."""
from portbench import flops
from portbench.check import reference
from portbench.stats import window_waves


def read(rec):
    waves = window_waves(rec)
    if not waves:
        return None
    s, _ = reference(rec["config"])
    work = sum(flops.prefill_flops(s, w["active"][0], w["prompt_len"])
               for w in waves)
    return 100.0 * work / (sum(w["prefill_s"] for w in waves)
                           * flops.PEAKS["bf16_flops"])
