"""mfu: the FLOPs of the work served inside the window (portbench/flops.py:
each wave's prefill at its token read, each decode step's active tokens
at theirs) over the window's seconds times the bf16 peak, in percent."""
from portbench import flops
from portbench.check import reference
from portbench.stats import in_window


def read(rec):
    s, _ = reference(rec["config"])
    total = 0
    for w in rec["window"]["waves"]:
        p = w["prompt_len"]
        for k, (t, active) in enumerate(zip(w["token_times"], w["active"])):
            if not in_window(rec, t):
                break
            total += (flops.prefill_flops(s, active, p) if k == 0
                      else active * flops.decode_flops(s, p + k - 1))
    return 100.0 * total / (rec["window"]["seconds"]
                            * flops.PEAKS["bf16_flops"])
