"""tokens_per_s: new tokens the engine produced inside the window, each
counted at its step's token read, over the window's seconds."""
from portbench.stats import in_window


def read(rec):
    n = sum(a for w in rec["window"]["waves"]
            for t, a in zip(w["token_times"], w["active"])
            if in_window(rec, t))
    return n / rec["window"]["seconds"]
