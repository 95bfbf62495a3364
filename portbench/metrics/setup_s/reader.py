"""setup_s: from the process's start to the window's start: imports, the
card, the weights, the store's fill, the kernels' build where it is not
cached, the captures and the warm-up wave."""


def read(rec):
    return rec["setup_s"]
