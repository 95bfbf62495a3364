from repro_torch.kernels.rglru_scan.ops import *  # noqa: F401,F403
