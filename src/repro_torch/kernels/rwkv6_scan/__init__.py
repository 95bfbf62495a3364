from repro_torch.kernels.rwkv6_scan.ops import *  # noqa: F401,F403
