from repro_torch.kernels.fletcher.ops import *  # noqa: F401,F403
