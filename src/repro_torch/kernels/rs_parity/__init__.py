from repro_torch.kernels.rs_parity.ops import *  # noqa: F401,F403
