from repro_torch.kernels.stream_cipher.ops import *  # noqa: F401,F403
