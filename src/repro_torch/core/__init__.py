"""ROS2 core: the paper's contribution as a composable package.

Control plane (sessions/namespace/rkeys), data plane (RDMA zero-copy vs
TCP two-copy), DAOS-style object store + DFS, SmartNIC offload runtime,
device-direct placement, and the calibrated MVA performance model —
ported to PyTorch: EC parity runs on the rs_matmul CUDA kernel and
device-direct placement lands tensors in GPU memory.
"""
from repro_torch.core.client import ROS2Client, media_image       # noqa: F401
from repro_torch.core.control_plane import ControlPlane           # noqa: F401
from repro_torch.core.data_plane import (                         # noqa: F401
    AccessError, MemoryRegistry, RDMATransport, TCPTransport)
from repro_torch.core.device_direct import DeviceDirectSink       # noqa: F401
from repro_torch.core.dfs import DFSClient, DFSMeta               # noqa: F401
from repro_torch.core.metadata_cache import MetadataCache         # noqa: F401
from repro_torch.core.object_store import (                       # noqa: F401
    MediaScrubber, ObjectStore, VerifiedExtentCache)
from repro_torch.core.smartnic import DPURuntime, InlineCrypto    # noqa: F401
