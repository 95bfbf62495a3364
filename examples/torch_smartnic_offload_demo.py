"""SmartNIC-offload walkthrough on the PyTorch port: everything the
paper's Fig. 2 promises, demonstrated against the functional system, with
the device-direct tensors landing on the CUDA card.

    PYTHONPATH=src python examples/torch_smartnic_offload_demo.py [--device cpu]

The counterpart of `examples/smartnic_offload_demo.py`:

1. host vs DPU client, TCP vs RDMA: modeled throughput/IOPS (Fig. 5)
2. transport semantics: copies/byte, segmentation, rendezvous counters
3. multi-tenant isolation: scoped rkeys — cross-tenant/revoked/expired
   access is denied on the RDMA path
4. inline services: per-tenant encryption close to the NIC, transparent
   to the POSIX reader, ciphertext at rest
5. storage-failure drill: kill a device, reads survive via replicas,
   rebuild restores replication
6. device-direct placement (GPUDirect analogue): tensor bytes land in a
   registered pinned ring, one DMA to the card
"""
import argparse

import numpy as np

from repro_torch.core.client import ROS2Client
from repro_torch.core.data_plane import AccessError, RDMATransport
from repro_torch.core.device_direct import DeviceDirectSink
from repro_torch.core.sim import GiB, KiB, MiB
from repro_torch.distributed.fault import FailureInjector


def section(title):
    print(f"\n=== {title} ===")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="the CUDA card by default, or cpu")
    device = ap.parse_args(argv).device

    section("1. modeled end-to-end performance (paper Fig. 5)")
    for mode in ("host", "dpu"):
        for transport in ("tcp", "rdma"):
            c = ROS2Client(mode=mode, transport=transport, n_devices=4,
                           device=device)
            bw = c.model_throughput(MiB, write=False, jobs=16) / GiB
            io = c.model_iops(4 * KiB, write=False, jobs=16) / 1e3
            print(f"  {mode:4s}/{transport:4s}: 1MiB read {bw:5.1f} GiB/s   "
                  f"4KiB read {io:6.0f} kIOPS")
            c.close()
    print("  -> DPU+RDMA == host; DPU+TCP collapses (RX path)")

    section("2. transport semantics (counted, not claimed)")
    c = ROS2Client(mode="dpu", transport="rdma", device=device)
    fd = c.open("/demo", create=True)
    payload = np.random.default_rng(0).integers(
        0, 256, 4 * MiB, dtype=np.uint8).tobytes()
    c.pwrite(fd, payload, 0)
    assert c.pread(fd, len(payload), 0) == payload
    s = c.io.stats
    print(f"  RDMA: {s.copy_bytes / s.bytes_moved:.2f} copies/byte, "
          f"{s.rendezvous} rendezvous transfers, "
          f"{s.control_msgs} control msgs")
    t = ROS2Client(mode="dpu", transport="tcp", device=device)
    fd2 = t.open("/demo", create=True)
    t.pwrite(fd2, payload, 0)
    t.pread(fd2, len(payload), 0)
    st = t.io.stats
    print(f"  TCP : {st.copy_bytes / st.bytes_moved:.2f} copies/byte, "
          f"{st.segments} MTU segments")
    t.close()

    section("3. multi-tenant isolation (rkey capability model)")
    reg = c.server_registry
    mr = reg.register(4096, "tenantA")
    rk = reg.grant(mr, "r", ttl_s=3600)
    x = RDMATransport(c.client_registry, reg)
    dst = c.client_registry.register(4096, "tenantA")
    x.read(rk.token, "tenantA", 0, dst, 0, 128)
    print("  tenantA read with valid rkey: OK")
    for desc, fn in [
        ("cross-tenant read",
         lambda: x.read(rk.token, "tenantB", 0, dst, 0, 128)),
        ("write with r-only rkey",
         lambda: x.write(rk.token, "tenantA", 0, dst, 0, 128)),
    ]:
        try:
            fn()
            print(f"  {desc}: UNEXPECTEDLY ALLOWED")
        except AccessError as e:
            print(f"  {desc}: denied ({e})")
    reg.revoke(rk.token)
    try:
        x.read(rk.token, "tenantA", 0, dst, 0, 128)
    except AccessError as e:
        print(f"  revoked rkey: denied ({e})")

    section("4. inline encryption on the DPU data path")
    e = ROS2Client(mode="dpu", transport="rdma", inline_encryption=True,
                   device=device)
    fd3 = e.open("/secret", create=True)
    e.pwrite(fd3, b"attack at dawn" * 64, 0)
    readback = e.pread(fd3, 14, 0)
    for d in e.devices:               # land donated staging buffers first
        d.writeback()
    at_rest = any(b"attack at dawn" in blk for d in e.devices
                  for blk in d._blocks.values())
    print(f"  POSIX readback: {readback!r} (transparent)")
    print(f"  plaintext at rest on any SSD: {at_rest}")
    e.close()

    section("5. storage-failure drill")
    inj = FailureInjector(c.store)
    victim = c.devices[0].name
    inj.kill(victim)
    assert c.pread(fd, 1024, 0) == payload[:1024]
    print(f"  killed {victim}: reads served from replicas")
    moved = inj.rebuild(victim)
    print(f"  rebuild re-replicated {moved} extents onto survivors")

    section("6. device-direct placement (GPUDirect analogue)")
    arr = np.arange(8192, dtype=np.float32)
    fd4 = c.open("/tensor", create=True)
    c.pwrite(fd4, arr.tobytes(), 0)
    sink = DeviceDirectSink(c, slot_bytes=arr.nbytes)
    before = c.io.stats.copy_bytes
    dev_arr = sink.read_tensor(fd4, 0, arr.shape, np.float32)
    assert np.array_equal(dev_arr.cpu().numpy(), arr)
    print(f"  tensor on device: {tuple(dev_arr.shape)} "
          f"{str(dev_arr.dtype).removeprefix('torch.')}, "
          f"{c.io.stats.copy_bytes - before} bytes spliced "
          f"(== {arr.nbytes} payload bytes: zero-copy), "
          f"1 host->device DMA")
    print(f"  placed on {dev_arr.device}")
    sink.close()
    c.close()
    print("\nAll six properties demonstrated.")


if __name__ == "__main__":
    main()
