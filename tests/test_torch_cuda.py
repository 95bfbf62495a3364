"""The port on the CUDA card: the hand-written kernels against their plain
versions, device-direct placement into GPU memory, the EC path's parity
legs through rs_matmul, a small model's prefill through
flash_attention_fwd and its train step through flash_attention_bwd, and
the RG-LRU and RWKV6 scans (rglru_scan forward and reverse, wkv6) with
the small hybrid and ssm models that serve through them, the storage
path's stream cipher and Fletcher checksum (bit-exact with their plain
versions, the inline crypto and the engine checksum), and the moe, vlm
and encdec families: the flash forward at head_dim 128 in the GQA groups
of dbrx and llama-3.2-vision, `moe_ffn` with drops and the float8
dispatch cast on the card against the CPU port; the scans' backward at
their train shapes (`rglru_scan` reversed at (4, 256, 2560), the
`wkv6_backward` op at (4, 256, 32, 64) against the same op on the CPU)
and the captured train steps of the tiny dense, hybrid and ssm models,
bit for bit their eager steps; the decode kernel (`flash_decode`) against
its plain version at both benchmark cells' shapes and dbrx-132b's, and a
captured decode step bit for bit its eager step; and the multi-device
layer on a one-rank NCCL group: the mesh's train step and `moe_ffn` bit
for bit their one-device counterparts.
Every test here needs a card and skips
without one; on the card run them with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports neither JAX nor the reference package, so it runs where
only PyTorch is installed.
"""
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from repro_torch.core import ROS2Client
from repro_torch.core.device_direct import DeviceDirectSink
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.flash_attention import kernel_bwd as FKB
from repro_torch.kernels.flash_attention import kernel_decode as FKD
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.flash_attention import ref as fref
from repro_torch.kernels.rs_parity import kernel as K
from repro_torch.kernels.rs_parity import ops
from repro_torch.kernels.rs_parity import ref
from repro_torch.kernels.rglru_scan import kernel as RK
from repro_torch.kernels.rglru_scan import ops as rops
from repro_torch.kernels.rglru_scan import ref as rref
from repro_torch.kernels.rwkv6_scan import kernel as WK
from repro_torch.kernels.rwkv6_scan import ops as wops
from repro_torch.kernels.rwkv6_scan import ref as wref
from repro_torch.kernels.fletcher import kernel as FLK
from repro_torch.kernels.fletcher import ops as flops
from repro_torch.kernels.fletcher import ref as flref
from repro_torch.kernels.stream_cipher import kernel as SCK
from repro_torch.kernels.stream_cipher import ops as scops
from repro_torch.kernels.stream_cipher import ref as scref

MiB = 1 << 20
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def test_kernel_matches_plain_version_on_card(cuda_device):
    """rs_matmul against its plain version and the numpy oracle: encode,
    decode, delta, ragged widths and an unaligned start."""
    rng = np.random.default_rng(5)
    cases = [(ref.cauchy_matrix(4, 2), 262144),
             (ref.cauchy_matrix(8, 3), 131072),
             (ref.decode_matrix(4, 2, [0, 1, 4, 5], [2, 3]), 4096),
             (np.ascontiguousarray(ref.cauchy_matrix(4, 2)[:, [1, 3]]), 1000),
             (rng.integers(0, 256, (11, 11), np.uint8), 333)]
    cases += [(ref.cauchy_matrix(4, 2), n) for n in (1, 15, 4097)]
    for mat, n in cases:
        x = torch.from_numpy(rng.integers(0, 256, (mat.shape[1], n),
                                          np.uint8)).to(cuda_device)
        got = K.rs_matmul(mat, x)
        torch.cuda.synchronize()
        assert torch.equal(got, ref.gf_matmul_torch(mat, x))
        np.testing.assert_array_equal(got.cpu().numpy(), ref.gf_matmul_np(
            mat, x.cpu().numpy()))
    flat = torch.from_numpy(rng.integers(0, 256, 1 + 4 * 4097,
                                         np.uint8)).to(cuda_device)
    x = flat[1:].view(4, 4097)
    assert x.data_ptr() % 16
    got = K.rs_matmul(ref.cauchy_matrix(4, 2), x)
    assert torch.equal(got, ref.gf_matmul_torch(ref.cauchy_matrix(4, 2), x))
    with pytest.raises(ValueError):
        K.rs_matmul(rng.integers(0, 256, (12, 4), np.uint8), x)
    with pytest.raises(ValueError):
        K.rs_matmul(ref.cauchy_matrix(4, 2), x.cpu())


@pytest.mark.parametrize("L", [4, 8, 12, 19, 16 * 64 + 3, 16 * 16384 + 3])
def test_kernel_word_edges_on_card(cuda_device, L):
    """The nibble-table kernel at whole-word and ragged widths (one word a
    thread), at m = s = 11 (121 coefficients, the most it takes) and at
    the ec(4,2) encode, from aligned rows and from views that start 1, 2
    and 3 bytes into a word, against the plain version and the oracle."""
    rng = np.random.default_rng(L)
    for mat in (rng.integers(0, 256, (11, 11), np.uint8),
                ref.cauchy_matrix(4, 2)):
        s = mat.shape[1]
        flat = torch.from_numpy(rng.integers(0, 256, 3 + s * L,
                                             np.uint8)).to(cuda_device)
        for start in (0, 1, 2, 3):
            x = flat[start:start + s * L].view(s, L)
            got = K.rs_matmul(mat, x)
            torch.cuda.synchronize()
            assert torch.equal(got, ref.gf_matmul_torch(mat, x)), (L, start)
            np.testing.assert_array_equal(got.cpu().numpy(), ref.gf_matmul_np(
                mat, x.cpu().numpy()))


def test_ops_count_launches_by_leg(cuda_device):
    cells = np.random.default_rng(6).integers(0, 256, (4, 4096), np.uint8)
    before = ops.launches()
    parity = ops.ec_encode(cells, 2)
    assert parity.device.type == "cuda"
    ops.ec_parity_delta(4, 2, [1], cells[1:2])
    ops.ec_decode(np.concatenate([cells[:3], parity[:1].cpu().numpy()]),
                  [0, 1, 2, 4], 4, 2)
    after = ops.launches()
    assert {leg: after[leg] - before[leg] for leg in after} \
        == {"encode": 1, "delta": 1, "decode": 1, "matmul": 0}


def test_concurrent_launches_are_all_counted(cuda_device):
    """The EC path launches from several pools at once: with more threads
    than cores and a short switch interval, every launch is counted and
    every result is right."""
    rng = np.random.default_rng(9)
    cells = [rng.integers(0, 256, (4, 4096), np.uint8) for _ in range(256)]
    before = ops.launches()["encode"]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with ThreadPoolExecutor(max_workers=2 * (os.cpu_count() or 4),
                                thread_name_prefix="rs-stress") as pool:
            outs = list(pool.map(lambda x: ops.ec_encode(x, 2), cells,
                                 timeout=120))
    finally:
        sys.setswitchinterval(old)
    torch.cuda.synchronize()
    for x, out in zip(cells, outs):
        np.testing.assert_array_equal(out.cpu().numpy(), ref.rs_encode_np(x, 2))
    assert ops.launches()["encode"] - before == len(cells)


def test_ec_path_runs_every_leg_through_the_kernel(cuda_device):
    """A small ec(4,2) run on the card: write, one-cell overwrite, degraded
    read, outage write, rebuild and scrub — bit-exact, with encode, delta
    and decode launches counted."""
    rng = np.random.default_rng(7)
    data = bytearray(rng.bytes(8 * MiB))
    c = ROS2Client(mode="host", transport="rdma", n_targets=8,
                   domains=["a", "a", "b", "b", "c", "c", "d", "d"],
                   ec=(4, 2), inline_encryption=True, scrub_interval_s=None)
    ops.reset_launches()
    try:
        fd = c.open("/f", create=True)
        c.pwrite(fd, bytes(data), 0)
        cell = rng.bytes(MiB // 4)
        c.pwrite(fd, cell, MiB + MiB // 4)
        data[MiB + MiB // 4:MiB // 2 + MiB] = cell
        c.cluster.fail_target(2)
        assert c.pread(fd, len(data), 0) == data
        out = rng.bytes(2 * MiB)
        c.pwrite(fd, out, 4 * MiB)
        data[4 * MiB:6 * MiB] = out
        c.cluster.recover_target(2)
        assert c.pread(fd, len(data), 0) == data
        scrub = c.scrubber.scrub_parity(64 * MiB)
        assert scrub["parity_checks"] > 0 and scrub["parity_mismatches"] == 0
        ec = c.io.data_path_counters()["ec"]
        assert ec["delta_writes"] >= 1 and ec["reconstructions"] > 0
        assert ec["rebuilt_cells"] > 0
    finally:
        c.close()
    n = ops.launches()
    assert n["encode"] > 0 and n["delta"] > 0 and n["decode"] > 0


def test_read_tensors_land_on_card(cuda_device):
    """Mixed dtypes packed back to back (misaligned starts included)
    placed from the pinned ring into GPU memory, byte for byte."""
    rng = np.random.default_rng(8)
    data = rng.bytes(3 * MiB)
    dtypes = [np.float32, np.float16, np.int32, np.int16, np.uint8]
    reqs = []
    for i in range(30):
        dt = np.dtype(dtypes[i % len(dtypes)])
        shape = tuple(int(x) for x in rng.integers(1, 40, 2))
        off = int(rng.integers(0, len(data) - 40 * 40 * 4))
        reqs.append((off, shape, dt))
    c = ROS2Client(mode="host", transport="rdma", scrub_interval_s=None)
    try:
        fd = c.open("/t", create=True)
        c.pwrite(fd, data, 0)
        with DeviceDirectSink(c, 64 << 10, n_slots=2) as sink:
            assert sink._host.is_pinned()
            out = sink.read_tensors([(fd, o, s, d) for o, s, d in reqs])
            one = sink.read_tensor(fd, *reqs[1])
        assert torch.equal(one.view(torch.uint8), out[1].view(torch.uint8))
        for (off, shape, dt), got in zip(reqs, out):
            assert got.device.type == "cuda"
            assert tuple(got.shape) == shape
            nbytes = int(np.prod(shape)) * dt.itemsize
            src = torch.frombuffer(bytearray(data[off:off + nbytes]),
                                   dtype=torch.uint8)
            assert torch.equal(got.reshape(-1).view(torch.uint8).cpu(), src)
    finally:
        c.close()


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,T,S,H,KH,D,causal,window,softcap,seq_k", [
    (2, 128, 128, 4, 2, 64, True, None, None, None),     # GQA
    (1, 100, 100, 4, 1, 128, True, None, None, None),    # MQA, ragged
    (1, 96, 96, 2, 2, 256, True, 32, None, None),        # window, head_dim 256
    (1, 64, 64, 2, 2, 64, False, None, 30.0, None),      # non-causal, softcap
    # the edges of the bf16 kernel's tiles (BQ = 128, BK = 128 or 64)
    (1, 17, 17, 2, 2, 64, True, None, None, None),       # below one tile
    (1, 17, 40, 2, 1, 128, False, None, None, None),     # T != S, both small
    (1, 127, 127, 4, 2, 64, True, None, None, None),
    (1, 129, 129, 4, 2, 128, True, None, None, None),
    (2, 200, 200, 4, 2, 64, True, None, None, None),
    (1, 200, 256, 4, 2, 64, True, 64, None, 230),        # seq_k < S, window
    (1, 150, 192, 2, 2, 128, True, 48, 30.0, 160),       # and softcap
    (1, 130, 130, 2, 2, 64, False, None, 20.0, 100),
    (1, 200, 200, 2, 1, 256, True, None, None, None),    # head_dim 256 ragged
    (1, 100, 100, 32, 1, 64, True, None, None, None),    # MQA, a group of 32
    (4, 1024, 1024, 32, 8, 64, True, None, None, None),  # the serve shape
])
def test_flash_kernel_matches_plain_version_on_card(
        cuda_device, B, T, S, H, KH, D, causal, window, softcap, seq_k, dtype,
        tol):
    """flash_attention_fwd's out and lse against attention_ref on the card,
    at the reference's tolerances (tests/test_kernels.py:56); where keys
    past seq_k are padding, through the kernel's wrapper, which takes it."""
    gen = torch.Generator(device=cuda_device).manual_seed(T + S + D)
    q, k, v = (torch.randn(B, n, h, D, generator=gen, device=cuda_device)
               .to(dtype) for n, h in ((T, H), (S, KH), (S, KH)))
    kw = dict(causal=causal, window=window, softcap=softcap)
    before = fops.launches()["fwd"]
    if seq_k is None:
        out, lse = fops.flash_attention(q, k, v, block_q=64, block_k=64,
                                        return_lse=True, **kw)
        assert fops.launches()["fwd"] == before + 1
    else:
        out, lse = FK.flash_attention_fwd(q, k, v, scale=D ** -0.5,
                                          seq_k=seq_k, **kw)
    want, want_lse = fref.attention_ref(q, k, v, return_lse=True,
                                        seq_k=seq_k, **kw)
    torch.cuda.synchronize()
    assert out.dtype == dtype and lse.dtype == torch.float32
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, want_lse, atol=tol, rtol=tol)


def test_flash_kernel_refuses_what_it_does_not_take(cuda_device):
    q = torch.randn(1, 64, 2, 64, device=cuda_device)
    with pytest.raises(ValueError):                     # head_dim 32
        FK.flash_attention_fwd(q[..., :32].contiguous(),
                               q[..., :32].contiguous(),
                               q[..., :32].contiguous(), scale=1.0)
    with pytest.raises(ValueError):                     # mixed dtypes
        FK.flash_attention_fwd(q, q.bfloat16(), q, scale=1.0)
    with pytest.raises(ValueError):                     # strided last dim
        t = torch.randn(1, 64, 2, 128, device=cuda_device)[..., ::2]
        FK.flash_attention_fwd(t, t, t, scale=1.0)
    # the backward kernel refuses the same, and rows that are not float32
    lse = torch.zeros(1, 2, 64, device=cuda_device)
    q32 = q[..., :32].contiguous()
    with pytest.raises(ValueError):                     # head_dim 32
        FKB.flash_attention_bwd(q32, q32, q32, q32, lse, lse, scale=1.0)
    with pytest.raises(ValueError):                     # mixed dtypes
        FKB.flash_attention_bwd(q, q, q, q.bfloat16(), lse, lse, scale=1.0)
    with pytest.raises(ValueError):                     # float16
        h = q.half()
        FKB.flash_attention_bwd(h, h, h, h, lse, lse, scale=1.0)
    with pytest.raises(ValueError):                     # bf16 lse
        FKB.flash_attention_bwd(q, q, q, q, lse.bfloat16(), lse, scale=1.0)


@pytest.mark.parametrize("T", [200, 1024])
@pytest.mark.parametrize("H,KH", [(48, 8), (64, 8)])
def test_flash_kernel_at_head_dim_128_in_groups_of_6_and_8(cuda_device, H,
                                                           KH, T):
    """dbrx's (48 heads over 8) and llama-3.2-vision's (64 over 8) prefill
    attention at head_dim 128, bf16 and causal, against the plain version
    at the reference's 2e-2; T = 1024 is their serve prompt."""
    gen = torch.Generator(device=cuda_device).manual_seed(H + T)
    q, k, v = (torch.randn(2, T, h, 128, generator=gen, device=cuda_device)
               .bfloat16() for h in (H, KH, KH))
    before = fops.launches()["fwd"]
    out, lse = fops.flash_attention(q, k, v, return_lse=True)
    assert fops.launches()["fwd"] == before + 1
    want, want_lse = fref.attention_ref(q, k, v, return_lse=True)
    torch.testing.assert_close(out.float(), want.float(), atol=2e-2,
                               rtol=2e-2)
    torch.testing.assert_close(lse, want_lse, atol=2e-2, rtol=2e-2)


def test_moe_ffn_on_card_matches_the_cpu_port_with_drops(cuda_device):
    """Float32, 8 experts top-2 with most tokens sent to expert 0, so the
    second level drops past cap2: the card's output equals the CPU's to
    1e-5, and no out-of-bounds scatter asserts on the device."""
    import dataclasses
    from repro_torch.configs import tiny_config
    from repro_torch.models import moe
    from repro_torch.models.context import single_device_ctx
    cfg = tiny_config("dbrx-132b")
    cfg = cfg.replace(moe=dataclasses.replace(
        cfg.moe, n_experts=8, dispatch_dtype="float32"))
    E, D, F = 8, cfg.d_model, cfg.moe.d_ff_expert
    gen = torch.Generator().manual_seed(0)
    x = 1.0 + 0.3 * torch.randn(2, 48, D, generator=gen)
    router = 0.05 * torch.randn(D, E, generator=gen)
    router[:, 0] += 0.5
    p = {"router": router,
         "experts": {k: torch.randn(E, *s, generator=gen) / 8 for k, s in
                     (("w_gate", (D, F)), ("w_up", (D, F)),
                      ("w_down", (F, D)))}}
    want = moe.moe_ffn(x, p, cfg, single_device_ctx(cfg, device="cpu"))
    on_card = {"router": router.cuda(),
               "experts": {k: w.cuda() for k, w in p["experts"].items()}}
    got = moe.moe_ffn(x.cuda(), on_card, cfg, single_device_ctx(cfg))
    torch.cuda.synchronize()
    assert (x @ router).argmax(-1).eq(0).float().mean() > 0.9
    torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=1e-5)


def test_fp8_dispatch_cast_on_card_is_the_cpu_one(cuda_device):
    """The reference's float8_e4m3fn rule (NaN above 464 and for ±inf,
    keeping the sign; saturation nowhere) gives the same bits on the card
    as on the CPU, from float32 and from bfloat16."""
    from repro_torch.models import moe
    edges = torch.tensor([448.0, -448.0, 463.99, 464.0, -464.0, 464.01,
                          -466.0, 480.0, 1e4, float("inf"), float("-inf"),
                          float("nan"), 0.0, -0.0, 2.0 ** -9, 2.0 ** -10,
                          1e-30])
    x = torch.cat([edges, 300 * torch.randn(
        1 << 16, generator=torch.Generator().manual_seed(1))])
    for src in (x, x.bfloat16()):
        cpu = moe.to_dispatch(src, torch.float8_e4m3fn).view(torch.uint8)
        card = moe.to_dispatch(src.cuda(), torch.float8_e4m3fn)
        assert torch.equal(card.view(torch.uint8).cpu(), cpu)
        assert torch.isnan(card[6:12].float()).all()


def test_small_model_prefill_through_the_kernel(cuda_device):
    """A float32 granite-shaped model (head_dim 64): prefill and loss with
    attn_impl="flash" launch the kernel once per layer and match the plain
    attention path to 1e-4 (tests/test_flash_integration.py)."""
    from repro_torch.configs import tiny_config
    from repro_torch.models.api import ModelAPI
    from repro_torch.models.context import single_device_ctx
    from repro_torch.models.params import init_params
    cfg = tiny_config("granite-3-2b").replace(head_dim=64)
    flash = ModelAPI(cfg.replace(attn_impl="flash"))
    plain = ModelAPI(cfg)
    mctx = single_device_ctx(cfg)
    params = init_params(flash.param_defs(),
                         torch.Generator(device=cuda_device).manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 64), dtype=np.int32))
    with torch.inference_mode():
        before = fops.launches()["fwd"]
        lf, cf = flash.prefill(params, {"tokens": toks}, mctx)
        assert fops.launches()["fwd"] - before == cfg.n_layers
        lp, cp = plain.prefill(params, {"tokens": toks}, mctx)
        batch = {"tokens": toks, "labels": toks}
        loss_f = float(flash.loss(params, batch, mctx))
        loss_p = float(plain.loss(params, batch, mctx))
    torch.testing.assert_close(lf, lp, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(cf["k"], cp["k"], atol=1e-4, rtol=1e-4)
    assert abs(loss_f - loss_p) <= 1e-4 * (1 + abs(loss_p))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4),
                                       (torch.bfloat16, 5e-2)])
@pytest.mark.parametrize("B,T,S,H,KH,D,window,seq_k", [
    (1, 128, 128, 4, 2, 64, None, None),       # GQA
    (2, 64, 64, 4, 1, 64, None, None),         # MQA
    (1, 128, 128, 2, 2, 64, 32, None),         # local window
    (1, 100, 100, 2, 2, 64, None, None),       # ragged T
    (1, 128, 128, 2, 2, 128, None, None),      # head_dim 128
    (2, 200, 200, 4, 2, 256, None, None),      # head_dim 256, ragged
    (4, 256, 256, 12, 4, 64, None, None),      # the train shape
    # the edges of the bf16 kernels' tiles (64 x 64, 32 x 64, 64 x 32)
    (1, 17, 17, 2, 2, 64, None, None),         # below one tile
    (1, 127, 127, 4, 2, 64, None, None),
    (1, 129, 129, 4, 2, 128, None, None),
    (1, 200, 256, 4, 2, 64, 64, 230),          # seq_k < S, window, T != S
    (1, 150, 192, 2, 2, 128, 48, 160),
    (1, 200, 200, 2, 1, 256, None, None),      # head_dim 256 ragged, MQA
    (1, 100, 100, 32, 1, 64, None, None),      # MQA, a group of 32
    (4, 1024, 1024, 32, 8, 64, None, None),    # the serve shape
])
def test_flash_bwd_kernel_matches_plain_version_on_card(
        cuda_device, B, T, S, H, KH, D, window, seq_k, dtype, tol):
    """flash_attention_bwd's dq, dk and dv against flash_attention_bwd_ref
    on the same out and lse, at the reference's backward tolerances
    (tests/test_kernels.py:303); where keys past seq_k are padding,
    through the kernel's wrapper, which takes it."""
    gen = torch.Generator(device=cuda_device).manual_seed(T + S + D + H)
    q, k, v, dout = (torch.randn(B, n, h, D, generator=gen,
                                 device=cuda_device).to(dtype)
                     for n, h in ((T, H), (S, KH), (S, KH), (T, H)))
    scale = D ** -0.5
    out, lse = FK.flash_attention_fwd(q, k, v, scale=scale, window=window,
                                      seq_k=seq_k)
    before = fops.launches()["bwd"]
    if seq_k is None:
        got = fops.flash_attention_backward(q, k, v, out, lse, dout,
                                            scale=scale, window=window)
        assert fops.launches()["bwd"] == before + 1
    else:
        delta = (dout.float() * out.float()).sum(-1).transpose(1, 2)
        got = FKB.flash_attention_bwd(q, k, v, dout, lse,
                                      delta.contiguous(), scale=scale,
                                      window=window, seq_k=seq_k)
    want = fref.flash_attention_bwd_ref(q, k, v, out, lse, dout,
                                        scale=scale, causal=True,
                                        window=window,
                                        seq_k=S if seq_k is None else seq_k)
    torch.cuda.synchronize()
    for g, w, x in zip(got, want, (q, k, v)):
        assert g.dtype == dtype and g.shape == x.shape
        torch.testing.assert_close(g.float(), w, atol=tol, rtol=tol)


def test_autograd_through_flash_attention_on_card(cuda_device):
    """Gradients through ops.flash_attention on the card (forward and
    backward kernels) equal autograd through the plain version; softcap
    takes its counted plain branch."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    for softcap in (None, 30.0):
        q, k, v, dout = (torch.randn(2, 96, h, 64, generator=gen,
                                     device=cuda_device) for h in (4, 2, 2, 4))
        qkv = [x.clone().requires_grad_() for x in (q, k, v)]
        before = fops.launches()
        out = fops.flash_attention(*qkv, softcap=softcap)
        got = torch.autograd.grad(out, qkv, dout)
        after = fops.launches()
        ref_qkv = [x.clone().requires_grad_() for x in (q, k, v)]
        want = torch.autograd.grad(fref.attention_ref(*ref_qkv,
                                                      softcap=softcap),
                                   ref_qkv, dout)
        assert after["fwd"] == before["fwd"] + 1
        key = "bwd" if softcap is None else "bwd_softcap"
        assert after[key] == before[key] + 1
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, atol=2e-4, rtol=2e-4)


def test_small_model_train_step_through_the_kernels(cuda_device):
    """One float32 train step of a granite-shaped model (head_dim 64):
    attn_impl "flash" launches the backward kernel once per layer and its
    loss and gradients match the plain attention path
    (tests/test_flash_integration.py: 1e-4, atol 2e-4 / rtol 2e-3)."""
    from repro_torch.common.config import TrainConfig
    from repro_torch.configs import tiny_config
    from repro_torch.models.api import ModelAPI
    from repro_torch.models.context import single_device_ctx
    from repro_torch.models.params import init_params, tree_leaves
    from repro_torch.train.optimizer import init_adam
    from repro_torch.train.trainer import make_train_step, value_and_grad
    cfg = tiny_config("granite-3-2b").replace(head_dim=64)
    mctx = single_device_ctx(cfg)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (4, 65), dtype=np.int32)).to(cuda_device)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    out = {}
    for impl in ("flash", "jnp"):
        api = ModelAPI(cfg.replace(attn_impl=impl))
        params = init_params(api.param_defs(),
                             torch.Generator(device=cuda_device).manual_seed(0))
        before = fops.launches()["bwd"]
        out[impl] = value_and_grad(api, params, batch, mctx)
        launched = fops.launches()["bwd"] - before
        assert launched == (cfg.n_layers if impl == "flash" else 0)
        step = make_train_step(api, TrainConfig(num_microbatches=2), mctx)
        _, opt, metrics = step(params, init_adam(params), batch)
        assert int(opt.step) == 1 and torch.isfinite(metrics["loss"])
    (lf, gf), (lj, gj) = out["flash"], out["jnp"]
    assert abs(float(lf) - float(lj)) <= 1e-4 * (1 + abs(float(lj)))
    for a, b in zip(tree_leaves(gf), tree_leaves(gj)):
        torch.testing.assert_close(a, b, atol=2e-4, rtol=2e-3)


def _scan_inputs(gen, B, T, R, dev):
    a = torch.sigmoid(2 * torch.randn(B, T, R, generator=gen, device=dev))
    return a, torch.randn(B, T, R, generator=gen, device=dev), torch.randn(
        B, R, generator=gen, device=dev)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("B,T,R", [(1, 64, 128), (2, 128, 256),
                                   (1, 100, 96), (3, 32, 512),
                                   (4, 1, 2560), (2, 1, 130), (2, 77, 1000)])
def test_rglru_kernel_matches_plain_version_on_card(
        cuda_device, B, T, R, with_h0, reverse):
    """rglru_scan against rglru_scan_ref to 1e-5 (tests/test_kernels.py:
    103-117): the reference's shapes, T = 1, ragged R, ± h0, both
    directions."""
    gen = torch.Generator(device=cuda_device).manual_seed(B * T + R)
    a, b, h0 = _scan_inputs(gen, B, T, R, cuda_device)
    h0 = h0 if with_h0 else None
    got = RK.rglru_scan(a, b, h0, reverse=reverse)
    want = rref.rglru_scan_ref(a, b, h0, reverse=reverse)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("T", [RK.WINDOW - 1, RK.WINDOW + 1, 4096])
def test_rglru_kernel_at_its_window_edges_on_card(cuda_device, T, reverse):
    """rglru_scan to 1e-5 of rglru_scan_ref at T around one window of the
    CTA's warps and at 4096 steps, with R = 2560 + 7 (B * R not a
    multiple of the CTA's 32 channels: CTAs straddle the batch rows and
    the last is part live) and h0; at 4096 a near 1 with b scaled by
    sqrt(1 - a^2), as the model feeds the scan, so carries cross many
    windows."""
    gen = torch.Generator(device=cuda_device).manual_seed(T)
    B, R = 2, 2560 + 7
    a, b, h0 = _scan_inputs(gen, B, T, R, cuda_device)
    if T == 4096:
        a = 1 - 1e-3 * torch.rand(B, T, R, generator=gen, device=cuda_device)
        b = b * torch.sqrt(1 - a * a)
    got = RK.rglru_scan(a, b, h0, reverse=reverse)
    want = rref.rglru_scan_ref(a, b, h0, reverse=reverse)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_rglru_backward_runs_the_kernel_in_reverse(cuda_device):
    """Gradients of sum(sin(h)) through the kernel's reverse mode against
    autograd through the plain version, to 1e-4 (tests/test_kernels.py:
    120-141); one fwd and one bwd launch."""
    gen = torch.Generator(device=cuda_device).manual_seed(13)
    ins = [x.requires_grad_() for x in _scan_inputs(gen, 2, 96, 200,
                                                    cuda_device)]
    ref_ins = [x.detach().clone().requires_grad_() for x in ins]
    before = rops.launches()
    torch.sin(rops.rglru_scan(*ins)).sum().backward()
    after = rops.launches()
    assert (after["fwd"] - before["fwd"], after["bwd"] - before["bwd"]) == (
        1, 1)
    torch.sin(rref.rglru_scan_ref(*ref_ins)).sum().backward()
    for x, y in zip(ins, ref_ins):
        torch.testing.assert_close(x.grad, y.grad, atol=1e-4, rtol=1e-4)


def test_rglru_backward_at_the_train_shape(cuda_device):
    """The backward at one microbatch of recurrentgemma-2b's train step
    (4, 256, 2560), a near 1 as the model's gates give it, without h0 as
    the model calls it: gradients of sum(h * w) for a random w through
    the kernel's reverse mode against autograd through the plain version,
    to 1e-4."""
    gen = torch.Generator(device=cuda_device).manual_seed(17)
    B, T, R = 4, 256, 2560
    a = (1 - 0.1 * torch.rand(B, T, R, generator=gen, device=cuda_device)
         ).requires_grad_()
    b = torch.randn(B, T, R, generator=gen, device=cuda_device
                    ).requires_grad_()
    w = torch.randn(B, T, R, generator=gen, device=cuda_device)
    ref_a, ref_b = (x.detach().clone().requires_grad_() for x in (a, b))
    before = rops.launches()
    (rops.rglru_scan(a, b) * w).sum().backward()
    after = rops.launches()
    assert (after["fwd"] - before["fwd"], after["bwd"] - before["bwd"]) == (
        1, 1)
    (rref.rglru_scan_ref(ref_a, ref_b) * w).sum().backward()
    for x, y in ((a, ref_a), (b, ref_b)):
        torch.testing.assert_close(x.grad, y.grad, atol=1e-4, rtol=1e-4)


def _wkv_inputs(gen, B, T, H, hd, dev):
    def n(*shape):
        return torch.randn(*shape, generator=gen, device=dev)
    w = torch.exp(-torch.exp(n(B, T, H, hd)))
    return (n(B, T, H, hd), 0.5 * n(B, T, H, hd), n(B, T, H, hd), w,
            0.5 * n(H, hd), 0.1 * n(B, H, hd, hd))


@pytest.mark.parametrize("B,T,H,hd", [
    (1, 64, 2, 32), (2, 96, 2, 64), (1, 33, 1, 64), (1, 128, 4, 64),
    (2, 1, 2, 64), (1, 37, 3, 16), (1, 70, 2, 128)])
def test_wkv6_kernel_matches_plain_version_on_card(cuda_device, B, T, H, hd):
    """wkv6 against the plain chunked and sequential versions to 3e-4
    (tests/test_kernels.py:152-167): the reference's shapes, T = 1,
    ragged T, head_dim 16 and 128."""
    gen = torch.Generator(device=cuda_device).manual_seed(T + hd)
    xs = _wkv_inputs(gen, B, T, H, hd, cuda_device)
    before = wops.launches()["fwd"]
    y, s = wops.wkv6(*xs)
    assert wops.launches()["fwd"] == before + 1
    yc, sc = wref.wkv_plain(*xs)
    ys, ss = wref.wkv_ref(*xs)
    torch.cuda.synchronize()
    for got, want in ((y, yc), (s, sc), (y, ys), (s, ss)):
        torch.testing.assert_close(got, want, atol=3e-4, rtol=3e-4)


def test_wkv6_wrapper_without_state_on_card(cuda_device):
    """With s0 None, as prefill calls it, the wrapper launches the kernel
    with no initial state (3e-4), and its gradients, autograd through the
    sequential version, match autograd through that version (1e-4)."""
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    xs = [x.requires_grad_()
          for x in _wkv_inputs(gen, 2, 40, 2, 32, cuda_device)[:5]]
    refs = [x.detach().clone().requires_grad_() for x in xs]
    before = wops.launches()["fwd"]
    y, s = wops.wkv6(*xs)
    assert wops.launches()["fwd"] == before + 1
    yr, sr = wref.wkv_ref(*refs)
    torch.testing.assert_close(y, yr, atol=3e-4, rtol=3e-4)
    torch.testing.assert_close(s, sr, atol=3e-4, rtol=3e-4)
    (torch.sin(y).sum() + s.square().sum()).backward()
    (torch.sin(yr).sum() + sr.square().sum()).backward()
    for x, r in zip(xs, refs):
        torch.testing.assert_close(x.grad, r.grad, atol=1e-4, rtol=1e-4)


def test_wkv6_kernel_strong_decay_stays_finite(cuda_device):
    """w = 1e-9 everywhere: finite, and within 1e-4 of the sequential
    version (tests/test_kernels.py:190-203)."""
    gen = torch.Generator(device=cuda_device).manual_seed(31)
    r, k, v = (torch.randn(1, 64, 1, 32, generator=gen, device=cuda_device)
               for _ in range(3))
    w = torch.full_like(r, 1e-9)
    u = torch.zeros(1, 32, device=cuda_device)
    y, s = WK.wkv6(r, k, v, w, u)
    yr, sr = wref.wkv_ref(r, k, v, w, u)
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    torch.testing.assert_close(y, yr, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(s, sr, atol=1e-4, rtol=1e-4)


def test_wkv6_kernel_mixed_strong_decay_over_many_chunks(cuda_device):
    """Seven chunks with half the channels at w = 1e-12 and half near 1:
    finite, and within 1e-4 of the sequential version. The strong
    channels' exponents underflow in the factored off-diagonal sub-block
    of every chunk."""
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    B, T, H, hd = 1, 200, 2, 64
    r, k, v = (torch.randn(B, T, H, hd, generator=gen, device=cuda_device)
               for _ in range(3))
    near = 0.9 + 0.1 * torch.rand(B, T, H, hd, generator=gen,
                                  device=cuda_device)
    w = torch.where(torch.arange(hd, device=cuda_device) < hd // 2,
                    torch.full_like(near, 1e-12), near)
    u = 0.5 * torch.randn(H, hd, generator=gen, device=cuda_device)
    y, s = WK.wkv6(r, k, v, w, u)
    yr, sr = wref.wkv_ref(r, k, v, w, u)
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    torch.testing.assert_close(y, yr, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(s, sr, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("decay", ["model", "strong"])
def test_wkv6_backward_op_on_card_is_the_cpu_op(cuda_device, decay):
    """The backward op `repro_torch::wkv6_backward` (autograd through the
    sequential recurrence) at one microbatch of rwkv6-1.6b's train step
    (4, 256, 32, 64), without s0 as the model calls it, on the card
    against the same op on the CPU, to 1e-4: under the model's decays
    (w = exp(-exp(x))) and under strong decay (half the channels at w =
    1e-12, half near 1)."""
    gen = torch.Generator(device=cuda_device).manual_seed(23)
    B, T, H, hd = 4, 256, 32, 64
    r, k, v, w, u, _ = _wkv_inputs(gen, B, T, H, hd, cuda_device)
    if decay == "strong":
        near = 0.9 + 0.1 * torch.rand(B, T, H, hd, generator=gen,
                                      device=cuda_device)
        w = torch.where(torch.arange(hd, device=cuda_device) < hd // 2,
                        torch.full_like(near, 1e-12), near)
    dy = torch.randn(B, T, H, hd, generator=gen, device=cuda_device)
    ds = torch.randn(B, H, hd, hd, generator=gen, device=cuda_device)
    args = (r, k, v, w, u, None, dy, ds)
    got = torch.ops.repro_torch.wkv6_backward(*args)
    want = torch.ops.repro_torch.wkv6_backward(
        *(None if x is None else x.cpu() for x in args))
    assert len(got) == len(want) == 5
    for g, x in zip(got, want):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g.cpu(), x, atol=1e-4, rtol=1e-4)


def test_wkv6_kernel_takes_inputs_that_start_off_16_bytes(cuda_device):
    """A contiguous view one float into its storage gives what the same
    values at an aligned start give (the wrapper copies it for cp.async)."""
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    xs = _wkv_inputs(gen, 1, 70, 2, 32, cuda_device)
    flat = torch.empty(1 + xs[0].numel(), device=cuda_device)
    r = flat[1:].view_as(xs[0])
    r.copy_(xs[0])
    assert r.is_contiguous() and r.data_ptr() % 16 != 0
    for got, want in zip(WK.wkv6(r, *xs[1:]), WK.wkv6(*xs)):
        torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_scan_kernels_refuse_what_they_do_not_take(cuda_device):
    x = torch.randn(1, 8, 2, 48, device=cuda_device)
    u = torch.zeros(2, 48, device=cuda_device)
    with pytest.raises(ValueError):                     # head_dim 48
        WK.wkv6(x, x, x, x, u)
    y = torch.randn(1, 8, 2, 64, device=cuda_device)
    with pytest.raises(ValueError):                     # float64
        WK.wkv6(y.double(), y, y, y, u)
    with pytest.raises(ValueError):                     # strided
        WK.wkv6(y.transpose(1, 2), y, y, y, u)
    a = torch.rand(2, 16, 32, device=cuda_device)
    with pytest.raises(ValueError):                     # bf16
        RK.rglru_scan(a.bfloat16(), a.bfloat16())
    with pytest.raises(ValueError):                     # h0 of the wrong shape
        RK.rglru_scan(a, a, torch.zeros(2, 31, device=cuda_device))
    with pytest.raises(ValueError):                     # on the CPU
        RK.rglru_scan(a.cpu(), a.cpu())


@pytest.mark.parametrize("name", ["recurrentgemma-2b", "rwkv6-1.6b"])
def test_small_recurrent_models_serve_through_the_kernels(cuda_device, name):
    """A float32 tiny hybrid and ssm model: under "flash" prefill and two
    decode steps launch rglru_scan once per recurrent layer a call (the
    hybrid; no flash-attention launch) or wkv6 once per layer in prefill
    and never in decode (ssm), and match the plain path to 1e-4."""
    from repro_torch.configs import tiny_config
    from repro_torch.models import recurrent
    from repro_torch.models.api import ModelAPI
    from repro_torch.models.context import single_device_ctx
    from repro_torch.models.params import init_params
    cfg = tiny_config(name)
    mctx = single_device_ctx(cfg)
    if cfg.family == "hybrid":
        n_super, n_tail = recurrent.pattern(cfg)
        per_call = (n_super * cfg.hybrid.rnn_per_attn + n_tail, ) * 2
        counts = lambda: rops.launches()["fwd"]          # noqa: E731
    else:
        per_call = (cfg.n_layers, 0)
        counts = lambda: wops.launches()["fwd"]          # noqa: E731
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 40), dtype=np.int32))
    out = {}
    for impl in ("flash", "jnp"):
        api = ModelAPI(cfg.replace(attn_impl=impl))
        params = init_params(api.param_defs(),
                             torch.Generator(device=cuda_device).manual_seed(0))
        with torch.inference_mode():
            before, fwd_before = counts(), fops.launches()["fwd"]
            logits, state = api.prefill(params, {"tokens": toks}, mctx)
            mid = counts()
            steps = []
            for i in range(2):
                pos = torch.full((2,), 40 + i, dtype=torch.int32,
                                 device=cuda_device)
                tok = logits.argmax(-1).to(torch.int32)
                logits, state = api.decode(params, {"token": tok, "pos": pos},
                                           state, mctx)
                steps.append(logits)
            if impl == "flash":
                assert (mid - before, counts() - mid) == (
                    per_call[0], 2 * per_call[1])
            assert fops.launches()["fwd"] == fwd_before
        out[impl] = steps
    for a, b in zip(out["flash"], out["jnp"]):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit equality through u8 views (torch has few ops for uint32)."""
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


def _storage_inputs(dev):
    """(name, tensor) pairs: the reference's test shapes, ragged u8,
    narrow dtypes and u8 views that start 1, 2 and 3 bytes into a word."""
    gen = torch.Generator(device=dev).manual_seed(3)
    out = []
    for n in (1, 4, 7, 100, 256, 2048, 2049, 4096, 8193, 10000):
        out.append((f"u32 n={n}", torch.randint(
            -2**31, 2**31, (n,), generator=gen, device=dev,
            dtype=torch.int32).view(torch.uint32)))
    for n in (1, 3, 999, 1013, 4099, 1 << 20):
        out.append((f"u8 n={n}", torch.randint(
            0, 256, (n,), generator=gen, device=dev, dtype=torch.uint8)))
    buf = torch.randint(0, 256, (10003,), generator=gen, device=dev,
                        dtype=torch.uint8)
    for start in (1, 2, 3):
        view = buf[start:start + 9001]
        assert view.data_ptr() % 4 != 0
        out.append((f"u8 at byte {start}", view))
    f = torch.randn(333, generator=gen, device=dev)
    out += [("float32", f), ("bfloat16", f.bfloat16()),
            ("float16", f.half()), ("int16", (f * 1000).to(torch.int16))]
    return out


@pytest.mark.parametrize("key,nonce", [(0xC0FFEE, 42), (1, 2),
                                       ((1 << 32) + 7, (1 << 40) + 9),
                                       (0xFFFFFFFF, 0xFFFFFFFF)])
def test_stream_cipher_kernel_matches_plain_version_on_card(
        cuda_device, key, nonce):
    for name, x in _storage_inputs(cuda_device):
        if x.dtype not in (torch.uint8, torch.uint32):
            continue
        got = scops.stream_cipher(x, key, nonce)
        want = scref.stream_cipher_torch(x, key, nonce)
        torch.cuda.synchronize()
        assert _same_bits(got, want), name
        assert _same_bits(scops.stream_cipher(got, key, nonce),
                          x.reshape(-1)), f"not an involution: {name}"
    words = torch.arange(5000, dtype=torch.int32).view(torch.uint32)
    np.testing.assert_array_equal(
        scops.stream_cipher(words.to(cuda_device), key, nonce).cpu().numpy(),
        scref.cipher_ref(words.numpy(), key, nonce))


def test_fletcher_kernel_matches_plain_version_on_card(cuda_device):
    for name, x in _storage_inputs(cuda_device):
        got = flops.fletcher_checksum(x)
        want = flref.fletcher_checksum_torch(x)
        torch.cuda.synchronize()
        assert got.device == x.device and _same_bits(got, want), name
    data = np.random.default_rng(8).integers(0, 256, 8193, np.uint8)
    from repro_torch.core import media
    assert flops.packed(flops.fletcher_checksum(
        torch.from_numpy(data).to(cuda_device))) == media.checksum(
            data.tobytes())


def test_storage_kernels_count_their_launches(cuda_device):
    x = torch.randint(0, 256, (4097,), dtype=torch.uint8, device=cuda_device)
    scops.reset_launches()
    flops.reset_launches()
    scops.stream_cipher(x, 1, 2)
    scops.stream_cipher(x.view(-1)[:0], 1, 2)           # empty: no launch
    flops.fletcher_checksum(x)
    flops.fletcher_checksum(x[:0])
    flops.fletcher_checksum(x.cpu())                    # plain version
    assert scops.launches() == {"cipher": 1}
    assert flops.launches() == {"checksum": 1}
    assert _same_bits(flops.fletcher_checksum(x[:0]),
                      torch.zeros(2, dtype=torch.int32,
                                  device=cuda_device).view(torch.uint32))


def test_storage_kernels_refuse_what_they_do_not_take(cuda_device):
    x = torch.randint(0, 256, (64, 64), dtype=torch.uint8, device=cuda_device)
    for fn in (lambda t: SCK.cipher(t, 1, 2), FLK.fletcher):
        with pytest.raises(ValueError):                 # strided
            fn(x.t())
        with pytest.raises(ValueError):                 # float32
            fn(x.float())
        with pytest.raises(ValueError):                 # on the CPU
            fn(x.cpu())
        with pytest.raises(ValueError):                 # empty
            fn(x[:0])
    with pytest.raises(TypeError):
        scops.stream_cipher(x.float(), 1, 2)


def _device_ops(fn, expect: int) -> list:
    """The names of the device operations (kernels, memsets, copies) of
    one call of `fn`, from torch.profiler, which loses a record now and
    then: a window that did not record `expect` of them is traced again,
    up to 5 times."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(5):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ops = [ev.name for ev in prof.events()
               if ev.device_type == torch.autograd.DeviceType.CUDA]
        if len(ops) == expect:
            break
    return ops


FLETCHER_FULL = 132 * 8 * 256 * 2 * 16   # where fletcher's grid stops


@pytest.mark.parametrize("start", [0, 1, 2, 3, 4])
def test_fletcher_kernel_at_its_grid_edges_on_card(cuda_device, start):
    """Bit-exact with the plain version at 1 MiB and where the grid stops
    growing (grid-stride beyond), at 16-byte-aligned and misaligned
    starts."""
    buf = torch.randint(0, 256, (3 * FLETCHER_FULL + 64,), dtype=torch.uint8,
                        device=cuda_device)
    for n in (4, 16, 1 << 20, (1 << 20) + 3, FLETCHER_FULL - 4,
              FLETCHER_FULL, FLETCHER_FULL + 4, 3 * FLETCHER_FULL + 13):
        x = buf[start:start + n]
        got = flops.fletcher_checksum(x)
        torch.cuda.synchronize()
        assert _same_bits(got, flref.fletcher_checksum_torch(x)), (n, start)


def test_fletcher_call_is_one_device_operation(cuda_device):
    """A call is the kernel alone at every size: no memset. On a new
    stream the first call zeroes a pool of POOL_PAIRS output pairs, and
    the next POOL_PAIRS - 1 calls make no other operation."""
    x = torch.randint(0, 256, (64 << 20,), dtype=torch.uint8,
                      device=cuda_device)
    FLK.fletcher(x[:1 << 20])                            # built, pool made
    for n in (16, 1 << 20, 5 << 20, 64 << 20):
        ops = _device_ops(lambda: FLK.fletcher(x[:n]), 1)
        assert ops == [ops[0]] and FLK.KERNEL_NAME in ops[0], ops
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        ops = _device_ops(lambda: [FLK.fletcher(x[:4096])
                                   for _ in range(FLK.POOL_PAIRS)],
                          FLK.POOL_PAIRS + 1)
    kernels = [op for op in ops if FLK.KERNEL_NAME in op]
    assert len(kernels) == FLK.POOL_PAIRS and len(ops) == len(kernels) + 1
    assert not any("Memset" in op for op in ops), set(ops)


def test_fletcher_on_two_streams_at_once(cuda_device):
    """Checksums launched on two streams in turn, each stream's results
    from its own pool, give every block's own sums, and no result is
    overwritten by a later call."""
    data = torch.randint(0, 256, (64 << 20,), dtype=torch.uint8,
                         device=cuda_device)
    blocks = [data[i << 20:(i + 1) << 20] for i in range(48)] + [
        data[:FLETCHER_FULL + 4], data[1:FLETCHER_FULL + 5],
        data[3:(1 << 20) + 3]]
    want = [flref.fletcher_checksum_torch(b) for b in blocks]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    got = []
    for i, b in enumerate(blocks):
        with torch.cuda.stream(streams[i % 2]):
            got.append(flops.fletcher_checksum(b))
    torch.cuda.synchronize()
    for i, (g, w) in enumerate(zip(got, want)):
        assert _same_bits(g, w), i


def test_stream_cipher_at_1mib_and_past_one_wave_on_card(cuda_device):
    """Bit-exact with the plain version at the engine's 1 MiB extent and
    at streams past the grid's full size (132 x 16 CTAs x 256 threads x 4
    loads x 16 B = 34.6 MB, grid-stride beyond), aligned, ragged and 3
    bytes into a word."""
    data = torch.randint(0, 256, ((96 << 20) + 32,), dtype=torch.uint8,
                         device=cuda_device)
    for x in (data[:1 << 20], data[:96 << 20], data[:(96 << 20) + 13],
              data[3:(64 << 20) + 3]):
        got = scops.stream_cipher(x, 0xC0FFEE, 42)
        want = scref.stream_cipher_torch(x, 0xC0FFEE, 42)
        torch.cuda.synchronize()
        assert _same_bits(got, want), x.numel()


def test_fletcher_from_many_threads_at_once(cuda_device):
    """Threads that share a stream take distinct pairs of its pool: with
    more threads than cores and a short switch interval, every result is
    its own block's sums and no two results share memory."""
    data = torch.randint(0, 256, (16 << 20,), dtype=torch.uint8,
                         device=cuda_device)
    blocks = [data[i << 16:(i + 1) << 16] for i in range(256)]
    want = [flref.fletcher_checksum_torch(b) for b in blocks]
    torch.cuda.synchronize()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(16) as ex:
            got = list(ex.map(flops.fletcher_checksum, blocks * 8,
                              timeout=120))
    finally:
        sys.setswitchinterval(interval)
    torch.cuda.synchronize()
    assert len({g.data_ptr() for g in got}) == len(got)
    for i, g in enumerate(got):
        assert _same_bits(g, want[i % len(blocks)]), i


# -- compiled steps: CUDA graph replays against eager steps ------------------
COMPILED_ARCHS = [  # tiny config, its overrides: each family's kernels
    ("granite-3-2b", dict(head_dim=64, attn_impl="flash")),
    ("dbrx-132b", dict(head_dim=64, attn_impl="flash")),
    ("deepseek-v2-236b", dict(attn_impl="flash")),
    ("recurrentgemma-2b", dict(attn_impl="flash")),
    ("rwkv6-1.6b", dict(attn_impl="flash")),
    ("llama-3.2-vision-90b", dict(head_dim=64, attn_impl="flash")),
    ("whisper-tiny", dict()),
]


def _tiny_on_card(name, over, dev, seed=0):
    from repro_torch.configs import tiny_config
    from repro_torch.models.api import ModelAPI
    from repro_torch.models.context import single_device_ctx
    from repro_torch.models.params import init_params
    cfg = tiny_config(name).replace(compute_dtype="bfloat16", **over)
    api = ModelAPI(cfg)
    params = init_params(api.param_defs(),
                         torch.Generator(device=dev).manual_seed(seed))
    return api, params, single_device_ctx(cfg)


def _prefill_inputs(cfg, B, T, dev, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {"tokens": torch.randint(0, cfg.vocab, (B, T), generator=gen,
                                   device=dev, dtype=torch.int32)}
    if cfg.family == "vlm":
        out["vision_embeds"] = torch.randn(
            (B, cfg.vlm.n_vision_tokens, cfg.vlm.d_vision), generator=gen,
            device=dev)
    if cfg.family == "encdec":
        out["frames"] = torch.randn((B, cfg.encdec.n_frames, cfg.d_model),
                                    generator=gen, device=dev)
    return out


def _equal_trees(got, want) -> None:
    from repro_torch.train.trainer import map_tree
    map_tree(lambda a, b: torch.testing.assert_close(a, b, rtol=0, atol=0),
             got, want)


@pytest.mark.parametrize("name,over", COMPILED_ARCHS)
def test_compiled_engine_replays_equal_its_eager_steps(cuda_device, name,
                                                       over):
    """The engine's captured prefill and decode (bf16, the family's
    kernels) against its eager steps from the same state: the first
    wave's logits, every greedy token of two waves and the decode cache,
    bit for bit; a replay makes no wrapper launch."""
    from repro_torch.launch.serve import BatchedEngine, Request
    api, params, mctx = _tiny_on_card(name, over, cuda_device)
    B, T = 2, 64
    waves = [_prefill_inputs(api.cfg, B, T, cuda_device, seed)
             for seed in (1, 2)]

    class Engine(BatchedEngine):
        def wave_inputs(self, padded, toks):
            return dict(self.extra, tokens=toks)

    runs = []
    for compiled in (("prefill", "decode"), ()):
        eng = Engine(api, params, mctx, B, T, T + 8, compiled=compiled)
        outs = []
        for i, inp in enumerate(waves):
            eng.extra = {k: v for k, v in inp.items() if k != "tokens"}
            reqs = [Request(r, inp["tokens"][r].cpu().numpy(), 5)
                    for r in range(B)]
            before = (fops.launches()["fwd"], rops.launches()["fwd"],
                      wops.launches()["fwd"])
            eng.run_wave(reqs)
            after = (fops.launches()["fwd"], rops.launches()["fwd"],
                     wops.launches()["fwd"])
            if compiled and i:
                assert after == before      # replays go round the wrappers
            outs.append([r.out for r in reqs])
        torch.cuda.synchronize()
        runs.append((outs, eng.cache))
    assert runs[0][0] == runs[1][0]
    _equal_trees(runs[0][1], runs[1][1])


@pytest.mark.parametrize("name,over", COMPILED_ARCHS)
def test_jit_decode_step_replay_equals_eager(cuda_device, name, over):
    """jit_prefill_step's and jit_decode_step's replays against the eager
    model from the same state, bit for bit: logits and cache after three
    chained decode steps (the second and third are replays)."""
    from repro_torch.common.config import ShapeConfig
    from repro_torch.launch.serve import grow_cache
    from repro_torch.train.trainer import (jit_decode_step,
                                           jit_prefill_step, map_tree)
    api, params, mctx = _tiny_on_card(name, over, cuda_device)
    cfg, B = api.cfg, 2
    inp = {k: v for k, v in api.input_specs(ShapeConfig(
        "p", cfg.encdec.n_frames if cfg.family == "encdec" else 64, B,
        "prefill")).items()}
    inp = {k: (torch.randint(0, cfg.vocab, s.shape, device=cuda_device,
                             dtype=torch.int32) if s.dtype == torch.int32
               else torch.randn(s.shape, device=cuda_device).to(s.dtype))
           for k, s in inp.items()}
    plen = inp["tokens"].shape[1]
    pre = jit_prefill_step(api, mctx, ShapeConfig("p", plen if cfg.family
                                                  != "encdec" else
                                                  cfg.encdec.n_frames, B,
                                                  "prefill"))
    dec = jit_decode_step(api, mctx, ShapeConfig("d", plen + 8, B, "decode"))
    with torch.inference_mode():
        for _ in range(2):                   # the capture, then a replay
            logits, cache = pre(params, inp)
        want_logits, want_cache = api.prefill(params, inp, mctx)
        torch.testing.assert_close(logits, want_logits, rtol=0, atol=0)
        eager = grow_cache(want_cache, cfg.family, 8)
        cache = grow_cache(cache, cfg.family, 8)
        tok = logits.argmax(-1).to(torch.int32)
        pos = torch.full((B,), plen, dtype=torch.int32, device=cuda_device)
        for i in range(3):
            got, cache = dec(params, tok, pos + i, cache)
            want, eager = api.decode(params, {"token": tok, "pos": pos + i},
                                     eager, mctx)
            torch.testing.assert_close(got, want, rtol=0, atol=0)
            tok = want.argmax(-1).to(torch.int32)
        _equal_trees(cache, eager)
    assert dec.calls == 3 and pre.calls == 2
    assert dec.capture_s > 0


TRAIN_ARCHS = [  # tiny config, its overrides: the train paths' kernels
    ("granite-3-2b", dict(head_dim=64, attn_impl="flash")),
    ("recurrentgemma-2b", dict(attn_impl="flash")),
    ("rwkv6-1.6b", dict(attn_impl="flash")),
]


def _all_launches() -> tuple:
    return fops.launches(), rops.launches(), wops.launches()


@pytest.mark.parametrize("name,over", TRAIN_ARCHS)
def test_jit_train_step_replay_equals_eager(cuda_device, name, over):
    """Three steps of jit_train_step (bf16, 2 microbatches, remat: the
    flash forward and backward kernels for granite, rglru_scan forward
    and reverse for the hybrid, wkv6 and the wkv6_backward op for the
    ssm) against make_train_step from the same state, bit for bit: loss,
    grad norm, params, m and v. A replay makes no wrapper launch."""
    from repro_torch.common.config import ShapeConfig, TrainConfig
    from repro_torch.models.params import tree_leaves
    from repro_torch.train.optimizer import init_adam
    from repro_torch.train.trainer import (jit_train_step, make_train_step,
                                           map_tree)
    api, params, mctx = _tiny_on_card(name, over, cuda_device)
    assert api.cfg.remat
    tcfg = TrainConfig(lr=1e-2, total_steps=10, warmup_steps=2,
                       num_microbatches=2)
    step = jit_train_step(api, tcfg, mctx, ShapeConfig("t", 64, 4, "train"))
    eager = make_train_step(api, tcfg, mctx)
    p_e = map_tree(torch.clone, params)
    s_e = init_adam(p_e)
    s_c = init_adam(params)
    p_c = params
    gen = np.random.default_rng(5)
    for i in range(3):
        toks = gen.integers(0, api.cfg.vocab, (4, 65), dtype=np.int32)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        before = _all_launches()
        p_c, s_c, m_c = step(p_c, s_c, batch)
        if i:
            assert _all_launches() == before
        p_e, s_e, m_e = eager(p_e, s_e, {k: torch.from_numpy(v).to(
            cuda_device) for k, v in batch.items()})
        for key in ("loss", "grad_norm", "lr"):
            torch.testing.assert_close(m_c[key], m_e[key], rtol=0, atol=0)
    for a, b in zip(tree_leaves(p_c) + tree_leaves(s_c.m) + tree_leaves(
            s_c.v), tree_leaves(p_e) + tree_leaves(s_e.m) + tree_leaves(
            s_e.v)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert int(s_c.step) == 3 and step.calls == 3 and step.copies == 6


# -- the multi-device layer on a one-rank NCCL group ----------------------------
@pytest.fixture
def nccl_mesh(cuda_device):
    """A one-rank NCCL group (from a HashStore: no port) and its (data 1,
    model 1) DeviceMesh; the group is destroyed after the test."""
    import torch.distributed as dist
    from repro_torch.models.context import make_mesh
    assert dist.is_nccl_available()
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=torch.device(
                                "cuda", torch.cuda.current_device()))
    try:
        yield make_mesh((1, 1), ("data", "model"), "cuda")
    finally:
        dist.destroy_process_group()


def test_mesh_train_step_equals_the_one_device_step(nccl_mesh):
    """Three steps of jit_train_step on the one-rank mesh (params and
    moments DTensors, zero1, the flash kernels, 2 microbatches), captured
    and replayed, against the one-device compiled step from the same
    state, bit for bit."""
    from repro_torch.common.config import ShapeConfig, TrainConfig
    from repro_torch.models.context import mesh_ctx
    from repro_torch.models.params import tree_leaves
    from repro_torch.train.optimizer import init_adam, local
    from repro_torch.train.trainer import jit_train_step, map_tree
    api, params, one = _tiny_on_card("granite-3-2b", dict(
        head_dim=64, attn_impl="flash"), torch.device("cuda"))
    assert api.cfg.zero1
    tcfg = TrainConfig(lr=1e-2, total_steps=10, warmup_steps=2,
                       num_microbatches=2)
    shape = ShapeConfig("t", 64, 4, "train")
    steps = [jit_train_step(api, tcfg, ctx, shape)
             for ctx in (one, mesh_ctx(api.cfg, nccl_mesh))]
    states = [(p, init_adam(p)) for p in (params, map_tree(torch.clone,
                                                           params))]
    gen = np.random.default_rng(5)
    for _ in range(3):
        toks = gen.integers(0, api.cfg.vocab, (4, 65), dtype=np.int32)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        out = [step(p, s, batch) for step, (p, s) in zip(steps, states)]
        states = [(p, s) for p, s, _ in out]
        for key in ("loss", "grad_norm", "lr"):
            torch.testing.assert_close(out[1][2][key], out[0][2][key],
                                       rtol=0, atol=0)
    assert steps[1].step.graph is not None
    (p1, s1), (p2, s2) = states
    assert all(hasattr(t, "device_mesh") for t in tree_leaves(p2))
    for a, b in zip(tree_leaves(p2) + tree_leaves(s2.m) + tree_leaves(s2.v),
                    tree_leaves(p1) + tree_leaves(s1.m) + tree_leaves(s1.v)):
        torch.testing.assert_close(local(a), b, rtol=0, atol=0)


@pytest.mark.parametrize("wire", ["bfloat16", "float8_e4m3fn"])
def test_mesh_moe_ffn_equals_the_meshless_call(nccl_mesh, wire):
    """moe_ffn on the one-rank mesh (its exchanges through NCCL's
    all_to_all_single and all-gather), eagerly and as a captured graph's
    replay, bit for bit the meshless call."""
    import dataclasses
    from repro_torch.models.context import mesh_ctx
    from repro_torch.models.moe import moe_ffn
    from repro_torch.models.params import tree_map
    from repro_torch.train.trainer import BIND, StaticStep
    api, params, one = _tiny_on_card("dbrx-132b", {}, torch.device("cuda"))
    cfg = api.cfg.replace(moe=dataclasses.replace(api.cfg.moe,
                                                  dispatch_dtype=wire))
    mesh = mesh_ctx(cfg, nccl_mesh)
    layer = tree_map(lambda t: t[0], params["blocks"]["mlp"])
    x = torch.randn(4, 32, cfg.d_model, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(1)
                    ).bfloat16()
    want = moe_ffn(x, layer, cfg, one)
    torch.testing.assert_close(moe_ffn(x, layer, cfg, mesh), want, rtol=0,
                               atol=0)
    step = StaticStep(lambda p, h: moe_ffn(h, p, cfg, mesh), mesh.device,
                      {"p": BIND, "x": BIND})
    step(layer, x)
    torch.testing.assert_close(step(layer, x), want, rtol=0, atol=0)
    assert step.graph is not None


DECODE_CARD_SHAPES = [  # B, S, KH, G, D: granite-3-2b's chat and rag cells,
    # a dbrx-132b wave, tile and split edges, a group of 16, MQA
    (96, 1288, 8, 4, 64), (32, 3912, 8, 4, 64), (8, 1288, 8, 6, 128),
    (3, 17, 2, 16, 64), (2, 200, 1, 1, 128), (4, 4097, 1, 6, 128)]


@pytest.mark.parametrize("B,S,KH,G,D", DECODE_CARD_SHAPES)
def test_flash_decode_matches_plain_version_on_card(cuda_device, B, S, KH,
                                                    G, D):
    """flash_decode against its plain version (the plain path's arithmetic,
    `ref.decode_ref`) on ragged kv_len (1 and S among them), at the bf16
    tolerance 2e-2; also through a cache viewed as a slice of its kv
    heads, as a mesh rank may hand it over."""
    gen = torch.Generator(device=cuda_device).manual_seed(B + S + D)
    H = KH * G
    q = torch.randn(B, 1, H, D, generator=gen, device=cuda_device).bfloat16()
    k = torch.randn(B, S, KH, D, generator=gen, device=cuda_device).bfloat16()
    v = torch.randn(B, S, KH, D, generator=gen, device=cuda_device).bfloat16()
    kv_len = torch.randint(1, S + 1, (B,), generator=gen, device=cuda_device,
                           dtype=torch.int32)
    kv_len[0], kv_len[-1] = 1, S
    views = [(q, k, v)]
    if KH > 1:
        views.append((q[:, :, G:], k[:, :, 1:], v[:, :, 1:]))
    for qq, kk, vv in views:
        got = fops.flash_decode(qq, kk, vv, kv_len)
        want = fref.decode_ref(qq, kk, vv, kv_len, D ** -0.5)
        torch.cuda.synchronize()
        assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                                   rtol=2e-2)


def test_flash_decode_refuses_what_it_does_not_take(cuda_device):
    """float32, head_dim 256, a group of 32, two query tokens and a kv_len
    of the wrong shape raise before any launch."""
    def t(*shape, dtype=torch.bfloat16):
        return torch.zeros(*shape, dtype=dtype, device=cuda_device)
    kv = torch.ones(2, dtype=torch.int32, device=cuda_device)
    for q, k, kvl, match in (
            (t(2, 1, 8, 64, dtype=torch.float32),
             t(2, 16, 2, 64, dtype=torch.float32), kv, "bfloat16"),
            (t(2, 1, 8, 256), t(2, 16, 2, 256), kv, "D in"),
            (t(2, 1, 64, 64), t(2, 16, 2, 64), kv, "groups of at most"),
            (t(2, 2, 8, 64), t(2, 16, 2, 64), kv, "q \\(B,1,H,D\\)"),
            (t(2, 1, 8, 64), t(2, 16, 2, 64), kv[:1], "kv_len")):
        with pytest.raises(ValueError, match=match):
            FKD.flash_decode(q, k, k, kvl, scale=0.125)


def test_decode_graph_replays_its_eager_step_and_counts(cuda_device):
    """A bf16 granite-shaped model of 40 layers (head_dim 64) served with
    attn_impl="flash": the engine's captured decode step gives its eager
    step's tokens and last logits bit for bit; the decode step calls
    flash_decode once a layer, counted at its warm-up and at its capture
    (40 each), never at a replay, and no decode call takes the plain
    path."""
    from repro_torch.configs import tiny_config
    from repro_torch.launch.mesh import make_host_mesh_ctx
    from repro_torch.launch.serve import BatchedEngine, Request
    from repro_torch.models.api import ModelAPI
    from repro_torch.models.params import init_params
    cfg = tiny_config("granite-3-2b").replace(
        n_layers=40, head_dim=64, compute_dtype="bfloat16",
        attn_impl="flash")
    api = ModelAPI(cfg)
    mctx = make_host_mesh_ctx(cfg)
    params = init_params(api.param_defs(),
                         torch.Generator(device=cuda_device).manual_seed(0))
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab, 32, dtype=np.int32)
               for _ in range(3)]
    out, logits = {}, {}
    for compiled in (("prefill", "decode"), ()):
        eng = BatchedEngine(api, params, mctx, 3, 32, 32 + 6 + 8,
                            compiled=compiled)
        fops.reset_launches()
        reqs = [Request(i, p, 6) for i, p in enumerate(prompts)]
        eng.run_wave(reqs)
        torch.cuda.synchronize()
        counts = fops.launches()
        steps = eng.steps
        assert counts["decode_plain"] == 0
        if compiled:
            assert counts["decode"] == 2 * cfg.n_layers     # warm-up, capture
            assert eng.decode_step.graph is not None and steps > 2
        else:
            assert counts["decode"] == cfg.n_layers * steps
        out[bool(compiled)] = [r.out for r in reqs]
        logits[bool(compiled)] = eng.logits["decode"].clone()
        del eng
    assert out[True] == out[False]
    assert torch.equal(logits[True], logits[False])
