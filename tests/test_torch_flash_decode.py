"""The decode kernel (`csrc/flash_decode.cu`) on the CPU: its rounding
points, the calls `layers.attention` sends to it, and its op under a trace.

The kernel cannot run here, so (a) `_decode_rounded` below is a plain
float32 computation with its rounding points and its order: the sequence
cut into the wrapper's splits (`kernel_decode.plan`) and tiles of 64
positions, each of a CTA's four warps taking 16 positions of a tile with
its own running max, sum and accumulator, q times the bf16 scale rounded
to bf16, float32 scores and softmax, l summed from the float32 p, p
rounded to bf16 at its slice's running max for p.v, the warps and then
the splits merged in float32, out rounded to bf16. On bf16 inputs made
from a numpy seed it is held against the reference's decode path
(`repro.models.layers.attention` with kv_len and chunk = S) at the
reference's bf16 tolerance, 2e-2 (tests/test_kernels.py:56), at
granite-3-2b's group (G=4, D=64) and dbrx-132b's (G=6, D=128). (b) The
dispatch: which attention calls reach `flash_decode`, and that a CPU call
gives the plain path's numbers bit for bit. (c) The op's fake
implementation and FLOP formula under FakeTensorMode, and the dry-run's
decode trace through it. The card's own checks are in
tests/test_torch_cuda.py (marked `cuda`).
"""
import math

import ml_dtypes
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

import jax.numpy as jnp

from repro.models.layers import attention as jattention
from repro_torch.common.config import ShapeConfig
from repro_torch.configs import tiny_config
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import kernel_decode as KD
from repro_torch.kernels.flash_attention import ops, ref
from repro_torch.launch import dryrun
from repro_torch.launch.serve import grow_cache
from repro_torch.models import layers as L
from repro_torch.models.api import ModelAPI
from repro_torch.models.context import single_device_ctx
from repro_torch.models.params import init_params

MASK_VALUE = -1e30
WARPS, SLICE = 4, 16          # the .cu's NW and the positions a warp takes
TOL = 2e-2
H100_SLOTS = {64: 132 * 3, 128: 132 * 2}   # split CTAs an H100 holds


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 (to nearest even) and back to float32."""
    return x.to(torch.bfloat16).float()


def _merge(parts):
    """(m, l, o) partials over the same heads merged in float32."""
    mx = torch.stack([m for m, _, _ in parts]).amax(0)
    w = [torch.exp(m - mx) for m, _, _ in parts]
    l = sum(e * l for e, (_, l, _) in zip(w, parts))
    o = sum(e[..., None] * o for e, (_, _, o) in zip(w, parts))
    return mx, l, o


def _decode_rounded(q, k, v, kv_len, scale, splits, per):
    """out (B,1,H,D) float32 with the kernel's rounding points, walking its
    splits, tiles and warp slices (module docstring)."""
    B, _, H, D = q.shape
    S, KH = k.shape[1], k.shape[2]
    G = H // KH
    tiles = splits * per
    pad = tiles * KD.TILE - S
    k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
    v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    qs = _bf16(q * _bf16(torch.tensor(scale))).reshape(B, KH, G, D)
    out = torch.empty(B, KH, G, D)
    for b in range(B):
        n = min(int(kv_len[b]), S)
        s_all = torch.einsum("kgd,skd->kgs", qs[b], k[b])
        pos = torch.arange(tiles * KD.TILE)
        s_all = torch.where(pos < n, s_all, torch.tensor(MASK_VALUE))
        ctas = []
        for sp in range(splits):
            t1 = min((sp + 1) * per, -(-n // KD.TILE))
            warps = []
            for w in range(WARPS):
                m = torch.full((KH, G), MASK_VALUE)
                l = torch.zeros(KH, G)
                o = torch.zeros(KH, G, D)
                for t in range(sp * per, t1):
                    lo = t * KD.TILE + SLICE * w
                    if lo >= n:
                        continue
                    st = s_all[..., lo:lo + SLICE]
                    mn = torch.maximum(m, st.amax(-1))
                    c = torch.exp(m - mn)
                    p = torch.exp(st - mn[..., None])
                    l = l * c + p.sum(-1)
                    o = o * c[..., None] + torch.einsum(
                        "kgs,skd->kgd", _bf16(p), v[b, lo:lo + SLICE])
                    m = mn
                warps.append((m, l, o))
            ctas.append(_merge(warps))
        _, l, o = _merge(ctas)
        out[b] = o / l.clamp_min(1e-30)[..., None]
    return _bf16(out).reshape(B, 1, H, D)


def _inputs(seed, B, S, H, KH, D):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape, np.float32).astype(ml_dtypes.bfloat16)
            for shape in ((B, 1, H, D), (B, S, KH, D), (B, S, KH, D))]


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32))


def _kv_len(kind: str, B: int, S: int) -> np.ndarray:
    if kind == "one":
        return np.ones(B, np.int32)
    if kind == "full":
        return np.full(B, S, np.int32)
    return np.array([S - 37, 130, 1][:B], np.int32)       # ragged


# B, S, KH, G, D: granite-3-2b's group and dbrx-132b's, over several splits
GROUPS = {"granite": (3, 600, 2, 4, 64), "dbrx": (3, 1100, 2, 6, 128)}


@pytest.mark.parametrize("kind", ["one", "full", "ragged"])
@pytest.mark.parametrize("group", list(GROUPS))
def test_decode_rounding_fits_reference_tolerance(group, kind):
    """The kernel's rounding and order, modelled in float32, within the
    reference's bf16 tolerance of its decode path, over the splits the
    wrapper gives an H100 at this shape."""
    B, S, KH, G, D = GROUPS[group]
    H = KH * G
    q, k, v = _inputs(S + D, B, S, H, KH, D)
    kv_len = _kv_len(kind, B, S)
    scale = 1.0 / math.sqrt(D)
    splits, per = KD.plan(B, KH, S, H100_SLOTS[D])
    assert splits > 1
    want = jattention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      q_positions=jnp.zeros((1,), jnp.int32),
                      kv_positions=jnp.arange(S), causal=False,
                      kv_len=jnp.asarray(kv_len), chunk=S)
    got = _decode_rounded(_t(q), _t(k), _t(v), torch.from_numpy(kv_len),
                          scale, splits, per)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("B,KH,S,slots,want", [
    (96, 8, 1288, 396, (3, 7)),      # granite-3-2b.chat on an H100
    (32, 8, 3912, 396, (7, 9)),      # granite-3-2b.rag
    (1, 1, 100, 396, (1, 2)),        # too short to split
    (1, 1, 64 * 4 * 40, 396, (32, 5)),   # capped at MAX_SPLITS
    (4096, 8, 1288, 396, (1, 21)),   # the card full without splits
])
def test_split_plan(B, KH, S, slots, want):
    """Splits from B, KH, S and the card's slots: every tile in exactly
    one split, none empty, none shorter than MIN_TILES but where one
    split holds all."""
    splits, per = KD.plan(B, KH, S, slots)
    assert (splits, per) == want
    tiles = -(-S // KD.TILE)
    assert (splits - 1) * per < tiles <= splits * per
    assert splits == 1 or per >= KD.MIN_TILES
    assert splits <= KD.MAX_SPLITS


# ---------------------------------------------------------------------------
# (b) dispatch: what goes to flash_decode

def _decode_args(B=2, S=80, H=8, KH=2, D=64, T=1, dtype=torch.bfloat16,
                 Dv=None, kv_shape=None):
    g = torch.Generator().manual_seed(B + S + H + D)
    q = torch.randn(B, T, H, D, generator=g).to(dtype)
    k = torch.randn(B, S, KH, D, generator=g).to(dtype)
    v = torch.randn(B, S, KH, Dv or D, generator=g).to(dtype)
    kv_len = torch.tensor([S, 5, 17, 1][:B], dtype=torch.int32)
    if kv_shape is not None:
        kv_len = kv_len[:1].reshape(kv_shape)
    return q, k, v, kv_len


# name -> (attention call's arguments, impl, other keywords, to the kernel)
DISPATCH = {
    "granite": (dict(), "flash", {}, True),
    "dbrx": (dict(H=12, KH=2, D=128), "flash", {}, True),
    "group_of_16": (dict(H=16, KH=1), "flash", {}, True),
    "kv_len_int64": (dict(), "flash", {"kv_int64": True}, True),
    "jnp": (dict(), "jnp", {}, False),
    "two_tokens": (dict(T=2), "flash", {}, False),
    "window": (dict(), "flash", {"window": 16}, False),
    "softcap": (dict(), "flash", {"logit_softcap": 30.0}, False),
    "causal": (dict(), "flash", {"causal": True}, False),
    "float32_cache": (dict(dtype=torch.float32), "flash", {}, False),
    "latent_value_dim": (dict(Dv=32), "flash", {}, False),
    "head_dim_256": (dict(D=256), "flash", {}, False),
    "group_of_32": (dict(H=32, KH=1), "flash", {}, False),
    "kv_len_broadcast": (dict(kv_shape=(1,)), "flash", {}, False),
}


@pytest.mark.parametrize("case", list(DISPATCH))
def test_dispatch_sends_only_what_the_kernel_takes(case, monkeypatch):
    """`layers.attention` sends a decode call to flash_decode exactly when
    `decode_takes` holds; either way a CPU call gives the plain path's
    numbers bit for bit."""
    shape, impl, kw, to_kernel = DISPATCH[case]
    q, k, v, kv_len = _decode_args(**shape)
    if kw.pop("kv_int64", False):
        kv_len = kv_len.long()
    kw.setdefault("causal", False)
    calls = _spy(monkeypatch)
    args = dict(q_positions=torch.zeros((1,), dtype=torch.int32),
                kv_positions=torch.arange(k.shape[1]), kv_len=kv_len,
                chunk=k.shape[1], **kw)
    got = L.attention(q, k, v, impl=impl, **args)
    assert len(calls) == int(to_kernel)
    if impl == "flash":
        assert ops.decode_takes(q, k, v, kv_len, causal=kw["causal"],
                                window=kw.get("window"),
                                softcap=kw.get("logit_softcap")) == to_kernel
    assert torch.equal(got, L.attention(q, k, v, impl="jnp", **args))


def test_cpu_call_is_the_plain_path_bit_for_bit():
    """flash_decode on CPU tensors is `decode_ref`, op for op the plain
    path of `layers.attention` (chunk = S), at granite's and dbrx's
    groups, ragged kv_len and kv_len of 1 and S; counts no launch."""
    before = ops.launches()
    for shape in (dict(B=4, S=300), dict(B=3, S=129, H=12, KH=2, D=128)):
        q, k, v, kv_len = _decode_args(**shape)
        S = k.shape[1]
        for lens in (kv_len, torch.ones_like(kv_len),
                     torch.full_like(kv_len, S)):
            plain = L.attention(q, k, v,
                                q_positions=torch.zeros(1, dtype=torch.int32),
                                kv_positions=torch.arange(S), causal=False,
                                kv_len=lens, chunk=S)
            assert torch.equal(ops.flash_decode(q, k, v, lens), plain)
    assert ops.launches() == before


def _tiny(arch, **over):
    cfg = tiny_config(arch).replace(compute_dtype="bfloat16", **over)
    params = init_params(ModelAPI(cfg, device="cpu").param_defs(),
                         torch.Generator().manual_seed(3), device="cpu")
    return cfg, params


def _decode_twice(cfg, params, impl):
    """Two greedy decode steps with `impl` after a prefill of 16 tokens on
    the plain path (so that only decode differs), as the engine runs them;
    returns both steps' logits."""
    mctx = single_device_ctx(cfg, "cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 16), dtype=np.int32))
    api = ModelAPI(cfg.replace(attn_impl=impl), device="cpu")
    with torch.inference_mode():
        logits, cache = ModelAPI(cfg.replace(attn_impl="jnp"),
                                 device="cpu").prefill(
            params, {"tokens": toks}, mctx)
        cache = grow_cache(cache, cfg.family, 8)
        pos = torch.full((2,), 16, dtype=torch.int32)
        out = []
        for _ in range(2):
            token = logits.argmax(-1).to(torch.int32)
            logits, cache = api.decode(params, {"token": token, "pos": pos},
                                       cache, mctx)
            out.append(logits)
            pos = pos + 1
    return out


def _spy(monkeypatch) -> list:
    """The calls that reach ops.flash_decode from here on."""
    calls = []
    real = ops.flash_decode
    monkeypatch.setattr(ops, "flash_decode",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    return calls


@pytest.mark.parametrize("arch,head_dim", [("granite-3-2b", 64),
                                           ("dbrx-132b", 128)])
def test_model_decode_reaches_the_kernel(arch, head_dim, monkeypatch):
    """`_gqa`'s decode passes the config's attn_impl: a bf16 dense or moe
    model with "flash" sends every layer's decode attention to
    flash_decode, and on the CPU gives the "jnp" config's logits bit for
    bit."""
    cfg, params = _tiny(arch, head_dim=head_dim)
    calls = _spy(monkeypatch)
    flash = _decode_twice(cfg, params, "flash")
    assert len(calls) == 2 * cfg.n_layers
    plain = _decode_twice(cfg, params, "jnp")
    assert len(calls) == 2 * cfg.n_layers
    assert all(torch.equal(a, b) for a, b in zip(flash, plain))


def test_encdec_decode_stays_plain(monkeypatch):
    """encdec's decoder self-attention passes no impl (the reference's
    does not either): with "flash" it never reaches flash_decode."""
    cfg, params = _tiny("whisper-tiny", head_dim=64)
    calls = _spy(monkeypatch)
    mctx = single_device_ctx(cfg, "cpu")
    frames = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, cfg.encdec.n_frames, cfg.d_model)).astype(np.float32))
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 16), dtype=np.int32))
    logits = {}
    for impl in ("flash", "jnp"):
        api = ModelAPI(cfg.replace(attn_impl=impl), device="cpu")
        with torch.inference_mode():
            lg, cache = api.prefill(params, {"tokens": toks,
                                             "frames": frames}, mctx)
            cache = grow_cache(cache, cfg.family, 8)
            pos = torch.full((2,), 16, dtype=torch.int32)
            logits[impl], _ = api.decode(
                params, {"token": lg.argmax(-1).to(torch.int32), "pos": pos},
                cache, mctx)
    assert calls == []
    assert torch.equal(logits["flash"], logits["jnp"])


# ---------------------------------------------------------------------------
# (c) the op under a trace

def test_fake_decode_op_shapes_checks_and_flops():
    """Under FakeTensorMode the op makes out's shape and dtype, runs the
    kernel's argument checks, loads no library and counts no launch; its
    FLOP formula is 4 D a head a cached position, the plain path's
    einsums' count."""
    libs = dict(_build._libs)
    before = ops.launches()
    with FakeTensorMode():
        dev = torch.device("meta")
        q = torch.empty(96, 1, 32, 64, dtype=torch.bfloat16, device=dev)
        k = torch.empty(96, 1288, 8, 64, dtype=torch.bfloat16, device=dev)
        kv_len = torch.empty(96, dtype=torch.int32, device=dev)
        with FlopCounterMode(display=False) as fc:
            out = torch.ops.repro_torch.flash_decode(q, k, k, kv_len, 0.125)
        assert out.shape == q.shape and out.dtype == torch.bfloat16
        assert fc.get_total_flops() == 4 * 64 * 96 * 32 * 1288
        with pytest.raises(ValueError, match="groups of at most"):
            torch.ops.repro_torch.flash_decode(
                torch.empty(2, 1, 256, 64, dtype=torch.bfloat16, device=dev),
                k[:2], k[:2], kv_len[:2], 0.125)
        with pytest.raises(ValueError, match="bfloat16"):
            torch.ops.repro_torch.flash_decode(q.float(), k, k, kv_len, 0.1)
        with pytest.raises(ValueError, match="kv_len"):
            torch.ops.repro_torch.flash_decode(q, k, k, kv_len[:3], 0.1)
        with pytest.raises(RuntimeError, match="FakeTensor"):
            KD.flash_decode(q, k, k, kv_len, scale=0.125)
    assert _build._libs == libs
    assert ops.launches() == before


def test_dryrun_decode_trace_reaches_the_decode_op():
    """The dry-run's decode trace of a bf16 granite (head_dim 64) with
    "flash" passes through the op's fake implementation once a layer,
    with the plain path's FLOPs."""
    cfg = tiny_config("granite-3-2b").replace(
        attn_impl="flash", head_dim=64, compute_dtype="bfloat16")
    shape = ShapeConfig("tiny_decode", 48, 4, "decode")
    libs = dict(_build._libs)
    rec = dryrun.trace_cell(cfg, shape, nmb=1)
    plain = dryrun.trace_cell(cfg.replace(attn_impl="jnp"), shape, nmb=1)
    assert _build._libs == libs
    reached = {op for op in rec["flops_by_op"]
               if op.startswith("repro_torch.")}
    assert reached == {"repro_torch.flash_decode"}
    assert rec["flops_by_op"]["repro_torch.flash_decode"] == (
        4 * cfg.head_dim * shape.global_batch * cfg.n_heads * shape.seq_len
        * cfg.n_layers)
    assert rec["flops_per_device"] == plain["flops_per_device"]
