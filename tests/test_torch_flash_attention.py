"""The port's flash attention against the reference on the CPU.

On a CPU tensor `repro_torch`'s `flash_attention` runs its plain PyTorch
version; the reference's runs its Pallas kernel in interpret mode, as
tests/test_kernels.py runs it. Inputs are made from a seed with numpy and
handed to both. Tolerances are the reference's own
(tests/test_kernels.py:56): 2e-5 in float32, 2e-2 in bfloat16.
"""
import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.flash_attention.ops import flash_attention as jflash
from repro.kernels.flash_attention.ref import attention_ref as jref
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models import layers as L

CASES = [
    (1, 128, 128, 4, 4, 64, True, None, None),      # MHA causal
    (2, 128, 128, 4, 2, 64, True, None, None),      # GQA
    (1, 256, 256, 4, 1, 64, True, None, None),      # MQA
    (1, 256, 256, 2, 2, 64, True, 64, None),        # local window
    (1, 128, 128, 2, 2, 64, True, None, 30.0),      # softcap
    (1, 128, 128, 2, 2, 64, False, None, None),     # full (non-causal)
    (1, 100, 100, 2, 2, 64, True, None, None),      # non-multiple T/S
    (1, 128, 128, 2, 2, 128, True, None, None),     # head_dim 128
]
DTYPES = {"float32": (np.float32, torch.float32, jnp.float32, 2e-5),
          "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16, jnp.bfloat16,
                       2e-2)}


def _inputs(seed, B, T, S, H, KH, D, np_dtype):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape, np.float32).astype(np_dtype)
            for shape in ((B, T, H, D), (B, S, KH, D), (B, S, KH, D))]


def _torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("B,T,S,H,KH,D,causal,window,softcap", CASES)
def test_flash_matches_reference_kernel(B, T, S, H, KH, D, causal, window,
                                        softcap, dtype):
    """Port (plain version) vs the reference's Pallas kernel (interpret)."""
    np_dt, _, _, tol = DTYPES[dtype]
    q, k, v = _inputs(B * 1000 + T + H * 7 + D, B, T, S, H, KH, D, np_dt)
    got = ops.flash_attention(_torch(q), _torch(k), _torch(v), causal=causal,
                              window=window, softcap=softcap, block_q=64,
                              block_k=64)
    want = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  causal=causal, window=window, softcap=softcap, block_q=64,
                  block_k=64)
    assert got.dtype == _torch(q).dtype and got.shape == (B, T, H, D)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("B,T,S,H,KH,D,causal,window,softcap", CASES)
def test_flash_out_and_lse_match_attention_ref(B, T, S, H, KH, D, causal,
                                               window, softcap, dtype):
    """out and lse against the port's and the reference's attention_ref."""
    np_dt, _, _, tol = DTYPES[dtype]
    q, k, v = _inputs(7 + T + D, B, T, S, H, KH, D, np_dt)
    kw = dict(causal=causal, window=window, softcap=softcap)
    out, lse = ops.flash_attention(_torch(q), _torch(k), _torch(v),
                                   block_q=64, block_k=64, return_lse=True,
                                   **kw)
    assert lse.dtype == torch.float32 and lse.shape == (B, H, T)
    ref_out, ref_lse = attention_ref(_torch(q), _torch(k), _torch(v),
                                     return_lse=True, **kw)
    j_out, j_lse = jref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        return_lse=True, **kw)
    for want_out, want_lse in ((ref_out, ref_lse), (j_out, j_lse)):
        np.testing.assert_allclose(_f32(out), _f32(want_out), atol=tol,
                                   rtol=tol)
        np.testing.assert_allclose(_f32(lse), _f32(want_lse), atol=tol,
                                   rtol=tol)


def test_flash_matches_model_attention():
    """The flash path matches the model-side chunked online-softmax
    attention (tests/test_kernels.py:62-75)."""
    B, T, H, KH, D = 2, 128, 4, 2, 64
    q, k, v = (_torch(a) for a in _inputs(3, B, T, T, H, KH, D, np.float32))
    pos = torch.arange(T)
    model = L.attention(q, k, v, q_positions=pos, kv_positions=pos,
                        causal=True)
    kern = ops.flash_attention(q, k, v, causal=True, block_q=64, block_k=64)
    np.testing.assert_allclose(kern.numpy(), model.numpy(), atol=2e-5,
                               rtol=2e-5)
    assert torch.equal(L.attention(q, k, v, q_positions=pos,
                                   kv_positions=pos, impl="flash"),
                       ops.flash_attention(q, k, v))


def test_flash_counts_no_launch_on_the_cpu():
    ops.reset_launches()
    q, k, v = (_torch(a) for a in _inputs(4, 1, 16, 16, 2, 1, 64,
                                          np.float32))
    ops.flash_attention(q, k, v)
    assert ops.launches() == {"fwd": 0, "bwd": 0, "bwd_softcap": 0,
                              "decode": 0, "decode_plain": 0}
