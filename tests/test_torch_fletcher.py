"""The port's Fletcher checksum on the CPU against the reference's, bit for
bit.

The same seeded numpy inputs go through the reference's
`fletcher_checksum` (its Pallas kernel in interpret mode, as
tests/test_kernels.py runs it) and its oracles `fletcher_ref` and
`fletcher_np`, and through the port's `fletcher_checksum`, which on a CPU
tensor runs the plain version `ref.fletcher_checksum_torch`. The packed
checksum also equals the storage engine's extent checksum
(`core/media.py fletcher64` / `checksum`).
"""
import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels.fletcher.ops import fletcher_checksum as ref_checksum
from repro.kernels.fletcher.ops import packed as ref_packed
from repro.kernels.fletcher.ref import fletcher_np as ref_fletcher_np
from repro.kernels.fletcher.ref import fletcher_ref as ref_fletcher_ref
from repro_torch.core import media
from repro_torch.kernels.fletcher import ops, ref


def _words(seed, n):
    return np.random.default_rng(seed).integers(0, 2**32, n, dtype=np.uint32)


def _bytes(seed, n):
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8)


def _port(x, **kw) -> np.ndarray:
    out = ops.fletcher_checksum(x, device="cpu", **kw)
    assert out.shape == (2,) and out.dtype == torch.uint32
    return out.numpy()


@pytest.mark.parametrize("n", [1, 7, 256, 2048, 2049, 10000])
def test_checksum_matches_reference_ops_and_oracle(n):
    """tests/test_kernels.py:212-218's shapes and block."""
    words = _words(n, n)
    got = _port(torch.from_numpy(words), block=256)
    np.testing.assert_array_equal(
        got, np.asarray(ref_checksum(jnp.asarray(words), block=256)))
    np.testing.assert_array_equal(
        got, np.asarray(ref_fletcher_ref(jnp.asarray(words))))
    np.testing.assert_array_equal(got, ref.fletcher_ref(words))


@pytest.mark.parametrize("n", [1, 3, 999, 1013])
def test_u8_matches_reference_and_numpy_bytes(n):
    data = _bytes(n, n)
    got = ops.fletcher_checksum(torch.from_numpy(data), block=128)
    want = ref_checksum(jnp.asarray(data), block=128)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert ops.packed(got) == ref_packed(want) == ref_fletcher_np(
        data.tobytes()) == ref.fletcher_np(data.tobytes())


def test_detects_corruption_and_order():
    words = np.arange(4096, dtype=np.uint32)
    base = ops.packed(ops.fletcher_checksum(torch.from_numpy(words)))
    flipped = words.copy()
    flipped[1234] ^= 1
    assert ops.packed(ops.fletcher_checksum(torch.from_numpy(flipped))) \
        != base
    swapped = words.copy()
    swapped[10], swapped[11] = swapped[11], swapped[10]
    assert ops.packed(ops.fletcher_checksum(torch.from_numpy(swapped))) \
        != base


def _dtype_inputs(name):
    """(reference array, port tensor) of 333 elements, the same bits."""
    if name == "uint8":
        x = _bytes(1, 333)
        return jnp.asarray(x), torch.from_numpy(x)
    f = np.array(jax.random.normal(jax.random.PRNGKey(0), (333,)),
                 np.float32)
    if name == "float32":
        return jnp.asarray(f), torch.from_numpy(f)
    if name == "bfloat16":
        bits = f.astype(ml_dtypes.bfloat16).view(np.uint16)
        return (jnp.asarray(f).astype(jnp.bfloat16),
                torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16))
    if name == "float16":
        h = f.astype(np.float16)
        return jnp.asarray(h), torch.from_numpy(h)
    i = (f * 1000).astype(np.int16)
    return jnp.asarray(i), torch.from_numpy(i)


@pytest.mark.parametrize("name", ["float32", "bfloat16", "uint8",
                                  "float16", "int16"])
def test_dtypes_match_reference_values(name):
    """tests/test_kernels.py:238-248 checks only the shape; here the
    values too. Narrow dtypes go through their little-endian bytes."""
    jx, tx = _dtype_inputs(name)
    assert np.array_equal(np.asarray(jx).view(np.uint8),
                          tx.view(torch.uint8).numpy())
    np.testing.assert_array_equal(_port(tx), np.asarray(ref_checksum(jx)))


@pytest.mark.parametrize("dtype", [np.float64, np.int64])
def test_eight_byte_elements_give_two_words_low_half_first(dtype):
    """JAX without x64 has no 8-byte dtype, so these are held against the
    oracle over the bytes and over the u32 words of memory order."""
    x = (np.random.default_rng(4).standard_normal(77) * 1e6).astype(dtype)
    got = _port(torch.from_numpy(x))
    words = x.view(np.uint32)
    assert words[0] == x.view(np.uint64)[0] & 0xFFFFFFFF
    np.testing.assert_array_equal(got, ref.fletcher_ref(words))
    assert ops.packed(torch.from_numpy(got)) == ref.fletcher_np(x.tobytes())


def test_block_does_not_change_the_result():
    words = _words(3, 5000)
    base = _port(torch.from_numpy(words))
    for block in (1, 8, 128, 256, 2048, 8192):
        np.testing.assert_array_equal(
            _port(torch.from_numpy(words), block=block), base)
    np.testing.assert_array_equal(
        np.asarray(ref_checksum(jnp.asarray(words), block=128)), base)
    with pytest.raises(ValueError, match="block"):
        _port(torch.from_numpy(words), block=0)


@pytest.mark.parametrize("n", [0, 1, 3, 4, 100, 4096, 8193])
def test_packed_equals_the_engine_checksum(n):
    """tests/test_sg_data_path.py:358-362's lengths, against the port's
    media.fletcher64 and media.checksum."""
    data = _bytes(n + 2, n).tobytes()
    got = ops.packed(ops.fletcher_checksum(
        np.frombuffer(data, np.uint8), device="cpu"))
    assert got == media.fletcher64(data) == media.checksum(data)
    assert got == ref_fletcher_np(data)


def test_empty_input_returns_the_oracles_value():
    """The reference's wrapper raises at n = 0 (a Pallas grid of no step);
    the port returns [0, 0], as the oracles and media.fletcher64 do."""
    with pytest.raises(TypeError):
        ref_checksum(jnp.zeros(0, jnp.uint8))
    for dt in (np.uint8, np.uint32, np.float32):
        np.testing.assert_array_equal(_port(np.zeros(0, dt)), [0, 0])
    np.testing.assert_array_equal(
        np.asarray(ref_fletcher_ref(jnp.zeros(0, jnp.uint32))), [0, 0])
    assert media.fletcher64(b"") == ref.fletcher_np(b"") == 0


def test_plain_version_keeps_every_bit_at_2_20_words():
    """2^20 words, the top 2^16 all 2^32 - 1, so every product (N - i) w_i
    is near 2^64 and any lost high bit of the int64 arithmetic would
    show."""
    words = _words(13, 1 << 20)
    words[-(1 << 16):] = 0xFFFFFFFF
    got = ref.fletcher_torch(torch.from_numpy(words)).numpy()
    np.testing.assert_array_equal(got, ref.fletcher_ref(words))
    assert ops.packed(torch.from_numpy(got)) == ref.fletcher_np(
        words.tobytes()) == media.fletcher64(words.view(np.uint8))


def test_non_contiguous_input_is_read_in_logical_order():
    words = _words(6, 600).reshape(20, 30)
    np.testing.assert_array_equal(
        _port(torch.from_numpy(words).t()),
        np.asarray(ref_checksum(jnp.asarray(words.T))))


def test_numpy_input_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ops.fletcher_checksum(_words(1, 8))


def test_cpu_tensor_takes_the_plain_version_and_counts_no_launch():
    ops.reset_launches()
    ops.fletcher_checksum(torch.from_numpy(_words(2, 100)))
    assert ops.launches() == {"checksum": 0}
