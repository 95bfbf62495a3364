"""The port's stream cipher on the CPU against the reference's, bit for bit.

The same seeded numpy inputs go through the reference's `stream_cipher`
(its Pallas kernel in interpret mode, as tests/test_kernels.py runs it)
and its oracle `cipher_ref`, and through the port's `stream_cipher`, which
on a CPU tensor runs the plain version `ref.stream_cipher_torch`. The
port's cipher also reproduces the storage path's inline crypto
(`core/smartnic.py InlineCrypto`) at block-absolute byte offsets, with the
nonce bits >= 32 folded into the key as the engine's nonces need.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.stream_cipher.ops import stream_cipher as ref_cipher
from repro.kernels.stream_cipher.ref import cipher_ref as ref_cipher_ref
from repro_torch.core.smartnic import KEYSTREAM_PAGE, InlineCrypto
from repro_torch.kernels.stream_cipher import ops, ref

M32 = 0xFFFFFFFF


def _words(seed, n):
    return np.random.default_rng(seed).integers(0, 2**32, n, dtype=np.uint32)


def _bytes(seed, n):
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8)


def _port(x, key, nonce, **kw):
    return ops.stream_cipher(torch.from_numpy(x), key, nonce, **kw).numpy()


@pytest.mark.parametrize("n", [4, 100, 4096, 8193])
def test_cipher_matches_reference_ops_and_oracle(n):
    """tests/test_kernels.py:254-259's shapes, key, nonce and block."""
    words = _words(n, n)
    got = _port(words, 0xC0FFEE, 42, block=512)
    want = np.asarray(ref_cipher(jnp.asarray(words), key=0xC0FFEE, nonce=42,
                                 block=512))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.asarray(ref_cipher_ref(jnp.asarray(words), 0xC0FFEE, 42)))
    np.testing.assert_array_equal(got, ref.cipher_ref(words, 0xC0FFEE, 42))


@pytest.mark.parametrize("n", [1, 3, 999, 1013])
def test_u8_values_match_reference(n):
    data = _bytes(n + 1, n)
    got = _port(data, 0xC0FFEE, 42)
    want = np.asarray(ref_cipher(jnp.asarray(data), key=0xC0FFEE, nonce=42))
    assert got.dtype == np.uint8 and got.shape == (n,)
    np.testing.assert_array_equal(got, want)


def test_block_does_not_change_the_result():
    words = _words(3, 5000)
    base = _port(words, 7, 9)
    for block in (1, 8, 128, 512, 2048, 8192):
        np.testing.assert_array_equal(_port(words, 7, 9, block=block), base)
    np.testing.assert_array_equal(
        np.asarray(ref_cipher(jnp.asarray(words), 7, 9, block=128)), base)
    with pytest.raises(ValueError, match="block"):
        _port(words, 7, 9, block=0)


def test_involution_and_nonce_change():
    """tests/test_kernels.py:262-271, with the values held against the
    reference's."""
    data = _bytes(7, 999)
    enc = _port(data, 1, 2)
    np.testing.assert_array_equal(
        enc, np.asarray(ref_cipher(jnp.asarray(data), key=1, nonce=2)))
    np.testing.assert_array_equal(_port(enc, 1, 2), data)
    enc2 = _port(data, 1, 3)
    np.testing.assert_array_equal(
        enc2, np.asarray(ref_cipher(jnp.asarray(data), key=1, nonce=3)))
    assert (enc != enc2).mean() > 0.9


def _fold(c: InlineCrypto, nonce: int) -> int:
    """The key the kernel takes for an engine nonce: InlineCrypto folds the
    nonce's bits >= 32 into its key (`_prf_words`)."""
    return int(c.key) ^ c._fmix32(nonce >> 32)


def _keystream_via_cipher(c: InlineCrypto, nonce: int, offset: int,
                          n: int) -> np.ndarray:
    """Bytes [offset, offset+n) of the (key, nonce) stream: byte offset % 4
    onward of the cipher over zeros, started at word offset // 4."""
    head = offset % 4
    zeros = np.zeros(head + n, np.uint8)
    out = _port(zeros, _fold(c, nonce), (nonce & M32) + offset // 4)
    return out[head:]


@pytest.mark.parametrize("nonce", [42, (4096 << 20) + 17, (1 << 40) + 3])
@pytest.mark.parametrize("n,offset", [
    (1, 0), (5, 3), (4096, 0), (1000, 4097),
    (300, KEYSTREAM_PAGE - 7),          # straddles a keystream page
    (2 * KEYSTREAM_PAGE + 11, 13),      # multi-page
])
def test_matches_inline_crypto_at_block_offsets(n, offset, nonce):
    """tests/test_zero_copy_path.py:44-52's offsets, against the port's
    InlineCrypto, with engine nonces (oid * 2^20 + block) below and above
    2^32."""
    c = InlineCrypto(0xC0FFEE)
    np.testing.assert_array_equal(
        _keystream_via_cipher(c, nonce, offset, n),
        c.keystream(n, nonce, offset))
    data = _bytes(n + offset, n)
    head = offset % 4
    padded = np.concatenate([np.zeros(head, np.uint8), data])
    got = _port(padded, _fold(c, nonce), (nonce & M32) + offset // 4)[head:]
    np.testing.assert_array_equal(got, c.apply(data, nonce, offset))


def test_empty_input_returns_the_oracles_value():
    """The reference's wrapper raises at n = 0 (a Pallas grid of no step);
    the port returns what the oracle gives, an empty stream."""
    for dt, jdt in ((np.uint8, jnp.uint8), (np.uint32, jnp.uint32)):
        with pytest.raises(TypeError):
            ref_cipher(jnp.zeros(0, jdt), 1, 2)
        got = ops.stream_cipher(np.zeros(0, dt), 1, 2, device="cpu")
        assert got.numel() == 0 and got.dtype == torch.from_numpy(
            np.zeros(0, dt)).dtype
    assert np.asarray(ref_cipher_ref(jnp.zeros(0, jnp.uint32), 1, 2)).size \
        == 0


def test_plain_version_keeps_every_bit_at_high_key_and_nonce():
    """2^20 words with key and nonce near 2^32 - 1, so the word counter
    wraps and any lost high bit of the int64 arithmetic would show."""
    words = _words(11, 1 << 20)
    for key, nonce in ((M32, M32), (M32 - 1, M32 - (1 << 19)),
                       ((1 << 32) + 5, (1 << 33) - 2)):
        got = ref.cipher_torch(torch.from_numpy(words), key, nonce).numpy()
        np.testing.assert_array_equal(got, ref.cipher_ref(words, key, nonce))
    np.testing.assert_array_equal(
        ref.cipher_ref(words[:4096], M32, M32),
        np.asarray(ref_cipher_ref(jnp.asarray(words[:4096]), M32, M32)))


def test_wrapper_shapes_dtypes_and_devices():
    words = _words(5, 60).reshape(6, 10)
    got = ops.stream_cipher(torch.from_numpy(words).t(), 3, 4)
    want = np.asarray(ref_cipher(jnp.asarray(words.T), 3, 4))
    assert got.shape == (60,) and got.dtype == torch.uint32
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(TypeError, match="uint8 or uint32"):
        ops.stream_cipher(torch.zeros(3), 1, 2)
    with pytest.raises(AssertionError):
        ref_cipher(jnp.zeros(3, jnp.float32), 1, 2)
    np.testing.assert_array_equal(
        ops.stream_cipher(words, 3, 4, device="cpu").numpy(),
        np.asarray(ref_cipher(jnp.asarray(words), 3, 4)))


def test_numpy_input_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ops.stream_cipher(_words(1, 8), 1, 2)


def test_cpu_tensor_takes_the_plain_version_and_counts_no_launch():
    ops.reset_launches()
    ops.stream_cipher(torch.from_numpy(_words(2, 100)), 1, 2)
    assert ops.launches() == {"cipher": 0}
