"""The partition of the `fletcher` kernel (`csrc/fletcher.cu`) on the CPU,
against the reference.

A call is one kernel: a grid of ceil(chunks / (2 x FLETCHER_THREADS))
CTAs of FLETCHER_THREADS threads, at most 132 x 8 (grid-stride beyond),
each thread up to FLETCHER_UNROLL uint4 loads at a time; the n_bytes % 16
tail is a
word a thread, and a start that is not 16-byte aligned goes word by word
from its bytes. A warp folds its sums by shuffles, warp 0 folds the CTA's
warps, and each CTA adds its pair into an output pair that holds zeros
(the wrapper's pool). The kernel runs only on the card, so
`_emulation` below walks the same loops in numpy, reading the sizes from
the source: which words each (CTA, thread, slot) takes and with which
weight, each thread's [s1, s2] in uint32 arithmetic, and the folds. Every
word must be taken exactly once, and the folded sums must equal, bit for
bit, the reference's `fletcher_checksum` (its Pallas kernel in interpret
mode, as tests/test_kernels.py runs it) and `fletcher_ref`.
tests/test_torch_cuda.py holds the kernel itself against the plain
version on the card.
"""
import re
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp

from repro.kernels.fletcher.ops import fletcher_checksum as ref_checksum
from repro.kernels.fletcher.ref import fletcher_ref as ref_fletcher_ref
from repro_torch.kernels.fletcher import kernel as K
from repro_torch.kernels.fletcher import ref

SRC = (Path(K.__file__).resolve().parents[2] / "csrc" /
       "fletcher.cu").read_text()
THREADS = int(re.search(r"#define FLETCHER_THREADS (\d+)", SRC).group(1))
UNROLL = int(re.search(r"#define FLETCHER_UNROLL (\d+)", SRC).group(1))
PER_THREAD = int(re.search(r"per_cta = (\d+) \* FLETCHER_THREADS",
                           SRC).group(1))   # items a thread the grid is cut to
GRID_CAP = int(np.prod([int(v) for v in re.search(
    r"if \(blocks > (\d+) \* (\d+)\)", SRC).groups()]))
FULL = GRID_CAP * THREADS * PER_THREAD * 16   # where the grid stops growing
PASS = GRID_CAP * THREADS * UNROLL * 16       # a pass of the full grid
MiB = 1 << 20


def _launch(n_bytes: int, start: int) -> tuple:
    """(CTAs, vec) as the C entry `fletcher` launches a stream of n_bytes
    that starts `start` bytes past a 16-byte boundary."""
    vec = start % 16 == 0
    items = (n_bytes + 15) // 16 if vec else (n_bytes + 3) // 4
    return min(-(-items // (PER_THREAD * THREADS)), GRID_CAP), vec


def _word_at(data: np.ndarray, i: np.ndarray) -> np.ndarray:
    """word_at: word i from its bytes, the bytes past the end read as 0."""
    w = np.zeros(i.shape, np.uint32)
    for b in range(4):
        p = 4 * i + b
        live = p < data.size
        w[live] |= data[p[live]].astype(np.uint32) << np.uint32(8 * b)
    return w


def _emulation(data: np.ndarray, start: int = 0) -> tuple:
    """([s1, s2] u32 as the kernel folds them into a pair of zeros, times
    each word is taken, the loop passes a thread makes) of the u8 stream
    `data`."""
    ctas, vec = _launch(data.size, start)
    n_bytes, n_words = data.size, (data.size + 3) // 4
    n32 = np.uint32(n_words & 0xFFFFFFFF)
    step = ctas * THREADS
    tid = np.arange(step, dtype=np.int64)
    s1 = np.zeros(step, np.uint32)
    s2 = np.zeros(step, np.uint32)
    taken = np.zeros(n_words, np.int64)
    passes = 0
    first_tail = 0
    with np.errstate(over="ignore"):
        if vec:
            nchunk = n_bytes // 16
            c0 = tid.copy()
            while (c0 < nchunk).any():          # for (c0 = tid; c0 < nchunk;
                passes += 1                     #      c0 += UNROLL * step)
                for u in range(UNROLL):
                    c = c0 + u * step
                    live = (c0 < nchunk) & (c < nchunk)
                    wt = n32 - (c[live] * 4).astype(np.uint32)
                    for j in range(4):          # .x .y .z .w
                        idx = 4 * c[live] + j
                        w = _word_at(data, idx)
                        s1[live] += w
                        s2[live] += w * (wt - np.uint32(j))
                        np.add.at(taken, idx, 1)
                c0 += UNROLL * step
            first_tail = nchunk * 4
        i = first_tail + tid                    # the tail, a word a thread
        while (i < n_words).any():
            live = i < n_words
            w = _word_at(data, i[live])
            s1[live] += w
            s2[live] += w * (n32 - i[live].astype(np.uint32))
            np.add.at(taken, i[live], 1)
            i += step
        # warps by shuffles, warp 0 over a CTA's warps, then each CTA's
        # atomicAdd into the pair of zeros
        pair = np.stack([s1, s2]).reshape(2, ctas, THREADS // 32, 32)
        warp = pair.sum(axis=3, dtype=np.uint32)
        cta = warp.sum(axis=2, dtype=np.uint32)
        out = np.zeros(2, np.uint32) + cta.sum(axis=1, dtype=np.uint32)
    return out, taken, passes


def _reference(data: np.ndarray) -> np.ndarray:
    """[s1, s2] of the reference's wrapper (Pallas, interpret mode), held
    against its oracle and the port's."""
    padded = np.concatenate([data, np.zeros((-data.size) % 4, np.uint8)])
    want = np.asarray(ref_fletcher_ref(jnp.asarray(padded.view(np.uint32))))
    np.testing.assert_array_equal(
        np.asarray(ref_checksum(jnp.asarray(data), block=8192)), want)
    np.testing.assert_array_equal(
        ref.fletcher_ref(padded.view(np.uint32)), want)
    return want


def _data(seed: int, n: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8)


@pytest.mark.parametrize("n_bytes", [
    4, 28,                               # n = 1, 7 words
    MiB,                                 # the engine's extent
    FULL - 4, FULL, FULL + 4,            # the grid's last size, ± 1 word
    4099, MiB + 3])                      # ragged u8
def test_partition_covers_every_word_once_and_matches_reference(n_bytes):
    data = _data(n_bytes, n_bytes)
    got, taken, passes = _emulation(data)
    assert (taken == 1).all(), f"words taken {np.unique(taken)} times"
    np.testing.assert_array_equal(got, _reference(data))
    if n_bytes <= FULL:
        # up to the full grid, one pass (none below 16 bytes): every load
        # of the stream issued at once
        assert passes == (n_bytes >= 16)


@pytest.mark.parametrize("n_bytes,start", [
    (9001, 1), (9001, 2), (9001, 3), (9001, 4), (MiB, 3), (FULL + 3, 1)])
def test_byte_path_of_misaligned_starts(n_bytes, start):
    """A view 1-3 bytes into a word (or 4, a word but not 16 bytes in)
    goes word by word from its bytes."""
    buf = _data(start + n_bytes, start + n_bytes + 16)
    data = buf[start:start + n_bytes]
    got, taken, _ = _emulation(data, start)
    assert (taken == 1).all()
    np.testing.assert_array_equal(got, _reference(data))


def test_grid_stride_past_the_full_grid():
    """Past 132 x 8 CTAs the grid stops growing and each thread takes
    UNROLL chunks a pass, then more passes."""
    n_bytes = 2 * PASS + 20
    data = _data(7, n_bytes)
    got, taken, passes = _emulation(data)
    assert (taken == 1).all() and passes == 3
    padded = np.concatenate([data, np.zeros((-data.size) % 4, np.uint8)])
    np.testing.assert_array_equal(got, ref.fletcher_ref(padded.view(
        np.uint32)))
