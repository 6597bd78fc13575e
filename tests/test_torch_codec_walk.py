"""The walk of the wire codec and server decode kernels
(``pack_kernel.codec_walk``), on the CPU.

``pack_flat``/``unpack_flat`` walk the words in V-groups: group j is
words ``[j*V, j*V + V)`` and, for each field f, the levels ``[f*W + j*V,
+ V)``; V is 2 where 2 words divide W, n and both operands' addresses,
else 1, and a thread walks GROUPS groups. The C entries mirror
``codec_walk``; chip_smoke.py phase 3 holds the two against each other on
the card. Here:

  * ``codec_walk`` picks V and the grid at the paper's round (10-bit, V =
    2, 73 blocks), at 16 bits (W odd, V = 1) and for views at word
    offsets 0 to 3;
  * at every width 1..16, W odd, W = 2 and W = 0 (mod 4) (in one block
    and in three), n = 1, k*W - 1 and k*W, and offsets 0 to 3, the walk
    covers each word and each coordinate below n exactly once, and plain
    versions that follow it (``pack_flat_walk``, ``unpack_flat_walk``
    below) equal ``wire.pack_bits``/``unpack_bits``, out-of-range levels
    and every word bit pattern included;
  * the walk's plain versions equal the reference's Pallas
    ``pack_flat``/``unpack_flat`` in interpret mode, and its jnp codec;
  * ``unpack_decode_apply`` takes the same walk over three operands (its
    C entry held against ``codec_walk`` on the card), and
    ``decode_apply_sum`` the walk of one field a word, SUM_GROUPS
    coordinates a thread: ``codec_walk`` picks V and the grid of the
    decode at the paper's round, at 16 bits, at odd W, at offsets 0 to 3
    of each operand and at n = 1; a plain version that follows each walk
    (``decode_walk_twin``) stores every coordinate below n and equals the
    entry's plain version and the reference's jnp ``decode_apply_sum``,
    bit for bit;
  * the folded ``decode_apply`` takes the dense walk too, FOLDED_GROUPS
    V-groups a thread, V 2 or 1 as ``folded_walk`` picks it from n and
    the three addresses (its C entry held against it on the card): the
    walk covers each coordinate once, and a plain version that follows it
    (``folded_walk_twin``) equals ``decode_apply_ref`` in float32 and
    bfloat16.
"""
import torch_threads  # noqa: F401  (first: pins torch's CPU threads)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import wire as jwire
from repro.core.grid import RQMParams as JaxRQMParams
from repro.kernels import decode_apply_kernel as jdecode
from repro.kernels import pack_kernel as jpack
from repro_torch.core import wire
from repro_torch.core.grid import RQMParams
from repro_torch.kernels.decode_apply_kernel import (
    FOLDED_GROUPS,
    INT_MAX,
    decode_apply_plain,
    decode_apply_ref,
    folded_walk,
)
from repro_torch.kernels.pack_kernel import (
    GROUPS,
    THREADS,
    codec_walk,
    unpack_decode_apply_plain,
)

_U32 = 0xFFFFFFFF
# one block and three (GROUPS * THREADS = 512 groups a block)
WORD_COUNTS = {"W odd": (7, 1031), "W = 2 mod 4": (10, 1030), "W = 0 mod 4": (12, 1032)}
OFFSETS = range(4)  # a view's start, in words past an aligned address
SUM_GROUPS = 4  # coordinates a thread of decode_apply_sum (csrc/decode_apply.cu: kSumGroups)


def _view(values: np.ndarray, offset: int) -> torch.Tensor:
    """``values`` as an int32 view ``offset`` words into a fresh buffer."""
    buf = torch.zeros(len(values) + offset, dtype=torch.int32)
    buf[offset:] = torch.from_numpy(values.astype(np.int32))
    return buf[offset:]


def _field_counts(bits: int):
    """(n, W) for each word count: n = 1, k*W - 1 and k*W fields."""
    k = wire.fields_per_word(bits)
    return [(n, w) for ws in WORD_COUNTS.values() for w in ws for n in (1, k * w - 1, k * w)]


def walk_owners(n: int, n_words: int, bits: int, v: int, groups: int = GROUPS):
    """The walk's index sets at width ``v``, one row a group, thread by
    thread (thread i of block b walks groups ``(b * groups + g) * THREADS
    + i``, g < groups, those below ``n_words / v``): ``(words, coords,
    live)``, the (J, v) words of each group, the (J, k, v) coordinates of
    their k = 32 // bits fields, and (J, k) whether field f of a group is
    below ``n`` (the kernels test its first coordinate). ``bits`` = 32 is
    the dense sum, one field a word."""
    if n_words % v or n % v:
        raise ValueError(f"width {v} does not divide {n_words} words and {n} fields")
    k = 32 // bits
    t = torch.arange(-(-(n_words // v) // (THREADS * groups)) * THREADS)
    group = (t[:, None] // THREADS * groups + torch.arange(groups)) * THREADS + \
        (t % THREADS)[:, None]
    words = group[group < n_words // v][:, None] * v + torch.arange(v)
    coords = torch.arange(k)[None, :, None] * n_words + words[:, None, :]
    return words, coords, coords[:, :, 0] < n


def pack_flat_walk(z: torch.Tensor, bits: int, v: int) -> torch.Tensor:
    """Plain version of ``pack_flat`` that follows the kernel's walk: per
    group and field, ``v`` levels, or 0 at or past n; shifted and added
    as uint32."""
    z = z.reshape(-1).to(torch.int64)
    n = z.numel()
    n_words = wire.packed_words(n, bits)
    words, coords, live = walk_owners(n, n_words, bits, v)
    fields = torch.where(live[..., None], z[coords.clamp(max=n - 1)] & _U32, 0)
    shifts = torch.arange(fields.shape[1])[None, :, None] * bits
    out = torch.empty(n_words, dtype=torch.int64)
    out[words] = ((fields << shifts) & _U32).sum(1) & _U32
    return wire.to_int32(out)


def unpack_flat_walk(words: torch.Tensor, bits: int, n: int, v: int,
                     groups: int = GROUPS) -> torch.Tensor:
    """Plain version of ``unpack_flat`` that follows the kernel's walk: per
    group ``v`` words read, and per field below n ``v`` levels stored. A
    coordinate no group stores reads -1."""
    u = words.reshape(-1).to(torch.int64) & _U32
    owned, coords, live = walk_owners(n, u.numel(), bits, v, groups)
    shifts = torch.arange(coords.shape[1])[None, :, None] * bits
    fields = (u[owned][:, None, :] >> shifts) & ((1 << bits) - 1)
    z = torch.full((n,), -1, dtype=torch.int64)
    z[coords[live]] = fields[live]
    return z.to(torch.int32)


@pytest.mark.parametrize("n,n_words,bits,addrs,want", [
    (222_030, 74_010, 10, (0, 512), (2, 73)),    # the paper's round
    (222_030, 111_015, 16, (0, 512), (1, 217)),  # secagg.pack_levels' 16-bit lanes
    (6000, 2000, 10, (1024, 0), (2, 2)),         # 16-byte aligned: still 2 words
    (6000, 2000, 10, (1028, 0), (1, 4)),         # offset 1 word
    (6000, 2000, 10, (1032, 0), (2, 2)),         # offset 2 words
    (6000, 2000, 10, (1036, 0), (1, 4)),         # offset 3 words
    (6000, 2000, 10, (0, 1032), (2, 2)),         # the other operand's offset counts too
    (5999, 2000, 10, (0, 0), (1, 4)),            # n odd
    (6002, 2001, 10, (0, 0), (1, 4)),            # W odd
    (1, 1, 16, (0, 0), (1, 1)),
    (512 * 4 * 3, 512 * 4, 10, (0, 0), (2, 2)),  # W = 0 mod 4
    (512 * 4 * 3 + 3, 512 * 4 + 1, 10, (0, 0), (1, 5)),
], ids=str)
def test_codec_walk_picks_the_widest_aligned_width(n, n_words, bits, addrs, want):
    assert codec_walk(n, n_words, bits, addrs) == want


def test_codec_walk_rejects_what_the_kernels_cannot_index():
    with pytest.raises(ValueError, match="k \\* n_words"):
        codec_walk(1, 1 << 30, 10, (0, 0))  # 3 * 2**30 field indices
    assert codec_walk(1, (1 << 30) - 1, 16, (0, 0))[0] == 1
    with pytest.raises(ValueError, match="packable field width"):
        codec_walk(4, 1, 17, (0, 0))
    with pytest.raises(ValueError, match="width 2 does not divide"):
        walk_owners(3, 2, 10, 2)


@pytest.mark.parametrize("bits", range(1, 17))
def test_walk_covers_each_word_and_coordinate_once(bits):
    """Every word is in one group of one thread, every coordinate below n
    is in one live group, and no live group reaches n."""
    for n, n_words in _field_counts(bits):
        # a view's offset reaches the walk only through V
        for v, blocks in {codec_walk(n, n_words, bits, (4 * o, 0)) for o in OFFSETS}:
            per_block = THREADS * GROUPS * v
            assert blocks * per_block >= n_words > (blocks - 1) * per_block
            words, coords, live = walk_owners(n, n_words, bits, v)
            assert torch.equal(torch.bincount(words.reshape(-1), minlength=n_words),
                               torch.ones(n_words, dtype=torch.int64))
            stored = coords[live].reshape(-1)
            assert int(stored.max()) < n
            assert torch.equal(torch.bincount(stored, minlength=n),
                               torch.ones(n, dtype=torch.int64))
            assert bool((coords[~live] >= n).all())


@pytest.mark.parametrize("bits", range(1, 17))
def test_walk_twins_match_the_codec(bits):
    """At each width, word count, field count and view offset, with V as
    ``codec_walk`` picks it for the view's address: levels in range, out
    of range (any int32) and the top field set pack as ``wire.pack_bits``
    does; any word bit pattern unpacks as ``wire.unpack_bits`` does. A
    twin's result depends on the view only through V, so each V is
    checked once."""
    rng = np.random.default_rng(bits)
    for n, n_words in _field_counts(bits):
        levels = {"in range": rng.integers(0, 1 << bits, n),
                  "any int32": rng.integers(-(1 << 31), 1 << 31, n),
                  "top field": np.full(n, (1 << bits) - 1)}
        words_in = rng.integers(-(1 << 31), 1 << 31, n_words)
        seen = set()
        for offset in OFFSETS:
            for what, values in levels.items():
                z = _view(values, offset)
                out = torch.empty(wire.packed_words(n, bits), dtype=torch.int32)
                v, _ = codec_walk(n, out.numel(), bits, (z.data_ptr(), out.data_ptr()))
                if (what, v) not in seen:
                    seen.add((what, v))
                    assert torch.equal(pack_flat_walk(z, bits, v),
                                       wire.pack_bits(z, bits)), (what, n, offset, v)
            words = _view(words_in, offset)
            out = torch.empty(n, dtype=torch.int32)
            v, _ = codec_walk(n, n_words, bits, (words.data_ptr(), out.data_ptr()))
            if ("words", v) in seen:
                continue
            seen.add(("words", v))
            got = unpack_flat_walk(words, bits, n, v)
            assert torch.equal(got, wire.unpack_bits(words, bits, n)), (n, offset, v)
            k = wire.fields_per_word(bits)
            if n == k * n_words:  # a round trip, the bits past the top field cleared
                assert torch.equal(pack_flat_walk(got, bits, v),
                                   wire.to_int32(words.to(torch.int64) & ((1 << k * bits) - 1)))


# W = 128 words take the reference's Pallas bodies, other counts its jnp codec
@pytest.mark.parametrize("bits,n", [(10, 384), (10, 383), (16, 256), (1, 32 * 128),
                                    (7, 4 * 128 - 2), (10, 30)], ids=str)
def test_walk_twins_match_the_reference(bits, n):
    z = np.random.default_rng(n).integers(0, 1 << bits, n).astype(np.int32)
    if bits == 16:
        z[:] = (1 << 16) - 1  # the top field sets the sign bit
    zt = torch.from_numpy(z)
    n_words = wire.packed_words(n, bits)
    v, _ = codec_walk(n, n_words, bits, (0, 0))
    words = pack_flat_walk(zt, bits, v)
    want = np.asarray(jpack.pack_flat(jnp.asarray(z), bits, interpret=True))
    np.testing.assert_array_equal(words.numpy(), want)
    np.testing.assert_array_equal(words.numpy(),
                                  np.asarray(jwire.pack_bits(jnp.asarray(z), bits)))
    back = unpack_flat_walk(words, bits, n, v)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jpack.unpack_flat(jnp.asarray(want), bits, n, interpret=True)))
    np.testing.assert_array_equal(back.numpy(), z)


# the reference's contract: float32 scalars of Python doubles (c=0.02,
# m=16, a cohort of 40, lr 0.5: the paper's round)
DECODE_PARAMS, DECODE_PARAMS_J = (RQMParams(c=0.02, delta=0.02, m=16, q=0.42),
                                  JaxRQMParams(c=0.02, delta=0.02, m=16, q=0.42))
COHORT, LR = 40, 0.5


def decode_walk_twin(w: torch.Tensor, z: torch.Tensor, bits: int, v: int,
                     groups: int) -> torch.Tensor:
    """Plain version of ``unpack_decode_apply`` (``z`` the words of
    ``bits``-bit fields) or, at ``bits`` = 32, ``decode_apply_sum`` (``z``
    the dense sum) that follows the kernels' walk: the levels as
    ``unpack_flat_walk`` reads them (-1 where no group stores one, which
    decodes to no level's value), decoded and applied by
    ``decode_apply_plain``'s expression."""
    levels = unpack_flat_walk(z, bits, w.numel(), v, groups)
    return decode_apply_plain(w, levels, DECODE_PARAMS, COHORT, LR)


@pytest.mark.parametrize("n,n_words,bits,addrs,want", [
    (222_030, 74_010, 10, (0, 1024, 2048), (2, 73)),    # the paper's round
    (222_030, 111_015, 16, (0, 1024, 2048), (1, 217)),  # 16 bits: W odd
    (222_031, 74_011, 10, (0, 1024, 2048), (1, 145)),   # n and W odd
    (222_029, 74_010, 10, (0, 1024, 2048), (1, 145)),   # n odd
    (6000, 2000, 10, (1028, 0, 0), (1, 4)),             # w 1 word off
    (6000, 2000, 10, (0, 1032, 0), (2, 2)),             # the words 2 words off: 8-byte aligned
    (6000, 2000, 10, (0, 0, 1036), (1, 4)),             # the output 3 words off
    (1, 1, 10, (0, 0, 0), (1, 1)),
], ids=str)
def test_decode_walk_picks_v_and_grid(n, n_words, bits, addrs, want):
    """unpack_decode_apply's walk, between w, the words and the output."""
    assert codec_walk(n, n_words, bits, addrs) == want


@pytest.mark.parametrize("bits,n,levels", [
    (10, 222_030, "round"),   # the paper's round: W = 74,010
    (10, 6299, "round"),      # n odd, W = 2100: several blocks
    (10, 6301, "round"),      # W = 2101 odd
    (16, 4101, "top"),        # W = 2051 odd, every field 2^16 - 1 (the sign bit)
    (1, 32 * 70 - 5, "round"),
    (10, 1, "round"),
    (32, 222_030, "round"),   # decode_apply_sum: the dense sum
    (32, 2 * THREADS * SUM_GROUPS + 5, "round"),
    (32, 1, "round"),
], ids=str)
def test_decode_walk_twins_match_plain_and_reference(bits, n, levels):
    """The decode kernels' walk stores every coordinate below n: its plain
    twin equals the entry's plain version and the reference's
    jnp ``decode_apply_sum`` (packed at ``bits`` <= 16, dense at 32) bit
    for bit, at each V that ``codec_walk`` picks for views 0 to 3 words
    off (each V once)."""
    rng = np.random.default_rng(n + bits)
    w = torch.from_numpy(rng.normal(0, 0.05, n).astype(np.float32))
    top = (1 << min(bits, 16)) - 1
    z = torch.from_numpy((np.full(n, top) if levels == "top" else
                          rng.integers(0, min(COHORT * 15, top) + 1, n)).astype(np.int32))
    if bits == 32:
        want = decode_apply_plain(w, z, DECODE_PARAMS, COHORT, LR)
        ref = jdecode.decode_apply_sum(jnp.asarray(w.numpy()), jnp.asarray(z.numpy()),
                                       DECODE_PARAMS_J, COHORT, LR)
        assert torch.equal(decode_walk_twin(w, z, 32, 1, SUM_GROUPS), want)
    else:
        words = wire.pack_bits(z, bits)
        want = unpack_decode_apply_plain(w, words, DECODE_PARAMS, COHORT, LR, pack_bits=bits)
        ref = jdecode.decode_apply_sum(jnp.asarray(w.numpy()), jnp.asarray(words.numpy()),
                                       DECODE_PARAMS_J, COHORT, LR, pack_bits=bits)
        widths = {codec_walk(n, words.numel(), bits, (4 * o, 0, 0))[0] for o in OFFSETS}
        for v in widths:
            assert torch.equal(decode_walk_twin(w, words, bits, v, GROUPS), want), v
    np.testing.assert_array_equal(want.numpy(), np.asarray(ref))


@pytest.mark.parametrize("n,bf16,addrs,want", [
    (222_030, False, (0, 1024, 2048), (2, 109)),  # the CNN: V = 2, 109 blocks
    (222_030, True, (0, 1024, 2048), (2, 109)),
    (222_029, False, (0, 1024, 2048), (1, 217)),  # n odd
    (222_030, False, (4, 0, 4), (1, 217)),        # w and out 1 float off
    (222_030, True, (4, 0, 4), (2, 109)),         # w and out 2 bfloat16 off: 4-byte aligned
    (222_030, True, (2, 0, 0), (1, 217)),         # w 1 bfloat16 off
    (222_030, True, (0, 4, 0), (1, 217)),         # the sum 1 int off
    (1, False, (0, 0, 0), (1, 1)),
    (INT_MAX - 2048, False, (0, 0, 0), (1, 2_097_150)),
], ids=str)
def test_folded_walk_picks_v_and_grid(n, bf16, addrs, want):
    """decode_apply's walk, between w, the sum and the output."""
    assert folded_walk(n, bf16, addrs) == want


def test_folded_walk_refuses_what_the_kernel_cannot_index():
    for n in (0, -1, INT_MAX - 2047):
        with pytest.raises(ValueError, match="coordinates"):
            folded_walk(n, False, (0, 0, 0))


def folded_walk_twin(w: torch.Tensor, z: torch.Tensor, v: int) -> torch.Tensor:
    """Plain version of ``decode_apply`` that follows its kernel's walk:
    each coordinate a live group owns is decoded by ``decode_apply_ref``'s
    expression; one that no group owns stays NaN."""
    n = w.numel()
    _, coords, live = walk_owners(n, n, 32, v, FOLDED_GROUPS)
    stored = coords[live].reshape(-1)
    out = torch.full_like(w, float("nan"))
    out[stored] = decode_apply_ref(w[stored], z[stored], DECODE_PARAMS, COHORT, LR)
    return out


@pytest.mark.parametrize("n", [1, FOLDED_GROUPS * THREADS - 1, FOLDED_GROUPS * THREADS + 1,
                               70_001, 2 * FOLDED_GROUPS * THREADS, 70_000])
def test_folded_walk_covers_each_coordinate_once_and_matches_ref(n):
    """At each V that ``folded_walk`` picks for views 0 to 3 elements off,
    in float32 and bfloat16: every coordinate below n is in one live
    group, the grid is the least that covers n, and the walk's twin equals
    ``decode_apply_ref`` bit for bit."""
    rng = np.random.default_rng(n)
    w32 = torch.from_numpy(rng.normal(0, 0.05, n).astype(np.float32))
    z = torch.from_numpy(rng.integers(0, COHORT * 15 + 1, n).astype(np.int32))
    for dtype in (torch.float32, torch.bfloat16):
        w = w32.to(dtype)
        size = w.element_size()
        for v, blocks in {folded_walk(n, dtype == torch.bfloat16, (size * o, 4 * o, size * o))
                          for o in OFFSETS}:
            per_block = THREADS * FOLDED_GROUPS * v
            assert blocks * per_block >= n > (blocks - 1) * per_block
            _, coords, live = walk_owners(n, n, 32, v, FOLDED_GROUPS)
            assert torch.equal(torch.bincount(coords[live].reshape(-1), minlength=n),
                               torch.ones(n, dtype=torch.int64))
            assert bool((coords[~live] >= n).all())
            assert torch.equal(folded_walk_twin(w, z, v),
                               decode_apply_ref(w, z, DECODE_PARAMS, COHORT, LR)), (dtype, v)
