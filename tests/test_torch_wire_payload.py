"""The port's wire payloads (``core/wire.py``: ``PackedPayload``,
``packed_nbytes``, ``payload_bits``) and ``Mechanism.payload_bits`` /
``encode_wire``, against the JAX reference on the CPU.

Contracts:
  * ``packed_nbytes``, ``payload_bits`` and ``Mechanism.payload_bits``
    are the reference's at every width and level count;
  * ``PackedPayload.pack`` gives the reference's words at widths 1-16
    (at 16 bits the top field crosses the int32 sign bit), unpacks
    exactly, and reports the reference's nbytes, wire_bits and shape; its
    validation refuses what the reference's refuses; the golden codec
    vectors of ``tests/golden/packed_words.json`` pack to their words;
  * ``encode_wire`` given ``key_to_seed`` of the reference's key packs
    the reference's words bit for bit for rqm and pbm, and for qmgeo
    within ``QMGEO_BUDGET`` of its levels (ROADMAP C4); the noise-free
    baseline returns its dense float encode, as the reference's.
"""
import torch_threads  # noqa: F401  (first: pins torch's CPU threads)
import json
import math
import os

import jax
import numpy as np
import pytest
import torch

from repro.core import mechanisms as jmechs
from repro.core import wire as jwire
from repro.kernels import ops as jops
from repro_torch.core import wire
from repro_torch.core.mechanisms import make_mechanism
from test_torch_quantize import QMGEO_BUDGET

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "packed_words.json")
SPECS = {"rqm": "rqm:c=0.05,m=16,q=0.42", "pbm": "pbm:c=0.05,m=16,theta=0.25",
         "qmgeo": "qmgeo:c=0.05,m=16,r=0.6", "rqm m=5": "rqm:c=0.05,m=5,q=0.5",
         "pbm m=1": "pbm:c=0.05,m=1,theta=0.25"}
DIM = 1037  # odd: every width leaves a padded tail


@pytest.mark.parametrize("bits", range(1, 17))
def test_packed_payload_is_the_reference(bits):
    rng = np.random.default_rng(bits)
    for n in (0, 1, 7, 64, DIM):
        z = rng.integers(0, 1 << bits, n).astype(np.int32)
        if n and bits == 16:
            z[-1] = 0xFFFF  # the top field's top bit is the word's sign bit
        got, want = wire.PackedPayload.pack(z, bits), jwire.PackedPayload.pack(z, bits)
        np.testing.assert_array_equal(got.words, want.words)
        assert got.words.dtype == np.int32 and got.words.flags.c_contiguous
        np.testing.assert_array_equal(got.unpack(), z)
        assert (got.bits, got.length, got.dtype) == (want.bits, want.length, want.dtype)
        assert (got.nbytes, got.wire_bits, got.shape) == (want.nbytes, want.wire_bits,
                                                          want.shape)
        assert wire.packed_nbytes(n, bits) == jwire.packed_nbytes(n, bits) == got.nbytes
    if bits == 16:
        words = wire.PackedPayload.pack(np.full(4, 0xFFFF, np.int32), 16).words
        assert (words < 0).all()  # two fields a word: 0xFFFFFFFF


def test_payload_bits_is_the_reference():
    for m in range(2, 70):
        assert wire.payload_bits(m) == jwire.payload_bits(m) == math.ceil(math.log2(m))
    for m in (0, 1):
        with pytest.raises(ValueError, match="needs >= 2 levels"):
            wire.payload_bits(m)
    for name, spec in SPECS.items():
        assert make_mechanism(spec).payload_bits == jmechs.make_mechanism(spec).payload_bits
    assert make_mechanism(SPECS["rqm"]).payload_bits == 4  # levels 0..15
    assert make_mechanism(SPECS["pbm"]).payload_bits == 5  # counts 0..16
    assert make_mechanism("none:c=0.05").payload_bits is None


def test_golden_codec_vectors():
    with open(GOLDEN) as f:
        golden = json.load(f)
    assert len(golden["codec"]) == 5
    for case in golden["codec"]:
        p = wire.PackedPayload.pack(np.asarray(case["levels"], np.int32), case["bits"])
        np.testing.assert_array_equal(p.words, np.asarray(case["words"], np.int32))
        np.testing.assert_array_equal(p.unpack(), case["levels"])


@pytest.mark.parametrize("kwargs,match", [
    (dict(words=np.zeros(3, np.int32), bits=4, length=25), r"needs \(4,\) words"),
    (dict(words=np.zeros(2, np.int32), bits=4, length=17), r"needs \(3,\) words"),
    (dict(words=np.zeros((1, 3), np.int32), bits=4, length=17), r"needs \(3,\) words"),
    (dict(words=np.zeros(1, np.int32), bits=0, length=1), "1..16 bits"),
    (dict(words=np.zeros(1, np.int32), bits=17, length=1), "1..16 bits"),
    (dict(words=np.zeros(0, np.int32), bits=4, length=-1), "length must be >= 0"),
    (dict(words=np.zeros(1, np.int32), bits=4, length=8, dtype="float32"), "dtype tag"),
])
def test_packed_payload_validation(kwargs, match):
    with pytest.raises(ValueError, match=match):
        wire.PackedPayload(**kwargs)
    with pytest.raises(ValueError):
        jwire.PackedPayload(**kwargs)


@pytest.mark.parametrize("name", list(SPECS))
def test_encode_wire_is_the_reference(name):
    spec = SPECS[name]
    mech, jmech = make_mechanism(spec), jmechs.make_mechanism(spec)
    rng = np.random.default_rng(5)
    for k in range(3):
        g = rng.normal(0.0, 0.05, DIM).astype(np.float32)
        key = jax.random.key(100 + k)
        seed = int(np.asarray(jops.key_to_seed(key)))
        want = jmech.encode_wire(jax.numpy.asarray(g), key)
        got = mech.encode_wire(torch.from_numpy(g), seed)
        assert isinstance(got, wire.PackedPayload) and isinstance(want, jwire.PackedPayload)
        assert (got.bits, got.length, got.nbytes) == (want.bits, want.length, want.nbytes)
        assert got.bits == mech.payload_bits
        if name.startswith("qmgeo"):
            diff = got.unpack() - want.unpack()
            assert np.abs(diff).max() <= 1
            assert np.count_nonzero(diff) <= math.ceil(QMGEO_BUDGET * diff.size)
        else:
            np.testing.assert_array_equal(got.words, want.words)
        # row 0 of a one-row batch: the encode of the same seed, packed
        levels = mech.quantize(torch.from_numpy(g), seed).numpy()
        np.testing.assert_array_equal(got.unpack(), levels)
        # a 0-d tensor seed (its int32 bit pattern) is the same seed
        bits = seed - (1 << 32) if seed >> 31 else seed
        again = mech.encode_wire(g, torch.tensor(bits, dtype=torch.int32))
        np.testing.assert_array_equal(again.words, got.words)


def test_encode_wire_noise_free_is_dense():
    mech, jmech = make_mechanism("none:c=0.05"), jmechs.make_mechanism("none:c=0.05")
    g = np.random.default_rng(2).normal(0.0, 0.1, DIM).astype(np.float32)
    got = mech.encode_wire(torch.from_numpy(g), 0)
    want = np.asarray(jmech.encode_wire(jax.numpy.asarray(g), jax.random.key(0)))
    assert isinstance(got, np.ndarray) and got.dtype == np.float32 and got.shape == (DIM,)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.clip(g, -0.05, 0.05))
