"""The dry run's analysis (``repro_torch/launch/hlo_analysis.py``) against
the reference's ``repro/launch/hlo_analysis.py``, and its counters, on
the CPU:

  * ``model_flops`` equal to the reference's, and ``roofline_terms`` of
    them equal to the reference's on its V5E and on the port's H100, for
    every architecture x input shape x tp in {1, 16};
  * ``collective_bytes`` of records made from the reference test's HLO
    snippet (tests/test_hlo_analysis.py; each collective its HLO line's
    bytes, as the reference's parser reads them, a tuple all-reduce one
    record of its operands' total) equal to the reference's numbers;
  * the counters on the meta device equal the same counters on a real CPU
    run of the same step (FLOPs, bytes, dispatched ops, peak live bytes):
    reduced configs' train (mechanism ``none``: on the CPU a quantize
    kernel runs its plain version, whose ops the meta branch charges as
    the kernel's traffic instead), prefill and decode steps;
  * every kernel dispatcher's meta branch: an empty output of the
    kernel's dtype and shape, its traffic (inputs and outputs once)
    charged under its entry's name, no launch counted.
"""
import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import pytest
import torch

from repro.configs.base import INPUT_SHAPES as JAX_SHAPES
from repro.configs.registry import get_config as jget_config
from repro.launch import hlo_analysis as jhlo
from repro.launch.mesh import V5E
from repro_torch.configs.base import INPUT_SHAPES, InputShape
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.convert import leaves, map_leaves
from repro_torch.distributed.step import make_plan
from repro_torch.kernels import _build
from repro_torch.launch import dryrun, hlo_analysis
from repro_torch.launch.mesh import H100

# the reference test's snippet (tests/test_hlo_analysis.py:HLO), line by
# line: kind, the bytes of its result, its group size
HLO_RECORDS = [
    ("all-gather", 8 * 4096 * 2560 * 2, 16),
    ("all-reduce", 1024 * 512 * 4, 16),
    ("all-reduce", (1 * 256 * 256 + 256 + 256 * 128) * 2, 4),  # the variadic tuple
    ("reduce-scatter", 8 * 256 * 2560 * 2, 16),
    ("collective-permute", 128 * 4, 1),
    ("all-to-all", 64 * 64, 4),
]
COUNTED_ARCHS = ("gemma3-4b", "qwen3-moe-30b-a3b", "mamba2-370m", "zamba2-1.2b")


@pytest.mark.parametrize("tp", [1, 16])
@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_and_roofline(arch, shape, tp):
    got = hlo_analysis.model_flops(get_config(arch), INPUT_SHAPES[shape], tp=tp)
    want = jhlo.model_flops(jget_config(arch), JAX_SHAPES[shape], tp=tp)
    assert got == want
    hbm, coll = got / 64.0, got / 1e4
    for hw in (V5E, H100):
        assert hlo_analysis.roofline_terms(got, hbm, coll, hw) == \
            jhlo.roofline_terms(want, hbm, coll, hw)


def test_h100_terms():
    assert H100 == {"peak_flops_bf16": 989e12, "hbm_bandwidth": 3.35e12,
                    "ici_link_bandwidth": 450e9, "hbm_bytes": 85_017_493_504}
    assert set(H100) == set(V5E)
    t = hlo_analysis.roofline_terms(989e12, 3.35e12 / 2, 450e9 * 2, H100)
    assert t == {"compute_s": 1.0, "memory_s": 0.5, "collective_s": 2.0,
                 "dominant": "collective"}


def test_collective_bytes_of_the_reference_snippet():
    from test_hlo_analysis import HLO

    want = jhlo.collective_bytes(HLO)
    got = hlo_analysis.collective_bytes(HLO_RECORDS)
    assert got.summary() == want.summary()
    assert got.total_bytes == want.total_bytes


def _real(tree, gen, vocab):
    def leaf(i, t):
        if t.dtype.is_floating_point:
            return (torch.randn(t.shape, generator=gen) * 0.02).to(t.dtype)
        return torch.randint(0, vocab, t.shape, generator=gen, dtype=t.dtype)
    return map_leaves(leaf, tree)


def _counted(fn, args):
    with hlo_analysis.counting() as c:
        out = fn(*args)
    del out
    return c


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", COUNTED_ARCHS)
def test_meta_counts_equal_a_real_cpu_run(arch, kind):
    cfg = get_config(arch, reduced=True)
    shape = InputShape("t", 32, 2, kind)
    fn, args = dryrun.build_step(cfg, make_plan((1, 1), "meta"), shape, mechanism="none")
    meta = _counted(fn, args)
    fn, args = dryrun.build_step(cfg, make_plan((1, 1), "cpu"), shape, mechanism="none",
                                 device="cpu")
    gen = torch.Generator().manual_seed(0)
    real = [_real(a, gen, cfg.vocab_size) if isinstance(a, (dict, tuple, torch.Tensor)) else a
            for a in args]
    cpu = _counted(fn, real)
    assert meta.flops == cpu.flops > 0
    assert meta.bytes == cpu.bytes > 0
    assert meta.ops == cpu.ops
    assert meta.peak_bytes == cpu.peak_bytes > 0
    assert meta.collectives == cpu.collectives == []
    assert not meta.kernel_bytes and not cpu.kernel_bytes


def test_meta_train_step_charges_the_encode_kernel():
    cfg = get_config("gemma3-4b", reduced=True)
    fn, args = dryrun.build_step(cfg, make_plan((1, 1), "meta"),
                                 InputShape("t", 32, 2, "train"))
    _build.reset_launches()
    c = _counted(fn, args)
    n = sum(t.numel() for t in leaves(args[0]))
    assert dict(c.kernel_bytes) == {"rqm_quantize": n * 8}  # float32 in, int32 out
    assert not _build.launches  # nothing launched on meta


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_meta_branches():
    from repro_torch.core.grid import RQMParams
    from repro_torch.core.pbm import PBMParams
    from repro_torch.core.qmgeo import QMGeoParams
    from repro_torch.kernels import (decode_apply_kernel, fused_round_kernel, pack_kernel,
                                     pbm_kernel, qmgeo_kernel, rqm_kernel)

    rqm = RQMParams(c=0.02, delta=0.02, m=16, q=0.42)
    x, w = _meta(3, 1000), _meta(3, dtype=torch.int32)
    flat, z = _meta(1000), _meta(1000, dtype=torch.int32)
    words = _meta(334, dtype=torch.int32)  # 1000 fields of 10 bits, 3 a word
    seed_t = _meta(1, dtype=torch.int32)
    cases = [
        ("rqm_quantize", lambda: rqm_kernel.rqm_quantize(x, 5, rqm), (3, 1000), torch.int32,
         3000 * 8),
        ("rqm_quantize_dev", lambda: rqm_kernel.rqm_quantize(x, seed_t, rqm), (3, 1000),
         torch.int32, 3000 * 8 + 4),
        ("pbm_quantize", lambda: pbm_kernel.pbm_quantize(x, 5, PBMParams(c=0.02, m=16,
                                                                         theta=0.25)),
         (3, 1000), torch.int32, 3000 * 8),
        ("qmgeo_quantize", lambda: qmgeo_kernel.qmgeo_quantize(
            x, 5, QMGeoParams(c=0.02, delta=0.02, m=16, r=0.6)), (3, 1000), torch.int32,
         3000 * 8),
        ("pack_flat", lambda: pack_kernel.pack_flat(z, 10), (334,), torch.int32,
         4000 + 334 * 4),
        ("unpack_flat", lambda: pack_kernel.unpack_flat(words, 10, 1000), (1000,),
         torch.int32, 334 * 4 + 4000),
        ("rqm_round_sum_dense", lambda: fused_round_kernel.round_sum(x, w, 5, 0, rqm),
         (1000,), torch.int32, 12000 + 12 + 4000),
        ("rqm_round_sum_packed", lambda: fused_round_kernel.round_sum_packed(x, w, 5, 0, rqm,
                                                                             10),
         (334,), torch.int32, 12000 + 12 + 334 * 4),
        ("decode_apply_sum", lambda: decode_apply_kernel.decode_apply_sum(flat, z, rqm, 3,
                                                                          0.5),
         (1000,), torch.float32, 12000),
        ("decode_apply_sum_dev", lambda: decode_apply_kernel.decode_apply_sum(
            flat, z, rqm, seed_t, 0.5), (1000,), torch.float32, 12004),
        ("decode_apply", lambda: decode_apply_kernel.decode_apply(flat, z, rqm, 3, 0.5),
         (1000,), torch.float32, 12000),
        ("unpack_decode_apply", lambda: pack_kernel.unpack_decode_apply(
            flat, words, rqm, 3, 0.5, pack_bits=10), (1000,), torch.float32,
         8000 + 334 * 4),
    ]
    _build.reset_launches()
    for entry, call, shape, dtype, nbytes in cases:
        with hlo_analysis.counting() as c:
            out = call()
        assert out.device.type == "meta" and out.shape == shape and out.dtype == dtype, entry
        assert dict(c.kernel_bytes) == {entry: nbytes}, entry
        assert c.bytes == nbytes, entry  # an empty output moves nothing
    assert not _build.launches
    with pytest.raises(ValueError):
        rqm_kernel.rqm_quantize(x.to(torch.float64), 5, rqm)
