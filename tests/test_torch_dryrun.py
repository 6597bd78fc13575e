"""The dry run (``repro_torch/launch/dryrun.py``) against the reference's
``repro/launch/dryrun.py``, on the CPU:

  * ``supports`` equals the reference's for every architecture x shape;
  * ``run_one`` at 16x16 (a fake default group of 256 ranks), production
    widths cut to two blocks, one architecture of each family (dense,
    MoE, SSM, hybrid, frontend) at train_4k, and decode_32k and
    long_500k: each ends ``ok``, with the reference's record keys (the
    meta run's three ``meta_*`` in place of ``xla_cpu_*``, ``build_s`` and
    ``run_s`` in place of ``lower_s`` and ``compile_s``);
  * at 2x2, reduced tp_cases.DRYRUN_ARCHS: the collectives the port's
    meta run records equal those of the reference's compiled
    ``build_step`` (tests/tp_reference.py job ``dryrun``), operand by
    operand and per kind (count, bytes, ring bytes), once each of XLA's
    rewrites (``REWRITES``; ROADMAP C11) is applied to the port's records.

Both sides run as subprocesses, started together: the reference with four
fake CPU devices, the port's runs in tests/torch_dryrun_worker.py (so no
fake group is left in this worker).
"""
import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import collections
import json
import os
import subprocess
import sys

import pytest

import tp_cases
import tp_harness
from repro.configs.base import INPUT_SHAPES as JAX_SHAPES
from repro.configs.registry import get_config as jget_config
from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.launch import dryrun, hlo_analysis

REF_KEYS_OK = {"arch", "shape", "mesh", "mechanism", "packed", "sp_compress", "agg_dtype",
               "zero1", "kv_quant", "seq_parallel", "tag", "status", "devices",
               "per_device_flops", "per_device_hbm_bytes", "collective", "roofline",
               "model_flops_per_device", "useful_flops_ratio", "memory"}
MEMORY_KEYS = {"meta_argument_bytes", "meta_output_bytes", "meta_peak_bytes", "analytical",
               "hbm_limit", "fits"}

# XLA's rewrites of the reference's collectives, each applied to the
# port's records by ``_as_xla_compiles`` (ROADMAP C11):
REWRITES = {
    "combiner": "XLA's all-reduce combiner merges independent all-reduces into one "
                "tuple all-reduce: compared operand by operand, and its per-kind count "
                "is one a tuple",
    "float-normalization": "XLA:CPU runs no bfloat16 all-gather or reduce-scatter: it "
                           "carries them in float32, twice the bytes (every one of these "
                           "steps moves the bfloat16 residual stream)",
    "result-shape": "the reference's parser charges a reduce-scatter by its HLO result, "
                    "1/n of the full input the port records (the ring model's bytes)",
    "metrics": "the port sums its three metrics (loss, cross-entropy, MoE aux loss) in "
               "one all-reduce of 12 bytes; the reference pmeans each, and XLA's CSE "
               "merges the loss and the cross-entropy where no MoE aux loss adds to it "
               "(3 float32 operands with MoE, 2 without)",
    "dce": "XLA removes collectives whose results reach no output: each MoE layer's "
           "dropped-count psum (its drop fraction is no output of the step; int32, 4 "
           "bytes), and the target-logit psum of each loss chunk run again in the "
           "backward (no gradient reads it; float32, rows x chunk)",
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    refs = {arch: tp_harness.reference("dryrun", tmp / "none.npz", tmp / f"ref_{arch}.npz",
                                       tp_cases.DRYRUN_MESH, arch)
            for arch in tp_cases.DRYRUN_ARCHS}
    port = subprocess.Popen([sys.executable, os.path.join(tp_harness.HERE,
                                                          "torch_dryrun_worker.py"),
                             str(tmp / "artifacts"), str(tmp / "port.json")],
                            env=tp_harness.ENV, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    tp_harness.wait([port, *refs.values()], timeout=300)
    ref = {}
    for arch in tp_cases.DRYRUN_ARCHS:
        got = tp_harness.load(tmp / f"ref_{arch}.npz")
        ref[arch] = {"summary": json.loads(str(got[f"{arch}/summary"])),
                     "operands": json.loads(str(got[f"{arch}/operands"]))}
    with open(tmp / "port.json") as f:
        return {"ref": ref, "port": json.load(f), "artifacts": tmp / "artifacts"}


@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_supports(arch, shape):
    flags = os.environ.get("XLA_FLAGS")  # the reference's module sets it at import
    try:
        from repro.launch import dryrun as jdryrun

        want = jdryrun.supports(jget_config(arch), JAX_SHAPES[shape])
    finally:
        if flags is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = flags
    assert dryrun.supports(get_config(arch), INPUT_SHAPES[shape]) == want


def test_families_at_16x16(runs):
    fams = runs["port"]["families"]
    assert len(fams) == 7
    for name, rec in fams.items():
        assert rec["status"] == "ok", (name, rec.get("traceback"))
        assert REF_KEYS_OK <= set(rec) and {"build_s", "run_s"} <= set(rec), name
        assert set(rec["memory"]) == MEMORY_KEYS, name
        assert rec["devices"] == 256 and rec["mesh"] == "16x16" and rec["layers"] == 2
        assert rec["per_device_flops"] > 0 and rec["per_device_hbm_bytes"] > 0, name
        assert set(rec["roofline"]) == {"compute_s", "memory_s", "collective_s", "dominant"}
        mem = rec["memory"]
        assert 0 < mem["meta_peak_bytes"] and 0 < mem["meta_argument_bytes"], name
        assert mem["fits"] == bool(mem["analytical"]["fits"])
        coll = rec["collective"]
        assert coll["total_ring_bytes"] == sum(v["ring_bytes"] for k, v in coll.items()
                                               if k != "total_ring_bytes")
        if rec["shape"] == "train_4k":
            # the SecAgg sum over the 16 clients, and the model axis's gathers
            assert coll["all-reduce"]["count"] > 0 and coll["all-gather"]["count"] > 0
            assert set(rec["kernel_bytes"]) == {"rqm_quantize"}
        path = runs["artifacts"] / f"{rec['arch']}_{rec['shape']}_16x16.json"
        with open(path) as f:
            assert json.load(f) == rec


def _as_xla_compiles(records, cfg) -> list:
    """The port's records as the reference's compiled step shows them,
    after ``REWRITES`` (but the combiner, undone on the reference's side
    by listing its operands)."""
    out = []
    for kind, nbytes, n in records:
        if kind == "all-gather":
            nbytes *= 2  # float-normalization
        elif kind == "reduce-scatter":
            nbytes = nbytes * 2 // n  # float-normalization, result-shape
        out.append((kind, nbytes, n))
    rows = tp_cases.DRYRUN_BATCH // int(tp_cases.DRYRUN_MESH.split("x")[0])
    chunks = 1  # a sequence of DRYRUN_SEQ < 512: one loss chunk
    drop = collections.Counter({("all-reduce", 12, 2): 1,  # metrics
                                ("all-reduce", rows * tp_cases.DRYRUN_SEQ * 4, 2): chunks})
    if cfg.moe is not None:  # dce
        drop[("all-reduce", 4, 2)] += sum(b.kind == "attn" for b in cfg.layers)
    have = collections.Counter(out)
    assert not drop - have, f"records the rewrites take out are missing: {drop - have}"
    out = list((have - drop).elements())
    out += [("all-reduce", 4, 2)] * (3 if cfg.moe is not None else 2)  # metrics
    return out


@pytest.mark.parametrize("arch", tp_cases.DRYRUN_ARCHS)
def test_collectives_at_2x2(runs, arch):
    ref = runs["ref"][arch]
    cfg = get_config(arch, reduced=True)
    port = [tuple(r) for r in runs["port"]["mesh"][arch]]
    assert {k for k, _, _ in port} <= {"all-reduce", "all-gather", "reduce-scatter"}
    assert all(n == 2 for _, _, n in port)
    mine = _as_xla_compiles(port, cfg)
    theirs = [tuple(o) for o in ref["operands"]]
    assert collections.Counter(mine) == collections.Counter(theirs)
    # per kind: bytes and ring bytes as the reference's summary has them;
    # its count is one a tuple (combiner)
    got = hlo_analysis.collective_bytes(mine).summary()
    want = ref["summary"]
    assert set(got) == set(want)
    assert got["total_ring_bytes"] == want["total_ring_bytes"]
    for kind in set(want) - {"total_ring_bytes"}:
        assert got[kind]["bytes"] == want[kind]["bytes"], kind
        assert got[kind]["ring_bytes"] == want[kind]["ring_bytes"], kind
        assert got[kind]["count"] >= want[kind]["count"], kind
        if kind != "all-reduce":  # only all-reduces are combined
            assert got[kind]["count"] == want[kind]["count"], kind
