"""Time the port's quantize, round-sum, wire codec and server decode kernels
of an earlier source tree against this tree's, and each of this tree's
by-value entries against its ``_dev`` twin, in turns, on one CUDA card.

    git archive <rev> -- src/repro_torch/kernels/csrc | tar -x -C build/parent
    python scripts/torch_kernel_ab.py --parent build/parent/src/repro_torch/kernels/csrc

Both trees' ``quantize.cu``, ``round_sum.cu``, ``pack.cu`` and
``decode_apply.cu`` are built with the port's nvcc flags (all eight builds
at once), and each library is called through ctypes at ``chip_smoke.py``
phase 3's inputs: a cohort of 40 rows of the CNN's 222,030 coordinates,
uniform in +-1.2 c, 10-bit packed words, the paper's mechanisms (rqm m=16
q=0.42, pbm m=16 theta=0.25, qmgeo m=16 r=0.6). Ten seeded cases: the
three quantize entries and ``rqm_quantize`` at m=64, q=0.5; the three
dense round sums; the two packed ones. Each runs three ways: the parent's
entry, this tree's by-value entry, and its ``_dev`` twin with the seed as
a 1-element int32 device tensor. Fifteen unseeded cases run two ways,
parent and tree (the C ABI is the same): ``pack_flat`` and
``unpack_flat`` of the RQM round's dense sum at 10 bits, at 16 bits with
every field 2^16 - 1 (the top field sets the sign bit), and at n = 1 (one
block: the entry's floor); ``decode_apply_sum`` of that sum at 222,030
and at n = 1, ``unpack_decode_apply`` of its 10-bit words, of the
16-bit words of 2^16 - 1 everywhere, and at n = 1, and the folded
``decode_apply`` of the sum on float32 and on bfloat16 parameters, at
222,030 and at n = 1 (cohort 40, lr 0.5, normal parameters). Each result
must equal the plain PyTorch version bit for bit. The device times are then taken in turns (parent, tree, dev,
dev, tree, parent; the unseeded cases' parent, tree, tree, parent) by
``chip_smoke.device_ms`` (torch.profiler, mean of 30 launches) and
``chip_smoke.queued_ms`` (CUDA events behind a sleeping kernel).

The RQM entries of a tree up to commit 698c532 take the float ``q``
(``--parent-abi q``, the default); later trees, this one among them, take
the integer keep constants (``--parent-abi keep``). The PBM and QMGeo
entries take the same arguments in every tree. Per library the script
prints ptxas's registers and spills of every kernel instance and, where
the toolkit has ``cuobjdump``, each instance's static SASS opcode counts
by pipe (``PIPES``: the opcode-to-pipe map of the H100's SM, for reading,
not for timing) and its innermost loops by pipe (divide by the elements
an iteration takes for a count an element). The ``[sass-diff]`` lines
say whether each of the parent's instances has the tree's by-value SASS,
instruction for instruction, and how each ``_dev`` instance differs from
its by-value twin: the opcodes it has more and fewer of, in the whole
kernel and in each innermost loop. Everything it writes goes
under ``--out`` (default ``build/ab``): the builds, ptxas and SASS text,
and ``times.json``.
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from repro_torch.core import wire  # noqa: E402
from repro_torch.core.grid import RQMParams  # noqa: E402
from repro_torch.core.mechanisms import make_mechanism  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    _build,
    decode_apply_kernel,
    pack_kernel,
    pbm_kernel,
    prng,
    qmgeo_kernel,
    rqm_kernel,
)
from repro_torch.kernels import fused_round_kernel as frk  # noqa: E402

ROWS, DIM, BITS = chip_smoke.ROWS, chip_smoke.DIM, chip_smoke.BITS
LIBS = ("quantize", "round_sum", "pack", "decode_apply")
P, I, U, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
# SASS opcode -> the SM pipe that executes it (by base name, before the
# first '.'); uniform-datapath opcodes (U*) count as "uniform", the rest as
# "other" (branches, barriers, special registers). VIADD counts on the FMA
# pipe: PERF.md's issue model of the PBM and QMGeo parents fits only so.
PIPES = {
    "alu": ("LOP3", "SHF", "IADD3", "ISETP", "SEL", "FSEL", "FSETP", "FMNMX", "IMNMX",
            "LEA", "PRMT", "IABS", "FLO", "POPC", "BMSK", "SGXT", "PLOP3", "P2R", "R2P",
            "I2FP", "F2IP", "VIMNMX", "MOV", "SHL", "SHR"),
    "fma": ("FFMA", "FADD", "FMUL", "IMAD", "IMUL", "VIADD", "HFMA2", "HADD2", "HMUL2",
            "FSWZADD"),
    "mufu": ("MUFU",),
    "conversion": ("I2F", "F2I", "F2F", "FRND"),
    "memory": ("LDG", "STG", "LDS", "STS", "LDC", "LD", "ST", "LDL", "STL", "ATOM", "ATOMS",
               "RED"),
}
PIPE_OF = {op: pipe for pipe, ops in PIPES.items() for op in ops}


def log(msg: str) -> None:
    print(msg, flush=True)


def short(symbol: str) -> str:
    return chip_smoke.demangle(symbol).replace("void ", "")


def sass_report(tag: str, lib: str, path: str, out: str) -> dict:
    """Print each kernel instance's SASS opcodes by pipe and its innermost
    loops (the static instructions between a backward branch and its
    target, by pipe). Return, by instance, its instruction texts
    (addresses and encodings stripped) and those of its innermost loops,
    keyed by the instance's name without the by-value seed's template
    argument, so that a tree's by-value instance can be held against its
    parent's."""
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    if not os.path.exists(cuobjdump):
        log("[sass] no cuobjdump")
        return {}
    text = subprocess.run([cuobjdump, "-sass", path], capture_output=True, text=True).stdout
    open(os.path.join(out, f"sass_{tag}_{lib}.txt"), "w").write(text)
    fn, instrs = None, {}
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = short(m.group(1))
            instrs[fn] = []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+((@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)[^;]*)",
                     line)
        if m and fn:
            instrs[fn].append((int(m.group(1), 16), m.group(4), m.group(2)))
    found = {}
    for fn, ins in instrs.items():
        c = collections.Counter(op for _, op, _ in ins)
        top = ", ".join(f"{k} {v}" for k, v in c.most_common(12))
        log(f"[sass] {tag} {fn}: {len(ins)} instructions; by pipe "
            f"{by_pipe(op for _, op, _ in ins)}; {top}")
        back = []
        for addr, op, text_ in ins:
            m = re.search(r"\bBRA\s+0x([0-9a-f]+)", text_)
            if op == "BRA" and m and int(m.group(1), 16) <= addr:
                back.append((int(m.group(1), 16), addr))
        loops = []
        for lo, hi in back:
            if any(lo <= a and b < hi for a, b in back if (a, b) != (lo, hi)):
                continue  # holds an inner loop
            body = [(op, text_) for addr, op, text_ in ins if lo <= addr <= hi]
            loops.append([mnemonic(text_) for _, text_ in body])
            log(f"[loops] {tag} {fn}: loop {lo:#x}-{hi:#x}, {len(body)} instructions, "
                f"by pipe {by_pipe(op for op, _ in body)}")
        key = re.sub(r"\s+>", ">", fn).replace(", unsigned int>", ">")
        found[key] = {"body": [re.sub(r"0x[0-9a-f]+", "#", t).strip() for _, _, t in ins],
                      "ops": [mnemonic(t) for _, _, t in ins], "loops": loops}
    return found


def mnemonic(text_: str) -> str:
    """An instruction's opcode with its modifiers, without predicate or
    operands (register numbers differ between two allocations)."""
    return re.sub(r"^@!?U?P\w+\s+", "", text_.strip()).split()[0]


def by_pipe(opcodes) -> dict:
    pipes = collections.Counter()
    for op in opcodes:
        pipes[PIPE_OF.get(op, "uniform" if op.startswith("U") else "other")] += 1
    return dict(pipes.most_common())


def op_delta(a: list, b: list) -> str:
    """The opcodes ``b`` has more (+) and fewer (-) of than ``a``."""
    more, fewer = collections.Counter(b) - collections.Counter(a), \
        collections.Counter(a) - collections.Counter(b)
    return ", ".join([f"+{k} {v}" for k, v in sorted(more.items())]
                     + [f"-{k} {v}" for k, v in sorted(fewer.items())]) or "same opcodes"


def build_all(trees: dict, out: str) -> dict:
    """One nvcc per (tree, library), all started together."""
    procs = {}
    for tag, src in trees.items():
        for lib in LIBS:
            so = os.path.join(out, f"{tag}_{lib}.so")
            cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-I", src, "-o", so,
                   os.path.join(src, f"{lib}.cu")]
            procs[(tag, lib)] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                  stderr=subprocess.STDOUT, text=True), so)
    libs, sass = {}, {}
    for (tag, lib), (proc, so) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{tag} {lib}: {text}")
        open(os.path.join(out, f"ptxas_{tag}_{lib}.txt"), "w").write(text)
        fn = None
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                fn = short(m.group(1))
            m = re.search(r"Used (\d+) registers", line)
            if m and fn:
                log(f"[ptxas] {tag} {lib}: {m.group(1)} registers  {fn}")
            if fn and "spill" in line and not re.search(r"\b0 bytes spill stores, 0 bytes spill loads", line):
                log(f"[ptxas] {tag} {lib}: {line.strip()}  {fn}")
        libs[(tag, lib)] = ctypes.CDLL(so)
        sass[(tag, lib)] = sass_report(tag, lib, so, out)
    for lib in LIBS:
        parent, tree = sass.get(("parent", lib), {}), sass.get(("tree", lib), {})
        for fn, got in parent.items():  # the parent's instances against the tree's by-value ones
            if fn not in tree:
                log(f"[sass-diff] {lib} {fn}: not in the tree")
                continue
            same = got["body"] == tree[fn]["body"]
            log(f"[sass-diff] {lib} {fn}: {'same SASS' if same else 'differs'} "
                f"({len(got['body'])} -> {len(tree[fn]['body'])} instructions)")
        for fn, dev in tree.items():  # each _dev instance against its by-value twin
            twin = tree.get(fn.replace(", unsigned int const*>", ">"))
            if twin is None or twin is dev:
                continue
            log(f"[sass-diff] dev {lib} {fn}: {len(twin['ops'])} -> {len(dev['ops'])} "
                f"instructions ({op_delta(twin['ops'], dev['ops'])}); innermost loops "
                + "; ".join(f"{len(a)} -> {len(b)} ({op_delta(a, b)})"
                            for a, b in zip(twin["loops"], dev["loops"]))
                + ("" if len(twin["loops"]) == len(dev["loops"]) else
                   f"; {len(twin['loops'])} loops -> {len(dev['loops'])}"))
    return libs


def codec_cases(launcher, dense) -> dict:
    """``pack_flat`` and ``unpack_flat`` of ``dense`` (the RQM round's sum)
    at BITS, of 2^16 - 1 everywhere at 16 bits, and of one field (the
    floor); both trees' entries take the same arguments."""
    top = torch.full_like(dense, (1 << 16) - 1)
    cases = {}
    for what, z, bits in ((f"{BITS}-bit", dense, BITS), ("16-bit top field", top, 16),
                          ("n=1", dense[:1], BITS)):
        n, words = z.numel(), pack_kernel.pack_flat_plain(z, bits)
        packed_out = torch.empty_like(words)
        unpacked_out = torch.empty_like(z)
        cases[f"pack_flat {what}"] = (
            lambda tag, z=z, o=packed_out, n=n, b=bits: launcher(
                tag, "pack", "pack_flat", (P, P, I, I, I),
                (z.data_ptr(), o.data_ptr(), n, o.numel(), b), o),
            ("::pack_flat_kernel",), lambda z=z, b=bits: pack_kernel.pack_flat_plain(z, b),
            ("parent", "tree"))
        cases[f"unpack_flat {what}"] = (
            lambda tag, words=words, o=unpacked_out, b=bits: launcher(
                tag, "pack", "unpack_flat", (P, P, I, I, I),
                (words.data_ptr(), o.data_ptr(), o.numel(), words.numel(), b), o),
            ("::unpack_flat_kernel",),
            lambda words=words, n=n, b=bits: pack_kernel.unpack_flat_plain(words, b, n),
            ("parent", "tree"))
    return cases


def decode_cases(launcher, dense, params, lr: float = 0.5) -> dict:
    """``decode_apply_sum`` of ``dense`` (the RQM round's sum) at its full
    length and at n = 1 (the floor), ``unpack_decode_apply`` of its
    BITS-bit words, of the 16-bit words of 2^16 - 1 everywhere, and at
    n = 1, and the folded ``decode_apply`` of the sum on float32 and on
    bfloat16 parameters, each at its full length and at n = 1, on normal
    parameters at a cohort of ROWS; both trees' entries take the same
    arguments."""
    w = torch.from_numpy(np.random.default_rng(5).normal(0, 0.05, dense.numel())
                         .astype(np.float32)).to(dense.device)
    k = decode_apply_kernel.f32_decode_constants(params, ROWS, lr)
    consts = (k["neg_x_max"], k["scale"], k["lr"])
    top = torch.full_like(dense, (1 << 16) - 1)
    cases = {}
    for what, d in ((f"{dense.numel():,}", dense.numel()), ("n=1", 1)):
        out = torch.empty(d, dtype=torch.float32, device=dense.device)
        cases[f"decode_apply_sum {what}"] = (
            lambda tag, d=d, o=out: launcher(
                tag, "decode_apply", "decode_apply_sum", (P, P, P, I, F, F, F),
                (w.data_ptr(), dense.data_ptr(), o.data_ptr(), d, *consts), o),
            ("decode_apply_sum_kernel",),
            lambda d=d: decode_apply_kernel.decode_apply_plain(w[:d], dense[:d], params, ROWS,
                                                               lr), ("parent", "tree"))
    for what, z, bits in ((f"{BITS}-bit", dense, BITS), ("16-bit top field", top, 16),
                          ("n=1", dense[:1], BITS)):
        d, words = z.numel(), pack_kernel.pack_flat_plain(z, bits)
        out = torch.empty(d, dtype=torch.float32, device=dense.device)
        cases[f"unpack_decode_apply {what}"] = (
            lambda tag, words=words, o=out, d=d, b=bits: launcher(
                tag, "decode_apply", "unpack_decode_apply", (P, P, P, I, I, I, F, F, F),
                (w.data_ptr(), words.data_ptr(), o.data_ptr(), d, words.numel(), b, *consts),
                o),
            ("unpack_decode_apply_kernel",),
            lambda words=words, d=d, b=bits: pack_kernel.unpack_decode_apply_plain(
                w[:d], words, params, ROWS, lr, pack_bits=b), ("parent", "tree"))
    shift, scale = decode_apply_kernel.folded_constants(params, ROWS, lr)
    for dtype in (torch.float32, torch.bfloat16):
        wt = w.to(dtype)
        for what, d in ((f"{dense.numel():,}", dense.numel()), ("n=1", 1)):
            out = torch.empty(d, dtype=dtype, device=dense.device)
            cases[f"decode_apply {str(dtype).split('.')[-1]} {what}"] = (
                lambda tag, wt=wt, d=d, o=out: launcher(
                    tag, "decode_apply", "decode_apply", (P, P, P, I, I, F, F),
                    (wt.data_ptr(), dense.data_ptr(), o.data_ptr(), d,
                     int(wt.dtype == torch.bfloat16), shift, scale), o),
                ("decode_apply_folded_kernel",),
                lambda wt=wt, d=d: decode_apply_kernel.decode_apply_ref(wt[:d], dense[:d], params,
                                                                        ROWS, lr),
                ("parent", "tree"))
    return cases


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="an earlier tree's csrc directory")
    ap.add_argument("--parent-abi", choices=("q", "keep"), default="q",
                    help="the parent's RQM entries take the float q, or keep_le and keep_any")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "ab"))
    args = ap.parse_args()
    if not torch.cuda.is_available() or not args.parent:
        log("needs a CUDA device and --parent")
        return 1
    t0 = time.perf_counter()
    os.makedirs(args.out, exist_ok=True)
    trees = {"parent": os.path.abspath(args.parent), "tree": str(_build.CSRC)}
    log(f"[env] {chip_smoke.nvidia_smi()}; torch {torch.__version__} cuda {torch.version.cuda}")
    libs = build_all(trees, args.out)

    mech = {name: make_mechanism(chip_smoke.SPECS[name]).params for name in ("rqm", "pbm", "qmgeo")}
    params = mech["rqm"]
    wide = RQMParams(c=params.c, delta=params.delta, m=64, q=0.5)
    rng = np.random.default_rng(2024)
    c = params.c
    x = torch.from_numpy(rng.uniform(-1.2 * c, 1.2 * c, size=(ROWS, DIM)).astype(np.float32)).cuda()
    w = torch.ones(ROWS, dtype=torch.int32, device="cuda")
    seed = int(rng.integers(0, 1 << 32))
    # the _dev entries read it from device memory, as a captured round does
    seed_t = torch.tensor([prng.seed_bits(seed)], dtype=torch.int32, device="cuda")
    words = wire.packed_words(DIM, BITS)
    out = {"quantize": torch.empty((ROWS, DIM), dtype=torch.int32, device="cuda"),
           "dense": torch.empty(DIM, dtype=torch.int32, device="cuda"),
           "packed": torch.empty(words, dtype=torch.int32, device="cuda")}

    def kernel_args(tag, name, p):
        if name == "pbm":
            return pbm_kernel.kernel_args(p)
        if name == "qmgeo":
            return qmgeo_kernel.kernel_args(p)
        if tag != "parent" or args.parent_abi == "keep":
            return rqm_kernel.kernel_args(p)
        k = rqm_kernel.f32_constants(p)  # the float-q entries of commit 698c532
        return (F, F, F, F, I), (k["c"], k["x_max"], k["step"], float(np.float32(p.q)), p.m)

    def launcher(tag, lib, entry, argtypes, args_, result):
        """``tag``: "parent", "tree", or "dev" (the tree's _dev entry)."""
        f = getattr(libs[("parent" if tag == "parent" else "tree", lib)],
                    entry + ("_dev" if tag == "dev" else ""))
        f.argtypes, f.restype = list(argtypes) + [P], I

        def call():
            rc = f(*args_, torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"{tag} {entry}: CUDA error {rc}")
            return result
        return call

    def seed_arg(tag):
        """The seed's C type and value: a _dev entry takes its device pointer."""
        return (P, seed_t.data_ptr()) if tag == "dev" else (U, seed)

    def quantize(tag, name, p):
        t, v = kernel_args(tag, name, p)
        st, sv = seed_arg(tag)
        return launcher(tag, "quantize", f"{name}_quantize", (P, P, I, I, st, U) + t,
                        (x.data_ptr(), out["quantize"].data_ptr(), ROWS, DIM, sv, 0, *v),
                        out["quantize"])

    def dense(tag, name):
        t, v = kernel_args(tag, name, mech[name])
        st, sv = seed_arg(tag)
        return launcher(tag, "round_sum", f"{name}_round_sum_dense",
                        (P, P, P, I, I, st, U) + t,
                        (x.data_ptr(), w.data_ptr(), out["dense"].data_ptr(), ROWS, DIM, sv, 0,
                         *v), out["dense"])

    def packed(tag, name):
        t, v = kernel_args(tag, name, mech[name])
        st, sv = seed_arg(tag)
        return launcher(tag, "round_sum", f"{name}_round_sum_packed",
                        (P, P, P, I, I, I, I, st, U) + t,
                        (x.data_ptr(), w.data_ptr(), out["packed"].data_ptr(), ROWS, DIM, words,
                         BITS, sv, 0, *v), out["packed"])

    plain_quantize = {"rqm": rqm_kernel.rqm_quantize_plain, "pbm": pbm_kernel.pbm_quantize_plain,
                      "qmgeo": qmgeo_kernel.qmgeo_quantize_plain}
    encoder = {"rqm": "RQMEncoder", "pbm": "PBMEncoder", "qmgeo": "QMGeoEncoder"}
    seeded = ("parent", "tree", "dev")
    cases = {}  # name -> (make(tag), profiler symbol, plain version, tags)
    for name in ("rqm", "pbm", "qmgeo"):
        cases[f"{name}_quantize"] = (
            lambda tag, n=name: quantize(tag, n, mech[n]),
            ("quantize_kernel", encoder[name]),
            lambda n=name: plain_quantize[n](x, seed, mech[n], 0), seeded)
    cases["rqm_quantize m=64 q=0.5"] = (
        lambda tag: quantize(tag, "rqm", wide), ("quantize_kernel", "RQMEncoder"),
        lambda: rqm_kernel.rqm_quantize_plain(x, seed, wide, 0), seeded)
    for name in ("rqm", "pbm", "qmgeo"):
        cases[f"{name}_round_sum_dense"] = (
            lambda tag, n=name: dense(tag, n),
            ("round_sum_dense_kernel", encoder[name]),
            lambda n=name: frk.round_sum_plain(x, w, seed, 0, mech[n], n), seeded)
    for name in frk.PACKED_KERNELS:
        cases[f"{name}_round_sum_packed"] = (
            lambda tag, n=name: packed(tag, n),
            ("round_sum_packed_kernel", encoder[name]),
            lambda n=name: frk.round_sum_packed_plain(x, w, seed, 0, mech[n], BITS, n), seeded)
    round_sum = frk.round_sum_plain(x, w, seed, 0, params, "rqm")
    cases.update(codec_cases(launcher, round_sum))
    cases.update(decode_cases(launcher, round_sum, params))
    results = {"card": chip_smoke.nvidia_smi(), "times": {}}
    for name, (make, symbol, plain, tags) in cases.items():
        want = plain()
        for tag in tags:
            got = make(tag)().clone()
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"{name} {tag}: {int((got != want).sum())} of "
                                     f"{got.numel()} differ from the plain version")
            log(f"[check] {name} {tag}: bit-exact")
        times = results["times"][name] = collections.defaultdict(list)
        for tag in tags + tags[::-1]:
            fn = make(tag)
            ms, by = chip_smoke.device_ms(torch, fn, chip_smoke.KERNEL_REPS, symbol)
            q_ms = chip_smoke.queued_ms(torch, fn, chip_smoke.KERNEL_REPS)
            times[tag].append({"ms": ms, "by": by, "queued_ms": q_ms})
            log(f"[time] {name} {tag}: {ms} ms ({by}), queued {q_ms} ms")
    results["card_after"] = chip_smoke.nvidia_smi()
    with open(os.path.join(args.out, "times.json"), "w") as fh:
        json.dump(results, fh, indent=1)
    log(f"[env] {results['card_after']}; {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
