"""The serve steps over a mesh against the JAX reference, both sides
started together on one inputs file through tests/tp_harness.py: the
reference's ``serve`` job (tests/tp_reference.py, four fake CPU devices)
and the port's gloo ranks (tests/torch_tp_worker.py). Shared by
tests/test_torch_serve_mesh*.py.

Inputs, from seeds: each reduced arch's one-rank parameters (the port's
``init_params`` on a CPU generator), its prompt tokens (mode ``batch``)
or one-rank caches and token (mode ``seq``: K/V drawn up to the prompt,
zero past it, as a prefill leaves them), the int8 run's first tokens.
Each rank's tokens and final caches are held against the reference's,
its piece cut from the reference's global arrays by the reference's
``cache_meta`` pspecs (an independent slicing of the one under test).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

import tp_cases
import tp_harness
from repro.configs import registry as jregistry
from repro.configs.base import InputShape as JaxInputShape
from repro.models import meta as jmeta
from repro.models import model as jmodel
from repro_torch.configs.base import InputShape
from repro_torch.configs.registry import get_config
from repro_torch.convert import leaves
from repro_torch.models import model

CACHE_RTOL = 1e-5  # of the largest entry: float32 einsums summed in another order


def make_inputs(mode: str) -> dict:
    rng = np.random.default_rng(17)
    B, out = tp_cases.SERVE_BATCH[mode], {}
    for arch in tp_cases.SERVE_ARCHS[mode]:
        cfg = get_config(arch, reduced=True)
        params = model.init_params(torch.Generator().manual_seed(3), cfg, device="cpu")
        for i, t in enumerate(leaves(params)):
            out[f"{arch}/params/{i}"] = t.numpy()
        out[f"{arch}/tok0"] = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
        if mode == "batch":
            out[f"{arch}/tokens"] = rng.integers(
                0, cfg.vocab_size, (B, tp_cases.SERVE_PROMPT)).astype(np.int32)
            continue
        out[f"{arch}/tok"] = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
        shape = InputShape("t", tp_cases.SERVE_CAP, B, "decode")
        metas = leaves(model.cache_meta(cfg, 1, shape, ()))
        for i, m in enumerate(metas):
            c = rng.normal(size=m.shape).astype(np.float32)
            if m.shape[3] == tp_cases.SERVE_CAP:  # a global layer: zero past the prompt
                c[:, :, :, tp_cases.SERVE_PROMPT:] = 0.0
            out[f"{arch}/cache/{i}"] = c
    if mode == "batch":
        # exact ties across shards (v_l = 16 at tp 2, 8 at tp 4): row 0 at
        # ids 5, 13, 29 (logit 8.0); row 1 at 20, 28 only (the last
        # shards); row 2 all zero (id 0); row 3 one maximum at 31
        D, V = tp_cases.ARGMAX_D, tp_cases.ARGMAX_V
        head = (rng.normal(size=(D, V)) * 0.1).astype(np.float32)
        head[:, [5, 13, 29]] = 1.0
        head[0, [20, 28]] = 5.0
        head[1, 31] = 5.0
        h = np.zeros((4, D), np.float32)
        h[0], h[1, 0], h[3, 1] = 1.0, 1.0, 1.0
        out["argmax/head"], out["argmax/h"] = head, h
    return out


def run(tmp, mode: str, meshes) -> dict:
    """Both sides at each mesh of ``meshes``, every process started at
    once: {mesh: (the reference's outputs, each rank's outputs in rank
    order)}."""
    src = tmp / f"serve_{mode}_inputs.npz"
    np.savez(src, **make_inputs(mode))
    procs, worlds = [], {}
    for mesh in meshes:
        worlds[mesh] = int(np.prod([int(d) for d in mesh.split("x")]))
        procs.append(tp_harness.reference("serve", src, tmp / f"serve_{mode}_{mesh}_ref.npz",
                                          mode, mesh))
        procs += tp_harness.ranks("serve", worlds[mesh], tmp, src, mode, mesh)
    tp_harness.wait(procs, timeout=300)
    return {mesh: (tp_harness.load(tmp / f"serve_{mode}_{mesh}_ref.npz"),
                   [tp_harness.load(tmp / f"serve_{mode}_{mesh}_rank{r}.npz")
                    for r in range(world)])
            for mesh, world in worlds.items()}


def piece(a: np.ndarray, pspec, mi: int, ci: int, tp: int, n: int) -> np.ndarray:
    """The block of the global ``a`` that a pspec gives model index ``mi``
    and client ``ci``."""
    for d, e in enumerate(pspec):
        if e is None:
            continue
        parts, i = (tp, mi) if e == "model" else (n, ci)
        size = a.shape[d] // parts
        a = np.take(a, np.arange(i * size, (i + 1) * size), axis=d)
    return a


def check(ref: dict, ranks: list, mode: str, mesh: str, arch: str, quant: bool) -> float:
    """Each rank's tokens of every step == the reference's rows of them;
    int8 codes and bfloat16 scales bit for bit, float32 caches (K/V and
    SSM states) within CACHE_RTOL of the largest entry. Returns the worst
    relative error."""
    D, M = (int(d) for d in mesh.split("x"))
    B = tp_cases.SERVE_BATCH[mode]
    shape = JaxInputShape("t", tp_cases.SERVE_CAP, B, "decode")
    metas = jax.tree_util.tree_leaves(jmodel.cache_meta(
        jregistry.get_config(arch, reduced=True), M, shape, ("data",), dtype=jnp.float32,
        kv_quant=quant), is_leaf=jmeta.is_meta)
    p = f"{arch}/q_" if quant else f"{arch}/"
    worst = 0.0
    for out in ranks:
        mi, ci = int(out["model_index"]), int(out["client_index"])
        rows = slice(0, 1) if mode == "seq" else slice(ci * (B // D), (ci + 1) * (B // D))
        np.testing.assert_array_equal(out[f"{p}tokens"], ref[f"{p}tokens"][:, rows],
                                      err_msg=f"{arch} {mode} {mesh} rank ({ci}, {mi}) tokens")
        for i, m in enumerate(metas):
            got, want = out[f"{p}cache/{i}"], piece(ref[f"{p}cache/{i}"], tuple(m.pspec),
                                                   mi, ci, M, D)
            what = f"{arch} {mode} {mesh} rank ({ci}, {mi}) cache {i} ({m.dtype})"
            if m.dtype != jnp.float32:  # int8 codes and bfloat16 scales (as float32)
                assert got.dtype == want.dtype, what
                np.testing.assert_array_equal(got, want, err_msg=what)
            else:
                tp_harness.close(got, want, CACHE_RTOL, what)
                scale = np.abs(want).max()
                worst = max(worst, float(np.abs(got - want).max() / scale) if scale else 0.0)
    return worst


ARGMAX_WANT = [5, 20, 0, 31]
