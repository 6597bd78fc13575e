"""The LM layers and steps at the reference's own precision, bfloat16,
against the JAX reference at bfloat16, on the CPU:

  * each layer's forward (attention with and without a window and qkv
    bias, the four MLP kinds, MoE, the SSD block) and the decode halves
    (attention against a bfloat16 KV cache, the SSM's recurrent step on a
    float32 state with bfloat16 conv tails), from the reference's
    bfloat16 parameters carried across exactly (``shard_from_numpy``,
    through float32), on a bfloat16 input: within ``HIDDEN_RTOL`` of the
    largest element of the reference's output;
  * on one dense (gemma3-4b), one MoE (qwen3-moe-30b-a3b) and one SSM
    (mamba2-370m) reduced config, on the reference's bfloat16 parameters,
    against the reference rounding every op as its dtype says
    (tests/tp_reference.py's ``precision`` job: XLA's excess precision
    off, which equals the reference run op by op under
    ``jax.disable_jit``, bit for bit): ``loss_fn`` at its
    defaults (bfloat16 compute, remat) within ``LOSS_RTOL`` of the
    reference's, ``forward_hidden``'s hidden states within
    ``HIDDEN_RTOL``; ``prefill`` and ``decode_step`` (the serve steps'
    defaults): the caches within ``HIDDEN_RTOL``, the greedy tokens equal
    to the reference's or a near tie;
  * ``remat`` on == off bit for bit at bfloat16 compute on float32
    parameters (the train step's): the loss and every gradient leaf, each
    config;
  * the parameters' dtypes: ``param_meta``/``init_params(dtype=)`` equal
    the reference's leaf for leaf (the router and the SSM's ``A_log``,
    ``D_skip``, ``dt_bias`` float32), ``batch_structs`` and
    ``meta.shape_dtype_structs`` on the meta device.

Both sides round each op's output to bfloat16 (the activations follow
the reference's formulas op by op, ``models/common.py:silu``/``gelu``),
and the products accumulate in float32 in another order, so outputs
differ by a few bfloat16 ulps, not bit for bit. Under ``jax.jit`` with
XLA's defaults the reference may keep a fused chain of bfloat16 ops in
float32 (``xla_allow_excess_precision``): its jitted forward strays from
its own op-by-op run by 0.9% of the largest hidden element on gemma3 and
32-42% on the MoE config (a token routed to another expert); the test
records that drift (``reference_jit_vs_op_by_op``, ROADMAP.md C10).
"""
import torch_threads  # noqa: F401  (first: pins torch's CPU threads)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tp_cases
import tp_harness
from repro.configs import registry as jregistry
from repro.configs.base import InputShape as JaxInputShape
from repro.distributed import step as jstep
from repro.models import attention as jattn
from repro.models import meta as jmeta
from repro.models import mlp as jmlp
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro.models import ssm as jssm
from repro.models.common import ParallelCtx as JaxParallelCtx
from repro_torch.configs import registry
from repro_torch.configs.base import InputShape
from repro_torch import convert
from repro_torch.convert import leaves, map_leaves, shard_from_numpy
from repro_torch.distributed import step as tstep
from repro_torch.models import attention, meta, mlp, model, moe, ssm
from repro_torch.models.common import ParallelCtx, rms_norm

HIDDEN_RTOL = 1e-2  # of the largest element: a few bfloat16 ulps over the layers
LOSS_RTOL = 5e-3
BF16 = torch.bfloat16
JCTX, CTX = JaxParallelCtx(), ParallelCtx()
ARCHS = tp_cases.PRECISION_ARCHS
B, PROMPT, CAP, STEPS = (tp_cases.PRECISION_BATCH, tp_cases.PRECISION_PROMPT,
                         tp_cases.PRECISION_CAP, tp_cases.PRECISION_STEPS)
D = 64
LAYERS = {
    "attn": dict(d_model=D, num_heads=4, num_kv_heads=2, head_dim=16, q_chunk=8),
    "attn_window_bias": dict(d_model=D, num_heads=4, num_kv_heads=1, head_dim=16, q_chunk=8,
                             window=6, qkv_bias=True),
}
MLP_KINDS = ("swiglu", "geglu", "squared_relu", "gelu")
MOE = dict(d_model=D, num_experts=4, top_k=2, d_ff_expert=32)
SSM = dict(d_model=D, state_dim=16, head_dim=16, chunk=8)


def _np(t):
    return np.asarray(jnp.asarray(t, jnp.float32), np.float64)


def _close(got: torch.Tensor, want, what: str, rtol: float = HIDDEN_RTOL) -> float:
    g, w = got.detach().to(torch.float64).numpy(), _np(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    err, scale = np.abs(g - w).max(), np.abs(w).max()
    assert err <= rtol * scale, f"{what}: max err {err} > {rtol} x {scale}"
    return float(err / scale)  # a plain float: pytest-xdist ships record_property's values


def _carry(jparams, meta_tree):
    """The reference's parameters (any dtype) as the port's, exactly."""
    return shard_from_numpy(jax.device_get(jparams), meta_tree, 1, 0, "cpu")


def _x(shape, seed=0):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(BF16)


def _positions(S):
    return (jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32)[None], (B, S)),
            torch.arange(S, dtype=torch.int32)[None].expand(B, S))


@pytest.mark.parametrize("name", LAYERS)
def test_attention_forward_and_decode_bf16(name, record_property):
    spec = attention.AttentionSpec(**LAYERS[name])
    jspec = jattn.AttentionSpec(**LAYERS[name])
    jp = jattn.init_params(jax.random.key(5), jspec, 1, jnp.bfloat16)
    p = _carry(jp, attention.param_meta(spec, 1, BF16))
    assert all(t.dtype == BF16 for t in leaves(p))
    jx, x = _x((B, 16, D))
    jpos, pos = _positions(16)
    want = jax.jit(lambda p, x: jattn.forward(p, jspec, JCTX, x, jpos))(jp, jx)
    got = attention.forward(p, spec, CTX, x, pos)
    assert got.dtype == BF16
    record_property("forward_rel_err", _close(got, want, f"{name} forward"))
    # decode one token at position 9 against a bfloat16 cache of 16
    cache_np = {k: np.random.default_rng(3).normal(size=s).astype(np.float32)
                for k, s in attention.init_cache_shape(spec, 1, B, 16).items()}
    jcache = {k: jnp.asarray(v, jnp.bfloat16) for k, v in cache_np.items()}
    cache = {k: torch.from_numpy(v).to(BF16) for k, v in cache_np.items()}
    jx1, x1 = _x((B, 1, D), seed=4)
    wy, wc = jax.jit(lambda p, c, x: jattn.decode(p, jspec, JCTX, x, c, jnp.int32(9)))(
        jp, jcache, jx1)
    gy, gc = attention.decode(p, spec, CTX, x1, cache, 9)
    assert gy.dtype == BF16 and gc["k"].dtype == BF16
    record_property("decode_rel_err", _close(gy, wy, f"{name} decode"))
    for k in ("k", "v"):
        _close(gc[k], wc[k], f"{name} decode cache {k}")


@pytest.mark.parametrize("kind", MLP_KINDS)
def test_mlp_forward_bf16(kind):
    jp = jmlp.init_params(jax.random.key(3), kind, D, 128, 1, jnp.bfloat16)
    p = _carry(jp, mlp.param_meta(kind, D, 128, 1, BF16))
    jx, x = _x((B, 8, D))
    want = jax.jit(lambda p, x: jmlp.forward(p, kind, JCTX, x))(jp, jx)
    got = mlp.forward(p, kind, CTX, x)
    assert got.dtype == BF16
    _close(got, want, kind)


def test_moe_forward_bf16_router_float32():
    spec, jspec = moe.MoESpec(**MOE), jmoe.MoESpec(**MOE)
    jp = jmoe.init_params(jax.random.key(9), jspec, 1, jnp.bfloat16)
    mt = moe.param_meta(spec, 1, BF16)
    assert mt["router"].dtype == torch.float32 and mt["w_up"].dtype == BF16
    p = _carry(jp, mt)
    jx, x = _x((B, 8, D))
    (wy, waux) = jax.jit(lambda p, x: jmoe.forward(p, jspec, JCTX, x))(jp, jx)
    gy, gaux = moe.forward(p, spec, CTX, x)
    assert gy.dtype == BF16
    _close(gy, wy, "moe")
    np.testing.assert_allclose(float(gaux["moe_aux_loss"]), float(waux["moe_aux_loss"]),
                               rtol=LOSS_RTOL)
    # a router handed back in bfloat16 (a ZeRO-1 step's) is promoted, as
    # the reference's mixed-dtype product promotes it
    p16 = {**p, "router": p["router"].to(BF16)}
    jp16 = {**jp, "router": jp["router"].astype(jnp.bfloat16)}
    _close(moe.forward(p16, spec, CTX, x)[0],
           jax.jit(lambda p, x: jmoe.forward(p, jspec, JCTX, x))(jp16, jx)[0], "moe bf16 router")


def test_ssm_forward_and_decode_bf16():
    spec, jspec = ssm.SSMSpec(**SSM), jssm.SSMSpec(**SSM)
    jp = jssm.init_params(jax.random.key(11), jspec, 1, jnp.bfloat16)
    mt = ssm.param_meta(spec, 1, BF16)
    assert {k for k, m in mt.items() if m.dtype == torch.float32} == {"A_log", "D_skip",
                                                                      "dt_bias"}
    p = _carry(jp, mt)
    jx, x = _x((B, 16, D))
    (wy, wstate) = jax.jit(lambda p, x: jssm.forward(p, jspec, JCTX, x, return_state=True))(
        jp, jx)
    gy, gstate = ssm.forward(p, spec, CTX, x, return_state=True)
    assert gy.dtype == BF16
    _close(gy, wy, "ssm forward")
    for k in ("h", "conv_x", "conv_bc"):
        _close(gstate[k], wstate[k], f"ssm state {k}")
    # one recurrent step from the prompt's state: h float32, tails bfloat16
    jstate = {"h": wstate["h"].astype(jnp.float32), "conv_x": wstate["conv_x"],
              "conv_bc": wstate["conv_bc"]}
    state = {"h": gstate["h"].to(torch.float32), "conv_x": gstate["conv_x"],
             "conv_bc": gstate["conv_bc"]}
    jx1, x1 = _x((B, 1, D), seed=7)
    wy1, wnew = jax.jit(lambda p, s, x: jssm.decode(p, jspec, JCTX, x, s))(jp, jstate, jx1)
    gy1, gnew = ssm.decode(p, spec, CTX, x1, state)
    _close(gy1, wy1, "ssm decode")
    assert gnew["h"].dtype == torch.float32 and gnew["conv_x"].dtype == BF16
    for k in ("h", "conv_x", "conv_bc"):
        _close(gnew[k], wnew[k], f"ssm decode state {k}")


@pytest.fixture(scope="module", autouse=True)
def reference_job(tmp_path_factory):
    """tests/tp_reference.py's ``precision`` job on each config's prompt,
    started with the module's first test so that it runs beside the layer
    tests: the reference at bfloat16 with XLA's excess precision off,
    which rounds every op as the reference run op by op
    (``jax.disable_jit``) does, bit for bit."""
    tmp = tmp_path_factory.mktemp("precision")
    rng = np.random.default_rng(2)
    inputs = {}
    for name in ARCHS:
        vocab = registry.get_config(name, reduced=True).vocab_size
        toks = rng.integers(0, vocab, (B, PROMPT)).astype(np.int32)
        inputs[f"{name}/tokens"], inputs[f"{name}/labels"] = toks, np.roll(toks, -1, axis=1)
    np.savez(tmp / "inputs.npz", **inputs)
    proc = tp_harness.reference("precision", tmp / "inputs.npz", tmp / "ref.npz")
    yield proc, tmp, inputs
    if proc.poll() is None:
        proc.kill()


@pytest.fixture(scope="module")
def reference(reference_job) -> dict:
    proc, tmp, inputs = reference_job
    tp_harness.wait([proc])
    return {**inputs, **tp_harness.load(tmp / "ref.npz")}


@pytest.fixture(scope="module", params=ARCHS)
def arch(request, reference):
    """One reduced config: the reference's bfloat16 parameters carried
    across, the port's own float32 ones (the train step's, for remat), a
    token batch, and the reference's outputs (``reference``)."""
    name = request.param
    jcfg, cfg = jregistry.get_config(name, reduced=True), registry.get_config(name, reduced=True)
    mt = model.param_meta(cfg, dtype=BF16)
    p16 = shard_from_numpy(map_leaves(lambda i, _: reference[f"{name}/params/{i}"], mt), mt, 1,
                           0, "cpu")
    n_caches = sum(1 for k in reference if k.startswith(f"{name}/cache/"))
    return {"name": name, "jcfg": jcfg, "cfg": cfg, "p16": p16,
            "p32": model.init_params(torch.Generator().manual_seed(7), cfg, device="cpu"),
            "batch": {k: reference[f"{name}/{k}"] for k in ("tokens", "labels")},
            "ref": {"loss": float(reference[f"{name}/loss"]),
                    "hidden": reference[f"{name}/hidden"],
                    "tokens": reference[f"{name}/greedy"],
                    "caches": [reference[f"{name}/cache/{i}"] for i in range(n_caches)]}}


def test_param_dtypes_match_reference(arch):
    for dtype, jdtype in ((torch.float32, jnp.float32), (BF16, jnp.bfloat16)):
        got = leaves(model.param_meta(arch["cfg"], tp=2, dtype=dtype))
        want = jax.tree_util.tree_leaves(jmodel.param_meta(arch["jcfg"], tp=2, dtype=jdtype),
                                         is_leaf=jmeta.is_meta)
        assert [(g.shape, str(g.dtype).split(".")[1], g.sync) for g in got] == [
            (tuple(w.shape), np.dtype(w.dtype).name, w.sync) for w in want]
    params = model.init_params(torch.Generator().manual_seed(0), arch["cfg"], device="cpu",
                               dtype=BF16)
    assert [t.dtype for t in leaves(params)] == [m.dtype for m in leaves(
        model.param_meta(arch["cfg"], dtype=BF16))]
    structs = meta.shape_dtype_structs(model.param_meta(arch["cfg"], dtype=BF16))
    assert all(t.device.type == "meta" for t in leaves(structs))
    assert [(tuple(t.shape), t.dtype) for t in leaves(structs)] == [
        (tuple(t.shape), t.dtype) for t in leaves(params)]
    shape = InputShape("t", 64, 4, "train")
    want = jstep.batch_structs(arch["jcfg"], JaxInputShape("t", 64, 4, "train"))
    got = tstep.batch_structs(arch["cfg"], shape)
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[1]) for k, v in got.items()} == {
        k: (tuple(v.shape), np.dtype(v.dtype).name) for k, v in want.items()}
    assert all(v.device.type == "meta" for v in got.values())


def test_loss_and_hidden_bf16_match_reference(arch, record_property):
    cfg, ref = arch["cfg"], arch["ref"]
    tbatch = {k: torch.from_numpy(v) for k, v in arch["batch"].items()}
    got, _ = model.loss_fn(arch["p16"], cfg, CTX, tbatch)  # the defaults: remat, bfloat16
    np.testing.assert_allclose(float(got), ref["loss"], rtol=LOSS_RTOL)
    record_property("loss_rel_err", abs(float(got) - ref["loss"]) / abs(ref["loss"]))
    h, _ = model.forward_hidden(arch["p16"], cfg, CTX, tbatch["tokens"], compute_dtype=BF16)
    assert h.dtype == BF16
    record_property("hidden_rel_err", _close(h, ref["hidden"], f"{arch['name']} hidden"))
    # the reference's forward under XLA's default, for the record: it may
    # keep a fused chain of bfloat16 ops in float32 (and a MoE token may
    # then pick another expert), so that it strays from its op-by-op self
    # as far as the port does, or further
    jparams = jax.tree_util.tree_map(lambda t: jnp.asarray(t.to(torch.float32).numpy(),
                                                           jnp.bfloat16), arch["p16"])
    jit, _ = jax.jit(lambda p, t: jmodel.forward_hidden(p, arch["jcfg"], JCTX, t,
                                                        compute_dtype=jnp.bfloat16))(
        jparams, jnp.asarray(arch["batch"]["tokens"]))
    eager = np.asarray(ref["hidden"], np.float64)
    record_property("reference_jit_vs_op_by_op", float(np.abs(_np(jit) - eager).max()
                                                       / np.abs(eager).max()))


def test_remat_on_equals_off_bit_for_bit(arch):
    cfg = arch["cfg"]
    tbatch = {k: torch.from_numpy(v) for k, v in arch["batch"].items()}
    out = []
    for remat in (False, True):
        p = [t.detach().requires_grad_() for t in leaves(arch["p32"])]
        loss, _ = model.loss_fn(map_leaves(lambda i, _: p[i], arch["p32"]), cfg, CTX, tbatch,
                                remat=remat, compute_dtype=BF16)
        out.append((loss.detach(), torch.autograd.grad(loss, p)))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    assert len(g0) == len(g1) and all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert all(g.dtype == torch.float32 for g in g1)


def _logits(arch, tokens: np.ndarray) -> torch.Tensor:
    """The port's bfloat16 logits (as float32) after the prompt followed
    by ``tokens`` (B, k), from a teacher-forced forward."""
    p, cfg = arch["p16"], arch["cfg"]
    seq = torch.cat([torch.from_numpy(arch["batch"]["tokens"]), torch.from_numpy(tokens)], 1)
    h, _ = model.forward_hidden(p, cfg, CTX, seq, compute_dtype=BF16)
    h = rms_norm(h, p["final_norm"])[:, -1]
    return (h @ p["lm_head"][:, 0]).to(torch.float32)


def test_prefill_and_decode_bf16_match_reference(arch, record_property):
    """Prefill's caches within HIDDEN_RTOL; each greedy token, the decode
    teacher-forced on the reference's tokens, equal to the reference's,
    or else a near tie: the two candidates' logits within HIDDEN_RTOL of
    the largest logit (bfloat16 logits tie often: 8 bits of mantissa
    over a few hundred ids)."""
    cfg, ref = arch["cfg"], arch["ref"]
    shape = InputShape("t", CAP, B, "decode")
    got_nxt, caches = model.prefill(arch["p16"], cfg, CTX,
                                    torch.from_numpy(arch["batch"]["tokens"]), shape)
    worst = 0.0
    got_caches = leaves(caches)
    assert len(got_caches) == len(ref["caches"])
    for c, w, m in zip(got_caches, ref["caches"], leaves(model.cache_meta(cfg, 1, shape, ()))):
        assert c.dtype == m.dtype and m.dtype in (BF16, torch.float32), (c.dtype, m)
        worst = max(worst, _close(c, w, f"{arch['name']} prefill cache"))
    record_property("cache_rel_err", worst)
    want = ref["tokens"]
    got = [got_nxt.numpy()]
    for i in range(STEPS):
        nxt, caches = model.decode_step(arch["p16"], caches, cfg, CTX,
                                        torch.from_numpy(want[:, i:i + 1]), PROMPT + i)
        got.append(nxt.numpy())
    got = np.stack(got, 1)
    ties = []
    for row, step in zip(*np.nonzero(got != want)):
        logits = _logits(arch, want[:, :step])[row]
        gap = abs(float(logits[got[row, step]] - logits[want[row, step]]))
        assert gap <= HIDDEN_RTOL * float(logits.abs().max()), (
            f"{arch['name']} step {step} row {row}: {got[row, step]} vs the reference's "
            f"{want[row, step]}, logits {gap} apart")
        ties.append((int(step), int(row), gap))
    record_property("near_ties", ties)


def test_zero1_master_of_a_bf16_tree_matches_reference():
    """``convert.zero1_init_master`` of the reference's bfloat16 global
    tree at tp = 2 over 2 clients == the reference's, and a rank's shard
    of it == ``zero1_master_shard`` of its own slices (reduced
    gemma3-4b)."""
    jcfg, cfg = jregistry.get_config(ARCHS[0], reduced=True), registry.get_config(ARCHS[0],
                                                                                  reduced=True)
    j16 = jax.jit(lambda k: jmodel.init_params(k, jcfg, tp=2, dtype=jnp.bfloat16))(
        jax.random.key(1))
    jmt = jmodel.param_meta(jcfg, tp=2, dtype=jnp.bfloat16)
    want = jax.device_get(jstep.zero1_init_master(j16, jmt, 2, 2))
    mt = model.param_meta(cfg, tp=2, dtype=BF16)
    host = jax.device_get(j16)
    got = convert.zero1_init_master(host, mt, 2, 2)
    for g, w in zip(leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    master_meta = tstep.zero1_master_meta(mt, 2, 2, ("data",))
    for model_index in range(2):
        local = shard_from_numpy(host, mt, 2, model_index, "cpu")
        for client in range(2):
            ctx = dataclasses.replace(CTX, n_clients=2, client_index=client)
            mine = tstep.zero1_master_shard(local, ctx)
            piece = shard_from_numpy(got, master_meta, 2, model_index, "cpu", client=client,
                                     n_clients=2)
            assert all(torch.equal(a, b) for a, b in zip(leaves(mine), leaves(piece)))
