"""The model zoo's layers in the port (``src/repro_torch/models/``) against
the JAX reference (``src/repro/models/``), module by module, at small
widths on the CPU, from the reference's parameters carried over with
``tree_from_numpy``: outputs, and gradients of ``sum(y * r)`` with
respect to the parameters and the input.

  * ``rms_norm`` (the ``1 + weight`` scale) and ``apply_rope``, full and
    partial rotary (interleaved pairs);
  * the four MLP kinds (GELU is the tanh approximation);
  * attention with GQA, ``qkv_bias``, a window shorter than S and more
    than one ``q_chunk``; the first window positions (the reference's
    padding-key fix) also against a plain unpadded attention;
  * MoE with drops at capacity and its aux loss; the routing indices
    against the reference's ``lax.top_k``, exactly;
  * the SSM with more than one chunk.

Tolerances: float32 einsums summed in another order; ``FWD_RTOL`` of the
largest output, ``GRAD_RTOL`` of the largest gradient.
"""
import torch_threads  # noqa: F401  (first: pins torch's CPU threads)
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import mlp as jmlp
from repro.models import moe as jmoe
from repro.models import ssm as jssm
from repro_torch.convert import ravel, tree_from_numpy
from repro_torch.models import attention, common, mlp, moe, ssm
from repro_torch.models.common import ParallelCtx

FWD_RTOL = 2e-6
GRAD_RTOL = 1e-5
JCTX = jcommon.ParallelCtx()
CTX = ParallelCtx()


def _x(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _close(got, want, rtol=FWD_RTOL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max()
    scale = np.abs(want).max()
    assert err <= rtol * scale, f"{what}: max err {err} > {rtol} x {scale}"


def _check_layer(jfwd, tfwd, jparams, x_np, seed=1):
    """Forward of both packages on the same parameters and input, and the
    gradients of sum(y * r) in the parameters (raveled) and the input."""
    jfwd = jax.jit(jfwd)
    jy = jfwd(jparams, jnp.asarray(x_np))
    r = _x(jy.shape, seed)

    def jloss(p, x):
        return jnp.sum(jfwd(p, x) * r)

    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jparams, jnp.asarray(x_np))

    params = tree_from_numpy(jax.device_get(jparams), device="cpu")
    flat, unravel = ravel(params)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(ravel_pytree(jparams)[0]))
    flat.requires_grad_(True)
    x = torch.from_numpy(x_np).requires_grad_(True)
    y = tfwd(unravel(flat), x)
    (y * torch.from_numpy(r)).sum().backward()
    _close(y.detach().numpy(), jy, what="output")
    _close(flat.grad.numpy(), ravel_pytree(jgp)[0], GRAD_RTOL, "parameter gradient")
    _close(x.grad.numpy(), jgx, GRAD_RTOL, "input gradient")


# ---------------------------------------------------------------------------
# common
# ---------------------------------------------------------------------------


def test_rms_norm_matches_reference():
    x, w = _x((3, 5, 48)), _x((48,), 1, 0.3)
    got = common.rms_norm(torch.from_numpy(x), torch.from_numpy(w))
    _close(got.numpy(), jcommon.rms_norm(jnp.asarray(x), jnp.asarray(w)))
    # zero weights: the 1 + weight scale is the plain RMS normalisation
    plain = x / np.sqrt((x.astype(np.float64) ** 2).mean(-1, keepdims=True) + 1e-6)
    _close(common.rms_norm(torch.from_numpy(x), torch.zeros(48)).numpy(), plain)


@pytest.mark.parametrize("rotary_frac", [1.0, 0.5, 0.3])
@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_apply_rope_matches_reference(rotary_frac, theta):
    x = _x((2, 24, 3, 20))
    pos = np.broadcast_to(np.arange(24, dtype=np.int32)[None], (2, 24))
    got = common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos.copy()), theta,
                            rotary_frac)
    want = jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta, rotary_frac)
    _close(got.numpy(), want)
    inv, rot = common.rope_frequencies(20, theta, rotary_frac)
    jinv, jrot = jcommon.rope_frequencies(20, theta, rotary_frac)
    assert rot == jrot and rot % 2 == 0
    _close(inv.numpy(), jinv)
    # the dims past rot pass through untouched
    np.testing.assert_array_equal(got.numpy()[..., rot:], x[..., rot:])


def test_dense_init_is_truncated_at_two_sigma():
    t = common.dense_init(torch.Generator().manual_seed(0), (256, 64), device="cpu")
    assert t.dtype == torch.float32 and t.shape == (256, 64)
    assert float(t.abs().max()) <= 2.0 / math.sqrt(256)
    assert abs(float(t.std()) * math.sqrt(256) - 0.88) < 0.02  # std of N(0,1) cut at +-2


def test_parallel_ctx_is_tp_one_only():
    """Without a model axis above 1 every model-axis collective is the
    identity (as the reference's with ``model_axis=None``); a model axis
    above 1 needs its process group (tests/test_torch_tp_ops.py runs
    one); so is the compressed all-gather (``sp_compress``)."""
    assert CTX.model_index() == 0 and CTX.psum_model(3) == 3
    for ctx in (ParallelCtx(tp=2), ParallelCtx(model_axis="model")):
        assert not ctx.model and ctx.model_index() == 0 and ctx.psum_model(3) == 3
    with pytest.raises(ValueError, match="process group"):
        ParallelCtx(model_axis="model", tp=2)
    x = torch.arange(6.0).reshape(1, 2, 3)
    assert ParallelCtx(sp_compress=True, seq_parallel=True).sp_gather(x) is x
    # the geometry planner is pure Python: equal at every tp it accepts
    for h, kv in [(8, 2), (32, 8), (4, 4), (48, 8), (24, 24)]:
        for tp in (1, 2, 4, 8, 16):
            try:
                want = dataclasses.astuple(jcommon.plan_attn_sharding(h, kv, tp))
            except ValueError:
                with pytest.raises(ValueError):
                    common.plan_attn_sharding(h, kv, tp)
                continue
            assert dataclasses.astuple(common.plan_attn_sharding(h, kv, tp)) == want


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "squared_relu", "gelu"])
def test_mlp_matches_reference(kind):
    jp = jmlp.init_params(jax.random.key(3), kind, 32, 64, 1)
    _check_layer(lambda p, x: jmlp.forward(p, kind, JCTX, x),
                 lambda p, x: mlp.forward(p, kind, CTX, x), jp, _x((2, 8, 32)))


def test_gelu_is_the_tanh_approximation():
    x = torch.linspace(-4, 4, 101)
    _close(mlp.gelu(x).numpy(), jax.nn.gelu(jnp.asarray(x.numpy())))
    erf = torch.nn.functional.gelu(x)
    assert float((mlp.gelu(x) - erf).abs().max()) > 1e-4  # the erf form differs


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

ATTN_CASES = {
    # GQA 4 query heads over 2 kv heads, bias, partial rotary, a window of
    # 12 over S=32 in q_chunks of 8 (the padded key path)
    "gqa_window_chunks": dict(d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
                              window=12, qkv_bias=True, q_chunk=8, rotary_frac=0.5),
    # full causal, several chunks, MHA
    "causal_chunks": dict(d_model=48, num_heads=3, num_kv_heads=3, head_dim=16, q_chunk=8),
    # a window that is not a chunk multiple, one kv head
    "mqa_window_7": dict(d_model=32, num_heads=2, num_kv_heads=1, head_dim=16, window=7,
                         q_chunk=16),
}


def _attn_params(spec):
    jp = jattn.init_params(jax.random.key(5), jattn.AttentionSpec(**spec), 1)
    if "bq" in jp:  # nonzero biases, to exercise them
        jp["bq"] = jnp.asarray(_x(jp["bq"].shape, 7, 0.2))
        jp["bkv"] = jnp.asarray(_x(jp["bkv"].shape, 8, 0.2))
    return jp


def _positions(B, S):
    return np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S)).copy()


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attention_matches_reference(case):
    kw = ATTN_CASES[case]
    jspec, spec = jattn.AttentionSpec(**kw), attention.AttentionSpec(**kw)
    B, S = 2, 32
    pos_j, pos_t = jnp.asarray(_positions(B, S)), torch.from_numpy(_positions(B, S))
    _check_layer(lambda p, x: jattn.forward(p, jspec, JCTX, x, pos_j),
                 lambda p, x: attention.forward(p, spec, CTX, x, pos_t),
                 _attn_params(kw), _x((B, S, kw["d_model"])))


def _plain_attention(params, spec, x, positions):
    """Unchunked, unpadded attention with the causal window mask: every
    query sees keys j with q - window < j <= q."""
    sh = attention.plan(spec, 1)
    q, k, v = attention._project_qkv(params, spec, sh, x, positions)
    B, S = x.shape[:2]
    group = sh.q_local // sh.kv_local
    k = k.repeat_interleave(group, dim=2)
    v = v.repeat_interleave(group, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * spec.scale
    i = torch.arange(S)
    ok = (i[None, :] <= i[:, None])
    if spec.window is not None:
        ok &= i[None, :] > i[:, None] - spec.window
    w = torch.softmax(scores.masked_fill(~ok, -math.inf), dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(B, S, -1)
    return out @ params["wo"][0]


@pytest.mark.parametrize("case", ["gqa_window_chunks", "mqa_window_7"])
def test_window_front_padding_is_masked(case):
    """The first ``window`` positions of the padded windowed path attend
    no padding key: equal to the plain unpadded attention there (and
    everywhere), where the reference before its padding-key fix was not."""
    kw = ATTN_CASES[case]
    spec = attention.AttentionSpec(**kw)
    params = tree_from_numpy(jax.device_get(_attn_params(kw)), device="cpu")
    x = torch.from_numpy(_x((2, 32, kw["d_model"])))
    pos = torch.from_numpy(_positions(2, 32))
    got = attention.forward(params, spec, CTX, x, pos)
    want = _plain_attention(params, spec, x, pos)
    _close(got[:, :kw["window"]].detach().numpy(), want[:, :kw["window"]].detach().numpy())
    _close(got.detach().numpy(), want.detach().numpy())


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

MOE = dict(d_model=32, num_experts=4, top_k=2, d_ff_expert=48, capacity_factor=0.5)


def test_moe_matches_reference_with_drops():
    jspec, spec = jmoe.MoESpec(**MOE), moe.MoESpec(**MOE)
    jp = jmoe.init_params(jax.random.key(9), jspec, 1)
    x = _x((2, 32, 32))
    jy, jaux = jmoe.forward(jp, jspec, JCTX, jnp.asarray(x))
    params = tree_from_numpy(jax.device_get(jp), device="cpu")
    y, aux = moe.forward(params, spec, CTX, torch.from_numpy(x))
    assert float(jaux["moe_drop_frac"]) > 0.2  # capacity 16 of 128 assignments / 4
    np.testing.assert_allclose(float(aux["moe_drop_frac"]), float(jaux["moe_drop_frac"]),
                               rtol=0, atol=0)
    _close(y.numpy(), jy)
    np.testing.assert_allclose(float(aux["moe_aux_loss"]), float(jaux["moe_aux_loss"]),
                               rtol=1e-6)
    # the routing: the same experts, in lax.top_k's order
    logits = torch.from_numpy(x.reshape(-1, 32)) @ params["router"]
    _, top_e = moe.top_k(torch.softmax(logits, -1), 2)
    _, jtop_e = jax.lax.top_k(jax.nn.softmax(jnp.asarray(x.reshape(-1, 32)) @ jp["router"]), 2)
    np.testing.assert_array_equal(top_e.numpy(), np.asarray(jtop_e))
    _check_layer(lambda p, x: jmoe.forward(p, jspec, JCTX, x)[0],
                 lambda p, x: moe.forward(p, spec, CTX, x)[0], jp, x)


def test_moe_top_k_breaks_ties_to_the_lower_index():
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4]])
    vals, idx = moe.top_k(probs, 2)
    np.testing.assert_array_equal(idx.numpy(), [[0, 1], [1, 3]])
    _, jidx = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))


def test_moe_runs_under_vmap_grad():
    spec = moe.MoESpec(**MOE)
    params = moe.init_params(torch.Generator().manual_seed(0), spec, device="cpu")
    flat, unravel = ravel(params)
    xs = torch.from_numpy(_x((3, 2, 16, 32)))

    def loss(f, x):
        return moe.forward(unravel(f), spec, CTX, x)[0].square().sum()

    g = torch.func.vmap(torch.func.grad(loss), in_dims=(None, 0))(flat, xs)
    for i in range(3):
        _close(g[i].numpy(), torch.func.grad(loss)(flat, xs[i]).numpy(), 1e-6)


# ---------------------------------------------------------------------------
# SSM
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [8, 32])
def test_ssm_matches_reference(chunk):
    kw = dict(d_model=32, state_dim=8, head_dim=16, expand=2, chunk=chunk)
    jspec, spec = jssm.SSMSpec(**kw), ssm.SSMSpec(**kw)
    jp = jssm.init_params(jax.random.key(11), jspec, 1)
    jp["norm"] = jnp.asarray(_x(jp["norm"].shape, 12, 0.2))
    _check_layer(lambda p, x: jssm.forward(p, jspec, JCTX, x),
                 lambda p, x: ssm.forward(p, spec, CTX, x), jp, _x((2, 32, 32), 13, 0.5))


def test_ssm_init_special_leaves():
    spec = ssm.SSMSpec(d_model=32, state_dim=8, head_dim=16, chunk=8)
    p = ssm.init_params(torch.Generator().manual_seed(0), spec, device="cpu")
    jp = jssm.init_params(jax.random.key(0), jssm.SSMSpec(**dataclasses.asdict(spec)), 1)
    assert {k: tuple(v.shape) for k, v in p.items()} == {k: v.shape for k, v in jp.items()}
    np.testing.assert_array_equal(p["A_log"].numpy(), np.asarray(jp["A_log"]))
    np.testing.assert_array_equal(p["D_skip"].numpy(), np.asarray(jp["D_skip"]))
    assert not p["norm"].any()
    dt = torch.nn.functional.softplus(p["dt_bias"].double())  # the inverse softplus
    assert float(dt.min()) >= spec.dt_min * (1 - 1e-5) and float(dt.max()) <= spec.dt_max * 1.00001
