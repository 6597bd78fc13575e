"""The serving half of the model zoo in the port (``models/attention.py``,
``ssm.py``, ``moe.py`` and ``model.py``'s prefill / decode, and
``launch/serve.py``) against the JAX reference, on the CPU, from the
reference's parameters carried over with ``tree_from_numpy``:

  * for each of the ten reduced configs (batch 2, prompt 64, capacity
    96; pixtral and musicgen with prefix embeddings): prefill's caches
    (``k``, ``v``, ``h``, ``conv_x``, ``conv_bc``) within ``CACHE_RTOL``
    of the largest entry of the reference's, each cache of the shape
    ``init_cache_shape`` / ``init_state_shape`` give and in a buffer of
    its own (a view would keep the prompt's activations alive through
    decode), and the greedy tokens of
    prefill and two decode steps equal to the reference's, each step's
    top-2 logit margin (from the port's teacher-forced forward) above
    ``MARGIN_MIN`` so that a flip fails with its margin;
  * in the port, prefill == the forward's argmax at the last position and
    the first decoded token == a teacher-forced forward over prompt + 1,
    for all ten; the MoE configs at a capacity that drops nothing (the
    training forward drops tokens past an expert's capacity, which
    depends on the token count, and decode never drops: the reference's
    ``tests/test_arch_smoke.py`` leaves them out of this check);
  * the sliding-window ring: reduced gemma3 at prompt 96 > window 64
    (prefill re-lays the last 64 keys to slot ``p % 64``), against the
    reference and teacher-forced;
  * the int8 KV helpers and a masked ``_cache_write`` on a hand-built
    int8 cache, and a decode step over it, bit for bit;
  * MoE decode capacity (T * top_k, nothing dropped); a tie in
    ``lm_head_argmax`` (the smallest id); ``seq_sharded=True`` with no
    seq axis == the plain decode bit for bit;
    ``dense_init`` on a CPU generator unchanged;
  * ``python -m repro_torch.launch.serve`` and
    ``examples/serve_demo_torch.py`` on ``--device cpu``.

Decode writes its caches in place: no test reuses a cache after a step.
"""
import torch_threads  # noqa: F401  (first: pins torch's CPU threads)
import dataclasses
import math
import os
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.configs.base import InputShape as JaxInputShape
from repro.models import attention as jattn
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro.models.common import ParallelCtx as JaxParallelCtx
from repro_torch.configs import registry
from repro_torch.configs.base import InputShape
from repro_torch.convert import tree_from_numpy
from repro_torch.models import attention, common, model, moe, ssm
from repro_torch.models.common import ParallelCtx, rms_norm

CACHE_RTOL = 1e-5  # of the largest entry: float32 einsums summed in another order
MARGIN_MIN = 1e-4  # a step's top-2 logit gap, far above the caches' ~1e-6 error
B, PROMPT, CAP, STEPS = 2, 64, 96, 2
ARCHS = registry.ARCH_IDS
JCTX, CTX = JaxParallelCtx(), ParallelCtx()
EXAMPLE = os.path.join(os.path.dirname(__file__), "..", "examples", "serve_demo_torch.py")


def _prompt(cfg, prompt_len, seed=1):
    """Tokens (B, prompt_len - P) and, with a frontend, P prefix embeddings."""
    rng = np.random.default_rng(seed)
    pfx = cfg.frontend.prefix_len if cfg.frontend else 0
    toks = rng.integers(0, cfg.vocab_size, (B, prompt_len - pfx)).astype(np.int32)
    pe = (rng.normal(size=(B, pfx, cfg.d_model)) * 0.02).astype(np.float32) if pfx else None
    return toks, pe


def _reference(jcfg, jparams, toks, pe, prompt_len, cap, steps):
    """The reference's prefill caches (numpy) and its greedy tokens of
    prefill and ``steps`` decode steps, jitted, float32 compute."""
    shape = JaxInputShape("t", cap, B, "decode")
    prefill = jax.jit(lambda p, t, e: jmodel.prefill(
        p, jcfg, JCTX, t, shape, prefix_embeds=e, compute_dtype=jnp.float32))
    decode = jax.jit(lambda p, c, t, pos: jmodel.decode_step(
        p, c, jcfg, JCTX, t, pos, compute_dtype=jnp.float32))
    nxt, caches = prefill(jparams, jnp.asarray(toks), None if pe is None else jnp.asarray(pe))
    first_caches = jax.device_get(caches)
    tokens = [np.asarray(nxt)]
    for i in range(steps):
        nxt, caches = decode(jparams, caches, nxt[:, None], jnp.int32(prompt_len + i))
        tokens.append(np.asarray(nxt))
    return first_caches, np.stack(tokens, 1)


def _case(name, prompt_len=PROMPT, cap=CAP, steps=STEPS):
    jcfg = jregistry.get_config(name, reduced=True)
    cfg = registry.get_config(name, reduced=True)
    jparams = jax.jit(lambda k: jmodel.init_params(k, jcfg))(jax.random.key(0))
    toks, pe = _prompt(cfg, prompt_len)
    ref_caches, ref_tokens = _reference(jcfg, jparams, toks, pe, prompt_len, cap, steps)
    return {"name": name, "cfg": cfg, "params": tree_from_numpy(jax.device_get(jparams), "cpu"),
            "toks": torch.from_numpy(toks), "pe": None if pe is None else torch.from_numpy(pe),
            "prompt_len": prompt_len, "cap": cap, "ref_caches": ref_caches,
            "ref_tokens": ref_tokens}


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    return _case(request.param)


def _prefill(c):
    return model.prefill(c["params"], c["cfg"], CTX, c["toks"],
                         InputShape("t", c["cap"], B, "decode"), c["pe"],
                         compute_dtype=torch.float32)


def _generate(c, steps):
    """Port tokens (B, steps + 1) and the prefill's caches as copies."""
    nxt, caches = _prefill(c)
    first = [{k: t.clone() for k, t in cache.items()} for cache in caches]
    tokens = [nxt]
    for i in range(steps):
        nxt, caches = model.decode_step(c["params"], caches, c["cfg"], CTX, nxt[:, None],
                                        c["prompt_len"] + i, compute_dtype=torch.float32)
        tokens.append(nxt)
    return first, torch.stack(tokens, 1).numpy()


def _last_logits(c, tokens):
    """The port's teacher-forced logits at the last position of the
    prompt followed by ``tokens`` (B, k)."""
    seq = torch.cat([c["toks"], torch.as_tensor(tokens, dtype=torch.int32)], 1)
    h, _ = model.forward_hidden(c["params"], c["cfg"], CTX, seq, c["pe"])
    h = rms_norm(h, c["params"]["final_norm"])[:, -1]
    return h @ c["params"]["lm_head"][:, 0]


def _assert_caches(got, want, what):
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        assert sorted(g) == sorted(w), (what, i)
        for k in w:
            w_np = np.asarray(w[k], np.float64)
            g_np = g[k].numpy().astype(np.float64)
            assert g_np.shape == w_np.shape, (what, i, k)
            err, scale = np.abs(g_np - w_np).max(), np.abs(w_np).max()
            assert err <= CACHE_RTOL * scale, f"{what} layer {i} {k}: {err} > {CACHE_RTOL} x {scale}"


def _assert_tokens(c, got, want):
    """Equal greedy tokens; each step's top-2 margin first, so that a flip
    reports how close the two candidates were."""
    for step in range(want.shape[1]):
        top2 = torch.topk(_last_logits(c, want[:, :step]), 2, dim=-1).values
        margin = (top2[:, 0] - top2[:, 1]).min().item()
        assert margin > MARGIN_MIN, f"{c['name']} step {step}: top-2 margin {margin}"
        np.testing.assert_array_equal(got[:, step], want[:, step],
                                      err_msg=f"{c['name']} step {step}, margin {margin}")


def test_prefill_caches_match_reference(case):
    first, _ = _generate(case, 0)
    _assert_caches(first, case["ref_caches"], case["name"])


def test_prefill_caches_own_their_storage(case):
    cfg = case["cfg"]
    _, caches = _prefill(case)
    for i, (layer, cache) in enumerate(zip(cfg.layers, caches)):
        if layer.kind == "ssm":
            want = ssm.init_state_shape(cfg.ssm, 1, B)
        else:
            S_c = case["cap"] if layer.window is None else min(case["cap"], layer.window)
            want = attention.init_cache_shape(cfg.attn_spec(layer), 1, B, S_c)
        assert {k: tuple(t.shape) for k, t in cache.items()} == want, (case["name"], i)
        for k, t in cache.items():
            assert t.untyped_storage().nbytes() == t.numel() * t.element_size(), (
                f"{case['name']} layer {i} {k}: a view of {t.untyped_storage().nbytes()} B")


def test_greedy_tokens_match_reference(case):
    _, tokens = _generate(case, STEPS)
    assert tokens.dtype == np.int32
    _assert_tokens(case, tokens, case["ref_tokens"])


def test_prefill_matches_forward_and_decode_teacher_forced(case):
    cfg = case["cfg"]
    if cfg.moe is not None:  # capacity T * top_k: no token dropped anywhere
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cfg.moe.num_experts)))
        case = {**case, "cfg": cfg}
    _, tokens = _generate(case, 1)
    assert ((tokens >= 0) & (tokens < cfg.padded_vocab(1))).all()
    for step in range(2):
        want = torch.argmax(_last_logits(case, tokens[:, :step]), -1).numpy()
        np.testing.assert_array_equal(tokens[:, step], want, err_msg=f"step {step}")


def test_ring_relay_prompt_longer_than_window():
    """Reduced gemma3: window 64 < prompt 96, so prefill keeps the last 64
    keys with key p at slot p % 64, and decode's ring rebuilds their
    positions from the write pointer."""
    c = _case("gemma3-4b", prompt_len=96, cap=128, steps=STEPS)
    window = c["cfg"].layers[0].window
    assert window == 64 and c["cfg"].layers[1].window is None
    first, tokens = _generate(c, STEPS)
    _assert_caches(first, c["ref_caches"], "gemma3 prompt 96")
    assert first[0]["k"].shape[3] == window and first[1]["k"].shape[3] == 128
    # slot p % 64 holds key p: the full-attention layer keeps every key in
    # order, but its keys are another layer's; recompute layer 0's own
    attn_p, spec = c["params"]["layers"][0]["attn"], c["cfg"].attn_spec(c["cfg"].layers[0])
    x = model.embed(c["params"], c["cfg"], CTX, c["toks"])
    h = rms_norm(x, c["params"]["layers"][0]["norm1"])
    pos = torch.arange(96, dtype=torch.int32)[None].expand(B, 96)
    _, full = attention.prefill_kv(attn_p, spec, CTX, h, pos, max_len=96)
    for p in range(96 - window, 96):
        assert torch.equal(first[0]["k"][:, :, :, p % window], full["k"][:, :, :, p])
    _assert_tokens(c, tokens, c["ref_tokens"])
    np.testing.assert_array_equal(
        tokens[:, 1], torch.argmax(_last_logits(c, tokens[:, :1]), -1).numpy())


def test_quant_kv_and_masked_int8_cache_write_bit_for_bit():
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(2, 3, 1, 16)) * 2.0).astype(np.float32)
    x[0, 0, 0] = 0.0  # the scale's 1e-8 floor
    x[1, 2, 0, :4] = [127.0, -63.5, 0.5, 1.5]  # halves: round half to even
    q, s = attention.quant_kv(torch.from_numpy(x))
    jq, js = jattn.quant_kv(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.bfloat16
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.float().numpy(), np.asarray(js).astype(np.float32))
    np.testing.assert_array_equal(attention.dequant_kv(q, s, torch.float32).numpy(),
                                  np.asarray(jattn.dequant_kv(jq, js, jnp.float32)))

    # a hand-built int8 cache (B, 1, kvl, S, hd) and its bf16 scales
    codes = rng.integers(-127, 128, size=(2, 1, 3, 8, 16)).astype(np.int8)
    scales = rng.uniform(0.01, 0.1, size=(2, 1, 3, 8, 1)).astype(np.float32)
    jcache = {"k": jnp.asarray(codes), "k_scale": jnp.asarray(scales, jnp.bfloat16)}
    cache = {"k": torch.from_numpy(codes.copy()),
             "k_scale": torch.from_numpy(scales).to(torch.bfloat16)}
    mask = np.array([True, False])[:, None, None, None]
    for masked in (None, mask):
        jnew = jattn._cache_write(jcache, "k", jcache["k"][:, 0], jnp.asarray(x), 5,
                                  masked_write=None if masked is None else jnp.asarray(masked))
        attention._cache_write(cache, "k", torch.from_numpy(x), 5,
                               masked_write=None if masked is None else torch.from_numpy(masked))
        np.testing.assert_array_equal(cache["k"].numpy(), np.asarray(jnew["k"]))
        np.testing.assert_array_equal(cache["k_scale"].float().numpy(),
                                      np.asarray(jnew["k_scale"]).astype(np.float32))
        jcache = {**jcache, **jnew}


def test_decode_over_int8_cache_matches_reference():
    """One attention decode step on an int8 KV cache: the written codes
    and scales bit for bit, the output within the float tolerance."""
    spec = dict(d_model=64, num_heads=4, num_kv_heads=2, head_dim=16)
    jspec, tspec = jattn.AttentionSpec(**spec), attention.AttentionSpec(**spec)
    jp = jax.jit(lambda k: jattn.init_params(k, jspec, 1))(jax.random.key(3))
    p = tree_from_numpy(jax.device_get(jp), "cpu")
    rng = np.random.default_rng(6)
    kv = (rng.normal(size=(2, 1, 2, 12, 16))).astype(np.float32)
    jcache, cache = {}, {}
    for name in ("k", "v"):
        q, s = jattn.quant_kv(jnp.asarray(kv * (1.0 if name == "k" else 0.5)))
        jcache[name], jcache[name + "_scale"] = q, s
        cache[name] = torch.from_numpy(np.asarray(q).copy())
        cache[name + "_scale"] = torch.from_numpy(
            np.asarray(s).astype(np.float32)).to(torch.bfloat16)
    x = rng.normal(size=(2, 1, 64)).astype(np.float32)
    jy, jnew = jax.jit(lambda p, x, c: jattn.decode(p, jspec, JCTX, x, c, jnp.int32(7)))(
        jp, jnp.asarray(x), jcache)
    y, new = attention.decode(p, tspec, CTX, torch.from_numpy(x), cache, 7)
    assert new is cache
    for k in ("k", "v"):
        np.testing.assert_array_equal(cache[k].numpy(), np.asarray(jnew[k]))
        np.testing.assert_array_equal(cache[k + "_scale"].float().numpy(),
                                      np.asarray(jnew[k + "_scale"]).astype(np.float32))
    err = np.abs(y.numpy() - np.asarray(jy)).max()
    assert err <= CACHE_RTOL * np.abs(np.asarray(jy)).max()


def test_moe_decode_capacity_drops_nothing():
    kw = dict(d_model=32, num_experts=4, top_k=2, d_ff_expert=16)
    jspec, tspec = jmoe.MoESpec(**kw), moe.MoESpec(**kw)
    for T in (1, 2, 5):
        assert moe._capacity(tspec, T, decode=True) == T * 2 == \
            jmoe._capacity(jspec, T, decode=True)
        assert moe._capacity(tspec, T, decode=False) == jmoe._capacity(jspec, T, decode=False)
    jp = jax.jit(lambda k: jmoe.init_params(k, jspec, 1))(jax.random.key(4))
    p = tree_from_numpy(jax.device_get(jp), "cpu")
    # every token routed to one expert: training capacity would drop some
    x = np.ones((2, 3, 32), np.float32) + 0.01 * np.random.default_rng(2).normal(
        size=(2, 3, 32)).astype(np.float32)
    y, aux = moe.forward(p, tspec, CTX, torch.from_numpy(x), decode=True)
    jy, jaux = jax.jit(lambda p, x: jmoe.forward(p, jspec, JCTX, x, decode=True))(
        jp, jnp.asarray(x))
    _, aux_train = moe.forward(p, tspec, CTX, torch.from_numpy(x))
    assert float(aux["moe_drop_frac"]) == 0.0 == float(jaux["moe_drop_frac"])
    assert float(aux_train["moe_drop_frac"]) > 0.0
    err = np.abs(y.numpy() - np.asarray(jy)).max()
    assert err <= CACHE_RTOL * np.abs(np.asarray(jy)).max()


def test_lm_head_argmax_ties_go_to_the_smallest_id():
    D, V = 8, 16
    head = np.zeros((D, 1, V), np.float32)
    head[:, 0, 3] = head[:, 0, 11] = head[:, 0, 7] = 1.0  # three equal maxima
    head[:, 0, 5] = 0.5
    params = {"lm_head": torch.from_numpy(head)}
    h = np.ones((3, D), np.float32)
    h[2] = -1.0  # all logits of row 2 <= 0: ties among the zeros at id 0
    got = model.lm_head_argmax(params, CTX, torch.from_numpy(h))
    want = jmodel.lm_head_argmax({"lm_head": jnp.asarray(head)}, JCTX, jnp.asarray(h))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), [3, 3, 0])


def test_seq_sharded_decode_is_refused():
    """Named for the refusal it held until flash-decoding was ported: now
    the reference's case of ``seq_sharded=True`` with no seq axis (its
    ``attention.py:309``), the plain decode, bit for bit (output and the
    written caches, float32 and int8)."""
    spec = attention.AttentionSpec(d_model=16, num_heads=2, num_kv_heads=1, head_dim=8)
    p = attention.init_params(torch.Generator().manual_seed(0), spec, device="cpu")
    rng = np.random.default_rng(8)
    kv = rng.normal(size=(2, 1, 1, 6, 8)).astype(np.float32)
    x = torch.from_numpy(rng.normal(size=(2, 1, 16)).astype(np.float32))
    for quant in (False, True):
        caches = []
        for _ in range(2):
            if quant:
                q, s = attention.quant_kv(torch.from_numpy(kv))
                caches.append({"k": q.clone(), "k_scale": s.clone(), "v": q.clone(),
                               "v_scale": s.clone()})
            else:
                caches.append({k: torch.from_numpy(kv.copy()) for k in ("k", "v")})
        for pos in (0, 3, 5):
            plain, _ = attention.decode(p, spec, CTX, x, caches[0], pos)
            sharded, _ = attention.decode(p, spec, CTX, x, caches[1], pos, seq_sharded=True)
            assert torch.equal(plain, sharded), (quant, pos)
            for k in caches[0]:
                assert torch.equal(caches[0][k], caches[1][k]), (quant, pos, k)


def test_dense_init_on_a_cpu_generator_is_unchanged():
    """A CPU generator draws on the CPU, whatever the target device: the
    values of the truncated normal at 1/sqrt(fan_in), as before."""
    shape = (24, 1, 40)
    got = common.dense_init(torch.Generator().manual_seed(9), shape, in_axis=0, device="cpu")
    t = torch.empty(shape)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=torch.Generator().manual_seed(9))
    assert torch.equal(got, t * (1.0 / math.sqrt(24)))


def test_launch_serve_and_demo_on_cpu(monkeypatch, capsys):
    from repro_torch.launch import serve

    cfg = registry.get_config("musicgen-medium", reduced=True)  # a prefix frontend
    out = serve.main(["--arch", "musicgen-medium", "--reduced", "--batch", "2",
                      "--prompt-len", "40", "--gen", "5", "--device", "cpu"])
    tokens = np.asarray(out["tokens"])
    assert tokens.shape == (2, 5) and ((tokens >= 0) & (tokens < cfg.padded_vocab(1))).all()
    assert out["prefill_tok_per_s"] > 0 and out["decode_tok_per_s"] > 0
    assert "sample:" in capsys.readouterr().out

    monkeypatch.setattr(sys, "argv", [EXAMPLE, "--arch", "zamba2-1.2b", "--requests", "3",
                                      "--batch", "2", "--prompt-len", "24", "--gen", "4",
                                      "--device", "cpu"])
    runpy.run_path(EXAMPLE, run_name="__main__")
    lines = capsys.readouterr().out.splitlines()
    assert sum(line.startswith("batch done: generated 4 tokens x 2") for line in lines) == 2
    assert lines[-1].startswith("served 4 requests (16 tokens)")
