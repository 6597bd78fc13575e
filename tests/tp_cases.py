"""The cases the tensor-parallel parity tests share between the JAX
reference's side (tests/tp_reference.py, a subprocess with four fake CPU
devices) and the port's gloo ranks (tests/torch_tp_worker.py): plain
data, imported by both, importing neither package.

A layer case names the layer, its spec's fields, the model axis ``tp``,
sequence parallelism, and the input's (B, S). Both sides run it the
same way inside the model axis: ``y = sp_gather(layer(params, x))``, the
loss ``sum(y * r)`` (+ the MoE aux loss; the head case: ``lm_head_loss``
of ``embed(tokens) + x``), its gradient of ``loss / tp`` in this rank's
parameters and ``x``, and ``sync_grads``.
"""
D = 64

LAYERS = {
    # query heads over tp=2, one KV head a rank, sequence parallel
    "attn_tp2_sp": dict(layer="attn", tp=2, sp=True, B=2, S=16,
                        spec=dict(d_model=D, num_heads=8, num_kv_heads=2, head_dim=16,
                                  q_chunk=8)),
    # tp=4 over 2 KV heads: each KV slice held by an aligned pair of ranks
    # (kv_group = 2, subgroup_psum)
    "attn_tp4": dict(layer="attn", tp=4, sp=False, B=2, S=16,
                     spec=dict(d_model=D, num_heads=8, num_kv_heads=2, head_dim=16,
                               q_chunk=8)),
    # 2 query heads over tp=4: whole attention duplicated (dup_attn = 2,
    # a subgroup of 2 for wq/wo, the whole axis for wkv), with qkv bias
    # and a window, sequence parallel
    "attn_dup_tp4_sp": dict(layer="attn", tp=4, sp=True, B=1, S=16,
                            spec=dict(d_model=D, num_heads=2, num_kv_heads=1, head_dim=16,
                                      q_chunk=8, window=6, qkv_bias=True)),
    "mlp_tp2_sp": dict(layer="mlp", tp=2, sp=True, B=2, S=8,
                       spec=dict(kind="swiglu", d_model=D, d_ff=128)),
    "mlp_tp4": dict(layer="mlp", tp=4, sp=False, B=2, S=8,
                    spec=dict(kind="squared_relu", d_model=D, d_ff=128)),
    # experts over tp=2 with drops at capacity; the replicated router
    "moe_tp2": dict(layer="moe", tp=2, sp=False, B=2, S=8,
                    spec=dict(d_model=D, num_experts=4, top_k=2, d_ff_expert=32,
                              capacity_factor=1.0)),
    # heads over tp=2, two chunks, the replicated B/C projection
    "ssm_tp2_sp": dict(layer="ssm", tp=2, sp=True, B=2, S=16,
                       spec=dict(d_model=D, state_dim=16, head_dim=16, chunk=8)),
    # the vocab-parallel embedding and cross entropy (two sequence chunks)
    "head_tp2": dict(layer="head", tp=2, sp=False, B=2, S=16,
                     spec=dict(vocab=96, seq_chunk=8)),
}

# the model-axis collectives, each with its backward; x is (B, S, D) a rank
OPS = {"ops_tp2": dict(tp=2, B=2, S=4, D=3), "ops_tp4": dict(tp=4, B=2, S=4, D=3)}

# the train step: the reference's make_train_step at each mesh
STEP_ARCH = "mamba2-370m"
STEP_MESHES = ((1, 2), (2, 2))
STEP_SPEC = "rqm:c=0.02,m=16,q=0.42"
STEP_LR = 0.2
STEP_SEQ, STEP_BATCH, STEP_STEPS = 16, 2, 2

# the shard engine's 2-D lm round: tests/fed_lm_2d_checks.py's problem
# at cohorts of 2 (of 4 there: the CPU's plain RQM encode of 1.1M
# coordinates a client is the test's cost)
FED = dict(num_clients=8, clients_per_round=2, rounds=2, lr=0.5, samples_per_client=8,
           task="lm:model=mamba2-370m,seq_len=16,batch=1")
FED_GRIDS = ("2x2", "1x2", "2x1")

# make_client_grad's tensor-parallel branch (the shard engine's 2-D
# grid) and the lm task's held-out loss at tp, on FED's problem: two
# clients' batches, each case its model, model axis and local steps; the
# eval on every (model, tp) at one local step
CLIENT = {
    "mamba_tp2_steps1": dict(model="mamba2-370m", tp=2, local_steps=1),
    "mamba_tp2_steps2": dict(model="mamba2-370m", tp=2, local_steps=2),
    # KV heads on aligned pairs of ranks: gather_grads' subgroup sums
    "glm_tp4_steps1": dict(model="chatglm3-6b", tp=4, local_steps=1),
}
CLIENT_IDS = (5, 2)
CLIENT_LR = 0.1
CLIENT_SPEC = "rqm:c=0.02,m=16,q=0.42"


def client_fed(case: dict) -> dict:
    """FedConfig's fields of a CLIENT case (either package's FedConfig)."""
    return dict(FED, engine="shard", model_shards=case["tp"], local_steps=case["local_steps"],
                local_lr=CLIENT_LR,
                task=f"lm:model={case['model']},seq_len=16,batch=1")

# the serve steps over a mesh (tests/test_torch_serve_mesh*.py): each
# mode's reduced archs (gemma3: a window-64 ring and a global layer;
# h2o-danube: windows only; zamba2: SSM states and the shared attention
# block), the prompt and cache (the prompt past the window: the ring's
# re-lay), the float32 decode steps after the caches, the int8 steps from
# zero caches, each mode's global batch and meshes ("batch": the batch
# split over the clients, prefill then decode; "seq": a batch of 1, the
# global layers' caches sharded on their sequence over the clients,
# decode from given caches)
SERVE_ARCHS = {"batch": ("gemma3-4b", "h2o-danube-3-4b", "zamba2-1.2b"),
               "seq": ("gemma3-4b", "h2o-danube-3-4b")}
SERVE_PROMPT, SERVE_CAP = 96, 128
SERVE_STEPS, SERVE_INT8_STEPS = 3, 4
SERVE_BATCH = {"batch": 4, "seq": 1}
SERVE_MESHES = {"batch": ("2x2",), "seq": ("2x2", "4x1")}

# lm_head_argmax over a model axis of each tp: a (D, V) head whose rows'
# maxima tie across shards (the smallest id wins)
ARGMAX_TPS, ARGMAX_D, ARGMAX_V = (2, 4), 8, 32

# the train step's precision and memory options (tests/test_torch_perf_variants.py):
# the reference's tests/sharded_checks.py:check_perf_variants cases at 2x2
# (two clients, each tensor-parallel over two ranks), float32 compute, on
# reduced PERF_ARCH, PERF_STEPS steps each from the reference's global
# parameters at tp = 2; and one ZeRO-1 step on given per-rank gradients
# (normal, PERF_GRAD_SCALE), whose summed levels both sides keep
PERF_ARCH = "gemma3-4b"
PERF_MESH = "2x2"
PERF_SPEC = "rqm:c=0.05"
PERF_LR = 0.2
PERF_SEQ, PERF_BATCH, PERF_STEPS = 64, 4, 2
PERF_VARIANTS = {"base": {}, "int16": {"agg_dtype": "int16"},
                 "sp_compress": {"sp_compress": True},
                 "zero1": {"zero1": True, "agg_dtype": "auto"}}
# the reference's trajectories the port's are held against: its int16 and
# float32 ZeRO-1 steps are its base step's arithmetic (int16 carries the
# same sums, ZeRO-1's master update is sgd's), so the port's int16 and
# ZeRO-1 are held against its base
PERF_REFERENCE = {"base": "base", "int16": "base", "sp_compress": "sp_compress",
                  "zero1": "base"}
PERF_GRAD_SCALE = 0.05

# the LM steps at bfloat16 (tests/test_torch_precision.py): one dense, one
# MoE and one SSM reduced config, the reference's bfloat16 parameters
# (``init_params(key(PRECISION_KEY), dtype=bfloat16)``), a batch of
# PRECISION_BATCH prompts of PRECISION_PROMPT tokens into caches of
# PRECISION_CAP, PRECISION_STEPS greedy decode steps
PRECISION_ARCHS = ("gemma3-4b", "qwen3-moe-30b-a3b", "mamba2-370m")
PRECISION_KEY = 7
PRECISION_BATCH, PRECISION_PROMPT, PRECISION_CAP, PRECISION_STEPS = 2, 32, 48, 2

# the dry run (tests/test_torch_dryrun.py): the reference's compiled
# ``dryrun.build_step`` (rqm at c=0.01, sgd, remat, bfloat16 compute) at
# DRYRUN_MESH on each of DRYRUN_ARCHS reduced, a train shape of
# DRYRUN_SEQ x DRYRUN_BATCH, against the collectives the port's meta run
# of the same plan records
DRYRUN_ARCHS = ("qwen3-moe-30b-a3b", "mamba2-370m")
DRYRUN_MESH = "2x2"
DRYRUN_SEQ, DRYRUN_BATCH = 32, 4
