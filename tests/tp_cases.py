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
