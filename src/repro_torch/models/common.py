"""Shared model primitives (counterpart of ``repro/models/common.py``).

The reference runs its layers inside a manual ``shard_map`` over a
(pod, data, model) mesh; on one device it passes a ``ParallelCtx`` with
``model_axis=None`` and every collective is the identity. The port runs
one process a rank, as ``torch.distributed`` does: the federated-client
axes ('pod', 'data') are the ranks of the clients' process group,
linearized pod-major (``distributed/step.py:MeshPlan``), and the model
axis (Megatron-style tensor parallelism, tp > 1) the ranks of a model
group, one per client (``launch/mesh.py:mesh_groups``). Parameter layouts
keep the reference's leading ``tp`` axes, of size 1 on a rank.

The model-axis collectives carry the reference's transposes under its
``check_vma=False``, where a replicated value is not tracked: the
backward of psum is psum, of the tiled all_gather the psum_scatter, of
psum_scatter the tiled all_gather, and of the sequence slice the zero
padding (plain autograd of the slice). ``torch.distributed`` collectives
carry no gradient of their own, hence the ``autograd.Function``s below.
The reference's train step differentiates ``loss / tp`` against that
arithmetic (``distributed/step.py``), which the port repeats.

GQA head duplication: where an architecture's Q or KV head count does not
cover the model axis, parameter slices are duplicated across contiguous
power-of-two subgroups of the model axis; the forward divides the
out-projection psum by the duplication factor, and the duplicates'
gradients are summed over their subgroup (``subgroup_psum``) in the
reference's recursive-doubling order, so the copies stay bit-identical.
With ``sp_compress`` the sequence-parallel entry all-gather crosses the
wire as int8 codes with per-token float32 scales (``_CompressedGather``);
its backward is the exact psum_scatter of the uncompressed cotangent.

Long-context decode shards a KV cache's sequence dim over the client
axes (flash-decoding, ``attention.decode(seq_sharded=True)``): the seq
axis's ranks are the clients' process group and a shard's index its
client index. Its collectives (``pmax_seq``, ``psum_seq``) and the
model axis's ``pmin_model`` serve the forward-only decode and carry no
gradient.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F


# Every collective the port issues goes through ``all_reduce_``,
# ``_gather`` or ``_reduce_scatter``. While a recorder is active
# (``launch/hlo_analysis.py:recording``), each appends ``(kind, bytes,
# group size)`` to it: the bytes of the tensor reduced, of the whole
# gathered output, of the whole input scattered (the ring model's bytes).
# A fake group's collectives run through the same code.
_recorders: list = []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _note(kind: str, nbytes: int, group) -> None:
    if _recorders:
        rec = (kind, int(nbytes), dist.get_world_size(group))
        for r in _recorders:
            r.append(rec)


def all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced over ``group`` in place (and returned)."""
    _note("all-reduce", _nbytes(t), group)
    dist.all_reduce(t, op=op, group=group)
    return t


def _all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    out = x.detach().clone(memory_format=torch.contiguous_format)
    return all_reduce_(out, group, op)


def _gather(x: torch.Tensor, group, size: int) -> list:
    """The ``size`` ranks' ``x`` of ``group``, in rank order."""
    x = x.detach().contiguous()
    parts = [torch.empty_like(x) for _ in range(size)]
    _note("all-gather", size * _nbytes(x), group)
    dist.all_gather(parts, x, group=group)
    return parts


def _all_gather(x: torch.Tensor, group, size: int, dim: int) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order (the
    reference's tiled all_gather)."""
    return torch.cat(_gather(x, group, size), dim=dim)


def _reduce_scatter(x: torch.Tensor, group, size: int, dim: int) -> torch.Tensor:
    """The ranks' ``x`` summed, and this rank's block of ``dim`` (the
    reference's tiled psum_scatter)."""
    chunks = [c.contiguous() for c in x.detach().chunk(size, dim)]
    out = torch.empty_like(chunks[0])
    _note("reduce-scatter", _nbytes(x), group)
    dist.reduce_scatter(out, chunks, group=group)
    return out


class _Psum(torch.autograd.Function):
    """psum over ``group``; its backward is psum."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    """Tiled all_gather along ``dim``; its backward is the psum_scatter."""

    @staticmethod
    def forward(ctx, x, group, size, dim):
        ctx.group, ctx.size, ctx.dim = group, size, dim
        return _all_gather(x, group, size, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.group, ctx.size, ctx.dim), None, None, None


class _PsumScatter(torch.autograd.Function):
    """Tiled psum_scatter along ``dim``; its backward is the all_gather."""

    @staticmethod
    def forward(ctx, x, group, size, dim):
        ctx.group, ctx.size, ctx.dim = group, size, dim
        return _reduce_scatter(x, group, size, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group, ctx.size, ctx.dim), None, None, None


class _CompressedGather(torch.autograd.Function):
    """The int8 tiled all_gather along dim 1 with per-token float32
    scales (the reference's ``_make_compressed_all_gather``): ``scale =
    max(|x|, 1e-12) / 127`` over the last dim, the codes ``x / scale``
    rounded half to even and clipped to +-127, codes and scales gathered,
    then ``codes * scale`` in ``x``'s dtype. Its backward is the exact
    psum_scatter of the uncompressed cotangent (straight-through)."""

    @staticmethod
    def forward(ctx, x, group, size):
        ctx.group, ctx.size = group, size
        xf = x.detach().to(torch.float32)
        # divide by a device tensor: PyTorch's CUDA division by a Python
        # scalar multiplies by its reciprocal, which is not IEEE division
        levels = torch.full((), 127.0, device=x.device)
        scale = xf.abs().amax(-1, keepdim=True).clamp(min=1e-12) / levels
        q = torch.round(xf / scale).clamp(-127, 127).to(torch.int8)
        qg = _all_gather(q, group, size, 1)
        sg = _all_gather(scale, group, size, 1)
        return (qg.to(torch.float32) * sg).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.group, ctx.size, 1), None, None


def doubling_sum(parts: list) -> torch.Tensor:
    """``parts`` (a power-of-two count) summed in recursive-doubling order,
    ``(x0 + x1) + (x2 + x3)``: the sum every rank of the reference's
    ``subgroup_psum`` makes (IEEE addition commutes, so its ``own +
    partner`` is this on every rank)."""
    while len(parts) > 1:
        parts = [parts[i] + parts[i + 1] for i in range(0, len(parts), 2)]
    return parts[0]


@dataclasses.dataclass(frozen=True)
class ParallelCtx:
    """The mesh seen from inside the train step.

    model_axis / tp: the tensor-parallel axis's name (None: no model
      axis) and size; model_group: its ranks (this client's), model_rank:
      this rank's index on it; subgroups: ``((size, group), ...)``, this
      rank's aligned model-axis subgroup of each power-of-two size
      between 1 and tp (``subgroup_psum``);
    client_axes: the names of the federated-client axes ('pod', 'data'),
      empty for a plain run; n_clients: their product, the ranks of
      ``group``; client_index: this rank's linear index among them;
    seq_axis / seq_axis_sizes / seq_shards: the axes over which
      long-context decode shards the KV cache's sequence dim (the client
      axes; None: no seq axis), their sizes and product; a shard's index
      is ``client_index`` (``seq_index``) and its collectives run over
      ``group``;
    seq_parallel: Megatron-style sequence parallelism, the residual
      stream between blocks (B, S/tp, D), all-gathered on a block's entry
      and psum_scattered on its exit;
    sp_compress: that entry all-gather as int8 codes with per-token
      float32 scales (forward only: the backward is exact).
    """

    model_axis: Optional[str] = None
    tp: int = 1
    client_axes: tuple = ()
    n_clients: int = 1
    client_index: int = 0
    group: Optional[dist.ProcessGroup] = dataclasses.field(default=None, compare=False)
    model_group: Optional[dist.ProcessGroup] = dataclasses.field(default=None, compare=False)
    model_rank: int = 0
    subgroups: tuple = dataclasses.field(default=(), compare=False)
    seq_axis: Optional[tuple] = None
    seq_axis_sizes: tuple = ()
    seq_shards: int = 1
    seq_parallel: bool = False
    sp_compress: bool = False

    def __post_init__(self):
        if self.model and self.model_group is None:
            raise ValueError(f"a model axis of {self.tp} needs its process group")
        if self.client_axes and self.group is None:
            raise ValueError(f"client axes {self.client_axes} need the clients' process group")
        if self.seq_axis and self.seq_shards > 1 and self.group is None:
            raise ValueError(f"a seq axis {self.seq_axis} of {self.seq_shards} shards needs "
                             f"the clients' process group")

    @property
    def model(self) -> bool:
        """Whether the model-axis collectives act (a model axis above 1)."""
        return self.model_axis is not None and self.tp > 1

    def psum_clients(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the client ranks, in a new tensor; over one
        client rank a copy, with no collective (a one-rank gloo group
        would stage the tensor through the host and back)."""
        if not self.client_axes:
            return x
        if self.n_clients == 1:
            return x.clone()
        return _all_reduce(x, self.group)

    def pmean_clients(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the client ranks divided by their count, as
        ``jax.lax.pmean`` computes it."""
        if not self.client_axes:
            return x
        return self.psum_clients(x) / self.n_clients

    def psum_model(self, x: torch.Tensor) -> torch.Tensor:
        if not self.model:
            return x
        return _Psum.apply(x, self.model_group)

    def pmax_model(self, x: torch.Tensor) -> torch.Tensor:
        """The max over the model axis, of a value no gradient flows
        through (the reference's pmax has no differentiation rule)."""
        if not self.model:
            return x
        return _all_reduce(x, self.model_group, dist.ReduceOp.MAX)

    def pmin_model(self, x: torch.Tensor) -> torch.Tensor:
        """The min over the model axis (forward only)."""
        if not self.model:
            return x
        return _all_reduce(x, self.model_group, dist.ReduceOp.MIN)

    def model_index(self) -> int:
        return self.model_rank if self.model else 0

    def seq_index(self) -> int:
        """This shard's linear index along the KV-sequence sharding (the
        reference's pod-major index over ``seq_axis``: the client index)."""
        return self.client_index if self.seq_axis else 0

    def _seq(self) -> bool:
        return bool(self.seq_axis) and self.seq_shards > 1

    def pmax_seq(self, x: torch.Tensor) -> torch.Tensor:
        """The max over the seq axis (forward only); over one shard ``x``."""
        if not self._seq():
            return x
        return _all_reduce(x, self.group, dist.ReduceOp.MAX)

    def psum_seq(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the seq axis (forward only); over one shard ``x``."""
        if not self._seq():
            return x
        return _all_reduce(x, self.group)

    def subgroup_psum(self, x: torch.Tensor, group_size: int) -> torch.Tensor:
        """Sum over contiguous aligned subgroups of ``group_size`` (a
        power of two dividing tp) of the model axis, in the reference's
        recursive-doubling order: the subgroup's values gathered in rank
        order, then ``doubling_sum``. Not differentiated (it syncs
        gradients)."""
        if group_size <= 1 or not self.model:
            return x
        if group_size & (group_size - 1):
            raise ValueError(f"group_size must be a power of 2, got {group_size}")
        group = self.model_group if group_size == self.tp else dict(self.subgroups)[group_size]
        return doubling_sum(_gather(x, group, group_size))

    def sp_gather(self, x: torch.Tensor) -> torch.Tensor:
        """(B, S/tp, D) -> (B, S, D) when sequence parallelism is on."""
        if not self.seq_parallel or not self.model:
            return x
        if self.sp_compress:
            return _CompressedGather.apply(x, self.model_group, self.tp)
        return _AllGather.apply(x, self.model_group, self.tp, 1)

    def sp_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """Sum partial (B, S, D) contributions across the model axis:
        psum_scatter along the sequence to (B, S/tp, D) with sequence
        parallelism, else psum."""
        if not self.model:
            return x
        if not self.seq_parallel:
            return _Psum.apply(x, self.model_group)
        return _PsumScatter.apply(x, self.model_group, self.tp, 1)

    def sp_slice(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's sequence slice of a replicated (B, S, D) tensor
        (the free entry into the sequence-parallel form; its backward
        zero-pads, which composes with the embedding's psum)."""
        if not self.seq_parallel or not self.model:
            return x
        s_l = x.shape[1] // self.tp
        return x.narrow(1, self.model_rank * s_l, s_l)


# ---------------------------------------------------------------------------
# Attention sharding geometry (pure Python, as in the reference)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AttnSharding:
    """How H query heads and KV kv_heads map onto a tp-way model axis.

    tp_attn:  number of distinct Q-head slices (power of 2, divides tp).
    dup_attn: tp // tp_attn — whole-attention duplication factor.
    kv_shards: number of distinct KV-head slices within tp_attn.
    dup_kv:   tp_attn // kv_shards (KV params further duplicated).
    q_local / kv_local: heads held per device (content duplicated dup times).
    """

    tp: int
    tp_attn: int
    dup_attn: int
    kv_shards: int
    dup_kv: int
    q_local: int
    kv_local: int

    @property
    def kv_group(self) -> int:
        """Gradient-sync subgroup size for KV params."""
        return self.dup_attn * self.dup_kv


def plan_attn_sharding(num_heads: int, num_kv_heads: int, tp: int) -> AttnSharding:
    if num_heads % num_kv_heads != 0:
        raise ValueError(f"H={num_heads} not a multiple of kv={num_kv_heads}")
    p2 = num_heads & -num_heads  # largest power of 2 dividing H
    tp_attn = min(p2, tp)
    dup_attn = tp // tp_attn
    kv_shards = min(num_kv_heads, tp_attn)
    dup_kv = tp_attn // kv_shards
    q_local = num_heads // tp_attn
    kv_local = max(1, num_kv_heads // tp_attn)
    # Per-shard q heads must share the shard's kv heads contiguously.
    group = num_heads // num_kv_heads
    if kv_local == 1 and q_local > group:
        raise ValueError(
            f"unsupported geometry H={num_heads} kv={num_kv_heads} tp={tp}: "
            f"{q_local} local q heads span multiple kv heads with kv_local=1"
        )
    return AttnSharding(tp=tp, tp_attn=tp_attn, dup_attn=dup_attn, kv_shards=kv_shards,
                        dup_kv=dup_kv, q_local=q_local, kv_local=kv_local)


# ---------------------------------------------------------------------------
# Small shared layers
# ---------------------------------------------------------------------------


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: in float32 ``F.silu``; in a narrower dtype the
    reference's lowering op by op, ``x * (1 / (1 + exp(-x)))``, each op
    rounded to the dtype as XLA rounds it (``F.silu`` rounds once, and
    differs from it in a third of bfloat16 elements)."""
    if x.dtype == torch.float32:
        return F.silu(x)
    return x * (1 / (1 + torch.exp(-x)))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (approximate=True, the tanh form): in float32
    ``F.gelu(approximate="tanh")``; in a narrower dtype the reference's
    formula op by op, its constants rounded to the dtype (``sqrt(2 / pi)``
    is 0.796875 in bfloat16), each op rounded as XLA rounds it."""
    if x.dtype == torch.float32:
        return F.gelu(x, approximate="tanh")
    c = torch.full((), math.sqrt(2 / math.pi), dtype=x.dtype, device=x.device)
    k = torch.full((), 0.044715, dtype=x.dtype, device=x.device)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * x ** 3))))


def squeeze_tp(p: torch.Tensor, axis: int) -> torch.Tensor:
    """Drop a parameter's size-1 ``tp`` axis."""
    return p.squeeze(axis) if p.shape[axis] == 1 else p


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with the ``1 + weight`` scale (zero-initialised weights)."""
    dtype = x.dtype
    x = x.to(torch.float32)
    var = x.square().mean(-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * (1.0 + weight.to(torch.float32))).to(dtype)


def rope_frequencies(head_dim: int, theta: float, rotary_frac: float = 1.0, device=None):
    """Inverse frequencies for the rotated portion of the head dim."""
    rot = int(head_dim * rotary_frac)
    rot -= rot % 2
    inv = 1.0 / (theta ** (torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot))
    return inv, rot


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               rotary_frac: float = 1.0) -> torch.Tensor:
    """x: (..., S, n_heads, head_dim); positions: (..., S) int.

    Partial rotary (rotary_frac < 1) rotates only the first ``rot`` dims,
    in interleaved pairs (the ChatGLM-style "2d" RoPE)."""
    head_dim = x.shape[-1]
    inv, rot = rope_frequencies(head_dim, theta, rotary_frac, device=x.device)
    ang = positions[..., None].to(torch.float32) * inv  # (..., S, rot/2)
    cos = torch.cos(ang)[..., None, :]  # (..., S, 1, rot/2)
    sin = torch.sin(ang)[..., None, :]
    xr = x[..., :rot].to(torch.float32)
    x1 = xr[..., 0::2]
    x2 = xr[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x1 * sin + x2 * cos
    yr = torch.stack([y1, y2], dim=-1).reshape(xr.shape)
    return torch.cat([yr.to(x.dtype), x[..., rot:]], dim=-1)


def dense_init(generator: torch.Generator, shape, in_axis: int = 0,
               device="cuda", dtype=torch.float32) -> torch.Tensor:
    """A float32 normal truncated to +-2 standard deviations, at
    ``1/sqrt(fan_in)`` (``fan_in = shape[in_axis]``), drawn on the
    generator's device, then cast to ``dtype`` and moved to ``device``: a
    CPU generator gives the same values wherever they go, a CUDA
    generator draws on the card (a full-width model in seconds, where the
    CPU takes minutes)."""
    std = 1.0 / math.sqrt(shape[in_axis])
    t = torch.empty(tuple(shape), dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t.mul_(std).to(dtype).to(device)
