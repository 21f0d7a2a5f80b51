"""Tensor-parallel layers, forward only (port of
`paddle_tpu/distributed/fleet/mpu.py`: `VocabParallelEmbedding` :146,
`ColumnParallelLinear` :166, `RowParallelLinear` :194), and
`ParallelCrossEntropy` :227 on one device.

The reference lays whole weights over a JAX mesh and lets GSPMD insert
the collectives. Here every rank is a process that holds only its shard,
and the layers issue the collectives themselves, on the process group of
the `ModelParallelMesh` they were given (never the default group
implicitly; with no mesh a layer is its whole, unsplit self). The one
collective is a sum `all_reduce`, which NCCL, gloo on the CPU and gloo
over CUDA tensors all run (gloo cannot all_gather CUDA tensors):
  * RowParallelLinear reduces its partial products (a quantized shard's
    product is scaled before the reduce, as the reference's program
    scales it);
  * VocabParallelEmbedding reduces each rank's rows, zero for the ids
    outside its vocab range;
  * a gathered output (`ColumnParallelLinear(gather_output=True)`, the
    vocab-parallel LM head) is each rank's columns written into a
    zeroed full-width buffer and reduced: a sum with zeros is exact, so
    every rank holds the shards' values bitwise.

A dim of n split tp ways gives rank r the range [r * c, min(n, (r + 1)
* c)), c = ceil(n / tp): GSPMD's layout of an uneven split. A layer is
built from its whole counterpart (`Linear`, `Embedding`, or a
`WeightOnlyLinear` quantized whole) and keeps the slices; the whole
weights are freed with it.

`ParallelCrossEntropy` computes the reference's single-device function
(`nn.functional.parallel_cross_entropy`); over a class dim split on a
mesh of more than one rank it raises (training TP is not ported). Not
ported: the RNG tracker (training TP).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch import nn

from ...nn.functional.loss import parallel_cross_entropy
from ...nn.layer.common import Embedding, Linear
from ...nn.quant import shard_weight_only, weight_only_linear

__all__ = ["ModelParallelMesh", "VocabParallelEmbedding",
           "ColumnParallelLinear", "RowParallelLinear",
           "ParallelCrossEntropy", "shard_range", "MODEL_AXIS"]

MODEL_AXIS = "model"


def shard_range(n: int, rank: int, tp: int):
    """[start, stop) of rank's share of a dim of n split tp ways."""
    c = -(-int(n) // int(tp))
    return min(n, rank * c), min(n, (rank + 1) * c)


class ModelParallelMesh:
    """One rank's view of a tensor-parallel group. `shape` is
    {"model": tp}; `rank` this process's index in the group; `group` the
    process group the model's layers reduce over; `host_group` a gloo
    group of the same ranks for host-side checks; `device` the rank's
    device. Built by `serving.tp_serving_mesh`."""

    def __init__(self, tp: int, rank: int, group, host_group,
                 device: torch.device):
        self.shape = {MODEL_AXIS: int(tp)}
        self.rank = int(rank)
        self.group = group
        self.host_group = host_group
        self.device = device

    @property
    def tp(self) -> int:
        return self.shape[MODEL_AXIS]

    def __repr__(self):
        return (f"ModelParallelMesh(tp={self.tp}, rank={self.rank}, "
                f"device={self.device})")

    def shard_range(self, n: int):
        return shard_range(n, self.rank, self.tp)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum `t` over the group, in place; returns it."""
        if self.tp > 1:
            dist.all_reduce(t, group=self.group)
        return t

    def gather_last(self, local: torch.Tensor, n: int) -> torch.Tensor:
        """Every rank's slice of the last dim (this rank's is `local`)
        -> the whole (..., n), bitwise, through one all_reduce."""
        if self.tp == 1:
            return local
        a, b = self.shard_range(n)
        full = local.new_zeros(*local.shape[:-1], n)
        full[..., a:b] = local
        return self.all_reduce(full)


def _tp(mesh) -> int:
    return 1 if mesh is None else mesh.tp


class _ShardedLinear(nn.Module):
    """A linear's shard along dim `_dim` of its (in, out) weight: a float
    `weight` Parameter, or the `qweight` / `weight_scale` buffers of a
    weight quantized whole (`nn.quant.shard_weight_only`), plus an
    optional bias (the column shard's slice; the row shard's whole bias,
    added after the reduce)."""

    _dim = 1
    tp_sharded = True

    def __init__(self, in_features, out_features, has_bias, mesh, device,
                 dtype, generator, full):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.mesh = mesh
        if full is None:
            full = Linear(in_features, out_features, bias=has_bias,
                          device=device, dtype=dtype, generator=generator)
        n = (in_features, out_features)[self._dim]
        self.shard = ((0, n) if mesh is None else mesh.shard_range(n))
        a, b = self.shard
        bias = getattr(full, "bias", None)
        self.weight_dtype = getattr(full, "weight_dtype", None)
        with torch.no_grad():
            if self.weight_dtype is not None:
                qw, scale = shard_weight_only(
                    full.qweight, full.weight_scale, self.weight_dtype,
                    self._dim, a, b)
                self.register_buffer("qweight", qw)
                self.register_buffer("weight_scale", scale)
                self.weight = None
            else:
                w = full.weight
                w = w[:, a:b] if self._dim == 1 else w[a:b]
                self.weight = nn.Parameter(w.contiguous().clone())
            if bias is not None and self._dim == 1:
                bias = bias[a:b]
            self.bias = (None if bias is None else
                         nn.Parameter(bias.detach().contiguous().clone()))

    def _matmul(self, x):
        if self.weight_dtype is not None:
            return weight_only_linear(x, self.qweight, None,
                                      self.weight_scale, self.weight_dtype)
        return torch.matmul(x, self.weight)

    def extra_repr(self):
        return (f"in_features={self.in_features}, "
                f"out_features={self.out_features}, shard={self.shard}")


class ColumnParallelLinear(_ShardedLinear):
    """y = x @ W[:, cols] + b[cols]: this rank's output columns; with
    `gather_output` every rank's columns, gathered (exact)."""

    _dim = 1

    def __init__(self, in_features: int, out_features: int,
                 has_bias: bool = True, gather_output: bool = True, *,
                 mesh: Optional[ModelParallelMesh] = None, device=None,
                 dtype=None, generator=None, full=None):
        super().__init__(in_features, out_features, has_bias, mesh, device,
                         dtype, generator, full)
        self.gather_output = gather_output

    def forward(self, x):
        y = self._matmul(x)
        if self.bias is not None:
            y = y + self.bias
        if self.gather_output and _tp(self.mesh) > 1:
            y = self.mesh.gather_last(y, self.out_features)
        return y


class RowParallelLinear(_ShardedLinear):
    """y = sum over ranks of x[..., rows] @ W[rows] (one all_reduce),
    then + b. `input_is_parallel`: x already holds only this rank's
    rows (the output of a column-parallel layer), else it is sliced."""

    _dim = 0

    def __init__(self, in_features: int, out_features: int,
                 has_bias: bool = True, input_is_parallel: bool = False, *,
                 mesh: Optional[ModelParallelMesh] = None, device=None,
                 dtype=None, generator=None, full=None):
        super().__init__(in_features, out_features, has_bias, mesh, device,
                         dtype, generator, full)
        self.input_is_parallel = input_is_parallel

    def forward(self, x):
        if not self.input_is_parallel:
            a, b = self.shard
            x = x[..., a:b]
        y = self._matmul(x)
        if _tp(self.mesh) > 1:
            y = self.mesh.all_reduce(y.contiguous())
        if self.bias is not None:
            y = y + self.bias
        return y


class VocabParallelEmbedding(nn.Module):
    """Row lookup over this rank's vocab rows: ids outside them give
    zeros, and the all_reduce sums the ranks' rows (exact: one nonzero
    term each)."""

    tp_sharded = True

    def __init__(self, num_embeddings: int, embedding_dim: int, *,
                 mesh: Optional[ModelParallelMesh] = None, device=None,
                 dtype=None, generator=None, full=None):
        super().__init__()
        self.num_embeddings, self.embedding_dim = (num_embeddings,
                                                   embedding_dim)
        self.mesh = mesh
        if full is None:
            full = Embedding(num_embeddings, embedding_dim, device=device,
                             dtype=dtype, generator=generator)
        self.shard = ((0, num_embeddings) if mesh is None
                      else mesh.shard_range(num_embeddings))
        a, b = self.shard
        with torch.no_grad():
            self.weight = nn.Parameter(full.weight[a:b].contiguous().clone())

    def forward(self, ids):
        if _tp(self.mesh) == 1:
            return self.weight[ids]
        a, b = self.shard
        inside = (ids >= a) & (ids < b)
        rows = self.weight[(ids - a).clamp(0, b - a - 1)]
        out = torch.where(inside[..., None], rows, torch.zeros_like(rows))
        return self.mesh.all_reduce(out)

    def attend(self, h):
        """The tied LM head: h @ W^T over the whole vocab, each rank's
        columns from its rows, gathered (exact)."""
        logits = torch.matmul(h, self.weight.t())
        if _tp(self.mesh) == 1:
            return logits
        return self.mesh.gather_last(logits, self.num_embeddings)

    def extra_repr(self):
        return (f"num_embeddings={self.num_embeddings}, "
                f"embedding_dim={self.embedding_dim}, shard={self.shard}")


class ParallelCrossEntropy(nn.Module):
    """Per-position softmax cross entropy over the last (class) axis,
    shape (..., 1): fp32 log-softmax, the label's entry negated, 0 where
    the label is `ignore_index`. With no mesh (or one rank) it is the
    reference's single-device function. A class dim split over more
    than one rank (`mp_group`, or a `mesh` of tp > 1) raises: training
    tensor parallelism is not ported."""

    def __init__(self, mp_group=None, name=None, ignore_index: int = -100,
                 *, mesh: Optional[ModelParallelMesh] = None):
        super().__init__()
        if mp_group is not None or _tp(mesh) > 1:
            raise NotImplementedError(
                "ParallelCrossEntropy over a vocab split across ranks "
                "(training tensor parallelism) is not ported to "
                "paddle_tpu_torch")
        self.ignore_index = ignore_index

    def forward(self, input, label):
        return parallel_cross_entropy(input, label, self.ignore_index)
