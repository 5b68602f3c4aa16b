"""The collectives on the gradient path, as ``autograd.Function``\\ s.

- :func:`all_reduce_sum`: a SUM over a process group whose backward is a
  SUM of the cotangent (the transpose JAX's ``psum`` has inside the
  JAX package's ``shard_map(check_vma=False)`` steps). Synced BatchNorm,
  ``ShardedGroupNorm`` and nothing else use it; the masked count of the
  data x space loss is reduced without gradient.
- :func:`exchange`: each rank of an ordered group sends one tensor to
  its left neighbour and one to its right and receives theirs, zeros
  where a neighbour is missing (the global edges; no ring). Its
  backward is the same exchange of the cotangents the other way round.
  On a ``gloo`` group the tensors cross through host memory (gloo's
  point-to-point takes CPU tensors); on ``nccl`` they stay on the card.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

__all__ = ["all_reduce_sum", "exchange"]


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, x):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return None, g


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable all-reduce SUM over ``group`` (identity for None)."""
    if group is None:
        return x
    return _AllReduceSum.apply(group, x)


def _send_recv(to_left: Optional[torch.Tensor],
               to_right: Optional[torch.Tensor], like: torch.Tensor,
               ranks: List[int], index: int, group
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(from the right neighbour, from the left neighbour) for this rank
    at ``index`` of ``ranks`` (world ranks of ``group``)."""
    n = len(ranks)
    staged = dist.get_backend(group) == "gloo" and like.device.type != "cpu"
    host = torch.device("cpu") if staged else like.device

    def out_buf(t):
        return t.detach().to(host).contiguous()

    from_right = torch.zeros(like.shape, dtype=like.dtype, device=host)
    from_left = torch.zeros(like.shape, dtype=like.dtype, device=host)
    ops = []
    if to_left is not None and index > 0:
        ops.append(dist.P2POp(dist.isend, out_buf(to_left),
                              ranks[index - 1], group))
    if to_right is not None and index < n - 1:
        ops.append(dist.P2POp(dist.isend, out_buf(to_right),
                              ranks[index + 1], group))
    if to_left is not None and index < n - 1:
        ops.append(dist.P2POp(dist.irecv, from_right, ranks[index + 1],
                              group))
    if to_right is not None and index > 0:
        ops.append(dist.P2POp(dist.irecv, from_left, ranks[index - 1],
                              group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return from_right.to(like.device), from_left.to(like.device)


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ranks, index, group, to_left, to_right):
        ctx.meta = (ranks, index, group, to_left is not None,
                    to_right is not None)
        like = to_left if to_left is not None else to_right
        return _send_recv(to_left, to_right, like, ranks, index, group)

    @staticmethod
    def backward(ctx, g_from_right, g_from_left):
        ranks, index, group, has_left, has_right = ctx.meta
        # A rank's to_left reached its left neighbour as from_right: the
        # cotangent goes back the other way, and so for to_right.
        g_to_right, g_to_left = _send_recv(
            g_from_left if has_right else None,
            g_from_right if has_left else None,
            g_from_right, ranks, index, group)
        return (None, None, None, g_to_left if has_left else None,
                g_to_right if has_right else None)


def exchange(to_left: Optional[torch.Tensor],
             to_right: Optional[torch.Tensor], ranks: List[int],
             index: int, group) -> Tuple[torch.Tensor, torch.Tensor]:
    """Send ``to_left`` to rank ``ranks[index - 1]`` and ``to_right`` to
    ``ranks[index + 1]``; return (what the right neighbour sent left,
    what the left neighbour sent right), zeros at the edges. Every rank
    of the group passes tensors of one shape (None to skip a
    direction); differentiable. With a group of 1 (None) nothing
    crosses and both results are zeros."""
    like = to_left if to_left is not None else to_right
    if group is None:
        zeros = torch.zeros(like.shape, dtype=like.dtype, device=like.device)
        return zeros, zeros.clone()
    return _Exchange.apply(ranks, index, group, to_left, to_right)
