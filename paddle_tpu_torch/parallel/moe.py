"""Mixture-of-experts routing on one card (counterpart of
``moe_dispatch`` and ``load_balancing_loss`` in
``paddle_tpu/parallel/moe.py``; ``moe_ffn`` and its all-to-all over the
``ep`` axis wait for the multi-GPU item of ``ROADMAP.md``).

GShard's dense formulation: each token goes to its ``top_k`` most
probable experts, an expert takes at most ``capacity`` tokens in token
order, and the routing is a ``[T, E, C]`` one-hot dispatch tensor (and
its gate-weighted combine) that einsums apply.

A slot position is a ``cumsum`` in the gates' dtype, as in the JAX
package: under AMP (bf16 gates) positions above 256 round, so two
tokens can share a slot once an expert takes more than 256 tokens.  The
port keeps this (ROADMAP Queue C), and rounds where the JAX package
does: ``jnp.cumsum`` is a reduce-window that XLA rewrites into a scan
over blocks of 16 (``_cumsum16``), whose block offsets round when added.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["moe_dispatch", "load_balancing_loss"]


_BLOCK = 16


def _cumsum16(x: torch.Tensor) -> torch.Tensor:
    """The inclusive sum of ``x`` along dim 0 in x's dtype, as XLA's
    reduce-window rewrite computes ``jnp.cumsum``: a scan within blocks of
    16, the scan of the blocks' totals (recursively), and each block's
    offset added with one rounding.  In fp32 a count is exact either
    way; in bf16 the counts above 256 round as the JAX package's do."""
    n = x.shape[0]
    if n <= _BLOCK:
        return torch.cumsum(x, dim=0)
    m = -(-n // _BLOCK)
    pad = x.new_zeros((m * _BLOCK - n,) + tuple(x.shape[1:]))
    local = torch.cumsum(torch.cat([x, pad]).reshape(
        (m, _BLOCK) + tuple(x.shape[1:])), dim=1)
    totals = _cumsum16(local[:, -1])
    offset = torch.cat([totals.new_zeros((1,) + tuple(totals.shape[1:])),
                        totals[:-1]])
    return (local + offset[:, None]).reshape(
        (m * _BLOCK,) + tuple(x.shape[1:]))[:n]


def moe_dispatch(gates: torch.Tensor, capacity: int, top_k: int = 2):
    """(dispatch [T, E, C] of 0 and 1, combine [T, E, C]) from the gate
    probabilities ``gates`` [T, E]: token t goes to its k most probable
    experts, first come first served, each expert taking at most
    ``capacity``; overflow is dropped.  The slots taken in round 1 count
    in round 2."""
    T, E = gates.shape
    dispatch = torch.zeros((T, E, capacity), dtype=gates.dtype,
                           device=gates.device)
    combine = torch.zeros_like(dispatch)
    masked = gates
    occupancy = torch.zeros((E,), dtype=torch.int32, device=gates.device)
    for _ in range(top_k):
        idx = torch.argmax(masked, dim=1)                       # [T]
        mask = F.one_hot(idx, E).to(gates.dtype)                # [T, E]
        pos = occupancy[None, :] + (
            _cumsum16(mask) - mask).int()                       # [T, E]
        keep = mask * (pos < capacity)
        pos_t = (pos * mask).sum(dim=1).int()                   # [T]
        slot = F.one_hot(pos_t.clamp(0, capacity - 1).long(),
                         capacity).to(gates.dtype)              # [T, C]
        d = keep[:, :, None] * slot[:, None, :]
        dispatch = dispatch + d
        combine = combine + d * (gates * mask).sum(dim=1)[:, None, None]
        occupancy = occupancy + keep.sum(dim=0).int()
        masked = masked * (1.0 - mask)
    return dispatch, combine


def load_balancing_loss(gates: torch.Tensor, dispatch: torch.Tensor):
    """E * sum_e(fraction of tokens sent to e * mean gate of e): the
    Switch-Transformer auxiliary loss that keeps experts evenly
    loaded."""
    E = gates.shape[1]
    frac = dispatch.sum(dim=2).mean(dim=0)
    prob = gates.mean(dim=0)
    return E * (frac * prob).sum()
