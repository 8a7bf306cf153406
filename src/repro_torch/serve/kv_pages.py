"""KV-cache layout helpers (port of ``grow_caches`` from
``repro.serve.kv_pages``; the paged pools, page tables and allocator are not
ported yet).

Which axis of a cache leaf is the sequence axis is read off the blocks'
cache specs — the axis whose size changes with ``max_seq`` — never guessed
from sizes, so a batch equal to the prompt length cannot be mistaken for it.
"""
from __future__ import annotations

import torch.nn.functional as F

from repro_torch import tree
from repro_torch.models import lm


def seq_axes(cfg):
    """Per pattern group: a tree of per-layer seq-axis indices (None for
    state leaves), from differencing the cache spec at two lengths."""
    out = []
    for name, _ in cfg.pattern:
        block = lm._block(name)
        a = block.cache_spec(cfg, 2, 8, cfg.dtype)
        b = block.cache_spec(cfg, 2, 16, cfg.dtype)

        def axis(sa, sb):
            diff = [i for i, (x, y) in enumerate(zip(sa.shape, sb.shape)) if x != y]
            if len(diff) > 1:
                raise ValueError(f"ambiguous cache leaf layout: {sa.shape}")
            return diff[0] if diff else None

        out.append(tree.map(axis, a, b))
    return out


def grow_caches(cfg, caches, to_len: int):
    """Zero-pad every sequence axis of a decode-layout cache tree to
    ``to_len``."""
    axes = seq_axes(cfg)

    def one(ax, leaf):
        if ax is None or leaf.shape[ax] >= to_len:
            return leaf
        pad = [0, 0] * (leaf.dim() - 1 - ax) + [0, to_len - leaf.shape[ax]]
        return F.pad(leaf, pad)

    out = []
    for (name, count), ax, cache in zip(cfg.pattern, axes, caches):
        if count == 1:
            out.append(tree.map(one, ax, cache))
        else:
            out.append([tree.map(one, ax, c) for c in cache])
    return out
