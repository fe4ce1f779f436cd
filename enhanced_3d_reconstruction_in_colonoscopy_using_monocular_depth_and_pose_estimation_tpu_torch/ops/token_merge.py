"""ToMe-style token merging for the ViT encoder (an opt-in speed dial),
the JAX package's ``ops/token_merge.py``.

One bipartite soft matching (Bolya et al., "Token Merging: Your ViT But
Faster", ICLR 2023) after the first DPT tap: the ``ratio`` most similar
patch tokens are averaged into their nearest partners and the remaining
blocks run on the shorter sequence. A per-sample slot map lets the later
taps rebuild the full token grid (merged positions share one feature), so
the DPT decoder is unchanged.

Every step is deterministic on the card: the partners' sums are a
product with a 0/1 assignment matrix (no atomics), the rank a stable sort.
"""

from __future__ import annotations

import torch


def merge_count(n_patches: int, ratio: float) -> int:
    """Number of merged tokens for a patch count (capped below the size of
    the A partition, so the bipartite match stays well defined)."""
    na = (n_patches + 1) // 2
    return max(0, min(int(n_patches * ratio), na - 1))


def bipartite_merge(tokens: torch.Tensor, ratio: float
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge the ``ratio`` most similar patch tokens (cls protected).

    tokens: (B, 1+n, C), cls at index 0. Returns ``(merged (B, 1+n-r, C),
    slot_map (B, 1+n) int64)``, where ``unmerge(merged, slot_map)`` has
    the full length (merged originals point at their shared slot).

    A = the patches at even positions, B = the odd ones. Each A token's
    best cosine match in B (f32, norms clamped at 1e-6; the first maximum)
    is its candidate; the r A tokens with the highest scores (a stable
    descending sort) are averaged into their partners as (b + sum a) /
    (1 + count) in f32, the rest are kept in rank order."""
    b, n1, c = tokens.shape
    n = n1 - 1
    r = merge_count(n, ratio)
    if r == 0:
        return tokens, torch.arange(n1, device=tokens.device).expand(b, n1)
    patches = tokens[:, 1:]
    a = patches[:, 0::2]                                    # (B, na, C)
    bb = patches[:, 1::2]                                   # (B, nb, C)
    na, nb = a.shape[1], bb.shape[1]

    af, bf = a.float(), bb.float()
    an = af / torch.clamp_min(torch.linalg.vector_norm(af, dim=-1,
                                                       keepdim=True), 1e-6)
    bn = bf / torch.clamp_min(torch.linalg.vector_norm(bf, dim=-1,
                                                       keepdim=True), 1e-6)
    scores = torch.bmm(an, bn.transpose(1, 2))              # (B, na, nb)
    partner = scores.argmax(dim=-1)                         # (B, na)
    best = scores.amax(dim=-1)
    order = torch.argsort(-best, dim=-1, stable=True)       # (B, na)
    rank = torch.argsort(order, dim=-1)
    merged_mask = rank < r

    # Sums onto the partners as a product with the 0/1 assignment matrix.
    assign = torch.zeros((b, na, nb), dtype=torch.float32,
                         device=tokens.device)
    assign.scatter_(2, partner[..., None], merged_mask[..., None].float())
    wsum = assign.sum(dim=1)                                # (B, nb)
    fsum = torch.bmm(assign.transpose(1, 2), af)            # (B, nb, C)
    bb_new = ((bf + fsum) / (1.0 + wsum)[..., None]).to(tokens.dtype)

    a_kept = torch.gather(a, 1, order[..., None].expand(b, na, c))[:, r:]
    merged = torch.cat([tokens[:, :1], bb_new, a_kept], dim=1)

    # Slot map over the original positions: cls -> 0; B token j -> 1 + j;
    # A token i -> its partner's slot if merged, else its kept slot.
    slot_a = torch.where(merged_mask, 1 + partner, 1 + nb + (rank - r))
    slot_map = torch.zeros((b, n1), dtype=torch.int64, device=tokens.device)
    slot_map[:, 1::2] = slot_a
    slot_map[:, 2::2] = 1 + torch.arange(nb, device=tokens.device)
    return merged, slot_map


def unmerge(tokens: torch.Tensor, slot_map: torch.Tensor) -> torch.Tensor:
    """(B, 1+n-r, C) and the (B, 1+n) slot map -> (B, 1+n, C)."""
    return torch.gather(tokens, 1, slot_map[..., None].expand(
        -1, -1, tokens.shape[-1]))
