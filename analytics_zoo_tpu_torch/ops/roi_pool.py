"""ROI max pooling with Caffe ``ROIPooling`` semantics (counterpart of
``ops/roi_pool.py``).

Each ROI (pixel corners on the input image) is projected onto the
feature map by ``spatial_scale``, cut into a ``pooled_h × pooled_w``
grid with Caffe's floor/ceil bin bounds and max-reduced per bin; an
empty bin gives 0 and a masked ROI zeros.  The semantics are the
reference's exactly: C ``round()`` (half away from zero) of the scaled
corners, ``roi_w``/``roi_h`` clamped to ≥ 1, bin bounds in integer
arithmetic (``(k·rh)//P``, ``((k+1)·rh + P - 1)//P``) clipped to the map.

The reference takes two masked maxima per ROI, which run eagerly would
hold an ``(R, PH, H, W, C)`` tensor (4.4 GB an image at 300 ROIs over a
32 × 32 × 512 map).  Here a 2-D range-max table answers every bin:
level ``(i, j)`` holds the max over the ``2^i × 2^j`` window at each
cell, and a bin is the max of the four windows of its level that cover
it (overlapping, as max allows: the result is exact, bit for bit the
reference's).  Peak memory at full width (batch 8, a 32 × 32 × 512 fp32
map, 300 ROIs, 7 × 7 bins): the table of 6 × 6 levels, 604 MB, the
output, 241 MB, and one gathered corner, 241 MB — 1.09 GB against the
reference formulation's 35 GB.
"""

from __future__ import annotations

from typing import Optional

import torch


def _round_c(x: torch.Tensor) -> torch.Tensor:
    """C ``round()``: half away from zero (2.5 → 3, not numpy's 2)."""
    return torch.trunc(x + torch.sign(x) * 0.5)


def _levels(n: int) -> int:
    """Levels of a range-max table over ``n`` cells: window 2^l ≤ n."""
    return max(n, 1).bit_length()


def _range_max_table(feat: torch.Tensor) -> torch.Tensor:
    """feat (B, H, W, C) → (B, Lh, Lw, H, W, C): level (i, j) at cell
    (y, x) is the max over rows [y, y + 2^i) and columns [x, x + 2^j)
    where those fit the map (cells past the fit keep a shorter window's
    max and are never read)."""
    def along(t: torch.Tensor, dim: int, n: int):
        levels = [t]
        for lvl in range(1, _levels(n)):
            prev, s = levels[-1], 1 << (lvl - 1)
            cur = prev.clone()
            cur.narrow(dim, 0, n - s).copy_(torch.maximum(
                prev.narrow(dim, 0, n - s), prev.narrow(dim, s, n - s)))
            levels.append(cur)
        return levels

    _, H, W, _ = feat.shape
    rows = along(feat, 1, H)
    return torch.stack([torch.stack(along(r, 2, W), dim=1) for r in rows],
                       dim=1)


def _bin_bounds(start: torch.Tensor, size: torch.Tensor, pooled: int,
                limit: int):
    """(…,) ROI starts and sizes → (…, pooled) bin [lo, hi) clipped to
    [0, limit], in integer arithmetic."""
    k = torch.arange(pooled, dtype=torch.int32, device=start.device)
    lo = (k * size[..., None]) // pooled + start[..., None]
    hi = ((k + 1) * size[..., None] + pooled - 1) // pooled + start[..., None]
    return lo.clamp(0, limit), hi.clamp(0, limit)


def roi_pool_batch(feat: torch.Tensor, rois: torch.Tensor,
                   roi_mask: Optional[torch.Tensor] = None,
                   pooled_h: int = 7, pooled_w: int = 7,
                   spatial_scale: float = 1.0 / 16.0) -> torch.Tensor:
    """feat (B, H, W, C), rois (B, R, 4) x1y1x2y2 in input-image pixels,
    roi_mask (B, R) optional validity (invalid → zeros) →
    (B, R, pooled_h, pooled_w, C)."""
    B, H, W, C = feat.shape
    R = rois.shape[1]
    rois = rois.to(torch.float32)
    corner = _round_c(rois * spatial_scale).to(torch.int32)   # (B, R, 4)
    roi_w = torch.clamp(corner[..., 2] - corner[..., 0] + 1, min=1)
    roi_h = torch.clamp(corner[..., 3] - corner[..., 1] + 1, min=1)
    hs, he = _bin_bounds(corner[..., 1], roi_h, pooled_h, H)  # (B, R, PH)
    ws, we = _bin_bounds(corner[..., 0], roi_w, pooled_w, W)  # (B, R, PW)
    empty = (he <= hs)[..., :, None] | (we <= ws)[..., None, :]

    table = _range_max_table(feat)
    Lh, Lw = table.shape[1], table.shape[2]
    table = table.reshape(-1, C)
    # floor(log2(n)) for n = 1 … max(H, W) (n = 0 maps to 0), counted on
    # the device: the powers of two from 2 up to n
    n = max(H, W)
    powers = 2 ** torch.arange(1, max(n.bit_length(), 1), device=feat.device)
    log2 = (torch.arange(n + 1, device=feat.device)[:, None]
            >= powers[None]).sum(1)
    hlen = torch.clamp(he - hs, min=1).long()
    wlen = torch.clamp(we - ws, min=1).long()
    kh, kw = log2[hlen], log2[wlen]
    y0 = torch.clamp(hs.long(), max=H - 1)
    y1 = torch.clamp(he.long() - (1 << kh), min=0)
    x0 = torch.clamp(ws.long(), max=W - 1)
    x1 = torch.clamp(we.long() - (1 << kw), min=0)
    b = torch.arange(B, device=feat.device).view(B, 1, 1, 1)
    level = ((b * Lh + kh[..., :, None]) * Lw + kw[..., None, :]) * (H * W)

    def corner_max(y, x):
        idx = level + y[..., :, None] * W + x[..., None, :]
        return table.index_select(0, idx.reshape(-1))

    out = corner_max(y0, x0)
    for y, x in ((y0, x1), (y1, x0), (y1, x1)):
        out = torch.maximum(out, corner_max(y, x))
    out = out.view(B, R, pooled_h, pooled_w, C)
    out = torch.where(empty[..., None], torch.zeros((), dtype=out.dtype,
                                                    device=out.device), out)
    if roi_mask is not None:
        out = out * roi_mask[:, :, None, None, None].to(out.dtype)
    return out


def roi_pool(feat: torch.Tensor, rois: torch.Tensor,
             roi_mask: Optional[torch.Tensor] = None,
             pooled_h: int = 7, pooled_w: int = 7,
             spatial_scale: float = 1.0 / 16.0) -> torch.Tensor:
    """One image: feat (H, W, C), rois (R, 4), roi_mask (R,) →
    (R, pooled_h, pooled_w, C)."""
    return roi_pool_batch(feat[None], rois[None],
                          None if roi_mask is None else roi_mask[None],
                          pooled_h, pooled_w, spatial_scale)[0]
