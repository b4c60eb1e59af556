"""RoIAlign (counterpart of `sc2bench_tpu/ops/roi_align.py`).

torchvision semantics with aligned=False and a fixed sampling ratio: each
output cell averages sampling_ratio^2 bilinear samples taken at the raw
continuous coordinate; a sample outside [-1, size] of the map is zero.
`multiscale_roi_align` assigns each RoI to one FPN level by the JAX
package's rule k = floor(4 + log2(sqrt(area) / 224 + 1e-6)) (torchvision
adds its 1e-6 outside the log) and gathers its bilinear taps from that
level's rows of one table of all levels' (y, x) positions.

Features of one image are (C, H, W); results are (R, C, out, out), the
layout torchvision's box head flattens.
"""
from __future__ import annotations

import torch

from ..utils.profiling import span


def _sample_grid(x1, y1, roi_w, roi_h, output_size: int, sampling_ratio: int):
    """Sample coordinates (R, out, out, s, s) of the RoIs' bins, in the JAX
    package's order of operations."""
    out, s = output_size, sampling_ratio
    dev = x1.device
    a_out = torch.arange(out, device=dev, dtype=x1.dtype)
    a_s = torch.arange(s, device=dev, dtype=x1.dtype)
    bin_h = (roi_h / out)[:, None, None]
    bin_w = (roi_w / out)[:, None, None]
    iy = a_out[None, :, None] * bin_h + (a_s[None, None, :] + 0.5) \
        * bin_h / s + y1[:, None, None]
    ix = a_out[None, :, None] * bin_w + (a_s[None, None, :] + 0.5) \
        * bin_w / s + x1[:, None, None]
    r = x1.shape[0]
    return (iy[:, :, None, :, None].expand(r, out, out, s, s),
            ix[:, None, :, None, :].expand(r, out, out, s, s))


def _bilinear(table, ys, xs, h, w, off):
    """Mean over the s x s samples of the bilinear interpolation at
    (ys, xs) (R, out, out, s, s) into the (rows, C) `table`, whose map of
    each RoI is h x w starting at row
    `off` (int64 tensors, 0-d or (R, 1, 1, 1, 1)). Returns (R, C, out,
    out)."""
    valid = (ys >= -1.0) & (ys <= h) & (xs >= -1.0) & (xs <= w)
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy1, wx1 = ys - y0, xs - x0
    wy0, wx0 = 1 - wy1, 1 - wx1

    def rows(yy, xx):
        yi = torch.minimum(torch.clamp(yy.to(torch.int64), min=0), h - 1)
        xi = torch.minimum(torch.clamp(xx.to(torch.int64), min=0), w - 1)
        return table[(off + yi * w + xi).reshape(-1)].reshape(
            *ys.shape, table.shape[1])

    samples = rows(y0, x0) * (wy0 * wx0)[..., None]
    samples = samples + rows(y0, x0 + 1) * (wy0 * wx1)[..., None]
    samples = samples + rows(y0 + 1, x0) * (wy1 * wx0)[..., None]
    samples = samples + rows(y0 + 1, x0 + 1) * (wy1 * wx1)[..., None]
    samples = samples * valid[..., None]
    return samples.mean(dim=(3, 4)).permute(0, 3, 1, 2)


def roi_align(feature: torch.Tensor, boxes: torch.Tensor, output_size: int,
              spatial_scale: float, sampling_ratio: int = 2) -> torch.Tensor:
    """One map: feature (C, H, W), boxes (R, 4) in canvas coordinates ->
    (R, C, out, out). The single-level oracle of `multiscale_roi_align`."""
    c, h, w = feature.shape
    box = boxes * spatial_scale
    roi_w = torch.clamp(box[:, 2] - box[:, 0], min=1.0)
    roi_h = torch.clamp(box[:, 3] - box[:, 1], min=1.0)
    ys, xs = _sample_grid(box[:, 0], box[:, 1], roi_w, roi_h, output_size,
                          sampling_ratio)
    table = feature.permute(1, 2, 0).reshape(-1, c)
    h, w, off = (torch.tensor(v, device=feature.device) for v in (h, w, 0))
    return _bilinear(table, ys, xs, h, w, off)


def _fpn_level(boxes: torch.Tensor, num_levels: int, canonical_scale,
               canonical_level) -> torch.Tensor:
    """0-based level of each box: floor(4 + log2(sqrt(area) / 224 +
    1e-6)) clipped to the levels P2 ... P(1 + num_levels)."""
    areas = torch.clamp(boxes[:, 2] - boxes[:, 0], min=0) * \
        torch.clamp(boxes[:, 3] - boxes[:, 1], min=0)
    k = torch.floor(canonical_level + torch.log2(
        torch.sqrt(areas) / canonical_scale + 1e-6))
    return torch.clamp(k, 2, 2 + num_levels - 1).to(torch.int64) - 2


def multiscale_roi_align(features, boxes: torch.Tensor, output_size: int,
                         scales, sampling_ratio: int = 2,
                         canonical_scale: int = 224,
                         canonical_level: int = 4) -> torch.Tensor:
    """features: the (C, H_l, W_l) maps of one image (P2 ... P5); boxes
    (R, 4) in canvas coordinates; `scales` each level's map / canvas
    ratio. Returns (R, C, out, out), each RoI pooled from its level."""
    with span('detect.roi_align'):
        k = _fpn_level(boxes, len(features), canonical_scale,
                       canonical_level)
        c = features[0].shape[0]
        dev = boxes.device
        table = torch.cat([f.permute(1, 2, 0).reshape(-1, c)
                           for f in features])
        hs = torch.tensor([f.shape[1] for f in features], device=dev)
        ws = torch.tensor([f.shape[2] for f in features], device=dev)
        offs = torch.tensor([sum(f.shape[1] * f.shape[2]
                                 for f in features[:i])
                             for i in range(len(features))], device=dev)
        scale = torch.tensor(scales, dtype=torch.float32, device=dev)[k]
        box = boxes * scale[:, None]
        roi_w = torch.clamp(box[:, 2] - box[:, 0], min=1.0)
        roi_h = torch.clamp(box[:, 3] - box[:, 1], min=1.0)
        ys, xs = _sample_grid(box[:, 0], box[:, 1], roi_w, roi_h,
                              output_size, sampling_ratio)
        per_roi = (-1, 1, 1, 1, 1)
        return _bilinear(table, ys, xs, hs[k].view(per_roi),
                         ws[k].view(per_roi), offs[k].view(per_roi))
