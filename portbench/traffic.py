"""The one traffic generator: inputs made on the device from the seed,
as a traffic mix's parameters (`portbench/workloads/<name>.json`) say.

    pool     {"count": P, "sizes": [[h, w], ...], "weights": [...],
              "pixels": "normal" | "uniform", "canvas": {...}}
             P images, each of a size drawn by `weights` from `sizes`;
             "normal": unit-normal pixels (a normalized image);
             "uniform": pixels in [0, 1], then resized and padded to a
             detection canvas ("canvas": min_size, max_size,
             size_divisible) and normalized with ImageNet's mean and std
    batches  {"count": B, "batch": n, "size": [h, w], "classes": K}
             B distinct training batches of unit-normal images and labels

`request(pool, r, n)` is request r of n images: the pool's images
r*n ... r*n + n - 1, taken in turn. The seed fixes every pixel and every
draw of size; a mix gives every seed the same set of sizes, in another
order.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _generator(seed, device, stream):
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1000003 + stream) % (1 << 63))
    return g


def _round_up(v, d):
    return -(-v // d) * d


def canvas_of(hw, canvas):
    """(resized (h, w), canvas (h, w)) of an image of size `hw`: the
    shorter side to `min_size`, the longer capped at `max_size`, on the
    smallest of the landscape, portrait and square buckets that holds
    it (torchvision's `GeneralizedRCNNTransform` with the configs'
    `canvas_size`)."""
    h, w = hw
    mn, mx = canvas['min_size'], canvas['max_size']
    scale = min(mn / min(h, w), mx / max(h, w))
    nh, nw = int(round(h * scale)), int(round(w * scale))
    d = canvas.get('size_divisible', 32)
    a, b = _round_up(mn, d), _round_up(mx, d)
    buckets = [(a, b), (b, a), (b, b)]
    fit = [c for c in buckets if c[0] >= nh and c[1] >= nw]
    return (nh, nw), min(fit, key=lambda c: c[0] * c[1])


def size_order(spec, seed):
    """The pool's image sizes: exactly round(P * weight share) of each
    size, shuffled by the seed."""
    sizes = [tuple(s) for s in spec['sizes']]
    weights = np.asarray(spec.get('weights', [1] * len(sizes)), float)
    count = int(spec['count'])
    counts = np.floor(count * weights / weights.sum()).astype(int)
    counts[0] += count - counts.sum()
    order = [sizes[i] for i, c in enumerate(counts) for _ in range(c)]
    rng = np.random.default_rng(int(seed) % (1 << 63))
    return [order[i] for i in rng.permutation(count)]


@torch.no_grad()
def image_pool(spec, seed, device):
    """The pool's images, each (1, 3, h, w) float32 on `device`."""
    g = _generator(seed, device, 1)
    out = []
    for hw in size_order(spec, seed):
        if spec.get('pixels', 'normal') == 'normal':
            out.append(torch.randn((1, 3, *hw), generator=g, device=device))
            continue
        img = torch.rand((1, 3, *hw), generator=g, device=device)
        (nh, nw), (ch, cw) = canvas_of(hw, spec['canvas'])
        img = F.interpolate(img, size=(nh, nw), mode='bilinear',
                            align_corners=False).clamp_(0, 1)
        mean = torch.tensor(IMAGENET_MEAN, device=device)[:, None, None]
        std = torch.tensor(IMAGENET_STD, device=device)[:, None, None]
        canvas = torch.zeros((1, 3, ch, cw), device=device)
        canvas[..., :nh, :nw] = (img - mean) / std
        out.append(canvas)
    return out


def request(pool, r, n):
    """Request r of n images, the pool's images taken in turn."""
    p = len(pool)
    return [pool[(r * n + i) % p] for i in range(n)]


@torch.no_grad()
def training_batches(spec, seed, device):
    """[(images (n, 3, h, w), labels (n,))] * count, all distinct."""
    g = _generator(seed, device, 2)
    n, (h, w) = int(spec['batch']), spec['size']
    out = []
    for _ in range(int(spec['count'])):
        x = torch.randn((n, 3, h, w), generator=g, device=device)
        y = torch.randint(0, int(spec['classes']), (n,), generator=g,
                          device=device)
        out.append((x, y))
    return out
