"""Hybrid ViT over NCHW (counterpart of `sc2bench_tpu/models/hybrid_vit.py`):
timm's `vit_small_r26_s32_224`, a ResNetV2-26 patch embedding
(weight-standardized TF-'SAME' convolutions, GroupNorm(32), non-preact
bottlenecks, widths 256/512/1024/2048) and ViT-S (dim 384, 12 blocks, 6
heads), and its splittable student (a bottleneck in place of the stem and
stage 0, then stages 1-3 and the transformer).

Key spaces: the teacher's is timm's (`patch_embed.backbone.stem.conv`/
`.norm`, `patch_embed.backbone.stages.{0..3}.blocks.{j}.*`,
`patch_embed.proj`, `cls_token`, `pos_embed`, `blocks.{i}.norm1`/
`attn.qkv`/`attn.proj`/`norm2`/`mlp.fc1`/`mlp.fc2`, `norm`, `head`); the
student's the reference's, whose kept stages keep their indices
(`patch_embed_pruned_stages.{1..3}.blocks.{j}.*`, `patch_embed_proj`).

`pos_embed` has one token per cell of the patch grid plus the class
token, so its length is fixed when the model is built: `image_size` (224
by default, a 7x7 grid) is the input the model serves, as the JAX
package's comes from the image it is initialized on. Attention is plain
matmul and softmax in float32. `forward(x, io=...)` records the JAX
package's names: `stage{i}_out` and the last block's `vit.block{d-1}_out`
(the student also `bottleneck_layer_out`).
"""
from __future__ import annotations

import math
from collections import OrderedDict

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..registry import register_model
from .layer import get_layer

# ResNetV2-26 widths/depths (timm `_resnetv2((2, 2, 2, 2))`)
R26_WIDTHS = (256, 512, 1024, 2048)
R26_DEPTHS = (2, 2, 2, 2)
PATCH_STRIDE = 32


def pad_same(x: torch.Tensor, kernel: int, stride: int,
             value: float = 0.0) -> torch.Tensor:
    """TF-'SAME' padding of an NCHW tensor for a `kernel`/`stride` window:
    the output is ceil(in / stride), and an odd total pads the bottom and
    the right one more."""
    pads = []
    for size in (x.shape[-1], x.shape[-2]):
        total = max((math.ceil(size / stride) - 1) * stride + kernel - size,
                    0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads, value=value) if any(pads) else x


class StdConv(nn.Conv2d):
    """timm's `StdConv2dSame`: a bias-free convolution whose weight is
    standardized at call time over (I, kH, kW) for each output channel
    (biased variance, eps 1e-8), with TF-'SAME' padding."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int,
                 stride: int = 1):
        super().__init__(in_ch, out_ch, kernel, stride, padding=0,
                         bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight
        var, mean = torch.var_mean(w, dim=(1, 2, 3), keepdim=True,
                                   correction=0)
        w = (w - mean) * torch.rsqrt(var + 1e-8)
        x = pad_same(x, self.kernel_size[0], self.stride[0])
        return F.conv2d(x, w, None, self.stride)


def _gn(channels: int) -> nn.GroupNorm:
    return nn.GroupNorm(32, channels, eps=1e-5)


class _ConvNorm(nn.Module):
    """The projection of a ResNetV2 shortcut (`conv`, `norm`)."""

    def __init__(self, in_ch: int, out_ch: int, stride: int):
        super().__init__()
        self.conv = StdConv(in_ch, out_ch, 1, stride)
        self.norm = _gn(out_ch)

    def forward(self, x):
        return self.norm(self.conv(x))


class ResNetV2Block(nn.Module):
    """timm's non-preact ResNetV2 bottleneck: 1x1 -> GN, ReLU -> 3x3
    (stride) -> GN, ReLU -> 1x1 -> GN, then ReLU of the sum with the
    shortcut, projected (`downsample`) when the stride or width changes."""

    def __init__(self, in_ch: int, out_ch: int, stride: int = 1):
        super().__init__()
        mid = out_ch // 4
        self.conv1 = StdConv(in_ch, mid, 1)
        self.norm1 = _gn(mid)
        self.conv2 = StdConv(mid, mid, 3, stride)
        self.norm2 = _gn(mid)
        self.conv3 = StdConv(mid, out_ch, 1)
        self.norm3 = _gn(out_ch)
        self.downsample = _ConvNorm(in_ch, out_ch, stride) \
            if stride > 1 or in_ch != out_ch else None

    def forward(self, x):
        shortcut = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        y = self.norm3(self.conv3(y))
        return F.relu(y + shortcut)


class ResNetV2Stage(nn.Module):
    """`depth` blocks (`blocks.{j}`), the stride on the first."""

    def __init__(self, in_ch: int, out_ch: int, depth: int, stride: int = 1):
        super().__init__()
        self.blocks = nn.Sequential(*[
            ResNetV2Block(in_ch if i == 0 else out_ch, out_ch,
                          stride if i == 0 else 1) for i in range(depth)])

    def forward(self, x):
        return self.blocks(x)


class _Attention(nn.Module):
    """Fused `qkv` split into thirds, scaled dot-product softmax in float32,
    output projection `proj`."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        b, n, d = x.shape
        hd = d // self.num_heads
        q, k, v = (t.reshape(b, n, self.num_heads, hd).transpose(1, 2)
                   for t in self.qkv(x).chunk(3, dim=-1))
        attn = torch.softmax(q @ k.transpose(-2, -1) * hd ** -0.5, dim=-1)
        return self.proj((attn @ v).transpose(1, 2).reshape(b, n, d))


class _Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class ViTBlock(nn.Module):
    """timm's ViT block: pre-LN (eps 1e-6) attention and pre-LN exact-GELU
    MLP, both residual."""

    def __init__(self, dim: int = 384, num_heads: int = 6,
                 mlp_ratio: float = 4.0):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = _Attention(dim, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = _Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


def num_patches(image_size) -> int:
    """Cells of the stride-32 patch grid of an image of `image_size`
    (one size or (height, width)); every stride-2 stage rounds up, as
    'SAME' padding does."""
    h, w = (image_size, image_size) if isinstance(image_size, int) \
        else image_size
    return math.ceil(h / PATCH_STRIDE) * math.ceil(w / PATCH_STRIDE)


class _ViT(nn.Module):
    """The transformer the patch features go through: `cls_token`,
    `pos_embed`, `blocks`, `norm`, `head` on the class token. The 1x1
    patch projection belongs to the owner (its key differs between the
    teacher and the student)."""

    def __init__(self, embed_dim: int, depth: int, num_heads: int,
                 num_classes: int, num_tokens: int):
        super().__init__()
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(
            torch.randn(1, num_tokens + 1, embed_dim) * 0.02)
        self.blocks = nn.Sequential(*[ViTBlock(embed_dim, num_heads)
                                      for _ in range(depth)])
        self.norm = nn.LayerNorm(embed_dim, eps=1e-6)
        self.head = nn.Linear(embed_dim, num_classes)

    def tokens_to_logits(self, z: torch.Tensor, io: dict | None = None
                         ) -> torch.Tensor:
        """Logits from the projected NCHW patch features `z`."""
        tokens = z.flatten(2).transpose(1, 2)
        cls = self.cls_token.expand(tokens.shape[0], -1, -1)
        tokens = torch.cat([cls, tokens], dim=1) + self.pos_embed
        tokens = self.blocks(tokens)
        if io is not None:
            io[f'vit.block{len(self.blocks) - 1}_out'] = tokens
        return self.head(self.norm(tokens)[:, 0])


class SplittableHybridViT(_ViT):
    """Bottleneck (in place of the stem and stage 0, giving 256 channels
    at stride 4) -> ResNetV2 stages 1-3 -> 1x1 projection -> ViT."""

    def __init__(self, bottleneck_layer: nn.Module, embed_dim: int = 384,
                 depth: int = 12, num_heads: int = 6,
                 num_classes: int = 1000, num_pruned_stages: int = 1,
                 image_size=224):
        if num_pruned_stages != 1:
            raise NotImplementedError(
                'reference configs use num_pruned_stages=1')
        super().__init__(embed_dim, depth, num_heads, num_classes,
                         num_patches(image_size))
        self.bottleneck_layer = bottleneck_layer
        c = bottleneck_layer.out_channels
        stages = OrderedDict()
        for i in (1, 2, 3):
            stages[str(i)] = ResNetV2Stage(c, R26_WIDTHS[i], R26_DEPTHS[i],
                                           stride=2)
            c = R26_WIDTHS[i]
        self.patch_embed_pruned_stages = nn.Sequential(stages)
        self.patch_embed_proj = nn.Conv2d(c, embed_dim, 1)

    def forward(self, x: torch.Tensor, mode: str = 'train',
                generator: torch.Generator | None = None,
                io: dict | None = None) -> torch.Tensor:
        """Logits without a bitstream (the bottleneck's `mode` forward,
        then the tail); with `io`, the intermediates under their JAX
        names."""
        sub = {} if io is not None else None
        z = self.bottleneck_layer(x, mode=mode, generator=generator, io=sub)
        if io is not None:
            io.update({f'bottleneck_layer.{k}': v for k, v in sub.items()})
            io['bottleneck_layer_out'] = z
        return self.forward_tail(z, io=io)

    def forward_tail(self, feature: torch.Tensor, io: dict | None = None
                     ) -> torch.Tensor:
        """Server-side tail from a decoded bottleneck feature (NCHW)."""
        z = feature
        for i, stage in self.patch_embed_pruned_stages.named_children():
            z = stage(z)
            if io is not None:
                io[f'stage{i}_out'] = z
        return self.tokens_to_logits(self.patch_embed_proj(z), io)


class _Stem(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = StdConv(3, 64, 7, 2)
        self.norm = _gn(64)

    def forward(self, x):
        z = F.relu(self.norm(self.conv(x)))
        return F.max_pool2d(pad_same(z, 3, 2, value=-math.inf), 3, 2)


class _Backbone(nn.Module):
    def __init__(self):
        super().__init__()
        self.stem = _Stem()
        c, stages = 64, []
        for i, (w, d) in enumerate(zip(R26_WIDTHS, R26_DEPTHS)):
            stages.append(ResNetV2Stage(c, w, d, 1 if i == 0 else 2))
            c = w
        self.stages = nn.Sequential(*stages)


class _PatchEmbed(nn.Module):
    def __init__(self, embed_dim: int):
        super().__init__()
        self.backbone = _Backbone()
        self.proj = nn.Conv2d(R26_WIDTHS[-1], embed_dim, 1)


class HybridViT(_ViT):
    """The full hybrid ViT: a 7x7/2 'SAME' stem with GroupNorm and ReLU, a
    3x3/2 'SAME' max pool, stages 0-3, the 1x1 projection and the ViT."""

    def __init__(self, embed_dim: int = 384, depth: int = 12,
                 num_heads: int = 6, num_classes: int = 1000,
                 image_size=224):
        super().__init__(embed_dim, depth, num_heads, num_classes,
                         num_patches(image_size))
        self.patch_embed = _PatchEmbed(embed_dim)

    def forward(self, x: torch.Tensor, io: dict | None = None
                ) -> torch.Tensor:
        """Logits; with `io`, each stage's output as `stage{i}_out` and
        the last block's tokens."""
        backbone = self.patch_embed.backbone
        z = backbone.stem(x)
        for i, stage in enumerate(backbone.stages):
            z = stage(z)
            if io is not None:
                io[f'stage{i}_out'] = z
        return self.tokens_to_logits(self.patch_embed.proj(z), io)


@register_model
def hybrid_vit_small_r26_s32_224(num_classes: int = 1000, image_size=224,
                                 device=None, **kwargs) -> HybridViT:
    """The ViT-S R26+S/32 teacher for `image_size` inputs, built on
    `device` (CUDA unless asked otherwise)."""
    dev = resolve_device(device)
    with torch.device(dev):
        return HybridViT(num_classes=num_classes,
                         image_size=image_size).to(dev)


@register_model
def splittable_hybrid_vit(bottleneck_config: dict, num_classes: int = 1000,
                          num_pruned_stages: int = 1, image_size=224,
                          device=None, **kwargs) -> SplittableHybridViT:
    """The bottleneck from the layer registry + the R26+S/32 tail for
    `image_size` inputs, built on `device` (CUDA unless asked
    otherwise)."""
    dev = resolve_device(device)
    with torch.device(dev):
        bottleneck = get_layer(bottleneck_config['key'],
                               **bottleneck_config.get('kwargs', {}))
        return SplittableHybridViT(
            bottleneck, num_classes=num_classes,
            num_pruned_stages=num_pruned_stages,
            image_size=image_size).to(dev)
