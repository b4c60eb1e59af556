"""PASCAL VOC 2012 segmentation data (counterpart of
`sc2bench_tpu/datasets/voc.py`): JPEGImages with SegmentationClass PNG
masks, 21 classes, 255 the ignore index; a synthetic stand-in drawn as the
JAX package draws it; and the paired random resize / crop / flip of image
and mask. Samples are (HWC image, HW int32 mask) numpy arrays.
"""
from __future__ import annotations

import io
from pathlib import Path

import numpy as np

from ..registry import register_dataset
from ..utils.rngtools import ThreadLocalRng


@register_dataset
class VOCSegmentationDataset:
    """`root` holds `VOCdevkit/VOC2012` (or is that directory);
    `image_set` names the split file under `ImageSets/Segmentation`."""

    def __init__(self, root, image_set='train', transforms=None, **kwargs):
        root = Path(root).expanduser()
        base = root / 'VOCdevkit' / 'VOC2012' \
            if (root / 'VOCdevkit').exists() else root
        split_file = base / 'ImageSets' / 'Segmentation' / f'{image_set}.txt'
        names = split_file.read_text().split()
        self.images = [base / 'JPEGImages' / f'{n}.jpg' for n in names]
        self.masks = [base / 'SegmentationClass' / f'{n}.png' for n in names]
        self.transforms = transforms

    def __len__(self):
        return len(self.images)

    def __getitem__(self, idx):
        from PIL import Image
        img = np.asarray(Image.open(self.images[idx]).convert('RGB'))
        target = np.asarray(Image.open(self.masks[idx]), np.int32)
        if self.transforms is not None:
            img, target = self.transforms(img, target)
        return img, target


@register_dataset
class SyntheticSegmentationDataset:
    """Sample i from `default_rng(seed + i)`: a unit-normal float32 image
    of `image_size`, then a mask of uniform classes."""

    def __init__(self, num_samples=8, image_size=(64, 64), num_classes=21,
                 seed=0, **kwargs):
        self.num_samples = num_samples
        self.image_size = tuple(image_size)
        self.num_classes = num_classes
        self.seed = seed

    def __len__(self):
        return self.num_samples

    def __getitem__(self, idx):
        rng = np.random.default_rng(self.seed + idx)
        h, w = self.image_size
        img = rng.normal(0, 1, (h, w, 3)).astype(np.float32)
        target = rng.integers(0, self.num_classes, (h, w)).astype(np.int32)
        return img, target


class PairedSegTransforms:
    """Resize so the short side is `base_size` (times a uniform scale in
    [0.5, 2] when training), optionally JPEG-degrade the image at
    `jpeg_quality`; when training, pad to `crop_size` (image 0, mask 255),
    crop at random and flip with `hflip_prob`; then (x / 255 - mean) / std
    on the image. The mask is resized with nearest neighbours."""

    def __init__(self, base_size=520, crop_size=480, hflip_prob=0.5,
                 mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225),
                 train=True, seed=0, jpeg_quality=None):
        self.base_size = base_size
        self.crop_size = crop_size
        self.hflip_prob = hflip_prob
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.train = train
        self.rng = ThreadLocalRng(seed)
        self.jpeg_quality = jpeg_quality

    def __call__(self, img, target):
        from PIL import Image
        pil = Image.fromarray(np.asarray(img, np.uint8))
        tgt = Image.fromarray(np.asarray(target).astype(np.uint8))
        size = int(self.base_size * self.rng.uniform(0.5, 2.0)) \
            if self.train else self.base_size
        w, h = pil.size
        if w < h:
            nw, nh = size, int(size * h / w)
        else:
            nw, nh = int(size * w / h), size
        pil = pil.resize((nw, nh), Image.BILINEAR)
        tgt = tgt.resize((nw, nh), Image.NEAREST)
        if self.jpeg_quality is not None:
            buf = io.BytesIO()
            pil.save(buf, format='JPEG', quality=self.jpeg_quality)
            buf.seek(0)
            pil = Image.open(buf).convert('RGB')
        img_arr, tgt_arr = np.asarray(pil), np.asarray(tgt)
        if self.train:
            ph, pw = max(self.crop_size - nh, 0), max(self.crop_size - nw, 0)
            if ph or pw:
                img_arr = np.pad(img_arr, ((0, ph), (0, pw), (0, 0)))
                tgt_arr = np.pad(tgt_arr, ((0, ph), (0, pw)),
                                 constant_values=255)
            y0 = int(self.rng.integers(
                0, img_arr.shape[0] - self.crop_size + 1))
            x0 = int(self.rng.integers(
                0, img_arr.shape[1] - self.crop_size + 1))
            img_arr = img_arr[y0:y0 + self.crop_size, x0:x0 + self.crop_size]
            tgt_arr = tgt_arr[y0:y0 + self.crop_size, x0:x0 + self.crop_size]
            if self.rng.uniform() < self.hflip_prob:
                img_arr = img_arr[:, ::-1]
                tgt_arr = tgt_arr[:, ::-1]
        img_out = (img_arr.astype(np.float32) / 255.0 - self.mean) / self.std
        return img_out, tgt_arr.astype(np.int32)
