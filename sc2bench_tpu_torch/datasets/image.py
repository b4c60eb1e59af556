"""Host-side image data pipelines (counterpart of
`sc2bench_tpu/datasets/image.py`).

Loaders yield `(x, y)` numpy batches: x is NHWC (float32, or uint8 when
every image is uint8), y int64. The engine turns x into an NCHW tensor.
ImageFolder layout as ILSVRC-2012 (`val/<wnid>/*.JPEG`); the synthetic
dataset stands in where no data is mounted.
"""
from __future__ import annotations

import queue
import threading
from pathlib import Path

import numpy as np

from ..parallel.dist import rank, world_size
from ..registry import get, register_dataset

IMG_EXTENSIONS = {'.jpg', '.jpeg', '.png', '.ppm', '.bmp', '.webp'}


@register_dataset
class ImageFolderDataset:
    """ImageNet-style directory dataset: root/<class>/<image>."""

    def __init__(self, root, transform=None, **kwargs):
        self.root = Path(root).expanduser()
        self.transform = transform
        classes = sorted(d.name for d in self.root.iterdir() if d.is_dir())
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples = [
            (p, self.class_to_idx[c]) for c in classes
            for p in sorted((self.root / c).iterdir())
            if p.suffix.lower() in IMG_EXTENSIONS]

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx):
        from PIL import Image
        path, target = self.samples[idx]
        img = Image.open(path).convert('RGB')
        if self.transform is not None:
            img = self.transform(img)
        return img, target


@register_dataset
class SyntheticClassificationDataset:
    """Deterministic random images (HWC), image i from seed + i: unit
    normal float32, or uniform uint8 with `normalized=False`."""

    def __init__(self, num_samples=64, image_size=(224, 224),
                 num_classes=1000, seed=0, normalized=True, **kwargs):
        self.num_samples = num_samples
        self.image_size = tuple(image_size)
        self.num_classes = num_classes
        self.seed = seed
        self.normalized = normalized

    def __len__(self):
        return self.num_samples

    def __getitem__(self, idx):
        rng = np.random.default_rng(self.seed + idx)
        h, w = self.image_size
        if self.normalized:
            img = rng.normal(0, 1, (h, w, 3)).astype(np.float32)
        else:
            img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        target = int(rng.integers(0, self.num_classes))
        return img, target


class DataLoader:
    """Batched loader with optional shuffle (`default_rng(seed + epoch)`)
    and, with `prefetch`, a background thread that prepares the next
    batches while the caller works. With `num_workers` > 0 a pool of that
    many threads fetches a batch's items (PIL's decode and file reads
    release the GIL); the batches and their order are those of
    `num_workers=0`. `close()` ends the pool.

    Over `num_shards` processes (the reference's DistributedSampler
    contract, as the JAX loader keeps it): every process shuffles the
    whole index set with the same epoch's seed, pads it by wrapping to
    a multiple of `num_shards`, and takes the `shard_index`-strided slice
    -- disjoint shards up to the padding, all of one length."""

    def __init__(self, dataset, batch_size=1, shuffle=False, drop_last=False,
                 collate_fn=None, seed=0, prefetch=True, num_workers=0,
                 num_shards=1, shard_index=0):
        if not 0 <= shard_index < num_shards:
            raise ValueError(f'shard_index {shard_index} not in '
                             f'[0, {num_shards})')
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.collate_fn = collate_fn or self._collate
        self.seed = seed
        self.prefetch = prefetch
        self.num_workers = num_workers
        self.num_shards = num_shards
        self.shard_index = shard_index
        self._pool = None
        self.epoch = 0

    @staticmethod
    def _collate(batch):
        xs, ys = zip(*batch)
        arrs = [np.asarray(x) for x in xs]
        if all(a.dtype == np.uint8 for a in arrs):
            # uint8 stays uint8: the runtime normalizes on the device
            # (input_norm), and a quarter of the bytes cross to it
            x = np.stack(arrs)
        else:
            x = np.stack([a.astype(np.float32) for a in arrs])
        return x, np.asarray(ys, np.int64)

    def _shard_len(self):
        return -(-len(self.dataset) // self.num_shards)

    def __len__(self):
        n = self._shard_len()
        return n // self.batch_size if self.drop_last \
            else -(-n // self.batch_size)

    def _indices(self):
        """This shard's dataset indices for the current epoch."""
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        if self.num_shards > 1:
            total = self._shard_len() * self.num_shards
            if total > len(idx):
                idx = np.concatenate([idx, idx[:total - len(idx)]])
            idx = idx[self.shard_index::self.num_shards]
        return idx

    def _fetch(self, chunk):
        """The items of `chunk`, in order (on the pool with workers)."""
        if self.num_workers > 0:
            if self._pool is None:
                from concurrent.futures import ThreadPoolExecutor
                self._pool = ThreadPoolExecutor(self.num_workers)
            return list(self._pool.map(lambda i: self.dataset[int(i)],
                                       chunk))
        return [self.dataset[int(i)] for i in chunk]

    def close(self):
        """End the worker pool (its threads otherwise live until exit)."""
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def _batches(self):
        idx = self._indices()
        bs = self.batch_size
        end = len(idx) - (len(idx) % bs) if self.drop_last else len(idx)
        for start in range(0, end, bs):
            yield self.collate_fn(self._fetch(idx[start:start + bs]))
        self.epoch += 1

    def __iter__(self):
        if not self.prefetch:
            yield from self._batches()
            return
        q: queue.Queue = queue.Queue(maxsize=2)
        sentinel = object()
        failure = []

        def producer():
            try:
                for b in self._batches():
                    q.put(b)
            except Exception as e:  # handed to the consumer below
                failure.append(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            yield item
        t.join()
        if failure:
            raise failure[0]


def build_dataset(dataset_config):
    """A dataset from its config (`key` and `kwargs`) via the registry."""
    key = dataset_config.get('key', dataset_config.get('type'))
    return get('dataset', key)(**dataset_config.get('kwargs', {}))


def build_sharded_loader(split_config, collate_fn=None,
                         shard_over_processes=False):
    """DataLoader from a split config (`collate_fn`, by default stacking
    same-size images, makes the batches; the config's `num_workers`
    threads fetch the items). With `shard_over_processes`,
    each process of a data-parallel group iterates its own shard (the
    training and validation loaders, as in JAX); otherwise every process
    iterates the whole dataset (the test loaders)."""
    shards = world_size() if shard_over_processes else 1
    return DataLoader(build_dataset(split_config['dataset']),
                      batch_size=split_config.get('batch_size', 1),
                      shuffle=split_config.get('shuffle', False),
                      drop_last=split_config.get('drop_last', False),
                      collate_fn=collate_fn,
                      num_workers=split_config.get('num_workers', 0),
                      num_shards=shards,
                      shard_index=rank() if shards > 1 else 0)
