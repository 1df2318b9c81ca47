"""Host-side patch dataset and a prefetching loader (the JAX package's
``data/loader.py``, one process).

* PNG decode on the host with PIL, on a thread pool of ``num_workers``
  threads (the JAX package's native decoder is not ported);
* batches go to the device as raw uint8 NHWC through pinned memory, and
  augmentation and normalization run on the device inside the step;
* a background thread keeps up to ``PREFETCH`` (2) batches decoded and
  copied ahead of the consumer;
* the epoch order is ``RandomState(seed + epoch)``'s permutation
  (``DistributedSampler.set_epoch``); a final partial batch is wrap-padded
  from the epoch's start and marked in ``valid``.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, NamedTuple, Sequence, Tuple

import numpy as np
import torch
from PIL import Image

from pdac_pathological_image_segmentation_tpu_torch import host_to_device
from pdac_pathological_image_segmentation_tpu_torch.config import Config

PREFETCH = 2  # batches decoded and on the device ahead of the consumer


class Batch(NamedTuple):
    image: torch.Tensor  # (B, H, W, 3) uint8
    mask: torch.Tensor  # (B, H, W) uint8
    valid: torch.Tensor  # (B,) bool, False = wrap-padding


def decode_pair(img_path: str, mask_path: str
                ) -> Tuple[np.ndarray, np.ndarray]:
    image = np.asarray(Image.open(img_path).convert("RGB"), dtype=np.uint8)
    mask = np.asarray(Image.open(mask_path), dtype=np.uint8)
    if mask.ndim == 3:  # an RGB-stored mask
        mask = mask[..., 0]
    return image, mask


class PatchDataset:
    """Path-list dataset (reference ``CustomDataset``, ``dataset.py:7-30``)
    with its construction-time pre-shuffle by ``RandomState(cfg.seed)``."""

    def __init__(self, img_paths: Sequence[str], mask_paths: Sequence[str],
                 cfg: Config, pre_shuffle: bool = True) -> None:
        if len(img_paths) != len(mask_paths):
            raise ValueError("img/mask path count mismatch")
        self.img_paths = np.asarray(img_paths)
        self.mask_paths = np.asarray(mask_paths)
        self.cfg = cfg
        if pre_shuffle and len(img_paths):
            idxs = np.random.RandomState(cfg.seed).permutation(len(img_paths))
            self.img_paths = self.img_paths[idxs]
            self.mask_paths = self.mask_paths[idxs]

    def __len__(self) -> int:
        return len(self.img_paths)

    def __getitem__(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        return decode_pair(str(self.img_paths[i]), str(self.mask_paths[i]))


def epoch_indices(n: int, epoch: int, seed: int, shuffle: bool) -> np.ndarray:
    """The epoch's sample order (``RandomState(seed + epoch)`` when
    shuffling)."""
    if shuffle:
        return np.random.RandomState(seed + epoch).permutation(n)
    return np.arange(n)


class PatchLoader:
    """Epoch iterator of :class:`Batch` es on ``device``."""

    def __init__(self, dataset: PatchDataset, batch_size: int, shuffle: bool,
                 device, num_workers: int = 8) -> None:
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.device = torch.device(device)
        self.seed = dataset.cfg.seed
        self.num_workers = max(1, num_workers)

    def __len__(self) -> int:
        return -(-len(self.dataset) // self.batch_size)

    def host_batches(self, epoch: int) -> Iterator[Tuple[np.ndarray, ...]]:
        """``(images, masks, valid)`` numpy batches of one epoch, decoded
        by ``num_workers`` threads."""
        idxs = epoch_indices(len(self.dataset), epoch, self.seed,
                             self.shuffle)
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            for b in range(len(self)):
                chunk = idxs[b * self.batch_size:(b + 1) * self.batch_size]
                valid = np.ones(self.batch_size, dtype=bool)
                if len(chunk) < self.batch_size:  # final partial batch
                    pad = self.batch_size - len(chunk)
                    valid[len(chunk):] = False
                    # from the epoch's start, cyclically: a split smaller
                    # than the batch still fills it
                    chunk = np.concatenate([chunk, np.resize(idxs, pad)])
                pairs = list(pool.map(self.dataset.__getitem__, chunk))
                yield (np.stack([p[0] for p in pairs]),
                       np.stack([p[1] for p in pairs]), valid)

    def _to_device(self, host: Tuple[np.ndarray, ...]) -> Batch:
        return Batch(*(host_to_device(torch.from_numpy(a), self.device)
                       for a in host))

    def epoch(self, epoch: int) -> Iterator[Batch]:
        """One epoch, decoded and copied by a background thread up to
        ``PREFETCH`` batches ahead."""
        q: "queue.Queue" = queue.Queue(maxsize=PREFETCH)
        stop = object()
        error: list = []

        def producer():
            try:
                for hb in self.host_batches(epoch):
                    q.put(self._to_device(hb))
            except Exception as e:  # raised again in the consumer
                error.append(e)
            finally:
                q.put(stop)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is stop:
                break
            yield item
        t.join()
        if error:
            raise error[0]
