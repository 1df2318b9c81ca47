"""Host-side patch dataset and a prefetching loader (the JAX package's
``data/loader.py``, one process).

* PNG decode on the host by the native C++ decoder
  (``data/native_loader.py``) on ``num_workers`` threads, whenever the
  first image and its mask have the same size (as the JAX loader decides);
  a dataset whose pairs differ in size is decoded by PIL, pair by pair, on
  a pool of ``num_workers`` threads;
* batches go to the device as raw uint8 NHWC through pinned memory — the
  native decoder writes straight into pinned host tensors — and
  augmentation and normalization run on the device inside the step;
* a background thread keeps up to ``PREFETCH`` (2) batches decoded and
  copied ahead of the consumer;
* the epoch order is ``RandomState(seed + epoch)``'s permutation
  (``DistributedSampler.set_epoch``); a final partial batch is wrap-padded
  from the epoch's start and marked in ``valid``.
"""

from __future__ import annotations

import contextlib
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, NamedTuple, Sequence, Tuple

import numpy as np
import torch
from PIL import Image

from pdac_pathological_image_segmentation_tpu_torch import host_to_device
from pdac_pathological_image_segmentation_tpu_torch.config import Config
from pdac_pathological_image_segmentation_tpu_torch.data import native_loader

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
    """Epoch iterator of :class:`Batch` es on ``device``.

    ``native_hw`` is the ``(height, width)`` the native decoder decodes
    every pair at, from the first pair's PNG headers, or None when the first
    image and mask differ (then PIL's :func:`decode_pair` decodes them)."""

    def __init__(self, dataset: PatchDataset, batch_size: int, shuffle: bool,
                 device, num_workers: int = 8) -> None:
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.device = torch.device(device)
        self.seed = dataset.cfg.seed
        self.num_workers = max(1, num_workers)
        self.native_hw = None
        if len(dataset):
            hw_img = native_loader.png_info(str(dataset.img_paths[0]))
            hw_mask = native_loader.png_info(str(dataset.mask_paths[0]))
            if hw_img is not None and hw_img == hw_mask:
                self.native_hw = hw_img

    def __len__(self) -> int:
        return -(-len(self.dataset) // self.batch_size)

    def _native_decode(self, chunk: np.ndarray) -> Tuple[torch.Tensor, ...]:
        """One batch by the native decoder, into pinned host tensors when
        the batch is bound for a card (the copy then starts from where it
        was decoded; the caching host allocator holds each block until its
        copy has run), else into plain host memory."""
        h, w = self.native_hw
        pin = self.device.type == "cuda"
        images = torch.empty((len(chunk), h, w, 3), dtype=torch.uint8,
                             pin_memory=pin)
        masks = torch.empty((len(chunk), h, w, 1), dtype=torch.uint8,
                            pin_memory=pin)
        ds = self.dataset
        native_loader.decode_batch([str(ds.img_paths[i]) for i in chunk],
                                   h, w, 3, threads=self.num_workers,
                                   out=images.numpy())
        native_loader.decode_batch([str(ds.mask_paths[i]) for i in chunk],
                                   h, w, 1, threads=self.num_workers,
                                   out=masks.numpy())
        return images, masks[..., 0]

    def host_batches(self, epoch: int) -> Iterator[Tuple[torch.Tensor, ...]]:
        """``(images, masks, valid)`` host tensors of one epoch."""
        idxs = epoch_indices(len(self.dataset), epoch, self.seed,
                             self.shuffle)
        # PIL's pool, for a dataset the native decoder does not take
        with (ThreadPoolExecutor(max_workers=self.num_workers)
              if self.native_hw is None
              else contextlib.nullcontext()) as pool:
            for b in range(len(self)):
                chunk = idxs[b * self.batch_size:(b + 1) * self.batch_size]
                valid = np.ones(self.batch_size, dtype=bool)
                if len(chunk) < self.batch_size:  # final partial batch
                    pad = self.batch_size - len(chunk)
                    valid[len(chunk):] = False
                    # from the epoch's start, cyclically: a split smaller
                    # than the batch still fills it
                    chunk = np.concatenate([chunk, np.resize(idxs, pad)])
                if self.native_hw is not None:
                    images, masks = self._native_decode(chunk)
                else:
                    pairs = list(pool.map(self.dataset.__getitem__, chunk))
                    images = torch.from_numpy(np.stack([p[0] for p in pairs]))
                    masks = torch.from_numpy(np.stack([p[1] for p in pairs]))
                yield images, masks, torch.from_numpy(valid)

    def _to_device(self, host: Tuple[torch.Tensor, ...]) -> Batch:
        return Batch(*(host_to_device(t, self.device) for t in host))

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
