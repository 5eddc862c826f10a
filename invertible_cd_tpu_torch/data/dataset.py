"""Input pipeline: an image + caption folder with rank-strided infinite
sampling.

The port's own copy of `invertible_cd_tpu/data/dataset.py` (reference
`training/src/datasets.py`): a folder-scan dataset, the EDM-style
`InfiniteSampler` (a rank-strided, shuffled, infinite index stream with
window swaps) and `make_train_iterator`, which yields numpy NHWC float32
batches in [-1, 1] with captions, decoding in a thread pool so that it
overlaps the device's steps. The rank and the replica count are arguments;
the caller supplies them (one process: 0 and 1).
"""
from __future__ import annotations

import csv
import os
import queue
import threading
from typing import Iterator, List, Optional, Tuple

import numpy as np

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


def load_and_preprocess(path: str, resolution: int = 512) -> np.ndarray:
    """Load -> bicubic resize of the short side -> centre crop -> [-1, 1]
    float32 HWC (the reference transform, `datasets.py:15-22`), in the
    native library (`utils/native.py`) when it is available, PIL otherwise."""
    from PIL import Image

    from ..utils import native

    img = Image.open(path).convert("RGB")
    if native.available():
        return native.resize_crop_normalize(np.asarray(img), resolution)
    w, h = img.size
    scale = resolution / min(w, h)
    img = img.resize(
        (max(resolution, round(w * scale)), max(resolution, round(h * scale))), Image.BICUBIC)
    w, h = img.size
    left = (w - resolution) // 2
    top = (h - resolution) // 2
    img = img.crop((left, top, left + resolution, top + resolution))
    return np.asarray(img, np.float32) / 127.5 - 1.0


class ImageCaptionDataset:
    """Folder of images + `{subset}.csv` captions (reference `COCODataset`,
    `datasets.py:46-110`). CSV columns: file_name (or image), caption (or
    text); other columns are ignored. Without the CSV every image in the
    folder is taken, with an empty caption, in name order."""

    def __init__(self, root: str, subset: str = "train", resolution: int = 512,
                 captions_csv: Optional[str] = None):
        self.root = root
        self.resolution = resolution
        csv_path = captions_csv or os.path.join(root, f"{subset}.csv")
        self.items: List[Tuple[str, str]] = []
        if os.path.exists(csv_path):
            with open(csv_path, newline="", encoding="utf-8") as f:
                for row in csv.DictReader(f):
                    name = row.get("file_name") or row.get("image")
                    cap = row.get("caption") or row.get("text") or ""
                    if name:
                        self.items.append((name, cap))
        else:
            for name in sorted(os.listdir(root)):
                if name.lower().endswith(IMG_EXTENSIONS):
                    self.items.append((name, ""))
        if not self.items:
            raise FileNotFoundError(f"no images found under {root}")

    def __len__(self) -> int:
        return len(self.items)

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, str]:
        name, caption = self.items[idx]
        return load_and_preprocess(os.path.join(self.root, name), self.resolution), caption


class InfiniteSampler:
    """Infinite shuffled index stream with window swapping and rank striding
    (EDM-style; reference `datasets.py:113-150`). Deterministic given (seed,
    rank): every replica sees a disjoint stride of one shuffled order,
    reshuffled locally by window swaps."""

    def __init__(self, dataset_size: int, rank: int = 0, num_replicas: int = 1,
                 shuffle: bool = True, seed: int = 0, window_size: float = 0.5):
        if dataset_size <= 0 or not 0 <= rank < num_replicas or not 0 <= window_size <= 1:
            raise ValueError(f"InfiniteSampler({dataset_size}, rank={rank}, "
                             f"num_replicas={num_replicas}, window_size={window_size})")
        self.dataset_size = dataset_size
        self.rank = rank
        self.num_replicas = num_replicas
        self.shuffle = shuffle
        self.seed = seed
        self.window_size = window_size

    def __iter__(self) -> Iterator[int]:
        order = np.arange(self.dataset_size)
        rnd = None
        window = 0
        if self.shuffle:
            rnd = np.random.RandomState(self.seed)
            rnd.shuffle(order)
            window = int(np.rint(order.size * self.window_size))
        idx = 0
        while True:
            i = idx % order.size
            if idx % self.num_replicas == self.rank:
                yield int(order[i])
            if window >= 2:
                j = (i - rnd.randint(window)) % order.size
                order[i], order[j] = order[j], order[i]
            idx += 1


def make_train_iterator(dataset: ImageCaptionDataset, batch_size: int, rank: int = 0,
                        num_replicas: int = 1, seed: int = 0, num_workers: int = 4,
                        prefetch: int = 2) -> Iterator[Tuple[np.ndarray, List[str]]]:
    """Infinite (images (B, H, W, 3) float32 in [-1, 1], captions) batches.
    With `num_workers` > 0, decoding runs in that many daemon threads (a
    feeder, the workers and a collator), `prefetch` batches ahead; the
    batches then hold the sampler's indices in the order the workers finish
    them."""
    sampler = iter(InfiniteSampler(len(dataset), rank=rank, num_replicas=num_replicas, seed=seed))
    if num_workers <= 0:
        while True:
            pairs = [dataset[next(sampler)] for _ in range(batch_size)]
            yield np.stack([p[0] for p in pairs]), [p[1] for p in pairs]

    out_q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    idx_q: "queue.Queue" = queue.Queue(maxsize=batch_size * (prefetch + 1))
    item_q: "queue.Queue" = queue.Queue(maxsize=batch_size * (prefetch + 1))

    def feeder():
        while True:
            idx_q.put(next(sampler))

    def worker():
        while True:
            item_q.put(dataset[idx_q.get()])

    def collator():
        while True:
            pairs = [item_q.get() for _ in range(batch_size)]
            out_q.put((np.stack([p[0] for p in pairs]), [p[1] for p in pairs]))

    threads = [threading.Thread(target=feeder, daemon=True)]
    threads += [threading.Thread(target=worker, daemon=True) for _ in range(num_workers)]
    threads.append(threading.Thread(target=collator, daemon=True))
    for t in threads:
        t.start()
    while True:
        yield out_q.get()
