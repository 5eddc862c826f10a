"""The port's image-folder data path against the JAX package's: the native
image op's binding, `ImageCaptionDataset`, `InfiniteSampler` and
`make_train_iterator` on a folder of seeded PNGs, and the train CLI's
`--data_root` run at the tiny model (CPU).

The port keeps its own copies of `invertible_cd_tpu/data/dataset.py` and
`invertible_cd_tpu/utils/native.py`; both load the same native library
(`native/libicd_image_ops.so`, built from `native/image_ops.cc` on first use)
or take the same PIL path, so arrays and captions must agree exactly.
"""
import csv
import itertools
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from invertible_cd_tpu.data import dataset as j_dataset
from invertible_cd_tpu.utils import native as j_native
from invertible_cd_tpu_torch.cli import train_icd
from invertible_cd_tpu_torch.data import dataset
from invertible_cd_tpu_torch.utils import native

SIZES = [(24, 18), (20, 24), (17, 17), (30, 22)]  # (h, w): portrait, landscape, square, odd


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for the tiny CLI run (see `test_torch_baselines.py`)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """4 seeded PNGs of different shapes and a train.csv (captions, an extra
    column the reader ignores)."""
    root = tmp_path_factory.mktemp("images")
    rng = np.random.default_rng(0)
    rows = []
    for i, (h, w) in enumerate(SIZES):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8)).save(root / f"{i}.png")
        rows.append({"file_name": f"{i}.png", "caption": f"a photo of thing {i}", "score": i})
    with open(root / "train.csv", "w", newline="") as f:
        writer = csv.DictWriter(f, ["file_name", "caption", "score"])
        writer.writeheader()
        writer.writerows(rows)
    return str(root)


def test_native_binding_matches_the_jax_binding():
    """Same library, same arguments: bit-identical output, single and batch."""
    assert native.available() == j_native.available()
    if not native.available():
        pytest.skip("the native library could not be built (no g++)")
    rng = np.random.default_rng(1)
    imgs = [rng.integers(0, 256, (h, w, 3), np.uint8) for h, w in SIZES]
    for img in imgs:
        got = native.resize_crop_normalize(img, 16)
        assert got.shape == (16, 16, 3) and got.dtype == np.float32
        np.testing.assert_array_equal(got, j_native.resize_crop_normalize(img, 16))
        np.testing.assert_array_equal(
            native.resize_crop_normalize(img, 12, filter=native.FILTER_BILINEAR),
            j_native.resize_crop_normalize(img, 12, filter=j_native.FILTER_BILINEAR))
    np.testing.assert_array_equal(native.resize_crop_normalize_batch(imgs, 16, num_threads=2),
                                  j_native.resize_crop_normalize_batch(imgs, 16, num_threads=2))


@pytest.mark.parametrize("path", ["native", "pil"])
def test_dataset_items_match_jax(folder, path, monkeypatch):
    """Every item, on the native path and on PIL's (the library made
    unavailable to both packages): the same float32 array, bit for bit, and
    the same caption; the CSV's order and its extra column ignored."""
    if path == "pil":
        monkeypatch.setattr(native, "available", lambda: False)
        monkeypatch.setattr(j_native, "available", lambda: False)
    elif not native.available():
        pytest.skip("the native library could not be built (no g++)")
    ds = dataset.ImageCaptionDataset(folder, "train", resolution=16)
    jds = j_dataset.ImageCaptionDataset(folder, "train", resolution=16)
    assert len(ds) == len(jds) == 4 and ds.items == jds.items
    for i in range(4):
        (img, cap), (jimg, jcap) = ds[i], jds[i]
        assert img.shape == (16, 16, 3) and img.dtype == np.float32 and cap == jcap
        assert -1.0 <= img.min() and img.max() <= 1.0
        np.testing.assert_array_equal(img, jimg)


def test_dataset_without_csv_and_without_images(folder, tmp_path):
    """Without `<subset>.csv` the folder's images in name order with empty
    captions; an empty folder is an error."""
    ds = dataset.ImageCaptionDataset(folder, "val", resolution=8)
    assert ds.items == j_dataset.ImageCaptionDataset(folder, "val", resolution=8).items
    assert ds.items == [(f"{i}.png", "") for i in range(4)]
    with pytest.raises(FileNotFoundError):
        dataset.ImageCaptionDataset(str(tmp_path), "train")


@pytest.mark.parametrize("rank,replicas,shuffle", [(0, 1, True), (1, 3, True), (0, 2, False)])
def test_infinite_sampler_matches_jax(rank, replicas, shuffle):
    """The same index stream for the same (size, rank, replicas, seed): 200
    draws, window swaps and all."""
    got = list(itertools.islice(dataset.InfiniteSampler(
        7, rank=rank, num_replicas=replicas, shuffle=shuffle, seed=3), 200))
    want = list(itertools.islice(j_dataset.InfiniteSampler(
        7, rank=rank, num_replicas=replicas, shuffle=shuffle, seed=3), 200))
    assert got == want and set(got) <= set(range(7))
    with pytest.raises(ValueError):
        dataset.InfiniteSampler(7, rank=2, num_replicas=2)


def test_train_iterator_matches_jax(folder):
    """Five batches of 3 without worker threads: the JAX iterator's arrays
    (bit for bit) and captions, in its order, for the same seed; with
    threads, batches of the same shape drawn from the same items."""
    ds = dataset.ImageCaptionDataset(folder, "train", resolution=16)
    jds = j_dataset.ImageCaptionDataset(folder, "train", resolution=16)
    got = dataset.make_train_iterator(ds, 3, seed=5, num_workers=0)
    want = j_dataset.make_train_iterator(jds, 3, seed=5, num_workers=0)
    for _ in range(5):
        (imgs, caps), (jimgs, jcaps) = next(got), next(want)
        assert imgs.shape == (3, 16, 16, 3) and caps == jcaps
        np.testing.assert_array_equal(imgs, jimgs)
    threaded = dataset.make_train_iterator(ds, 3, seed=5, num_workers=2)
    captions = {cap for _, cap in ds.items}
    for _ in range(3):
        imgs, caps = next(threaded)
        assert imgs.shape == (3, 16, 16, 3) and set(caps) <= captions


def test_cli_tiny_run_from_an_image_folder(folder, tmp_path):
    """`--data_root` at the tiny model: the tiny bundle's VAE and text
    encoder encode each batch; two steps end with finite metrics, a
    checkpoint and the kohya export of both students at step 2."""
    out = tmp_path / "run"
    last = train_icd.main([
        "--model", "tiny", "--device", "cpu", "--data_root", folder, "--resolution", "16",
        "--batch_size", "2", "--lora_rank", "4", "--max_steps", "2", "--log_every", "1",
        "--lazy_lora", "--output_dir", str(out)])
    assert all(np.isfinite(v) for v in last.values()) and len(last) == 9
    assert sorted(os.listdir(out / "checkpoints")) == ["2"]
    for name in ("unet_lora", "forward_unet_lora"):
        assert (out / "export_2" / name / "lora_weights.safetensors").stat().st_size > 0
    rows = [json.loads(line) for line in open(out / "logs" / "metrics.jsonl")]
    assert [r["step"] for r in rows] == [1, 2]
