"""Vision datasets (paddle_tpu/vision/datasets/__init__.py, numpy only,
copied as it is): FakeImageDataset, and MNIST / FashionMNIST / Cifar10 /
Cifar100 / Flowers, each synthetic from a seed by default (MNIST: 4096
samples of [1, 28, 28] in [0, 1)) or read from a local .npz, idx or
tar.gz file the caller names; DatasetFolder and ImageFolder read a
directory (PIL). Nothing downloads."""
from __future__ import annotations

import numpy as np

from ...io import Dataset

__all__ = ["MNIST", "FashionMNIST", "Cifar10", "Cifar100", "FakeImageDataset"]


class FakeImageDataset(Dataset):
    def __init__(self, num_samples=1024, image_shape=(1, 28, 28),
                 num_classes=10, transform=None, seed=0,
                 synthesize=True):
        self.num_samples = num_samples
        self.image_shape = tuple(image_shape)
        self.num_classes = num_classes
        self.transform = transform
        if synthesize:
            rng = np.random.RandomState(seed)
            self._images = rng.rand(
                num_samples, *self.image_shape).astype(np.float32)
            self._labels = rng.randint(
                0, num_classes, (num_samples, 1)).astype(np.int64)
        else:
            # real-data subclasses assign _images/_labels themselves —
            # don't generate (and immediately discard) synthetic arrays
            self._images = self._labels = None

    def __getitem__(self, idx):
        img = self._images[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img, self._labels[idx]

    def __len__(self):
        return self.num_samples


class MNIST(FakeImageDataset):
    """Offline env: synthesizes MNIST-shaped data; pass data_file to load a
    local .npz with keys images/labels."""

    def __init__(self, image_path=None, label_path=None, mode="train",
                 transform=None, download=False, backend=None,
                 data_file=None):
        if image_path is not None and label_path is not None:
            images, labels = load_mnist_idx(image_path, label_path)
            super().__init__(len(labels), (1, 28, 28), 10, transform,
                             synthesize=False)
            self._images = images
            self._labels = labels
        elif data_file is not None:
            d = np.load(data_file)
            n = len(d["labels"])
            super().__init__(n, (1, 28, 28), 10, transform,
                             synthesize=False)
            self._images = d["images"].astype(np.float32).reshape(
                n, 1, 28, 28)
            self._labels = d["labels"].astype(np.int64).reshape(n, 1)
        else:
            n = 60000 if mode == "train" else 10000
            super().__init__(min(n, 4096), (1, 28, 28), 10, transform)


class FashionMNIST(MNIST):
    pass


class Cifar10(FakeImageDataset):
    _num_classes = 10

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=False, backend=None):
        if data_file is not None:
            images, labels = load_cifar_batches(
                data_file, mode, cifar100=self._num_classes == 100)
            super().__init__(len(labels), (3, 32, 32),
                             self._num_classes, transform,
                             synthesize=False)
            self._images = images
            self._labels = labels.reshape(-1, 1)
            return
        n = 2048 if mode == "train" else 512
        super().__init__(n, (3, 32, 32), self._num_classes, transform)

    def __getitem__(self, idx):
        img, label = super().__getitem__(idx)
        return img, int(label[0])


class Cifar100(Cifar10):
    _num_classes = 100


def _parse_idx(path):
    """Parse an (optionally gzipped) MNIST idx file."""
    import gzip
    import struct

    op = gzip.open if str(path).endswith(".gz") else open
    with op(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = [struct.unpack(">I", f.read(4))[0] for _ in range(ndim)]
        data = np.frombuffer(f.read(), np.uint8)
    return data.reshape(dims)


def load_mnist_idx(image_path, label_path):
    """Real-format MNIST loader (reference mnist.py parses the same idx
    files): returns (images [N,1,28,28] float32 in [0,1], labels [N,1])."""
    images = _parse_idx(image_path).astype(np.float32) / 255.0
    labels = _parse_idx(label_path).astype(np.int64)
    return images.reshape(-1, 1, 28, 28), labels.reshape(-1, 1)


def load_cifar_batches(data_file, mode="train", cifar100=False):
    """Real-format CIFAR loader from the standard tar.gz archive
    (reference cifar.py): returns (images [N,3,32,32], labels [N])."""
    import pickle
    import tarfile

    images, labels = [], []
    label_key = b"fine_labels" if cifar100 else b"labels"
    with tarfile.open(data_file, "r:*") as tar:
        for member in tar.getmembers():
            name = member.name.rsplit("/", 1)[-1]
            is_train = name.startswith("data_batch") or name == "train"
            is_test = name.startswith("test_batch") or name == "test"
            if not (is_train if mode == "train" else is_test):
                continue
            d = pickle.load(tar.extractfile(member), encoding="bytes")
            images.append(np.asarray(d[b"data"], np.float32)
                          .reshape(-1, 3, 32, 32) / 255.0)
            labels.append(np.asarray(d[label_key], np.int64))
    return np.concatenate(images), np.concatenate(labels)


def _scan_images(root, extensions, is_valid_file):
    """Walk `root` collecting image paths (shared by DatasetFolder /
    ImageFolder)."""
    import os

    exts = tuple(e.lower() for e in (extensions
                                     or DatasetFolder.IMG_EXTENSIONS))
    out = []
    for dirpath, _, files in sorted(os.walk(root)):
        for fn in sorted(files):
            path = os.path.join(dirpath, fn)
            ok = is_valid_file(path) if is_valid_file else \
                fn.lower().endswith(exts)
            if ok:
                out.append(path)
    return out


class DatasetFolder(Dataset):
    """Directory-per-class image dataset (reference folder.py:66)."""

    IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp", ".ppm", ".webp")

    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        import os

        self.root = root
        self.transform = transform
        self.loader = loader or self._pil_loader
        classes = sorted(d for d in os.listdir(root)
                         if os.path.isdir(os.path.join(root, d)))
        self.classes = classes
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples = []
        for c in classes:
            for path in _scan_images(os.path.join(root, c), extensions,
                                     is_valid_file):
                self.samples.append((path, self.class_to_idx[c]))

    @staticmethod
    def _pil_loader(path):
        from PIL import Image

        with Image.open(path) as img:
            arr = np.asarray(img.convert("RGB"), np.float32) / 255.0
        return arr.transpose(2, 0, 1)

    def __getitem__(self, idx):
        path, target = self.samples[idx]
        img = self.loader(path)
        if self.transform is not None:
            img = self.transform(img)
        return img, target

    def __len__(self):
        return len(self.samples)


class ImageFolder(DatasetFolder):
    """Flat folder of images, no labels (reference folder.py:310)."""

    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        self.root = root
        self.transform = transform
        self.loader = loader or self._pil_loader
        self.samples = _scan_images(root, extensions, is_valid_file)

    def __getitem__(self, idx):
        img = self.loader(self.samples[idx])
        if self.transform is not None:
            img = self.transform(img)
        return [img]


class Flowers(FakeImageDataset):
    """Flowers102 (reference flowers.py): real data via data_file pointing
    at a local npz with images/labels; synthetic shape otherwise."""

    def __init__(self, data_file=None, label_file=None, setid_file=None,
                 mode="train", transform=None, download=False,
                 backend=None):
        if data_file is not None and str(data_file).endswith(".npz"):
            d = np.load(data_file)
            n = len(d["labels"])
            super().__init__(n, tuple(d["images"].shape[1:]), 102,
                             transform, synthesize=False)
            self._images = d["images"].astype(np.float32)
            self._labels = d["labels"].astype(np.int64).reshape(n, 1)
        else:
            super().__init__(512, (3, 64, 64), 102, transform)


__all__ += ["DatasetFolder", "ImageFolder", "Flowers", "load_mnist_idx",
            "load_cifar_batches"]
