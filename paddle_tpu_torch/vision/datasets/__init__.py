"""Vision datasets (a port of ``paddle_tpu/vision/datasets``), host-side
numpy samples over the port's ``io.Dataset``. Nothing is downloaded:
``MNIST``, ``FashionMNIST`` and ``Cifar10/100`` read their archives from
``utils.download.DATA_HOME`` (or the paths given) and, as the
reference's do, stand in seeded ``FakeData`` of the same shapes where
the files are absent; ``Flowers`` and ``VOC2012`` are such stand-ins
always; ``DatasetFolder`` and ``ImageFolder`` raise on a tree with no
image. ``download`` and ``backend`` are taken and not read.
"""
import gzip
import os
import struct

import numpy as np

from ...io.dataset import Dataset
from ...utils.download import DATA_HOME


class FakeData(Dataset):
    """Seeded synthetic samples: N(0, 1) images, uniform int64 labels
    ``[1]`` (numpy ``RandomState(seed)``, as the reference's)."""

    def __init__(self, num_samples=1024, image_shape=(1, 28, 28),
                 num_classes=10, dtype="float32", seed=0):
        self.num_samples = num_samples
        self.image_shape = tuple(image_shape)
        self.num_classes = num_classes
        self.dtype = dtype
        self._rng = np.random.RandomState(seed)
        self._images = self._rng.standard_normal(
            (num_samples,) + self.image_shape).astype(dtype)
        self._labels = self._rng.randint(
            0, num_classes, (num_samples, 1)).astype("int64")

    def __getitem__(self, idx):
        return self._images[idx], self._labels[idx]

    def __len__(self):
        return self.num_samples


class MNIST(Dataset):
    """idx-format files from ``DATA_HOME/mnist``; ``FakeData`` of 60000
    (train) or 10000 samples where they are absent."""

    def __init__(self, image_path=None, label_path=None, mode="train",
                 transform=None, download=True, backend=None):
        self.mode = mode
        self.transform = transform
        base = os.path.join(DATA_HOME, "mnist")
        prefix = "train" if mode == "train" else "t10k"
        image_path = image_path or os.path.join(
            base, f"{prefix}-images-idx3-ubyte.gz")
        label_path = label_path or os.path.join(
            base, f"{prefix}-labels-idx1-ubyte.gz")
        if os.path.exists(image_path) and os.path.exists(label_path):
            self.images, self.labels = self._load(image_path, label_path)
        else:
            fake = FakeData(60000 if mode == "train" else 10000,
                            (1, 28, 28), 10)
            self.images = fake._images.reshape(-1, 28, 28)
            self.labels = fake._labels
        self._fake = not (os.path.exists(image_path)
                          and os.path.exists(label_path))

    @staticmethod
    def _load(image_path, label_path):
        with gzip.open(image_path, "rb") as f:
            magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
            images = np.frombuffer(f.read(), np.uint8).reshape(n, rows, cols)
        with gzip.open(label_path, "rb") as f:
            magic, n = struct.unpack(">II", f.read(8))
            labels = np.frombuffer(f.read(), np.uint8).astype("int64")
        images = images.astype("float32") / 255.0
        return images, labels.reshape(-1, 1)

    def __getitem__(self, idx):
        img = self.images[idx].reshape(1, 28, 28).astype("float32")
        if self.transform is not None:
            img = self.transform(img)
        return img, self.labels[idx]

    def __len__(self):
        return len(self.images)


class Cifar10(Dataset):
    """The python pickle archive; ``FakeData`` where it is absent."""

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=True, backend=None):
        self.transform = transform
        data_file = data_file or os.path.join(DATA_HOME, "cifar",
                                              "cifar-10-python.tar.gz")
        if os.path.exists(data_file):
            self.images, self.labels = self._load_tar(data_file, mode)
        else:
            fake = FakeData(50000 if mode == "train" else 10000,
                            (3, 32, 32), 10)
            self.images = fake._images
            self.labels = fake._labels

    @staticmethod
    def _load_tar(data_file, mode, label_key=b"labels"):
        import pickle
        import tarfile
        want = "test_batch" if mode != "train" else "data_batch"
        if label_key == b"fine_labels":
            want = "test" if mode != "train" else "train"
        images, labels = [], []
        with tarfile.open(data_file) as tf:
            for member in sorted(tf.getnames()):
                if want in os.path.basename(member):
                    batch = pickle.load(tf.extractfile(member),
                                        encoding="bytes")
                    images.append(batch[b"data"].reshape(-1, 3, 32, 32)
                                  .astype("float32") / 255.0)
                    labels.extend(batch[label_key])
        return (np.concatenate(images),
                np.asarray(labels, "int64").reshape(-1, 1))

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img, self.labels[idx]

    def __len__(self):
        return len(self.images)


class Cifar100(Cifar10):
    def __init__(self, data_file=None, mode="train", transform=None,
                 download=True, backend=None):
        self.transform = transform
        data_file = data_file or os.path.join(DATA_HOME, "cifar",
                                              "cifar-100-python.tar.gz")
        if os.path.exists(data_file):
            self.images, self.labels = self._load_tar(data_file, mode,
                                                      b"fine_labels")
        else:
            fake = FakeData(50000 if mode == "train" else 10000,
                            (3, 32, 32), 100, seed=1)
            self.images, self.labels = fake._images, fake._labels


class FashionMNIST(MNIST):
    """MNIST's idx format under ``DATA_HOME/fashion-mnist``."""

    def __init__(self, image_path=None, label_path=None, mode="train",
                 transform=None, download=True, backend=None):
        base = os.path.join(DATA_HOME, "fashion-mnist")
        prefix = "train" if mode == "train" else "t10k"
        image_path = image_path or os.path.join(
            base, f"{prefix}-images-idx3-ubyte.gz")
        label_path = label_path or os.path.join(
            base, f"{prefix}-labels-idx1-ubyte.gz")
        super().__init__(image_path, label_path, mode, transform, download,
                         backend)


def _default_image_loader(path):
    if path.endswith(".npy"):
        return np.load(path)
    try:
        from PIL import Image
        with Image.open(path) as img:
            return np.asarray(img.convert("RGB"), np.float32) / 255.0
    except ImportError as e:
        raise RuntimeError(
            f"cannot load {path}: PIL unavailable; use .npy files") from e


IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".npy")


class DatasetFolder(Dataset):
    """One class a subdirectory; samples ``(image, class_index)``. Images
    load as ``.npy`` or through PIL, imported at the call."""

    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        self.root = root
        self.loader = loader or _default_image_loader
        self.transform = transform
        extensions = tuple(extensions) if extensions else IMG_EXTENSIONS
        classes = sorted(d for d in os.listdir(root)
                         if os.path.isdir(os.path.join(root, d)))
        self.classes = classes
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples = []
        for c in classes:
            cdir = os.path.join(root, c)
            for dirpath, _, files in sorted(os.walk(cdir)):
                for fname in sorted(files):
                    path = os.path.join(dirpath, fname)
                    ok = (is_valid_file(path) if is_valid_file
                          else fname.lower().endswith(extensions))
                    if ok:
                        self.samples.append((path, self.class_to_idx[c]))
        if not self.samples:
            raise RuntimeError(f"no valid samples under {root}")

    def __getitem__(self, idx):
        path, target = self.samples[idx]
        img = self.loader(path)
        if self.transform is not None:
            img = self.transform(img)
        return img, target

    def __len__(self):
        return len(self.samples)


class ImageFolder(Dataset):
    """Every image under ``root``, without labels."""

    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        self.root = root
        self.loader = loader or _default_image_loader
        self.transform = transform
        extensions = tuple(extensions) if extensions else IMG_EXTENSIONS
        self.samples = []
        for dirpath, _, files in sorted(os.walk(root)):
            for fname in sorted(files):
                path = os.path.join(dirpath, fname)
                ok = (is_valid_file(path) if is_valid_file
                      else fname.lower().endswith(extensions))
                if ok:
                    self.samples.append(path)
        if not self.samples:
            raise RuntimeError(f"no valid samples under {root}")

    def __getitem__(self, idx):
        img = self.loader(self.samples[idx])
        if self.transform is not None:
            img = self.transform(img)
        return [img]

    def __len__(self):
        return len(self.samples)


class Flowers(Dataset):
    """A seeded stand-in of 102 classes at [3, 224, 224]."""

    def __init__(self, data_file=None, label_file=None, setid_file=None,
                 mode="train", transform=None, download=True, backend=None):
        self.transform = transform
        n = {"train": 6149, "valid": 1020, "test": 1020}.get(mode, 1020)
        fake = FakeData(min(n, 256), (3, 224, 224), 102, seed=2)
        self.images, self.labels = fake._images, fake._labels

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img, self.labels[idx]

    def __len__(self):
        return len(self.images)


class VOC2012(Dataset):
    """A seeded stand-in of segmentation pairs (image, mask of 21
    classes)."""

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=True, backend=None):
        self.transform = transform
        rng = np.random.RandomState(3)
        n = 64
        self.images = rng.standard_normal((n, 3, 64, 64)).astype("float32")
        self.masks = rng.randint(0, 21, (n, 64, 64)).astype("int64")

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img, self.masks[idx]

    def __len__(self):
        return len(self.images)
