"""MNIST data preparation — counterpart of
``gan_deeplearning4j_tpu/data/mnist.py`` (numpy only, copied so the port
imports nothing of the JAX package).

``prepare_mnist`` writes ``{prefix}_train.csv`` / ``{prefix}_test.csv`` in
the reference's layout (784 feature columns in [0, 1] with ``%.2f``, the
integer label as column 785) plus the stratified 100-per-class sample.
Its source is the best available: the real MNIST IDX files on disk, else
scikit-learn's bundled 8×8 handwritten digits upsampled to 28×28, else a
deterministic synthetic set of smooth glyphs (``source="synthetic"``
forces it). The same seed gives the same files as the JAX package.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

IMAGE_SIDE = 28
NUM_FEATURES = IMAGE_SIDE * IMAGE_SIDE  # 784 (dl4jGANComputerVision.java:71)
NUM_CLASSES = 10


def _class_templates(seed: int) -> np.ndarray:
    """Ten smooth, well-separated 28×28 glyph templates. Each class is a
    low-frequency random field (sum of seeded 2-D cosines) — smooth like pen
    strokes, distinct across classes, so convnets have real signal to learn."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:IMAGE_SIDE, 0:IMAGE_SIDE].astype(np.float32) / IMAGE_SIDE
    templates = np.zeros((NUM_CLASSES, IMAGE_SIDE, IMAGE_SIDE), dtype=np.float32)
    for c in range(NUM_CLASSES):
        field = np.zeros((IMAGE_SIDE, IMAGE_SIDE), dtype=np.float32)
        for _ in range(6):
            fx, fy = rng.uniform(0.5, 3.0, size=2)
            px, py = rng.uniform(0, 2 * np.pi, size=2)
            amp = rng.uniform(0.4, 1.0)
            field += amp * np.cos(2 * np.pi * fx * xx + px) * np.cos(
                2 * np.pi * fy * yy + py
            )
        field = (field - field.min()) / (field.max() - field.min() + 1e-8)
        # soft vignette keeps mass centered like handwritten digits
        r2 = (xx - 0.5) ** 2 + (yy - 0.5) ** 2
        templates[c] = field * np.exp(-4.0 * r2)
    return templates


def synthetic_mnist(
    num_train: int = 2000,
    num_test: int = 500,
    seed: int = 666,
    noise: float = 0.08,
    max_shift: int = 2,
) -> Tuple[Tuple[np.ndarray, np.ndarray], Tuple[np.ndarray, np.ndarray]]:
    """Deterministic MNIST-shaped dataset: ((x_train, y_train), (x_test, y_test))
    with x float32 in [0,1] of shape (N, 784) and y int labels — the exact
    contract of ``mnist.load_data()`` post-processing in gan.ipynb cell 2."""
    templates = _class_templates(seed)
    rng = np.random.default_rng(seed + 1)

    def make(n: int) -> Tuple[np.ndarray, np.ndarray]:
        labels = rng.integers(0, NUM_CLASSES, size=n)
        imgs = templates[labels].copy()
        shifts = rng.integers(-max_shift, max_shift + 1, size=(n, 2))
        for i in range(n):
            imgs[i] = np.roll(imgs[i], shifts[i], axis=(0, 1))
        imgs += rng.normal(0.0, noise, size=imgs.shape).astype(np.float32)
        imgs = np.clip(imgs, 0.0, 1.0)
        return imgs.reshape(n, NUM_FEATURES).astype(np.float32), labels.astype(np.int64)

    return make(num_train), make(num_test)


# -- IDX (the real MNIST distribution format) --------------------------------

_IDX_DTYPES = {
    0x08: np.dtype(np.uint8), 0x09: np.dtype(np.int8), 0x0B: np.dtype(">i2"),
    0x0C: np.dtype(">i4"), 0x0D: np.dtype(">f4"), 0x0E: np.dtype(">f8"),
}

_IDX_NAMES = {
    "train_images": ("train-images-idx3-ubyte", "train-images.idx3-ubyte"),
    "train_labels": ("train-labels-idx1-ubyte", "train-labels.idx1-ubyte"),
    "test_images": ("t10k-images-idx3-ubyte", "t10k-images.idx3-ubyte"),
    "test_labels": ("t10k-labels-idx1-ubyte", "t10k-labels.idx1-ubyte"),
}


def read_idx(path: str) -> np.ndarray:
    """Read one IDX-format array (the format of the canonical MNIST files;
    yann.lecun.com spec: 2 zero bytes, dtype code, ndim, big-endian dims,
    then row-major data). ``.gz`` paths are decompressed transparently."""
    import gzip

    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as fh:
        raw = fh.read()
    if len(raw) < 4 or raw[0] != 0 or raw[1] != 0:
        raise ValueError(f"{path}: not an IDX file (bad magic {raw[:4]!r})")
    if raw[2] not in _IDX_DTYPES:
        raise ValueError(f"{path}: unknown IDX dtype code 0x{raw[2]:02x}")
    dtype, ndim = _IDX_DTYPES[raw[2]], raw[3]
    dims = np.frombuffer(raw, ">i4", count=ndim, offset=4)
    expected = 4 + 4 * ndim + int(np.prod(dims)) * dtype.itemsize
    if len(raw) < expected:
        raise ValueError(f"{path}: truncated IDX file ({len(raw)} < {expected} bytes)")
    return np.frombuffer(raw, dtype, count=int(np.prod(dims)),
                         offset=4 + 4 * ndim).reshape(dims)


def _find_idx_file(directory: str, names: Tuple[str, ...]) -> Optional[str]:
    for name in names:
        for candidate in (name, name + ".gz"):
            path = os.path.join(directory, candidate)
            if os.path.exists(path):
                return path
    return None


def find_mnist_idx(extra_dirs: Tuple[str, ...] = ()) -> Optional[str]:
    """Locate a directory holding the four canonical MNIST IDX files.
    Searched: ``$MNIST_DIR``, any ``extra_dirs``, then the usual dataset
    caches. Returns the directory or None."""
    candidates = []
    if os.environ.get("MNIST_DIR"):
        candidates.append(os.environ["MNIST_DIR"])
    candidates.extend(extra_dirs)
    home = os.path.expanduser("~")
    candidates += [
        os.path.join(home, ".keras", "datasets"),
        os.path.join(home, ".keras", "datasets", "mnist"),
        os.path.join(home, "data", "mnist"),
        "/data/mnist", "/datasets/mnist", "/data", "/datasets",
    ]
    for d in candidates:
        if d and os.path.isdir(d) and all(
            _find_idx_file(d, names) for names in _IDX_NAMES.values()
        ):
            return d
    return None


def load_mnist_idx(directory: str) -> Tuple[Tuple[np.ndarray, np.ndarray], Tuple[np.ndarray, np.ndarray]]:
    """Load real MNIST from IDX files: ((x_train, y_train), (x_test, y_test)),
    x float32 (N, 784) in [0,1] — the exact gan.ipynb cell-2 post-processing
    (scale /255, flatten)."""
    arrays = {}
    for key, names in _IDX_NAMES.items():
        path = _find_idx_file(directory, names)
        if path is None:
            raise FileNotFoundError(f"missing MNIST IDX file {names[0]}[.gz] in {directory!r}")
        arrays[key] = read_idx(path)

    def prep(images, labels):
        x = images.astype(np.float32).reshape(len(images), -1) / 255.0
        return x, labels.astype(np.int64)

    return (
        prep(arrays["train_images"], arrays["train_labels"]),
        prep(arrays["test_images"], arrays["test_labels"]),
    )


# -- real handwritten digits without a download -------------------------------

def _resize_bilinear(imgs: np.ndarray, side: int) -> np.ndarray:
    """(N, h, w) → (N, side, side) bilinear, align-corners=False convention."""
    n, h, w = imgs.shape
    ys = (np.arange(side) + 0.5) * h / side - 0.5
    xs = (np.arange(side) + 0.5) * w / side - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = np.clip(ys - y0, 0.0, 1.0).astype(np.float32)[None, :, None]
    wx = np.clip(xs - x0, 0.0, 1.0).astype(np.float32)[None, None, :]
    a = imgs[:, y0][:, :, x0]
    b = imgs[:, y0][:, :, x1]
    c = imgs[:, y1][:, :, x0]
    d = imgs[:, y1][:, :, x1]
    top = a * (1.0 - wx) + b * wx
    bot = c * (1.0 - wx) + d * wx
    return (top * (1.0 - wy) + bot * wy).astype(np.float32)


def real_digits(
    num_train: int = 2000,
    num_test: int = 500,
    seed: int = 666,
    max_shift: int = 2,
) -> Tuple[Tuple[np.ndarray, np.ndarray], Tuple[np.ndarray, np.ndarray]]:
    """Real handwritten digits without a download: scikit-learn's bundled
    UCI optdigits set (1797 genuine 8×8 handwritten digits), bilinearly
    upsampled to 28×28 and shift-augmented up to the requested sizes. Not
    MNIST, but real pen strokes. Raises ImportError without sklearn."""
    from sklearn.datasets import load_digits

    d = load_digits()
    imgs = _resize_bilinear(d.images.astype(np.float32) / 16.0, IMAGE_SIDE)
    imgs = np.clip(imgs, 0.0, 1.0)
    labels = d.target.astype(np.int64)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(imgs))
    imgs, labels = imgs[perm], labels[perm]
    n_test_src = max(1, min(len(imgs) // 4, num_test))
    src = {
        "train": (imgs[n_test_src:], labels[n_test_src:]),
        "test": (imgs[:n_test_src], labels[:n_test_src]),
    }

    def take(split: str, n: int) -> Tuple[np.ndarray, np.ndarray]:
        base_x, base_y = src[split]
        idx = rng.integers(0, len(base_x), size=n) if n > len(base_x) else \
            rng.permutation(len(base_x))[:n]
        x, y = base_x[idx].copy(), base_y[idx]
        shifts = rng.integers(-max_shift, max_shift + 1, size=(n, 2))
        for i in range(n):
            x[i] = np.roll(x[i], shifts[i], axis=(0, 1))
        return x.reshape(n, NUM_FEATURES).astype(np.float32), y

    return take("train", num_train), take("test", num_test)


def load_mnist(
    num_train: int = 2000,
    num_test: int = 500,
    seed: int = 666,
    data_dir: Optional[str] = None,
) -> Tuple[str, Tuple[Tuple[np.ndarray, np.ndarray], Tuple[np.ndarray, np.ndarray]]]:
    """Best-available MNIST-shaped data: real IDX MNIST if on disk, else the
    real (non-MNIST) UCI digits, else the synthetic glyphs. Returns
    (provenance_tag, ((x_train, y_train), (x_test, y_test)))."""
    idx_dir = find_mnist_idx((data_dir,) if data_dir else ())
    if idx_dir is not None:
        (xtr, ytr), (xte, yte) = load_mnist_idx(idx_dir)
        rng = np.random.default_rng(seed)
        tr = rng.permutation(len(xtr))[:num_train]
        te = rng.permutation(len(xte))[:num_test]
        return "mnist-idx", ((xtr[tr], ytr[tr]), (xte[te], yte[te]))
    try:
        return "uci-digits-upsampled", real_digits(num_train, num_test, seed)
    except ImportError:
        return "synthetic", synthetic_mnist(num_train, num_test, seed)


def write_mnist_csv(
    path: str, features: np.ndarray, labels: np.ndarray, fmt: str = "%.2f"
) -> str:
    """Write the reference CSV layout: 784 feature columns then the label as
    column 785, ``%.2f`` formatted (gan.ipynb cell 2's np.savetxt calls)."""
    features = np.asarray(features, dtype=np.float32).reshape(len(labels), -1)
    table = np.concatenate(
        [features, np.asarray(labels, dtype=np.float32).reshape(-1, 1)], axis=1
    )
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    # np.savetxt, as in the JAX package: the prepared files are byte-equal
    # between the two packages for the same seed
    np.savetxt(path, table, delimiter=",", fmt=fmt)
    return path


def stratified_sample(
    features: np.ndarray, labels: np.ndarray, per_class: int = 100, seed: int = 666
) -> Tuple[np.ndarray, np.ndarray]:
    """The notebook's 100-per-class ``sampled_mnist_train.csv`` subset."""
    rng = np.random.default_rng(seed)
    keep = []
    for c in np.unique(labels):
        idx = np.flatnonzero(labels == c)
        take = min(per_class, idx.size)
        keep.append(rng.choice(idx, size=take, replace=False))
    keep = np.concatenate(keep)
    rng.shuffle(keep)
    return features[keep], labels[keep]


def load_mnist_csv(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Read a reference-format CSV back into (features[N,784] float32 in [0,1],
    labels[N] int64)."""
    from gan_deeplearning4j_tpu_torch.data.records import CSVRecordReader, FileSplit

    reader = CSVRecordReader(0, ",")
    reader.initialize(FileSplit(path))
    data = reader.data
    return data[:, :NUM_FEATURES].astype(np.float32), data[:, NUM_FEATURES].astype(np.int64)


def prepare_mnist(
    out_dir: str,
    num_train: int = 2000,
    num_test: int = 500,
    seed: int = 666,
    source: Optional[str] = None,
    prefix: str = "mnist",
) -> Tuple[str, str]:
    """End-to-end cell-2 analog: obtain MNIST, write ``{prefix}_train.csv`` +
    ``{prefix}_test.csv`` (+ the stratified sample) under ``out_dir``;
    returns the two paths. ``source``: None → best available (IDX MNIST on
    disk > bundled real UCI digits > synthetic; see ``load_mnist``);
    ``"synthetic"`` → force the deterministic glyphs; a directory → read
    reference-format CSVs from it."""
    train_path = os.path.join(out_dir, f"{prefix}_train.csv")
    test_path = os.path.join(out_dir, f"{prefix}_test.csv")
    if source is not None and source != "synthetic":
        src_train = os.path.join(source, f"{prefix}_train.csv")
        src_test = os.path.join(source, f"{prefix}_test.csv")
        if os.path.exists(src_train) and os.path.exists(src_test):
            xtr, ytr = load_mnist_csv(src_train)
            xte, yte = load_mnist_csv(src_test)
        else:
            raise FileNotFoundError(f"no mnist CSVs under {source!r}")
    elif source == "synthetic":
        (xtr, ytr), (xte, yte) = synthetic_mnist(num_train, num_test, seed)
    else:
        _, ((xtr, ytr), (xte, yte)) = load_mnist(num_train, num_test, seed)
    write_mnist_csv(train_path, xtr, ytr)
    write_mnist_csv(test_path, xte, yte)
    xs, ys = stratified_sample(xtr, ytr, per_class=100, seed=seed)
    write_mnist_csv(os.path.join(out_dir, f"sampled_{prefix}_train.csv"), xs, ys)
    return train_path, test_path
