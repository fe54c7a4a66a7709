"""Data layer of the PyTorch port — counterpart of
``gan_deeplearning4j_tpu/data``: the reference's CSV → record reader →
``RecordReaderDataSetIterator(batch, labelIndex=784, numClasses=10)`` →
``DataSet{features, one-hot labels}`` pipeline, plus the MNIST preparation
(real MNIST on disk, else scikit-learn's digits, else a synthetic set).

Batches are host numpy arrays; the experiment moves them to the device.
The JAX package's ``DeviceResidentIterator`` and ``DevicePrefetchIterator``
wait for ROADMAP.md queue 1, 'Device-resident and prefetch iterators'.
"""

from gan_deeplearning4j_tpu_torch.data.dataset import DataSet, one_hot_np
from gan_deeplearning4j_tpu_torch.data.iterator import (
    ArrayDataSetIterator,
    DataSetIterator,
    RecordReaderDataSetIterator,
)
from gan_deeplearning4j_tpu_torch.data.mnist import (
    load_mnist,
    load_mnist_csv,
    prepare_mnist,
    synthetic_mnist,
    write_mnist_csv,
)
from gan_deeplearning4j_tpu_torch.data.records import (
    CSVRecordReader,
    FileSplit,
    write_csv,
)

__all__ = [
    "DataSet",
    "one_hot_np",
    "ArrayDataSetIterator",
    "DataSetIterator",
    "RecordReaderDataSetIterator",
    "load_mnist",
    "load_mnist_csv",
    "prepare_mnist",
    "synthetic_mnist",
    "write_mnist_csv",
    "CSVRecordReader",
    "FileSplit",
    "write_csv",
]
