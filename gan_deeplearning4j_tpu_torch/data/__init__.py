"""Data layer of the PyTorch port — counterpart of
``gan_deeplearning4j_tpu/data``: the reference's CSV → record reader →
``RecordReaderDataSetIterator(batch, labelIndex=784, numClasses=10)`` →
``DataSet{features, one-hot labels}`` pipeline, plus the MNIST preparation
(real MNIST on disk, else scikit-learn's digits, else a synthetic set).

The record and array iterators yield host numpy batches, which the
experiment moves to the device. ``DeviceResidentIterator`` (the whole set
on the device, windows as one slice) and ``DevicePrefetchIterator`` (any
iterator, ``depth`` batches ahead on a side stream) yield device tensors.
"""

from gan_deeplearning4j_tpu_torch.data.dataset import DataSet, one_hot_np
from gan_deeplearning4j_tpu_torch.data.iterator import (
    ArrayDataSetIterator,
    DataSetIterator,
    DevicePrefetchIterator,
    DeviceResidentIterator,
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
    "DevicePrefetchIterator",
    "DeviceResidentIterator",
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
