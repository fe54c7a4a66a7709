"""Graph/module system of the PyTorch port — counterpart of
``gan_deeplearning4j_tpu/nn``: named layers, declared InputTypes with shape
inference, params as ``{layer: {name: tensor}}`` dicts, and the
transfer-learning surgery that builds the classifier."""

from gan_deeplearning4j_tpu_torch.nn.input_type import InputType
from gan_deeplearning4j_tpu_torch.nn.layers import (
    ActivationLayer,
    BatchNormalization,
    ConvolutionLayer,
    Deconvolution2D,
    DenseLayer,
    DropoutLayer,
    Layer,
    LossLayer,
    OutputLayer,
    SubsamplingLayer,
    Upsampling2D,
)
from gan_deeplearning4j_tpu_torch.nn.preprocessors import (
    CnnToFeedForwardPreProcessor,
    FeedForwardToCnnPreProcessor,
    FlatToCnnPreProcessor,
)
from gan_deeplearning4j_tpu_torch.nn.graph import ComputationGraph, GraphBuilder, GraphConfig
from gan_deeplearning4j_tpu_torch.nn.transfer import FineTuneConfiguration, TransferLearning

__all__ = [
    "InputType",
    "Layer",
    "ActivationLayer",
    "BatchNormalization",
    "ConvolutionLayer",
    "Deconvolution2D",
    "DenseLayer",
    "DropoutLayer",
    "LossLayer",
    "OutputLayer",
    "SubsamplingLayer",
    "Upsampling2D",
    "CnnToFeedForwardPreProcessor",
    "FeedForwardToCnnPreProcessor",
    "FlatToCnnPreProcessor",
    "ComputationGraph",
    "GraphBuilder",
    "GraphConfig",
    "FineTuneConfiguration",
    "TransferLearning",
]
