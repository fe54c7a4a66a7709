"""gan_deeplearning4j_tpu_torch — the PyTorch/CUDA port of
``gan_deeplearning4j_tpu``, built slice by slice beside it (ROADMAP.md).

The JAX package is the unchanged reference; this package imports nothing
of it and never imports ``jax``. Module paths and public names mirror the
JAX package's so each module's counterpart is easy to find. Entry points
run on the card (``cuda:0``) unless the caller passes ``device="cpu"``.

So far the port covers:
- training of every model family (DCGAN-MNIST with its transfer
  classifier, tabular, image, WGAN-GP), in fp32 and bf16: ``GanExperiment``
  (``run()``, checkpoints, ``publish_for_serving``) and the trainer CLI
  ``python -m gan_deeplearning4j_tpu_torch``;
- serving: generators and the transfer classifier, loaded from either
  package's bundles (fp32, bf16 or int8) and served over HTTP
  (``python -m gan_deeplearning4j_tpu_torch.serving``);
- quantization and its gate: ``quant`` (bf16 / int8 variants, the measured
  cost block), ``eval.fid`` and ``deploy.canary``;
- evaluation: the quality run (``python -m
  gan_deeplearning4j_tpu_torch.eval.quality_run``), FID under the frozen,
  Inception-schema and discriminator feature spaces, in-process accuracy.

The top-level namespace is lazy, as the JAX package's is: ``factory``,
``backend_info`` and the dtype policy's getters and setters are imported
on first use.
"""

# name -> (module to import, attribute to take from it; None = the module)
_LAZY_EXPORTS = {
    "backend_info": ("gan_deeplearning4j_tpu_torch.runtime.environment", "backend_info"),
    "factory": ("gan_deeplearning4j_tpu_torch.runtime.factory", None),
    "get_default_dtype": ("gan_deeplearning4j_tpu_torch.runtime.dtype", "get_default_dtype"),
    "set_default_dtype": ("gan_deeplearning4j_tpu_torch.runtime.dtype", "set_default_dtype"),
}

__all__ = list(_LAZY_EXPORTS)


def __getattr__(name):
    try:
        module_name, attr = _LAZY_EXPORTS[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}") from None
    import importlib

    module = importlib.import_module(module_name)
    value = module if attr is None else getattr(module, attr)
    globals()[name] = value  # cached: __getattr__ runs once per name
    return value


def __dir__():
    return sorted({*globals(), *_LAZY_EXPORTS})
