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
  cost block), ``eval.fid`` and ``deploy.canary``.
"""
