"""gan_deeplearning4j_tpu_torch — the PyTorch/CUDA port of
``gan_deeplearning4j_tpu``, built slice by slice beside it (ROADMAP.md).

The JAX package is the unchanged reference; this package imports nothing
of it and never imports ``jax``. Module paths and public names mirror the
JAX package's so each module's counterpart is easy to find. Entry points
run on the card (``cuda:0``) unless the caller passes ``device="cpu"``.

So far the port covers two paths of the DCGAN-MNIST model:
- training: ``GanExperiment`` (the alternating D/G/classifier iteration,
  ``run()``, checkpoints, ``publish_for_serving``) and the trainer CLI
  ``python -m gan_deeplearning4j_tpu_torch``;
- serving: the generator and transfer classifier, loaded from either
  package's checkpoints and served over HTTP
  (``python -m gan_deeplearning4j_tpu_torch.serving``).
"""
