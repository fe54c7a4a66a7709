"""Telemetry of the PyTorch port: the process-wide metrics registry and the
span tracer, copied from ``gan_deeplearning4j_tpu/telemetry`` (both are
stdlib-only) so that the port imports nothing of the JAX package."""
