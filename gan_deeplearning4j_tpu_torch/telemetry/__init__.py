"""telemetry/ of the PyTorch port — counterpart of
``gan_deeplearning4j_tpu/telemetry``, the observability plane every other
plane reads:

- :mod:`.trace` — structured spans in a bounded ring buffer with Chrome
  trace-event export and correlation ids;
- :mod:`.registry` — process-wide counters, gauges and histograms,
  exported as JSON, Prometheus text and BENCH snapshots;
- :mod:`.device` — on-demand ``torch.profiler`` captures behind the
  serving API's ``POST /debug/trace`` and the worker CLI's SIGUSR2;
- :mod:`.aggregate` — per-process snapshots and traces merged into one;
- :mod:`.slo` — multi-window burn rates; empty windows fail closed;
- :mod:`.alerts` — the declarative alerting plane over those snapshots
  (threshold, absence, burn and anomaly rules; pending → firing →
  resolved with hysteresis; exemplars; sinks);
- :mod:`.trace_report` — folds Chrome traces (span dumps, the fleet's
  merged trace, profiler captures) into occupancy and attribution tables
  (``python -m gan_deeplearning4j_tpu_torch.telemetry.trace_report``).

``registry``, ``trace``, ``aggregate``, ``slo``, ``alerts`` and
``trace_report`` (``scripts/trace_report.py`` there) are the JAX package's
stdlib-only modules, copied so that the port imports nothing of
that package. The namespace is lazy (PEP 562): importing it imports no
``torch``; only :mod:`.device` does, and only inside a capture.
"""

# name -> (module to import, attribute to take from it; None = the module)
_LAZY_EXPORTS = {
    "MetricsRegistry": ("gan_deeplearning4j_tpu_torch.telemetry.registry",
                        "MetricsRegistry"),
    "get_registry": ("gan_deeplearning4j_tpu_torch.telemetry.registry",
                     "get_registry"),
    "set_registry": ("gan_deeplearning4j_tpu_torch.telemetry.registry",
                     "set_registry"),
    "percentiles": ("gan_deeplearning4j_tpu_torch.telemetry.registry",
                    "percentiles"),
    "Tracer": ("gan_deeplearning4j_tpu_torch.telemetry.trace", "Tracer"),
    "TRACER": ("gan_deeplearning4j_tpu_torch.telemetry.trace", "TRACER"),
    "get_tracer": ("gan_deeplearning4j_tpu_torch.telemetry.trace", "get_tracer"),
    "new_trace_id": ("gan_deeplearning4j_tpu_torch.telemetry.trace",
                     "new_trace_id"),
    "current_trace_id": ("gan_deeplearning4j_tpu_torch.telemetry.trace",
                         "current_trace_id"),
    "bind_trace_id": ("gan_deeplearning4j_tpu_torch.telemetry.trace",
                      "bind_trace_id"),
    "unbind_trace_id": ("gan_deeplearning4j_tpu_torch.telemetry.trace",
                        "unbind_trace_id"),
    "configure_from_env": ("gan_deeplearning4j_tpu_torch.telemetry.trace",
                           "configure_from_env"),
    "sanitize_trace_id": ("gan_deeplearning4j_tpu_torch.telemetry.trace",
                          "sanitize_trace_id"),
    "merge_snapshots": ("gan_deeplearning4j_tpu_torch.telemetry.aggregate",
                        "merge_snapshots"),
    "snapshot_to_prometheus": ("gan_deeplearning4j_tpu_torch.telemetry.aggregate",
                               "snapshot_to_prometheus"),
    "merge_traces": ("gan_deeplearning4j_tpu_torch.telemetry.aggregate",
                     "merge_traces"),
    "SLOConfig": ("gan_deeplearning4j_tpu_torch.telemetry.slo", "SLOConfig"),
    "SLOTracker": ("gan_deeplearning4j_tpu_torch.telemetry.slo", "SLOTracker"),
    "AlertRule": ("gan_deeplearning4j_tpu_torch.telemetry.alerts", "AlertRule"),
    "AlertManager": ("gan_deeplearning4j_tpu_torch.telemetry.alerts",
                     "AlertManager"),
    "ExemplarStore": ("gan_deeplearning4j_tpu_torch.telemetry.alerts",
                      "ExemplarStore"),
    "WebhookSink": ("gan_deeplearning4j_tpu_torch.telemetry.alerts",
                    "WebhookSink"),
    "log_sink": ("gan_deeplearning4j_tpu_torch.telemetry.alerts", "log_sink"),
    "default_fleet_rules": ("gan_deeplearning4j_tpu_torch.telemetry.alerts",
                            "default_fleet_rules"),
    "default_mux_rules": ("gan_deeplearning4j_tpu_torch.telemetry.alerts",
                          "default_mux_rules"),
    "capture_device_trace": ("gan_deeplearning4j_tpu_torch.telemetry.device",
                             "capture_device_trace"),
    "capture_async": ("gan_deeplearning4j_tpu_torch.telemetry.device",
                      "capture_async"),
    "install_signal_capture": ("gan_deeplearning4j_tpu_torch.telemetry.device",
                               "install_signal_capture"),
    "CaptureBusy": ("gan_deeplearning4j_tpu_torch.telemetry.device",
                    "CaptureBusy"),
}

__all__ = list(_LAZY_EXPORTS)


def __getattr__(name):
    try:
        module_name, attr = _LAZY_EXPORTS[name]
    except KeyError:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}"
        ) from None
    import importlib

    module = importlib.import_module(module_name)
    value = module if attr is None else getattr(module, attr)
    globals()[name] = value  # cache: __getattr__ runs once per name
    return value


def __dir__():
    return sorted({*globals(), *_LAZY_EXPORTS})
