"""PyTorch port, the MFU ceiling (``harness/mfu.py``) against the JAX
package's ``scripts/mfu_ceiling.py``, on the CPU.

- Keys: the report, its gemm rows and its bare rows have the JAX script's
  keys (read from its dict literals with ``ast``) and the additions the
  module's docstring names, no other; ``achieved`` keeps the JAX config
  names ``"1"`` and ``"1b"``, null for a batch not measured.
- The bare step's FLOPs (``FlopCounterMode`` over one eager step) equal the
  port's ``flops_per_iteration`` at batch 8: the step computes every
  gradient of the full iteration.
- Fences: each timed call is fenced by a read of its own output, after it.
- The peak table: the H100 SXM, PCIe and NVL rows, and null for a card it
  does not hold (and the CPU).
- Without a card and without ``--cpu`` the CLI exits 2 and builds nothing.

The report runs at batch 8 with one step a call (``SCAN_K`` 1), one timed
call a tier and a 4-call ``achieved`` window at batch 8. Run with
``JAX_PLATFORMS=cpu``.
"""

import ast
import os

import pytest
import torch

from gan_deeplearning4j_tpu_torch.harness import ExperimentConfig, GanExperiment, mfu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_SCRIPT = os.path.join(REPO, "scripts", "mfu_ceiling.py")
#: what the port adds to the JAX script's keys (the module's docstring)
ADDED_REPORT = {"gemm_fp32", "peak_flops_fp32_assumed", "achieved_iteration"}
ADDED_ROW = {"peak_flops"}


def _dict_keys(function: str) -> list:
    """The string keys of each dict literal in ``function`` of the JAX
    script, in source order."""
    with open(JAX_SCRIPT) as fh:
        tree = ast.parse(fh.read())
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == function)
    return [{k.value for k in node.keys if isinstance(k, ast.Constant)}
            for node in ast.walk(fn) if isinstance(node, ast.Dict) and node.keys]


@pytest.fixture(scope="module")
def report():
    with pytest.MonkeyPatch.context() as mp:
        for name, value in (("SCAN_K", 1), ("GEMM_MIN_S", 1e-9), ("BARE_MIN_S", 1e-9),
                            ("MAX_CALLS", 1), ("ACHIEVED_ITERS", 4),
                            ("ACHIEVED_CONFIGS", {"1": 8, "1b": 256})):
            mp.setattr(mfu, name, value)
        return mfu.run(mfu.parse_args(["--cpu", "--gemm-n", "16", "--batches", "8"]))


def test_report_has_the_jax_keys_and_the_named_additions(report):
    main_keys = _dict_keys("main")
    jax_report = main_keys[0] | {"achieved"}  # main assigns "achieved" after its literal
    assert set(report) == jax_report | ADDED_REPORT
    assert set(report["achieved"]) == next(k for k in main_keys if k == {"1", "1b"})
    assert set(report["achieved_iteration"]) == {"1", "1b"}
    (gemm_keys,) = _dict_keys("bench_gemm")
    for tier in ("gemm", "gemm_fp32"):
        assert set(report[tier]) == gemm_keys | ADDED_ROW
    (bare_keys,) = [k for k in _dict_keys("bench_bare") if "bare_mfu" in k]
    assert set(report["bare"]) == {"8"}
    assert set(report["bare"]["8"]) == bare_keys | ADDED_ROW


def test_report_values_on_the_cpu(report):
    assert report["platform"] == "cpu" and report["device_kind"] == "cpu"
    assert report["scan_window"] == 1
    assert report["gemm"]["dtype"] == "bfloat16" and report["gemm_fp32"]["dtype"] == "float32"
    # no peak for the CPU: every MFU key is null, as the JAX script's
    assert report["peak_flops_assumed"] is None and report["gemm"]["frac_of_peak"] is None
    assert report["bare"]["8"]["bare_mfu"] is None
    assert report["achieved"] == {"1": None, "1b": None}
    assert report["achieved_iteration"]["1b"] is None
    row = report["achieved_iteration"]["1"]
    assert row["batch"] == 8 and row["mfu"] is None and row["sec_per_iter"] > 0


def test_bare_flops_equal_flops_per_iteration_at_b8(report):
    exp = GanExperiment(ExperimentConfig(batch_size_train=8, batch_size_pred=8, save_models=False,
                                         use_accelerator=False))
    assert report["bare"]["8"]["flops_per_iter"] == exp.flops_per_iteration(8)
    assert report["achieved_iteration"]["1"]["flops_per_iter"] == exp.flops_per_iteration(8)


class _Out:
    """A call's output that records when it is read."""

    def __init__(self, log: list, index: int):
        self.log, self.index = log, index

    def reshape(self, *shape):
        return self

    def __getitem__(self, item):
        return self

    def __float__(self):
        self.log.append(("read", self.index))
        return 0.0


def test_each_timed_call_is_fenced_on_its_own_output():
    log, calls = [], []

    def fn():
        calls.append(len(calls))
        log.append(("call", calls[-1]))
        return _Out(log, calls[-1])

    mfu._timed_calls(fn, mfu._read_first, min_s=1e9, max_calls=5)
    # the warm call, then 5 timed ones: each read right after its call, of it
    assert log == [ev for i in range(6) for ev in (("call", i), ("read", i))]


def test_read_first_reads_the_value():
    assert mfu._read_first(torch.tensor([[3.0, 1.0]])) == 3.0


@pytest.mark.parametrize("name, peaks", [
    ("NVIDIA H100 80GB HBM3", {"bf16": 989e12, "fp32": 67e12}),
    ("NVIDIA H100 SXM5 80GB", {"bf16": 989e12, "fp32": 67e12}),
    ("NVIDIA H100 PCIe", {"bf16": 756.5e12, "fp32": 51e12}),
    ("NVIDIA H100 NVL", {"bf16": 835.5e12, "fp32": 60e12}),
    ("NVIDIA A100-SXM4-80GB", None),
    ("cpu", None),
])
def test_the_peak_table(name, peaks):
    assert mfu._peak_flops(name) == peaks


def test_cli_without_a_card_exits_2(monkeypatch, capsys):
    def refuse(*args, **kwargs):
        raise AssertionError("the MFU report ran without a device")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(mfu, "run", refuse)
    monkeypatch.setattr(mfu, "bench_gemm", refuse)
    assert mfu.main([]) == 2
    assert "no CUDA device" in capsys.readouterr().err
