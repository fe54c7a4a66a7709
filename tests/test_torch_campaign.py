"""PyTorch port, the on-card campaign (``gan_deeplearning4j_tpu_torch/campaign.py``)
against the JAX package's ``scripts/tpu_campaign.sh``, on the CPU.

Every comparison runs the JAX script's own text, read out of the script at
test time:

- the quality-flag selector (the heredoc at ``:295-315``), run with
  ``python -`` in a working directory of its own, against
  ``select_quality_flags`` on the same sweep documents;
- the bench validator (the heredoc at ``:238-251``) against
  ``bench_records_ok`` on records made to pass and to fail each way; the
  MFU, sweep and quality one-liners against their validators;
- the 16 gates parsed from the script against ``PREFLIGHT``: the same
  program (by its port module), flags, paths, log, timeout and fatality,
  ``--cpu`` or ``--device cpu`` added; the card steps' commands and the
  ledger against ``CARD_STEPS`` and ``LEDGER``, with the additions the
  module names.

The orchestration runs ``run_campaign`` on stub tables of short ``python
-c`` commands: the exit codes (1 for a gate or the ledger, 2 without a
card, 3 at the deadline, 0 when everything is done), the restore of a
failed step, a retry, and the rounds kept as ``BENCH_rNN.json``. Nothing
here imports torch or needs a card.
"""

import dataclasses
import json
import os
import re
import shlex
import subprocess
import sys
import time

import numpy as np
import pytest

from gan_deeplearning4j_tpu_torch import campaign
from gan_deeplearning4j_tpu_torch.campaign import Gate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "scripts", "tpu_campaign.sh")


def _script() -> str:
    with open(SCRIPT) as fh:
        return fh.read()


def _heredoc(opening: str) -> str:
    """The heredoc that starts on the line holding ``opening``."""
    lines = _script().splitlines()
    start = next(i for i, line in enumerate(lines) if opening in line)
    end = next(i for i in range(start + 1, len(lines)) if lines[i] == "EOF")
    return "\n".join(lines[start + 1:end]) + "\n"


def _python_c(marker: str) -> str:
    """The code of the script's ``python -c "..."`` whose code holds ``marker``."""
    text = _script()
    for m in re.finditer(r'python -c "([^"]*)"', text):
        if marker in m.group(1):
            return m.group(1)
    raise AssertionError(f"no python -c holding {marker!r}")


def _run_python(code: str, cwd, stdin: bool = False) -> subprocess.CompletedProcess:
    argv = [sys.executable, "-"] if stdin else [sys.executable, "-c", code]
    return subprocess.run(argv, input=code if stdin else None, cwd=cwd, capture_output=True,
                          text=True, timeout=30)


def _write(path, obj) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        fh.write(obj if isinstance(obj, str) else json.dumps(obj))


# -- the selector -------------------------------------------------------------------

def _arm(fid, acc=0.95, **kw):
    return {"final_quick_fid": fid, "accuracy": acc, **kw}


SWEEPS = {
    "accuracy_filter": {"iterations": 1200, "arms": [
        _arm(40.0, 0.93, dis_lr=0.001, gen_lr=0.002), _arm(50.0, 0.95, dis_lr=0.004, gen_lr=0.008),
        _arm(55.0, 0.97, dis_lr=0.002, gen_lr=0.004)]},
    "accuracy_at_the_bar_counts": {"iterations": 1200, "arms": [
        _arm(50.0, 0.95, dis_lr=0.004), _arm(40.0, 0.94, dis_lr=0.001), _arm(30.0, 0.9399)]},
    "fallback_to_all_arms": {"iterations": 1200, "arms": [
        _arm(60.0, 0.90, dis_lr=0.004, gen_lr=0.002), _arm(45.0, 0.80, dis_lr=0.001, gen_lr=0.008)]},
    "rescale_half_rounds_to_even": {"iterations": 8000, "arms": [
        _arm(30.0, dis_lr_decay_every=5, dis_lr_decay_rate=0.5)]},
    "rescale_to_zero_floors_at_one": {"iterations": 10000, "arms": [
        _arm(30.0, dis_lr_decay_every=1, dis_lr_decay_rate=0.7)]},
    "rescale_default_iterations": {"arms": [
        _arm(30.0, dis_lr_decay_every=200, dis_lr_decay_rate=0.7, resample_label_noise=True)]},
    "resample_flag": {"iterations": 1200, "arms": [
        _arm(20.0, resample_label_noise=True, dis_lr=0.002, gen_lr=0.004),
        _arm(25.0, resample_label_noise=False)]},
    "missing_learning_rates": {"iterations": 1200, "arms": [_arm(20.0)]},
    "no_final_quick_fid": {"iterations": 1200, "arms": [_arm(20.0), {"accuracy": 0.99}]},
    "non_integer_decay_every": {"iterations": 1200, "arms": [
        _arm(20.0, resample_label_noise=True, dis_lr_decay_every="12.5")]},
    "float_decay_every_truncates": {"iterations": 1200, "arms": [
        _arm(20.0, dis_lr_decay_every=150.7, dis_lr_decay_rate=0.5, dis_lr=0.001)]},
    "zero_iterations_gives_partial_flags": {"iterations": 0, "arms": [
        _arm(20.0, resample_label_noise=True, dis_lr_decay_every=200)]},
    "null_decay_every": {"iterations": 1200, "arms": [_arm(20.0, dis_lr_decay_every=None)]},
    "missing_accuracy_falls_back": {"iterations": 1200, "arms": [
        {"final_quick_fid": 33.0, "gen_lr": 0.008}, {"final_quick_fid": 31.0, "dis_lr": 0.004}]},
    "tie_takes_the_first": {"iterations": 1200, "arms": [
        _arm(20.0, dis_lr=0.001), _arm(20.0, dis_lr=0.004)]},
    "no_arms": {"iterations": 1200, "arms": []},
    "missing_file": None,
    "malformed_file": "{not json",
}


@pytest.mark.parametrize("case", sorted(SWEEPS))
def test_selector_equals_the_jax_heredoc(case, tmp_path):
    doc = SWEEPS[case]
    path = tmp_path / "artifacts" / "tuning_sweep.json"
    if doc is not None:
        _write(str(path), doc)
    jax = _run_python(_heredoc("QFLAGS=$(python - <<'EOF'"), tmp_path, stdin=True)
    port = campaign.select_quality_flags(str(path))
    assert " ".join(port) == jax.stdout.strip()
    assert campaign.quality_flags(str(tmp_path)) == port


def test_the_selector_cases_reach_the_rescale_corners(tmp_path):
    # 5 · 4000 / 8000 = 2.5 rounds to even, 1 · 4000 / 10000 = 0.4 to the floor
    for case, every in (("rescale_half_rounds_to_even", "2"), ("rescale_to_zero_floors_at_one", "1")):
        path = tmp_path / f"{case}.json"
        _write(str(path), SWEEPS[case])
        flags = campaign.select_quality_flags(str(path))
        assert flags[flags.index("--dis-lr-decay-every") + 1] == every


# -- the validators -------------------------------------------------------------------

def _results(n=8, **kw):
    return [{"config": str(i), "value": 1.0 + i, "vs_baseline": 1.0, **kw} for i in range(n)]


def _record(results, degraded=False):
    return {"metric": "m", "degraded": degraded, "results": results}


GOOD = _record(_results())
BENCH_CASES = {
    "pass": (GOOD, GOOD),
    "pass_1_without_ratios": (_record(_results(vs_baseline=None)), GOOD),
    "seven_results": (_record(_results(7)), GOOD),
    "seven_results_in_pass_2": (GOOD, _record(_results(7))),
    "nine_results": (_record(_results(9)), GOOD),
    "degraded": (_record(_results(), degraded=True), GOOD),
    "stale": (GOOD, _record(_results()[:7] + [{"config": "4b", "stale": True,
                                                 "vs_baseline": 1.0}])),
    "error": (_record(_results()[:7] + [{"config": "5", "error": "boom"}]), GOOD),
    "skipped": (_record(_results()[:7] + [{"config": "5", "skipped": "budget"}]), GOOD),
    "stale_false_passes": (_record(_results(stale=False, skipped="")), GOOD),
    "null_ratio_in_pass_2": (GOOD, _record(_results()[:7] + [{"config": "3",
                                                             "vs_baseline": None}])),
    "missing_ratio_in_pass_2": (GOOD, _record(_results()[:7] + [{"config": "3"}])),
    "no_degraded_key": ({"results": _results()}, GOOD),
    "missing_pass_2": (GOOD, None),
    "malformed_pass_1": ("{", GOOD),
}


@pytest.mark.parametrize("case", sorted(BENCH_CASES))
def test_bench_validator_equals_the_jax_heredoc(case, tmp_path):
    for rel, doc in zip(campaign.BENCH_RECORDS, BENCH_CASES[case]):
        if doc is not None:
            _write(str(tmp_path / rel), doc)
    jax = _run_python(_heredoc("if python - <<'EOF'"), tmp_path, stdin=True)
    port = campaign.bench_records_ok(str(tmp_path))
    assert port == (jax.returncode == 0)
    assert port == (case.startswith("pass") or case == "stale_false_passes")


@pytest.mark.parametrize("platform", ["gpu", "cpu", "tpu", None, "malformed"])
@pytest.mark.parametrize("which", ["mfu", "quality"])
def test_record_validators_equal_the_jax_one_liners(which, platform, tmp_path):
    rel = campaign.MFU_RECORD if which == "mfu" else campaign.QUALITY_RECORD
    if platform == "malformed":
        _write(str(tmp_path / rel), "[")
    elif platform is not None:
        _write(str(tmp_path / rel), {"platform": platform})
    if which == "mfu":
        jax = _run_python(_python_c("mfu_ceiling.json"), tmp_path).returncode == 0
        port = campaign.mfu_ok(str(tmp_path))
    else:
        # the port's spelling of the JAX check: the card's platform is "gpu"
        code = _python_c("quality_run.json")
        assert "=='tpu'" in code
        jax = _run_python(code.replace("=='tpu'", "=='gpu'"), tmp_path).returncode == 0
        port = campaign.quality_ok(str(tmp_path))
    if which == "mfu" and platform == "tpu":
        # the JAX check is != "cpu"; the port's is == "gpu", a TPU record is not its own
        assert jax and not port
    else:
        assert port == jax


@pytest.mark.parametrize("platform,arms", [("gpu", 13), ("gpu", 14), ("gpu", 12), ("cpu", 13),
                                           (None, 0)])
def test_sweep_validator_equals_the_jax_one_liner(platform, arms, tmp_path):
    if platform is not None:
        _write(str(tmp_path / campaign.SWEEP_RECORD),
               {"platform": platform, "arms": [_arm(1.0)] * arms})
    jax = _run_python(_python_c("tuning_sweep.json"), tmp_path).returncode == 0
    assert campaign.sweep_ok(str(tmp_path)) == jax


# -- the tables against the script ------------------------------------------------------

PORT_PROGRAM = {
    "scripts/lint_gate.sh": "gan_deeplearning4j_tpu_torch/analysis/lint_gate.sh",
    "scripts/serve_bench.py": "gan_deeplearning4j_tpu_torch.serving.bench",
    "scripts/trace_report.py": "gan_deeplearning4j_tpu_torch.telemetry.trace_report",
    "scripts/zoo_drill.py": "gan_deeplearning4j_tpu_torch.zoo.drill",
    "scripts/resilience_drill.py": "gan_deeplearning4j_tpu_torch.resilience.drill",
    "scripts/update_sharding_bench.py": "gan_deeplearning4j_tpu_torch.parallel.bench",
    "scripts/reload_drill.py": "gan_deeplearning4j_tpu_torch.deploy.drill",
    "scripts/fleet_drill.py": "gan_deeplearning4j_tpu_torch.fleet.drill",
    "scripts/quant_bench.py": "gan_deeplearning4j_tpu_torch.quant.bench",
    "bench.py": "gan_deeplearning4j_tpu_torch.bench",
    "scripts/mfu_ceiling.py": "gan_deeplearning4j_tpu_torch.harness.mfu",
    "scripts/tune_sweep.py": "gan_deeplearning4j_tpu_torch.eval.tune_sweep",
    "scripts/quality_run.py": "gan_deeplearning4j_tpu_torch.eval.quality_run",
    "scripts/bench_ledger.py": "gan_deeplearning4j_tpu_torch.harness.bench_ledger",
}
_COMMAND_RE = re.compile(r"(?P<env>(?:[A-Z_]+=\S+\s+)*)(?:timeout (?P<timeout>\d+)\s+)?"
                         r"(?P<prog>python|bash) (?P<script>scripts/[\w./]+|bench\.py)(?P<rest>.*)")


def _jax_commands():
    """Every command of the script that runs a script or the bench, in order:
    dicts of its env, timeout, program, arguments, output and errors targets,
    whether a failure aborts, and the line it starts on."""
    commands, buf, start = [], "", None
    for number, line in enumerate(_script().splitlines(), 1):
        if line.lstrip().startswith("#"):
            continue
        if start is None:
            start = number
        if line.rstrip().endswith("\\"):
            buf += line.rstrip()[:-1] + " "
            continue
        logical, buf, first = buf + line, "", start
        start = None
        m = _COMMAND_RE.search(logical)
        if not m:
            continue
        args_part, _, redirect = m.group("rest").partition(" > ")
        env = dict(tok.split("=", 1) for tok in m.group("env").split())
        commands.append({
            "env": env, "timeout": int(m.group("timeout")) if m.group("timeout") else None,
            "program": PORT_PROGRAM[m.group("script")], "args": shlex.split(args_part),
            "stdout": redirect.split()[0],
            "stderr": (re.search(r"2>> (\S+)", redirect) or [None, None])[1],
            "fatal": logical.lstrip().startswith("if !") or "exit 1" in logical,
            "line": first})
    return commands


def _program(gate: Gate) -> str:
    if gate.argv[0] == "bash":
        return gate.argv[1].replace("{repo}/", "")
    assert gate.argv[:2] == ("{python}", "-m")
    return gate.argv[2]


def _port_args(gate: Gate) -> list:
    return list(gate.argv[2:] if gate.argv[0] == "bash" else gate.argv[3:])


def _assert_same_arguments(jax_args: list, port_args: list) -> None:
    """The JAX arguments, in order, each flag's value (a path) naming the
    same artifact: the stem of the JAX path lies in the port's."""
    assert [a for a in port_args if a.startswith("--")] == \
        [a for a in jax_args if a.startswith("--")]
    assert len(port_args) == len(jax_args)
    for jax_arg, port_arg in zip(jax_args, port_args):
        if jax_arg.startswith("--"):
            continue
        stem = os.path.splitext(os.path.basename(jax_arg))[0]
        assert stem in port_arg, (jax_arg, port_arg)


def _preflight_jax():
    bench_line = next(i for i, line in enumerate(_script().splitlines(), 1)
                      if line.startswith("bench_done=0"))
    return [c for c in _jax_commands() if c["line"] < bench_line]


def test_the_preflight_is_the_jax_scripts_sixteen_gates_in_order():
    jax = _preflight_jax()
    assert len(jax) == len(campaign.PREFLIGHT) == 16
    for i, (want, gate) in enumerate(zip(jax, campaign.PREFLIGHT), 1):
        assert _program(gate) == want["program"], i
        assert gate.timeout == want["timeout"], (i, gate.name)
        assert gate.fatal == want["fatal"], (i, gate.name)
        args = _port_args(gate)
        env = dict(want["env"])
        if env.pop("JAX_PLATFORMS", None) == "cpu":
            # the port's spelling of JAX_PLATFORMS=cpu
            if "--device" in args:
                at = args.index("--device")
                assert args[at + 1] == "cpu"
                del args[at:at + 2]
            else:
                args.remove("--cpu")
        assert "--cpu" not in args and "--device" not in args, (i, gate.name)
        if want["program"].endswith("serving.bench") and "--trace" in want["args"]:
            # the JAX --trace turns span tracing on; the port asks for it by name
            args.remove("--telemetry")
        assert dict(gate.env) == env, (i, gate.name)
        _assert_same_arguments(want["args"], args)
        if gate.stdout:
            assert gate.stdout.endswith(want["stdout"]) and gate.log == campaign.POLLER_LOG
            assert want["stderr"] == "tpu_poller.log"
        else:
            assert gate.log == want["stdout"], (i, gate.name)


def test_the_card_steps_and_the_ledger_are_the_jax_scripts():
    after = [c for c in _jax_commands() if c not in _preflight_jax()]
    port = [g for step in campaign.CARD_STEPS for g in step.commands] + [campaign.LEDGER]
    assert [c["program"] for c in after] == [_program(g) for g in port]
    # what the port adds to the JAX command lines (flag: value), and why
    added = {
        # the JAX bench runs every config by default; the port names it
        "gan_deeplearning4j_tpu_torch.bench": {"--config": "all"},
        # the JAX scripts' defaults write under artifacts/ (and the sweep
        # resumes from a TPU sweep there); the port has no such defaults and
        # names the root's files
        "gan_deeplearning4j_tpu_torch.harness.mfu": {"--out": "{root}/artifacts/mfu_ceiling.json"},
        "gan_deeplearning4j_tpu_torch.eval.tune_sweep": {
            "--out": "{root}/artifacts/tuning_sweep.json",
            "--resume-from": "{root}/artifacts/tuning_sweep_partial.json"},
        "gan_deeplearning4j_tpu_torch.eval.quality_run": {"--out": "{root}/artifacts"},
        # the port's ledger has no default root (the JAX one folds the repo's TPU records)
        "gan_deeplearning4j_tpu_torch.harness.bench_ledger": {"--root": "{root}"},
    }
    for want, gate in zip(after, port):
        assert gate.timeout == want["timeout"], gate.name
        assert gate.log == want["stdout"], gate.name
        args, jax_args = _port_args(gate), [a for a in want["args"] if a != "$QFLAGS"]
        extra = dict(added.get(_program(gate), {}))
        if "GDT_BENCH_BUDGET" in want["env"]:
            extra["--budget"] = want["env"]["GDT_BENCH_BUDGET"]
        for flag, value in extra.items():
            at = args.index(flag)
            assert args[at + 1] == value, (gate.name, flag)
            del args[at:at + 2]
        _assert_same_arguments(jax_args, args)
    steps = {s.name: s for s in campaign.CARD_STEPS}
    assert list(steps) == ["bench", "ceiling", "tune", "quality"]
    assert steps["quality"].needs == ("tune",) and steps["quality"].flags is campaign.quality_flags
    assert "$QFLAGS" in next(c for c in after if c["program"].endswith("quality_run"))["args"]
    assert not steps["bench"].check_rc and all(steps[n].check_rc for n in ("ceiling", "tune",
                                                                            "quality"))
    assert steps["bench"].validate is campaign.bench_records_ok
    # the baselines are the port's own file; the sweep resumes from the root
    assert campaign.BASELINES.endswith("gan_deeplearning4j_tpu_torch/bench_baselines.json")
    assert "BENCH_BASELINES" not in json.dumps([g.argv for g in port])
    tune = steps["tune"].commands[0].argv
    assert tune[tune.index("--resume-from") + 1].startswith("{root}/")


def test_the_deadline_and_the_probe_are_the_jax_scripts():
    text = _script()
    assert "${CAMPAIGN_BUDGET_S:-30600}" in text and campaign.DEFAULT_BUDGET_S == 30600
    assert "seq 1 300" in text and campaign.MAX_ROUNDS == 300
    assert "sleep 60" in text and campaign.RETRY_S == 60
    assert "timeout 150 python -c" in text and campaign.PROBE_TIMEOUT_S == 150
    assert "import torch" in campaign.PROBE_CODE and "jax" not in campaign.PROBE_CODE


@pytest.mark.parametrize("value,want", [(None, 30600.0), ("", 30600.0), ("7200", 7200.0)])
def test_the_budget_is_read_as_the_jax_script_reads_it(value, want, monkeypatch):
    if value is None:
        monkeypatch.delenv("CAMPAIGN_BUDGET_S", raising=False)
    else:
        monkeypatch.setenv("CAMPAIGN_BUDGET_S", value)
    assert campaign.budget_s() == want


def test_gate_5s_trace_is_the_seeded_heavy_tail(tmp_path):
    path = campaign.write_heavy_tail_trace(str(tmp_path))
    with open(path) as fh:
        trace = json.load(fh)
    want = np.minimum(np.random.default_rng(17).zipf(1.6, 400), 128)
    assert trace == {"name": "heavy_tail_seed17", "sizes": [int(s) for s in want]}
    gate5 = campaign.PREFLIGHT[4]
    assert gate5.prepare is campaign.write_heavy_tail_trace
    assert "{root}/heavy_tail_trace.json" in gate5.argv


# -- orchestration on stub tables ----------------------------------------------------------

def _writes(*pairs, rc=0) -> tuple:
    """A stub command: write each (relative path, JSON document) under the
    root it is given, then exit ``rc``."""
    code = ("import json, os, sys\nroot = sys.argv[1]\n"
            f"for rel, doc in {list(pairs)!r}:\n"
            "    path = os.path.join(root, rel)\n"
            "    os.makedirs(os.path.dirname(path), exist_ok=True)\n"
            "    open(path, 'w').write(doc if isinstance(doc, str) else json.dumps(doc))\n"
            f"sys.exit({rc})\n")
    return ("{python}", "-c", code, "{root}")


def _gate(name, *pairs, rc=0, **kw) -> Gate:
    return Gate(name, _writes(*pairs, rc=rc), 30, f"{name}.log", **kw)


SWEEP_DOC = {"platform": "gpu", "iterations": 1200,
             "arms": [_arm(30.0 + i, 0.95, dis_lr=0.001, gen_lr=0.002) for i in range(12)]
             + [_arm(20.0, 0.96, dis_lr=0.004, gen_lr=0.008, dis_lr_decay_every=300,
                     dis_lr_decay_rate=0.5)]}


def _stub_steps(quality_doc=None, quality_extra=()):
    """``CARD_STEPS`` with every command a stub that writes a record the
    step's own validator accepts (the quality run's: ``quality_doc``) and
    records its arguments; the baselines are a file of the root."""
    steps = {s.name: s for s in campaign.CARD_STEPS}
    record = _record(_results())
    quality_argv = ("import json, sys; json.dump(sys.argv[2:], "
                    "open(sys.argv[1] + '/artifacts/quality_argv.json', 'w'))")
    quality = _writes((campaign.QUALITY_RECORD, quality_doc or {"platform": "gpu"}),
                      *quality_extra)
    return (
        dataclasses.replace(steps["bench"], commands=(
            _gate("pass1", (campaign.BENCH_RECORDS[0], record), ("baselines.json", {"m": 2})),
            _gate("pass2", (campaign.BENCH_RECORDS[1], record), rc=1)),
            restore=(*campaign.BENCH_RECORDS, "baselines.json")),
        dataclasses.replace(steps["ceiling"], commands=(
            _gate("mfu", (campaign.MFU_RECORD, {"platform": "gpu"})),)),
        dataclasses.replace(steps["tune"], commands=(
            _gate("sweep", (campaign.SWEEP_RECORD, SWEEP_DOC)),)),
        dataclasses.replace(steps["quality"], commands=(
            Gate("quality", ("{python}", "-c", quality_argv, "{root}"), 30, "q0.log"),
            Gate("quality run", quality, 30, "quality_run.log"))),
    )


def _run(root, steps=(), gates=(), probe=lambda: True, ledger=None, **kw):
    rows = []
    rc = campaign.run_campaign(str(root), gates, steps, kw.pop("budget", 600), probe,
                               ledger=ledger or _gate("ledger"), card=lambda: "stub card",
                               retry_s=0, emit=rows.append, **kw)
    return rc, rows


def _read(path) -> bytes:
    with open(path, "rb") as fh:
        return fh.read()


def test_a_failing_gate_exits_1_before_any_probe(tmp_path):
    probed = []
    gates = (_gate("first", ("artifacts/g1.json", {})), _gate("second", rc=3),
             _gate("third", ("artifacts/g3.json", {})))
    rc, rows = _run(tmp_path, _stub_steps(), gates, probe=lambda: probed.append(1) or True)
    assert rc == 1 and not probed
    assert [r.get("gate") for r in rows[:-1]] == ["first", "second"]
    assert rows[-1]["reason"] == "gate failed: second" and rows[-1]["not_done"] == [
        "bench", "ceiling", "tune", "quality"]
    assert not (tmp_path / "artifacts" / "g3.json").exists()
    assert "second failed — campaign aborted (see second.log)" in (
        tmp_path / campaign.POLLER_LOG).read_text()


def test_a_gate_that_only_logs_does_not_stop_the_campaign(tmp_path):
    gates = (_gate("sarif", rc=1, fatal=False, stdout="artifacts/out.sarif"),)
    rc, rows = _run(tmp_path, (), gates)
    assert rc == 0 and rows[0]["rc"] == 1
    assert (tmp_path / "artifacts" / "out.sarif").exists()
    assert "sarif failed" in (tmp_path / campaign.POLLER_LOG).read_text()


def test_no_card_exits_2_and_runs_no_card_step(tmp_path):
    rc, rows = _run(tmp_path, _stub_steps(), probe=lambda: False)
    assert rc == 2 and [r for r in rows if "step" in r] == []
    assert rows[-1]["reason"] == "no card" and len(rows[-1]["not_done"]) == 4
    assert not (tmp_path / campaign.BENCH_RECORDS[0]).exists()


def test_a_failing_step_restores_the_prior_bytes_and_removes_new_files(tmp_path):
    _write(str(tmp_path / "artifacts" / "a.json"), "old bytes")
    step = campaign.Step(
        "s", (_gate("s", ("artifacts/a.json", "new"), ("artifacts/new.json", {}),
                    ("artifacts/sub/deep.json", {})),),
        lambda root: False, restore=("artifacts/a.json", "artifacts/new.json", "artifacts/sub/"),
        clear=("artifacts/a.json",))
    rc, rows = _run(tmp_path, (step,), max_rounds=2)
    assert rc == 3 and rows[-1]["reason"] == "rounds spent" and rows[-1]["not_done"] == ["s"]
    attempts = [r for r in rows if r.get("step") == "s"]
    assert [r["round"] for r in attempts] == [1, 2] and not any(r["done"] for r in attempts)
    assert attempts[0]["restore"] == {"restored": 1, "removed": 3}
    assert _read(tmp_path / "artifacts" / "a.json") == b"old bytes"
    assert sorted(os.listdir(tmp_path / "artifacts")) == ["a.json"]


def test_a_failing_quality_run_leaves_the_other_records_alone(tmp_path):
    _write(str(tmp_path / campaign.QUALITY_RECORD), '{"platform": "gpu", "committed": 1}')
    _write(str(tmp_path / "artifacts" / "DCGAN_Generated_Images.png"), "old png")
    steps = _stub_steps(quality_doc={"platform": "cpu"}, quality_extra=(
        ("artifacts/DCGAN_Generated_Images.png", "new png"), ("artifacts/gen_model.zip", "zip"),
        ("artifacts/quality_test.csv", "1,2"), ("artifacts/manifold/x.csv", "3")))
    rc, rows = _run(tmp_path, steps, max_rounds=1)
    assert rc == 3 and rows[-1]["not_done"] == ["quality"]
    quality = next(r for r in rows if r.get("step") == "quality")
    assert not quality["done"] and quality["rc"] == 0
    assert quality["flags"] == campaign.select_quality_flags(str(tmp_path / campaign.SWEEP_RECORD))
    assert _read(tmp_path / campaign.QUALITY_RECORD) == b'{"platform": "gpu", "committed": 1}'
    assert _read(tmp_path / "artifacts" / "DCGAN_Generated_Images.png") == b"old png"
    for rel, doc in ((campaign.BENCH_RECORDS[0], _record(_results())),
                     (campaign.BENCH_RECORDS[1], _record(_results())),
                     (campaign.MFU_RECORD, {"platform": "gpu"}),
                     (campaign.SWEEP_RECORD, SWEEP_DOC)):
        assert json.loads(_read(tmp_path / rel)) == doc, rel
    assert sorted(os.listdir(tmp_path / "artifacts")) == [
        "DCGAN_Generated_Images.png", "benchmarks.json", "benchmarks_vs_prev.json",
        "mfu_ceiling.json", "quality_run.json", "tuning_sweep.json"]
    assert (tmp_path / "BENCH_r01.json").exists()


def test_a_step_that_fails_once_is_retried_and_then_passes(tmp_path):
    code = ("import os, sys\np = os.path.join(sys.argv[1], 'artifacts', 'count')\n"
            "n = int(open(p).read()) + 1 if os.path.exists(p) else 1\n"
            "open(p, 'w').write(str(n))\nsys.exit(0 if n >= 2 else 1)\n")
    step = campaign.Step("flaky", (Gate("flaky", ("{python}", "-c", code, "{root}"), 30,
                                        "flaky.log"),), lambda root: True)
    rc, rows = _run(tmp_path, (step,))
    attempts = [r for r in rows if r.get("step") == "flaky"]
    assert rc == 0 and [(r["round"], r["rc"], r["done"]) for r in attempts] == [
        (1, 1, False), (2, 0, True)]
    assert rows[-1]["steps"]["flaky"]["attempts"] == 2 and rows[-1]["not_done"] == []
    log = (tmp_path / campaign.POLLER_LOG).read_text()
    assert "probe 1" in log and "probe 2" in log and "flaky rc=1 done=0" in log


def test_the_deadline_exits_3_and_names_the_steps_not_done(tmp_path):
    rc, rows = _run(tmp_path, _stub_steps(), budget=0)
    assert rc == 3 and rows[-1]["reason"] == "deadline"
    assert rows[-1]["not_done"] == ["bench", "ceiling", "tune", "quality"]
    assert [r for r in rows if "step" in r] == []
    assert "campaign deadline — exiting (bench=0 ceiling=0 tune=0 quality=0)" in (
        tmp_path / campaign.POLLER_LOG).read_text()


def test_a_failing_ledger_exits_1(tmp_path):
    rc, rows = _run(tmp_path, _stub_steps(), ledger=_gate("ledger", rc=1))
    assert rc == 1 and rows[-1]["reason"] == "ledger failed" and rows[-1]["not_done"] == []
    assert rows[-2] == {**rows[-2], "gate": "ledger", "rc": 1}


def test_a_campaign_that_succeeds_exits_0_and_keeps_its_rounds(tmp_path):
    for round_name in ("BENCH_r01.json", "BENCH_r02.json"):
        rc, rows = _run(tmp_path, _stub_steps())
        assert rc == 0 and rows[-1]["reason"] == "done" and rows[-1]["not_done"] == []
        steps = [r for r in rows if "step" in r]
        assert [r["step"] for r in steps] == ["bench", "ceiling", "tune", "quality"]
        assert all(r["done"] and r["card"] == "stub card" and r["seconds"] > 0 for r in steps)
        # the bench's pass 2 exited 1: the JAX validator reads only the records
        assert steps[0]["rcs"] == [0, 1] and steps[0]["kept"] == round_name
        assert _read(tmp_path / round_name) == _read(tmp_path / campaign.BENCH_RECORDS[1])
        flags = json.loads(_read(tmp_path / "artifacts" / "quality_argv.json"))
        assert flags == ["--dis-lr-decay-every", "1000", "--dis-lr-decay-rate", "0.5",
                         "--dis-lr", "0.004", "--gen-lr", "0.008"]
        assert rows[-1]["quality_flags"] == flags
    assert sorted(f for f in os.listdir(tmp_path) if f.startswith("BENCH_")) == [
        "BENCH_r01.json", "BENCH_r02.json"]


def test_a_timed_out_command_exits_124_and_its_session_is_killed(tmp_path):
    code = ("import subprocess, sys, time\n"
            "child = subprocess.Popen([sys.executable, '-c', 'import time; time.sleep(60)'])\n"
            "open(sys.argv[1] + '/child.pid', 'w').write(str(child.pid))\n"
            "time.sleep(60)\n")
    gate = Gate("slow", ("{python}", "-c", code, "{root}"), 1.5, "slow.log")
    assert campaign.run_command(gate, str(tmp_path)) == 124
    pid = int((tmp_path / "child.pid").read_text())
    deadline = time.time() + 10
    while time.time() < deadline:
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            break
        time.sleep(0.05)
    else:
        raise AssertionError(f"the command's child {pid} outlived its timeout")


def test_the_cli_takes_only_the_root(capsys):
    with pytest.raises(SystemExit) as exc:
        campaign.main(["--help"])
    assert exc.value.code == 0
    flags = set(re.findall(r"--[a-z][\w-]*", capsys.readouterr().out))
    assert flags == {"--root", "--help"}


def test_importing_the_campaign_loads_neither_torch_nor_jax():
    code = ("import sys\n"
            "import gan_deeplearning4j_tpu_torch.campaign\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'gan_deeplearning4j_tpu', 'scripts')]\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=60, check=True)
    assert out.stdout.strip() == "[]"
