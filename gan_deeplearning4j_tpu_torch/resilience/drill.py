"""Resilience drill — kill training mid-run, prove recovery, measure cost.

``python -m gan_deeplearning4j_tpu_torch.resilience.drill``: the PyTorch
port's counterpart of ``scripts/resilience_drill.py``, with the same
phases, invariants and payload keys, against the port's worker (``python
-m gan_deeplearning4j_tpu_torch.resilience``). Workers run on the card
unless ``--cpu`` writes ``use_accelerator=False`` into the workload. The
drill launches the worker as a real subprocess, murders it, relaunches it,
corrupts its checkpoints, and checks that the resilience layer keeps every
promise:

1. **oracle** — an uninterrupted run of ``total_steps`` records the ground
   truth: final state digests, per-step train time, checkpoint-write
   overhead.
2. **kill/recover** — a fresh store; a deterministic (seeded) fault
   schedule SIGKILLs the worker at step N. The drill observes the death,
   relaunches (the schedule is handed only to the first launch — the
   preemption happened once), and measures recovery time, lost steps, and
   relaunch count.
3. **bit-exact resume** — the recovered run's final state digests must be
   IDENTICAL to the oracle's: interrupted-and-resumed == uninterrupted at
   equal total steps.
4. **corruption fallback** — the recovered store's newest generation gets
   its bytes flipped; a further run must quarantine it (ledger status
   ``quarantined``), restore from the prior generation, and complete.

``--multihost N`` drills the MESH plane instead (resilience/mesh.py): N
real worker processes share one store and two-phase-commit coordinated
sharded generations. Phases: single-worker oracles (ground truth at
``total`` and ``total + publish_every`` steps); a gang with a straggler
shard writer and a seeded worker kill (the survivor must gang-abort with
exit 76, the relaunched gang must finish digest-identical to the oracle);
a coordinator killed INSIDE the commit window (marker written, rename
never happens — the half-committed round must stay invisible to
``latest_valid()`` and the relaunch must recover); and elastic resume
(the 2-worker-written store extended on a 1-worker and a 2-worker mesh,
both digest-identical to the uninterrupted oracle). ``--record TAG``
writes ``BENCH_resilience_mh_<TAG>.json`` (recovery time, lost steps,
commit overhead vs the single-writer publish).

Results land as a BENCH-style JSON (``--output``, and ``--record TAG``
additionally writes ``BENCH_resilience_torch_<TAG>.json`` at the repo root,
``BENCH_resilience_mh_torch_<TAG>.json`` with ``--multihost``: names of
their own, so the JAX drill's records are never written over). Exit status
is nonzero on any invariant breach — non-bit-exact resume, a corrupt
generation selected, the relaunch/retry budget exceeded without a terminal
error — so CI can gate on the drill directly.

The CLI's workload is the tabular family at toy size: the drill proves the
*mechanism* (processes really die; stores really quarantine), not model
quality, and must be cheap enough to run as a tier-1 smoke. The phase
functions (:func:`run_single_host_drill`, :func:`run_multihost_drill`) and
:func:`run_worker` / :func:`run_gang` take a workload made elsewhere (a
``{"config": path, "data": path}`` pair): ``chip_smoke.py`` hands them the
DCGAN-MNIST model at full width. :func:`run_worker` can also send the
worker one SIGUSR2 once its first generation lands (``trace_dir``), the
on-demand ``torch.profiler`` capture, and report what the trace holds.
With ``overlap=True`` the phase functions run worker lifetimes that do not
depend on each other at the same time (the single-writer oracle beside the
kill/relaunch chain; the mesh drill's two oracles, its kill and commit-
window gangs, and its two elastic resumes, in pairs): the same processes,
faults and invariants in fewer rounds of boots. The CLI keeps the JAX
drill's one-at-a-time order.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

#: the directory holding the port package: workers run from it
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

WORKER = [sys.executable, "-m", "gan_deeplearning4j_tpu_torch.resilience"]


def log(msg: str) -> None:
    print(f"[drill] {msg}", flush=True)


def make_workload(workdir: str, seed: int, use_accelerator: bool = True) -> dict:
    """Config + deterministic synthetic data for the drill's tiny tabular
    GAN. Returns the paths the worker CLI consumes."""
    from gan_deeplearning4j_tpu_torch.harness import ExperimentConfig

    cfg = ExperimentConfig(
        model_family="tabular", num_features=16, z_size=4,
        batch_size_train=8, batch_size_pred=8,
        height=1, width=1, channels=1,
        save_models=False, seed=seed, file_prefix="tabular",
        output_dir=os.path.join(workdir, "out"),
        use_accelerator=use_accelerator,
    )
    config_path = os.path.join(workdir, "config.json")
    cfg.to_json(config_path)
    rng = np.random.default_rng(seed)
    features = rng.random((64, 16), dtype=np.float32)
    labels = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 64)]
    data_path = os.path.join(workdir, "data.npz")
    np.savez(data_path, features=features, labels=labels)
    return {"config": config_path, "data": data_path}




def _platform(workload: dict) -> str:
    """``"gpu"`` or ``"cpu"``: where the workload's config trains."""
    with open(workload["config"]) as fh:
        return "gpu" if json.load(fh).get("use_accelerator", True) else "cpu"


def _load_summary(summary_path: str):
    """The worker's --summary JSON, or None when it never landed or was
    torn by a kill — one judgment shared by the single-worker and gang
    paths."""
    if not os.path.exists(summary_path):
        return None
    try:
        with open(summary_path) as fh:
            return json.load(fh)
    except json.JSONDecodeError:
        return None  # torn write from a killed worker — expected


def _signal_once_published(proc, store: str, poll_s: float = 0.02) -> None:
    """Send ``proc`` one SIGUSR2 as soon as the store's first generation is
    visible (the worker is past its boot and training), unless it exits
    first. Reads the directory only: opening a ``CheckpointStore`` would
    sweep the worker's in-flight staging."""
    from gan_deeplearning4j_tpu_torch.resilience.store import gen_dirname

    first = os.path.join(store, "generations", gen_dirname(0))
    while proc.poll() is None:
        if os.path.isdir(first):
            proc.send_signal(signal.SIGUSR2)
            log("SIGUSR2 sent: one device capture")
            return
        time.sleep(poll_s)


def trace_report(trace_dir: str) -> dict:
    """What the SIGUSR2 captures under ``trace_dir`` hold: their Chrome
    traces, their events by category, the card's kernel events among those
    (``cat`` ``"kernel"``), and the span the events cover, in ms."""
    traces, categories, stamps = [], {}, []
    for root, _, names in os.walk(trace_dir):
        for name in names:
            if name != "trace.json":
                continue
            path = os.path.join(root, name)
            with open(path) as fh:
                payload = json.load(fh)
            evs = payload.get("traceEvents", []) if isinstance(payload, dict) else payload
            traces.append(os.path.relpath(path, trace_dir))
            for e in evs:
                cat = str(e.get("cat", ""))
                categories[cat] = categories.get(cat, 0) + 1
                if isinstance(e.get("ts"), (int, float)):
                    stamps.append(float(e["ts"]))
    return {"traces": sorted(traces), "events": sum(categories.values()),
            "kernel_events": categories.get("kernel", 0), "categories": categories,
            "span_ms": (max(stamps) - min(stamps)) / 1e3 if stamps else 0.0}


def run_worker(workload: dict, store: str, total_steps: int,
               publish_every: int, summary_path: str,
               schedule_path: str | None = None,
               timeout_s: float = 600.0,
               trace_dir: str | None = None) -> tuple:
    """One worker lifetime. Returns (returncode, summary_dict_or_None,
    wall_seconds). A negative returncode is death by signal. With
    ``trace_dir`` the worker's SIGUSR2 captures land there, and it gets
    one SIGUSR2 once its first generation is published."""
    cmd = WORKER + [
        "--config", workload["config"], "--data", workload["data"],
        "--store", store,
        "--total-steps", str(total_steps),
        "--publish-every", str(publish_every),
        "--summary", summary_path,
    ]
    if schedule_path:
        cmd += ["--fault-schedule", schedule_path]
    if trace_dir:
        cmd += ["--trace-artifacts", trace_dir]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=_REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    poker = None
    if trace_dir:
        poker = threading.Thread(target=_signal_once_published,
                                 args=(proc, store), daemon=True)
        poker.start()
    try:
        _, err = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        # a hung worker is an invariant failure to REPORT, not a drill
        # crash: rc=None flows through the phase logic as "unexpected exit"
        proc.kill()
        proc.communicate()
        log(f"worker hung past {timeout_s:.0f}s — killed")
        return None, None, time.perf_counter() - t0
    finally:
        if poker is not None:
            poker.join()
    wall = time.perf_counter() - t0
    summary = _load_summary(summary_path)
    # a death by signal is expected only where the schedule kills
    if proc.returncode not in (0, 75) and (proc.returncode >= 0 or not schedule_path):
        log(f"worker rc={proc.returncode} stderr tail: {err[-500:]}")
    return proc.returncode, summary, wall  # negative rc = death by signal


def run_gang(workload: dict, store: str, total_steps: int,
             publish_every: int, world_size: int, token: str,
             summary_dir: str, schedules: dict | None = None,
             mesh_timeout_s: float = 15.0, timeout_s: float = 600.0) -> list:
    """One gang lifetime: ``world_size`` concurrent worker processes
    against one store. ``schedules`` maps worker id -> fault schedule
    path (workers absent from the map run clean). Returns a list of
    (returncode, summary_or_None, wall_seconds) per worker; each worker's
    summary lands in ``summary_dir/summary_<token>_w<k>.json``. Drained
    concurrently — a sequential wait would deadlock against the mesh
    barriers."""
    from concurrent.futures import ThreadPoolExecutor

    os.makedirs(summary_dir, exist_ok=True)
    procs = []
    for k in range(world_size):
        cmd = WORKER + [
            "--config", workload["config"], "--data", workload["data"],
            "--store", store,
            "--total-steps", str(total_steps),
            "--publish-every", str(publish_every),
            "--mesh-size", str(world_size),
            "--mesh-worker", str(k),
            "--mesh-token", token,
            "--mesh-timeout", str(mesh_timeout_s),
            "--summary",
            os.path.join(summary_dir, f"summary_{token}_w{k}.json"),
        ]
        if schedules and k in schedules:
            cmd += ["--fault-schedule", schedules[k]]
        procs.append(subprocess.Popen(
            cmd, cwd=_REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    t0 = time.perf_counter()
    results = []
    with ThreadPoolExecutor(world_size) as pool:
        futures = [pool.submit(p.communicate, timeout=timeout_s)
                   for p in procs]
        for k, future in enumerate(futures):
            try:
                _, err = future.result()
            except subprocess.TimeoutExpired:
                log(f"gang {token} worker {k} hung past {timeout_s:.0f}s "
                    f"— killed")
                for q in procs:
                    q.kill()
                err = ""
            results.append(err)
    # reap anything killed after a hang: its communicate() thread bailed
    # on TimeoutExpired, so returncode would otherwise stay None and the
    # rc classification below would crash instead of reporting the breach
    for proc in procs:
        if proc.returncode is None:
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                pass  # unkillable — rc stays None, reported as a hang
    wall = time.perf_counter() - t0
    out = []
    for k, (proc, err) in enumerate(zip(procs, results)):
        summary = _load_summary(
            os.path.join(summary_dir, f"summary_{token}_w{k}.json"))
        if proc.returncode is None:
            log(f"gang {token} worker {k} unreaped after kill — "
                f"treating as hung (rc=None)")
        elif proc.returncode not in (0, 75, 76) and proc.returncode >= 0:
            log(f"gang {token} worker {k} rc={proc.returncode} stderr "
                f"tail: {err[-500:]}")
        out.append((proc.returncode, summary, wall))
    return out


def _gang_digests(gang: list) -> list:
    """state_digests of every completed worker in a gang result."""
    return [s.get("state_digests") for rc, s, _ in gang
            if rc == 0 and s is not None]


def _gang_shards(gang: list) -> list:
    """Which updater shard each gang worker wrote (supervisor summary's
    ``updater_shard``: index, count, files) — so a shard mismatch names
    the owning worker instead of leaving it encoded in file names."""
    out = []
    for k, (rc, s, _) in enumerate(gang):
        shard = dict((s or {}).get("updater_shard") or {})
        # the summary's self-claimed rank must not mask which GANG SLOT
        # produced the record — a rank/slot disagreement is exactly what
        # a shard-mismatch log exists to expose
        shard.pop("worker", None)
        out.append({"worker": k, "rc": rc, **shard})
    return out


def _log_shard_owners(shards: list, what: str) -> None:
    for rec in shards:
        files = ", ".join(rec.get("files", [])) or "<none>"
        log(f"{what}: worker {rec['worker']} wrote updater shard "
            f"{rec.get('shard_index', '?')}/{rec.get('shard_count', '?')} "
            f"({files})")


def _pair(overlap: bool, first, second) -> tuple:
    """Run two independent worker lifetimes: at once on two threads when
    ``overlap``, else one after the other. Returns both results."""
    if not overlap:
        return first(), second()
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(2) as pool:
        a, b = pool.submit(first), pool.submit(second)
        return a.result(), b.result()


def run_multihost_drill(workload: dict, workdir: str, n: int, total: int,
                        publish_every: int, seed: int,
                        kill_step: int | None = None,
                        mesh_timeout: float = 15.0, smoke: bool = False,
                        timeout_s: float = 600.0, overlap: bool = False) -> dict:
    """The mesh-plane drill (see module docstring) over ``workload``.
    Returns the BENCH payload; ``invariants`` within gate the exit code.
    ``overlap`` runs the independent lifetimes in pairs (module
    docstring): the oracles, the kill gang beside the commit-window gang,
    the two recovering gangs, the two elastic resumes."""
    from gan_deeplearning4j_tpu_torch.resilience import (
        CheckpointStore,
        FaultSchedule,
        FaultSpec,
    )
    from gan_deeplearning4j_tpu_torch.resilience.mesh import MESH_STAGE_PREFIX

    results: dict = {}
    invariants: dict = {}
    total_ext = total + publish_every

    def gang(store_root, steps, token, schedules=None):
        return run_gang(workload, store_root, steps, publish_every, n, token,
                        workdir, schedules=schedules,
                        mesh_timeout_s=mesh_timeout, timeout_s=timeout_s)

    def stage_dirs(store_root: str) -> list:
        return sorted(d for d in os.listdir(store_root)
                      if d.startswith(MESH_STAGE_PREFIX))

    def all_published_verify(store_root: str) -> bool:
        store = CheckpointStore(store_root)
        return all(store.verify(g) is None for g in store.published())

    # -- phase 1: single-worker oracles (ground truth) -------------------
    log(f"oracle: single worker, {total} and {total_ext} uninterrupted "
        f"steps")
    (rc, oracle, oracle_wall), (rc2, oracle_ext, _) = _pair(
        overlap,
        lambda: run_worker(
            workload, os.path.join(workdir, "store_oracle"), total,
            publish_every, os.path.join(workdir, "summary_oracle.json"),
            timeout_s=timeout_s),
        lambda: run_worker(
            workload, os.path.join(workdir, "store_oracle_ext"), total_ext,
            publish_every, os.path.join(workdir, "summary_oracle_ext.json"),
            timeout_s=timeout_s))
    if (rc != 0 or oracle is None or oracle.get("status") != "completed"
            or rc2 != 0 or oracle_ext is None
            or oracle_ext.get("status") != "completed"):
        log(f"oracle runs failed (rc={rc}/{rc2}) — cannot drill")
        return {"ok": False, "invariants": {"oracle_completed": False}}
    results["oracle"] = {
        "wall_s": oracle_wall,
        "publish_count": oracle["publish_count"],
        "checkpoint_write_s_mean": (
            oracle["publish_s"] / oracle["publish_count"]
            if oracle["publish_count"] else 0.0),
    }

    # -- phases 2 and 3: a worker kill + straggler under coordinated
    # publish, and the coordinator killed inside the commit window, on
    # stores of their own (in pairs with ``overlap``) ---------------------
    mesh_store = os.path.join(workdir, "store_mesh")
    if kill_step is None:
        seeded = FaultSchedule.seeded(seed, total, kinds=("kill",))
        kill_step = max(seeded.specs[0].step, publish_every + 1)
    victim = n - 1  # a non-coordinator writer; the coordinator dies in p3
    schedule = FaultSchedule([
        FaultSpec(kind="straggler", step=publish_every,
                  args={"seconds": 0.3}),
        FaultSpec(kind="kill", step=kill_step),
    ])
    schedule_path = os.path.join(workdir, "faults_mesh.json")
    schedule.to_json(schedule_path)
    commit_store = os.path.join(workdir, "store_mesh_commit")
    window_step = 2 * publish_every  # publish 1 must land, publish 2 dies
    schedule = FaultSchedule([
        FaultSpec(kind="kill_committed", step=window_step),
    ])
    commit_schedule_path = os.path.join(workdir, "faults_commit.json")
    schedule.to_json(commit_schedule_path)
    log(f"mesh kill/recover: {n} workers, straggler at publish "
        f"{publish_every}, SIGKILL worker {victim} at step {kill_step}; "
        f"commit-window kill: coordinator dies after the commit marker "
        f"of the publish at step {window_step}, before the rename")
    gang1, gang3 = _pair(
        overlap,
        lambda: gang(mesh_store, total, "g1", {victim: schedule_path}),
        lambda: gang(commit_store, total, "g3", {0: commit_schedule_path}))
    rcs = [rc for rc, _, _ in gang1]
    invariants["mh_kill_observed"] = rcs[victim] is not None and \
        rcs[victim] < 0
    invariants["mh_gang_aborted"] = any(rc == 76 for rc in rcs)
    # all-or-nothing: every generation the dead gang left behind is
    # complete and digest-clean, and nothing beyond the kill step surfaced
    store = CheckpointStore(mesh_store)
    latest = store.latest_valid()
    invariants["mh_no_partial_generation"] = (
        all_published_verify(mesh_store)
        and latest is not None and latest.step <= kill_step)
    log(f"gang g1 rcs={rcs}; latest valid step="
        f"{latest.step if latest else None}")
    rcs3 = [rc for rc, _, _ in gang3]
    store = CheckpointStore(commit_store)
    latest = store.latest_valid()
    leftovers = stage_dirs(commit_store)
    # the half-committed round: marker written, never renamed — it must be
    # invisible to latest_valid() (fall back to the previous generation)
    # and absent from the ledger
    attempted = (store.published()[-1] + 1) if store.published() else 0
    invariants["mh_commit_window_all_or_nothing"] = (
        rcs3[0] is not None and rcs3[0] < 0
        and any(rc == 76 for rc in rcs3[1:])
        and bool(leftovers)
        and any(os.path.exists(os.path.join(commit_store, d,
                                            "MANIFEST.json"))
                for d in leftovers)
        and latest is not None
        and latest.step == publish_every
        and store.entry(attempted) == {})
    log(f"gang g3 rcs={rcs3}; leftovers={leftovers}; latest="
        f"{latest.step if latest else None}")
    results["commit_window"] = {
        "window_step": window_step,
        "gang_rcs": rcs3,
        "stage_leftovers": leftovers,
        "fallback_step": latest.step if latest else None,
    }

    def recover():
        t_recover = time.perf_counter()
        return gang(mesh_store, total, "g2"), time.perf_counter() - t_recover

    (gang2, recovery_wall), gang4 = _pair(
        overlap, recover, lambda: gang(commit_store, total, "g4"))
    digests2 = _gang_digests(gang2)
    shards2 = _gang_shards(gang2)
    invariants["mh_recovered"] = len(digests2) == n
    invariants["mh_workers_agree"] = (
        len(digests2) == n and all(d == digests2[0] for d in digests2))
    invariants["mh_bit_exact_resume"] = (
        bool(digests2) and digests2[0] == oracle.get("state_digests"))
    if not (invariants["mh_workers_agree"]
            and invariants["mh_bit_exact_resume"]):
        # name the owning worker per shard so a mismatch is attributable
        # without decoding shard file names by hand
        _log_shard_owners(shards2, "shard mismatch")
    coord_summary = gang2[0][1] or {}
    restores = [e for e in coord_summary.get("events", [])
                if e.get("event") == "restore"]
    restored_step = restores[0]["step"] if restores else 0
    mesh_publish_mean = (
        coord_summary.get("publish_s", 0.0)
        / coord_summary.get("publish_count", 1)
        if coord_summary.get("publish_count") else None)
    results["kill_recover"] = {
        "kill_step": kill_step,
        "victim": victim,
        "gang1_rcs": rcs,
        "worker_shards": shards2,
        "recovery_wall_s": recovery_wall,
        "restore_s": coord_summary.get("restore_s"),
        "time_to_first_step_s": coord_summary.get("time_to_first_step_s"),
        "restored_step": restored_step,
        "lost_steps": kill_step - restored_step,
        "mesh_publish_s_mean": mesh_publish_mean,
        "commit_overhead_vs_single": (
            mesh_publish_mean / results["oracle"]["checkpoint_write_s_mean"]
            if mesh_publish_mean
            and results["oracle"]["checkpoint_write_s_mean"] else None),
    }
    digests4 = _gang_digests(gang4)
    invariants["mh_commit_window_recovered"] = (
        len(digests4) == n
        and digests4[0] == oracle.get("state_digests")
        and not stage_dirs(commit_store))  # the corpse round was swept

    # -- phase 4: elastic resume — M=2-written store onto N∈{1,2} --------
    elastic: dict = {}
    shapes = ((1, "mesh_to_single"), (n, "mesh_to_mesh"))

    def elastic_digests(shape):
        src = os.path.join(workdir, f"store_elastic_{shape}")
        log(f"elastic resume: {n}-written store extended to {total_ext} "
            f"steps on {shape} worker(s)")
        if shape == 1:
            rc, summary, wall = run_worker(
                workload, src, total_ext, publish_every,
                os.path.join(workdir, "summary_elastic1.json"),
                timeout_s=timeout_s)
            return [summary.get("state_digests")] if rc == 0 and summary \
                else []
        return _gang_digests(run_gang(
            workload, src, total_ext, publish_every, shape,
            f"g5-{shape}", workdir, mesh_timeout_s=mesh_timeout,
            timeout_s=timeout_s))

    for shape, _ in shapes:
        shutil.copytree(mesh_store, os.path.join(workdir, f"store_elastic_{shape}"))
    found = _pair(overlap, *(functools.partial(elastic_digests, shape) for shape, _ in shapes))
    for (shape, label), digests in zip(shapes, found):
        ok = bool(digests) and all(
            d == oracle_ext.get("state_digests") for d in digests)
        invariants[f"mh_elastic_{label}"] = ok
        elastic[label] = {"workers": shape, "bit_exact": ok}
    results["elastic"] = elastic

    ok = all(invariants.values())
    return {
        "bench": "resilience_drill_multihost",
        "config": {
            "total_steps": total,
            "publish_every": publish_every,
            "world_size": n,
            "kill_step": kill_step,
            "seed": seed,
            "smoke": bool(smoke),
            "mesh_timeout_s": mesh_timeout,
            "platform": _platform(workload),
        },
        "results": results,
        "invariants": invariants,
        "telemetry": {
            "oracle": oracle.get("telemetry"),
            "recovered_coordinator": coord_summary.get("telemetry"),
        },
        "ok": ok,
    }


def run_single_host_drill(workload: dict, workdir: str, total: int,
                          publish_every: int, seed: int,
                          kill_step: int | None = None,
                          relaunch_budget: int = 5, smoke: bool = False,
                          timeout_s: float = 600.0,
                          trace_dir: str | None = None,
                          overlap: bool = False) -> dict:
    """The single-writer drill (phases 1-4 of the module docstring) over
    ``workload``. Returns the BENCH payload; ``invariants`` within gate
    the exit code. With ``trace_dir`` the oracle worker gets one SIGUSR2
    once its first generation lands, and ``results["signal_capture"]``
    reports what its capture holds (:func:`trace_report`); the oracle is
    what the recovered run must equal bit for bit, so the capture is held
    to the same invariant. ``overlap`` runs the oracle beside the
    kill/relaunch chain (phase 2), which does not read it."""
    from gan_deeplearning4j_tpu_torch.resilience import (
        CheckpointStore,
        FaultSchedule,
        FaultSpec,
        corrupt_generation,
    )

    # the seeded schedule: one SIGKILL somewhere in (0, total)
    if kill_step is not None:
        schedule = FaultSchedule([FaultSpec(kind="kill", step=kill_step)])
    else:
        schedule = FaultSchedule.seeded(seed, total, kinds=("kill",))
        kill_step = schedule.specs[0].step
    schedule_path = os.path.join(workdir, "faults.json")
    schedule.to_json(schedule_path)

    results: dict = {}
    invariants: dict = {}

    def fault_chain():
        """Phase 2: the seeded kill, then relaunches until a run
        completes (or the budget is spent)."""
        fault_store = os.path.join(workdir, "store_fault")
        log(f"kill/recover: SIGKILL scheduled at step {kill_step}")
        relaunches = 0
        killed_observed = False
        recovery = None
        final = None
        while relaunches <= relaunch_budget:
            first = relaunches == 0
            rc, summary, wall = run_worker(
                workload, fault_store, total, publish_every,
                os.path.join(workdir, f"summary_fault_{relaunches}.json"),
                schedule_path=schedule_path if first else None,
                timeout_s=timeout_s)
            if rc == 0 and summary is not None:
                final = summary
                if not first and recovery is None:
                    restores = [e for e in summary.get("events", [])
                                if e.get("event") == "restore"]
                    restored_step = restores[0]["step"] if restores else 0
                    recovery = {
                        "relaunch_wall_s": wall,
                        "restore_s": summary.get("restore_s"),
                        "time_to_first_step_s": summary.get(
                            "time_to_first_step_s"),
                        "restored_step": restored_step,
                        "lost_steps": kill_step - restored_step,
                    }
                break
            if rc is not None and rc < 0:
                killed_observed = True
                log(f"worker died by signal (rc={rc}) — relaunching")
                relaunches += 1
                continue
            log(f"worker exited rc={rc} unexpectedly — drill failed")
            break
        return fault_store, relaunches, killed_observed, recovery, final

    # -- phase 1: oracle (beside phase 2 with ``overlap``) ---------------
    log(f"oracle: {total} uninterrupted steps, publish every {publish_every}")
    (rc, oracle, oracle_wall), chain = _pair(
        overlap,
        lambda: run_worker(
            workload, os.path.join(workdir, "store_oracle"), total,
            publish_every, os.path.join(workdir, "summary_oracle.json"),
            timeout_s=timeout_s, trace_dir=trace_dir),
        fault_chain)
    fault_store, relaunches, killed_observed, recovery, final = chain
    if rc != 0 or oracle is None or oracle.get("status") != "completed":
        log(f"oracle run failed (rc={rc}) — cannot drill")
        return {"ok": False, "invariants": {"oracle_completed": False}}
    results["oracle"] = {
        "wall_s": oracle_wall,
        "train_s": oracle["train_s"],
        "publish_s": oracle["publish_s"],
        "publish_count": oracle["publish_count"],
        "steps": oracle["steps"],
        "checkpoint_overhead_frac": (
            oracle["publish_s"] / (oracle["train_s"] + oracle["publish_s"])
            if oracle["train_s"] + oracle["publish_s"] > 0 else 0.0
        ),
        "checkpoint_write_s_mean": (
            oracle["publish_s"] / oracle["publish_count"]
            if oracle["publish_count"] else 0.0
        ),
    }
    if trace_dir is not None:
        results["signal_capture"] = trace_report(trace_dir)
        invariants["signal_capture_written"] = bool(
            results["signal_capture"]["traces"])

    # -- phase 2: kill + relaunch (above) -------------------------------
    results["kill_recover"] = {
        "kill_step": kill_step,
        "killed_observed": killed_observed,
        "relaunches": relaunches,
        "recovery": recovery,
        "completed": final is not None,
    }
    invariants["kill_observed"] = killed_observed
    invariants["recovered_within_budget"] = (
        final is not None and relaunches <= relaunch_budget)

    # -- phase 3: bit-exact resume --------------------------------------
    oracle_digests = oracle.get("state_digests")
    final_digests = (final or {}).get("state_digests")
    invariants["bit_exact_resume"] = (
        oracle_digests is not None and oracle_digests == final_digests)
    results["bit_exact"] = {
        "oracle_digests": oracle_digests,
        "recovered_digests": final_digests,
    }

    # -- phase 4: corruption fallback -----------------------------------
    corrupt_result: dict = {}
    if final is not None:
        store = CheckpointStore(fault_store)
        published = store.published()
        newest = published[-1]
        prior = published[-2] if len(published) > 1 else None
        member = corrupt_generation(store, newest, seed=seed)
        log(f"corrupted generation {newest} member {member!r}; "
            f"extending run to {total + publish_every} steps")
        rc, summary, wall = run_worker(
            workload, fault_store, total + publish_every, publish_every,
            os.path.join(workdir, "summary_corrupt.json"),
            timeout_s=timeout_s)
        restores = [e for e in (summary or {}).get("events", [])
                    if e.get("event") == "restore"]
        restored_gen = restores[0]["generation"] if restores else None
        entry = CheckpointStore(fault_store).entry(newest)
        corrupt_result = {
            "corrupted_generation": newest,
            "corrupted_member": member,
            "fallback_generation": restored_gen,
            "ledger_status": entry.get("status"),
            "quarantine_reason": entry.get("reason"),
            "completed": rc == 0 and (summary or {}).get("status")
            == "completed",
        }
        invariants["corrupt_never_selected"] = (
            entry.get("status") == "quarantined"
            and restored_gen is not None
            and restored_gen != newest
            and (prior is None or restored_gen == prior)
            and corrupt_result["completed"]
        )
    else:
        invariants["corrupt_never_selected"] = False
    results["corruption"] = corrupt_result

    # -- verdict ---------------------------------------------------------
    ok = all(invariants.values())
    return {
        "bench": "resilience_drill",
        "config": {
            "total_steps": total,
            "publish_every": publish_every,
            "kill_step": kill_step,
            "seed": seed,
            "smoke": bool(smoke),
            "relaunch_budget": relaunch_budget,
            "platform": _platform(workload),
        },
        "results": results,
        "invariants": invariants,
        # each worker's registry snapshot (same series a live scrape would
        # show) — bench artifacts and /metrics share one definition
        "telemetry": {
            "oracle": oracle.get("telemetry"),
            "recovered": (final or {}).get("telemetry"),
        },
        "ok": ok,
    }


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--smoke", action="store_true",
                   help="tier-1 shape: 12 steps, publish every 3")
    p.add_argument("--total-steps", type=int, default=None)
    p.add_argument("--publish-every", type=int, default=None)
    p.add_argument("--kill-step", type=int, default=None,
                   help="override the seeded kill step")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--relaunch-budget", type=int, default=5)
    p.add_argument("--multihost", type=int, default=0, metavar="N",
                   help="drill the MESH plane with N coordinated worker "
                        "processes sharing one store (0 = single-host "
                        "drill, the default)")
    p.add_argument("--mesh-timeout", type=float, default=15.0,
                   help="mesh in-round wait bound handed to the workers "
                        "(multihost mode); expiry = gang abort")
    p.add_argument("--workdir", default=None,
                   help="keep work files here instead of a temp dir")
    p.add_argument("--output", default=None, metavar="PATH",
                   help="write the drill JSON here")
    p.add_argument("--record", default=None, metavar="TAG",
                   help="also write BENCH_resilience_torch_<TAG>.json "
                        "(BENCH_resilience_mh_torch_<TAG>.json with "
                        "--multihost) at the repo root")
    p.add_argument("--cpu", action="store_true",
                   help="train the workers on the CPU "
                        "(use_accelerator=False in the workload); the "
                        "card otherwise")
    args = p.parse_args(argv)
    if args.multihost and args.multihost < 2:
        p.error("--multihost needs N >= 2 (one coordinator plus at "
                "least one peer writer)")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    total = args.total_steps or (12 if args.smoke else 40)
    publish_every = args.publish_every or (3 if args.smoke else 5)
    workdir = args.workdir or tempfile.mkdtemp(prefix="resilience_drill_")
    cleanup = args.workdir is None
    os.makedirs(workdir, exist_ok=True)
    workload = make_workload(workdir, args.seed, use_accelerator=not args.cpu)

    if args.multihost:
        payload = run_multihost_drill(
            workload, workdir, args.multihost, total, publish_every,
            args.seed, kill_step=args.kill_step,
            mesh_timeout=args.mesh_timeout, smoke=args.smoke)
        record = f"BENCH_resilience_mh_torch_{args.record}.json"
    else:
        payload = run_single_host_drill(
            workload, workdir, total, publish_every, args.seed,
            kill_step=args.kill_step,
            relaunch_budget=args.relaunch_budget, smoke=args.smoke)
        record = f"BENCH_resilience_torch_{args.record}.json"
        if payload["invariants"].get("oracle_completed") is False:
            return 2  # no ground truth: nothing was drilled
    invariants = payload.get("invariants", {})
    ok = bool(payload.get("ok"))
    text = json.dumps(payload, indent=2)
    print(text)
    if args.output:
        os.makedirs(os.path.dirname(os.path.abspath(args.output)),
                    exist_ok=True)
        with open(args.output, "w") as fh:
            fh.write(text + "\n")
    if args.record:
        with open(os.path.join(_REPO, record), "w") as fh:
            fh.write(text + "\n")
    if cleanup and ok:
        shutil.rmtree(workdir, ignore_errors=True)
    elif not ok:
        log(f"INVARIANT BREACH — work files kept at {workdir}")
    for name, good in sorted(invariants.items()):
        log(f"invariant {name}: {'ok' if good else 'BREACH'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
