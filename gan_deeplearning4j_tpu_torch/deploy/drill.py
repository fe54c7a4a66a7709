"""Reload drill — a live server under load tracks a training run, swap by
swap, and a poisoned generation is quarantined by the canary gate.

``python -m gan_deeplearning4j_tpu_torch.deploy.drill [--smoke] [--cpu]``:
the PyTorch port's counterpart of ``scripts/reload_drill.py``, with the same
phases, invariants and payload keys, against the port's server (``python -m
gan_deeplearning4j_tpu_torch.serving``) and supervised worker (``python -m
gan_deeplearning4j_tpu_torch.resilience``), real subprocesses:

1. **seed bundle** — an untrained experiment publishes serving generation
   0 into a fresh serve store (in-process; publishing is cheap).
2. **live server** — the serving CLI with ``--reload-store`` boots from that
   generation, warms synchronously, and starts its reload plane (watcher
   poll + canary gate on the workload's own data). Closed-loop client
   threads then hammer ``/v1/sample`` for the rest of the drill.
3. **supervisor segment** — the worker CLI with ``--serve-store`` trains the
   workload, publishing serving bundles on cadence. The drill watches
   ``/healthz`` and requires the server to swap to ≥ 2 newer generations
   and to converge on the trainer's FINAL generation — with **zero**
   requests lost and **zero** shed across every swap (the zero-downtime
   invariant).
4. **poison** — the drill republishes the newest bundle with a saturated
   (all-weights-large) generator: digest-VALID, quality-garbage. A forced
   ``POST /admin/reload?block=1`` must reject it at the canary gate,
   quarantine it through the store, and keep serving the good generation.
5. **evidence** — the server's span trace (``GET /debug/spans``) must
   contain a ``deploy.swap`` span, and the Prometheus
   ``serving_generation`` gauge must equal the final good generation.

Adaptations, against the JAX script:

- :func:`run_reload_drill` takes a workload made elsewhere (a ``{"config":
  path, "data": path}`` pair): ``chip_smoke.py`` hands it the DCGAN-MNIST
  model at full width; the CLI makes the toy with
  ``resilience.drill.make_workload``.
- The server and the worker run on the card unless the workload's config
  says ``use_accelerator: false`` (``--cpu``): the server gets ``--device``
  from it. The payload's ``config.platform`` is where the server and the
  trainer say they ran (``/healthz`` and the worker summary), not an
  environment variable; the drill fails when they disagree with the
  workload's.
- The clients' latent width is read from the published ``serving.json``
  (``z_size``), not taken as the toy's literal 4.
- :func:`run_reload_drill` takes ``poison``, which picks the poisoned
  generation and the canary's bars together (:data:`POISONS`). The CLI
  runs the JAX drill's ``"saturate"``: a saturated generator (every weight
  25) against its bars (FID under 1.1 × the incumbent's + 0.5, accuracy
  within 0.05), tuned to the toy. At the
  DCGAN-MNIST width on synthetic rows they cannot work: the untrained seed
  generation's raw-feature FID is 58.6, the trainer's first generations
  180 to past 660, the classifier trained beside them moves its accuracy
  by more than 0.05 between generations, and the saturated generator (its
  BatchNorm statistics at 25 too) outputs a constant 0.0 that scores 88,
  better than training. ``chip_smoke.py`` therefore passes ``"diverge"``:
  every weight NaN (the digest-valid garbage a diverged run publishes; its
  FID is NaN, which no bar admits) against bars that admit every finite
  probe, so only the gate's finiteness check decides. ``canary_probes``
  in the payload records what the gate saw for each generation it decided
  (its FID and accuracy and the incumbent's, from ``/healthz``).
- The forced poll after the poison asks again while it answers 409, as
  the poll before it does: ``/healthz`` counts the rejection before the
  rejecting cycle ends, and a periodic cycle may be running (the JAX
  script asks once, so a poll landing in either fails its
  ``rejection_surfaced``).
- Results go to ``--output``; ``--record TAG`` writes
  ``BENCH_reload_torch_<TAG>.json``, never the JAX drill's file. The
  payload also carries each swap's publish→served seconds and the
  poisoned generation's canary seconds.

Exit status is nonzero on any invariant breach.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np

#: the directory holding the port package: the server and worker run from it
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SERVER = [sys.executable, "-m", "gan_deeplearning4j_tpu_torch.serving"]
WORKER = [sys.executable, "-m", "gan_deeplearning4j_tpu_torch.resilience"]

#: subprocesses get the caller's environment, minus the JAX package's
#: compilation-cache switch (nothing here reads it)
_ENV = {k: v for k, v in os.environ.items() if k != "GDT_COMPILATION_CACHE"}


def log(msg: str) -> None:
    print(f"[reload-drill] {msg}", flush=True)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def http_json(method: str, url: str, payload=None, timeout: float = 10.0,
              headers=None):
    """(status, decoded JSON body) — None body on connection failure.
    ``headers`` adds/overrides request headers (the fleet drill's
    X-Trace-Id propagation probe)."""
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json",
                                          **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        try:
            return exc.code, json.loads(exc.read())
        except (ValueError, OSError):
            return exc.code, None
    except (urllib.error.URLError, OSError, TimeoutError):
        return None, None


def workload_device(workload: dict) -> str:
    """``"cuda"`` or ``"cpu"``: where the workload's config runs."""
    with open(workload["config"]) as fh:
        return "cuda" if json.load(fh).get("use_accelerator", True) else "cpu"


def seed_bundle(workload: dict, serve_store_root: str, keep_last: int) -> int:
    """Publish generation 0 (the untrained model) so the server has an
    initial bundle to boot from; returns the generation number."""
    from gan_deeplearning4j_tpu_torch.harness import ExperimentConfig, GanExperiment
    from gan_deeplearning4j_tpu_torch.resilience import CheckpointStore

    cfg = ExperimentConfig.from_json(workload["config"])
    exp = GanExperiment(cfg)
    try:
        store = CheckpointStore(serve_store_root, keep_last=keep_last)
        info = exp.publish_for_serving(store=store)
    finally:
        exp.close()
    return info["generation"]


def bundle_z_size(serve_store_root: str, keep_last: int) -> int:
    """The latent width the newest serving generation publishes."""
    from gan_deeplearning4j_tpu_torch.resilience import CheckpointStore

    newest = CheckpointStore(serve_store_root, keep_last=keep_last).latest_valid()
    with open(os.path.join(newest.path, "serving.json")) as fh:
        return int(json.load(fh)["z_size"])


#: the poisons: the value :func:`poison_newest` sets every generator weight
#: to, and the canary flags the drills' server or fleet runs against it
POISONS = {
    "saturate": (25.0, ("--canary-fid-ratio", "1.1", "--canary-fid-slack", "0.5")),
    "diverge": (float("nan"), ("--canary-fid-ratio", "1.1", "--canary-fid-slack", "inf",
                               "--canary-acc-drop", "inf")),
}


def _fill(tree, value: float):
    import torch

    if isinstance(tree, dict):
        return {k: _fill(v, value) for k, v in tree.items()}
    return torch.full_like(tree, value)


def poison_newest(serve_store_root: str, keep_last: int, poison: str = "saturate") -> int:
    """Republish the newest bundle with a poisoned generator: digest-valid
    bytes, collapsed model. ``"saturate"`` (the JAX drill's) pushes every
    weight far positive, so a sigmoid output without BatchNorm pins at 1.0;
    ``"diverge"`` sets every weight to NaN, as a diverged run would publish.
    Returns the poisoned generation number."""
    value = POISONS[poison][0]
    from gan_deeplearning4j_tpu_torch.resilience import CheckpointStore
    from gan_deeplearning4j_tpu_torch.utils.serializer import read_model, write_model

    store = CheckpointStore(serve_store_root, keep_last=keep_last)
    newest = store.latest_valid()
    number = store.next_number()

    def writer(staging: str) -> None:
        with open(os.path.join(newest.path, "serving.json")) as fh:
            manifest = json.load(fh)
        for name in os.listdir(newest.path):
            if name == "MANIFEST.json":
                continue
            shutil.copy2(os.path.join(newest.path, name),
                         os.path.join(staging, name))
        gen_zip = os.path.join(staging, manifest["generator"])
        graph, params, _, _ = read_model(gen_zip, load_updater=False, device="cpu")
        write_model(gen_zip, graph, _fill(params, value), save_updater=False)
        manifest["generation"] = number
        with open(os.path.join(staging, "serving.json"), "w") as fh:
            json.dump(manifest, fh, indent=2)

    generation = store.publish(writer, step=newest.step,
                               extra={"kind": "serving"})
    if generation.number != number:
        raise RuntimeError(
            f"poisoned bundle labeled generation {number} but the store "
            f"assigned {generation.number} — concurrent writer?")
    return generation.number


def _published_at(serve_store_root: str, generation: int):
    """The wall time (Unix seconds) the store's ledger says a generation was
    published at (kept after retention collects the generation)."""
    from gan_deeplearning4j_tpu_torch.resilience import CheckpointStore

    return CheckpointStore(serve_store_root).entry(generation).get("published_at")


class LoadGenerator:
    """Closed-loop /v1/sample clients. Every attempt is accounted: ok,
    shed (overloaded/deadline), error, or lost (no HTTP answer) — the
    zero-lost / zero-shed ledger the swap invariant reads."""

    def __init__(self, base: str, z_size: int, threads: int = 2):
        self.base = base
        self.z_size = z_size
        self.stop = threading.Event()
        self.counts = {"sent": 0, "ok": 0, "shed": 0, "error": 0, "lost": 0}
        self._lock = threading.Lock()
        self._threads = [
            threading.Thread(target=self._run, args=(i,), daemon=True)
            for i in range(threads)
        ]

    def _run(self, tid: int) -> None:
        rng = np.random.default_rng(1000 + tid)
        while not self.stop.is_set():
            rows = (rng.random((int(rng.integers(1, 4)), self.z_size),
                               dtype=np.float32) * 2.0 - 1.0)
            with self._lock:
                self.counts["sent"] += 1
            status, body = http_json(
                "POST", f"{self.base}/v1/sample", {"data": rows.tolist()})
            with self._lock:
                if status is None:
                    self.counts["lost"] += 1
                elif status == 200:
                    self.counts["ok"] += 1
                elif status == 503:
                    self.counts["shed"] += 1
                else:
                    self.counts["error"] += 1
            time.sleep(0.005)  # keep 2 shared cores breathable

    def start(self) -> None:
        for t in self._threads:
            t.start()

    def finish(self) -> dict:
        self.stop.set()
        for t in self._threads:
            t.join(timeout=10.0)
        # the joins are bounded — a straggler stuck in a slow request may
        # still be incrementing, so read under the same lock the workers
        # write under
        with self._lock:
            return dict(self.counts)


def run_reload_drill(workload: dict, workdir: str, *, total: int,
                     serve_every: int, publish_every: int, keep_last: int = 10,
                     poll: float = 0.3, seed: int = 1, smoke: bool = False,
                     poison: str = "saturate", boot_timeout_s: float = 240.0,
                     worker_timeout_s: float = 600.0) -> dict:
    """The drill on ``workload`` in ``workdir``; returns the payload
    (``ok``, ``invariants``, ``results``, ``config``)."""
    poison_kind = poison
    serve_store = os.path.join(workdir, "store_serve")
    train_store = os.path.join(workdir, "store_train")
    device = workload_device(workload)
    expected = "gpu" if device == "cuda" else "cpu"
    results: dict = {}
    invariants: dict = {}
    server = worker = None
    load = None
    worker_summary: dict = {}
    health: dict = {}
    port = free_port()
    base = f"http://127.0.0.1:{port}"

    def payload(ok: bool) -> dict:
        return {
            "bench": "reload_drill",
            "config": {
                "total_steps": total,
                "publish_every": publish_every,
                "serve_publish_every": serve_every,
                "poll_interval": poll,
                "seed": seed,
                "smoke": bool(smoke),
                "poison": poison_kind,
                "device": device,
                "platform": (health or {}).get("platform"),
                "trainer_platform": worker_summary.get("platform"),
            },
            "results": results,
            "invariants": invariants,
            "ok": ok,
        }

    try:
        # -- phase 1: seed bundle + live server -------------------------
        gen0 = seed_bundle(workload, serve_store, keep_last)
        z_size = bundle_z_size(serve_store, keep_last)
        log(f"seeded serving generation {gen0} (z_size {z_size})")
        server_log = open(os.path.join(workdir, "server.log"), "w")
        server = subprocess.Popen(
            SERVER + [
                "--reload-store", serve_store,
                "--reload-poll", str(poll),
                "--canary-data", workload["data"],
                "--canary-samples", "48",
                *POISONS[poison_kind][1],
                "--host", "127.0.0.1", "--port", str(port),
                "--replicas", "1", "--buckets", "1,8",
                "--max-latency", "0.002",
                "--warmup", "sync", "--telemetry",
                "--device", device,
            ],
            cwd=_REPO, env=_ENV, stdout=server_log, stderr=server_log,
        )
        deadline = time.monotonic() + boot_timeout_s
        t_boot = time.monotonic()
        health = None
        while time.monotonic() < deadline:
            if server.poll() is not None:
                log(f"server exited rc={server.returncode} during startup")
                return payload(False)
            status, health = http_json("GET", f"{base}/healthz", timeout=5.0)
            if status == 200 and health and health.get("status") == "ok":
                break
            time.sleep(0.25)
        else:
            log("server never became healthy — cannot drill")
            return payload(False)
        results["server_boot_s"] = time.monotonic() - t_boot
        invariants["server_on_expected_platform"] = health.get("platform") == expected
        if health["generation"] != gen0:
            raise RuntimeError(
                f"server booted from generation {health['generation']}, "
                f"expected the seeded {gen0}")
        log(f"server healthy on {base}, serving generation {gen0}")

        # -- phase 2: load + supervisor segment -------------------------
        load = LoadGenerator(base, z_size)
        load.start()
        worker_log = open(os.path.join(workdir, "worker.log"), "w")
        worker = subprocess.Popen(
            WORKER + [
                "--config", workload["config"], "--data", workload["data"],
                "--store", train_store,
                "--serve-store", serve_store,
                "--total-steps", str(total),
                "--publish-every", str(publish_every),
                "--serve-publish-every", str(serve_every),
                "--keep-last", str(keep_last),
                "--summary", os.path.join(workdir, "worker_summary.json"),
            ],
            cwd=_REPO, env=_ENV, stdout=worker_log, stderr=worker_log,
        )
        generations_seen = [gen0]
        served_at = {}  # generation -> wall time the server first showed it
        canary_probes = results["canary_probes"] = {}

        def note_canary(body) -> None:
            last = ((body or {}).get("reload") or {}).get("canary")
            if last:
                canary_probes[str(last["generation"])] = last
        t_worker = time.monotonic()
        while worker.poll() is None:
            if time.monotonic() - t_worker > worker_timeout_s:
                worker.kill()
                log("worker hung — killed")
                break
            status, body = http_json("GET", f"{base}/healthz", timeout=5.0)
            note_canary(body)
            if status == 200 and body:
                g = body.get("generation")
                if g is not None and g != generations_seen[-1]:
                    generations_seen.append(g)
                    served_at[g] = time.time()
                    log(f"server swapped to generation {g} "
                        f"(reload: {body.get('reload')})")
            time.sleep(0.1)
        worker_rc = worker.returncode
        try:
            with open(os.path.join(workdir, "worker_summary.json")) as fh:
                worker_summary = json.load(fh)
        except (OSError, json.JSONDecodeError):
            worker_summary = {}  # a dead worker breaches the invariants below
        final_gen = worker_summary.get("final_serve_generation")
        log(f"worker done rc={worker_rc}, final serve generation {final_gen}")

        # convergence: the server must reach the trainer's final generation
        deadline = time.monotonic() + 60.0
        converged = False
        while time.monotonic() < deadline:
            status, body = http_json("GET", f"{base}/healthz", timeout=5.0)
            note_canary(body)
            if status == 200 and body:
                g = body.get("generation")
                if g != generations_seen[-1] and g is not None:
                    generations_seen.append(g)
                    served_at[g] = time.time()
                    log(f"server swapped to generation {g}")
                if g == final_gen:
                    converged = True
                    break
            time.sleep(0.1)
        swaps = len(generations_seen) - 1
        _, metrics = http_json("GET", f"{base}/metrics", timeout=5.0)
        publish_to_served = {}
        for g, at in served_at.items():
            published = _published_at(serve_store, g)
            if published is not None:
                publish_to_served[str(g)] = at - published
        results["swap_phase"] = {
            "worker_rc": worker_rc,
            "serve_publishes": worker_summary.get("serve_publish_count"),
            "final_serve_generation": final_gen,
            "generations_seen": generations_seen,
            "swaps_observed": swaps,
            "engine_swaps_metric": (metrics or {}).get("engine_swaps"),
            "converged_to_final": converged,
            "reload": (body or {}).get("reload"),
            "publish_to_served_s": publish_to_served,
        }
        invariants["swaps_ge_2"] = swaps >= 2
        invariants["converged_to_final_generation"] = converged
        invariants["trainer_on_expected_platform"] = (
            worker_summary.get("platform") == expected)

        # the span trace must show the swap (fetched before poison-phase
        # traffic can age it out of the ring)
        trace_path = os.path.join(workdir, "reload_trace.json")
        _, trace = http_json("GET", f"{base}/debug/spans", timeout=10.0)
        span_names = {e.get("name") for e in (trace or {}).get(
            "traceEvents", [])}
        with open(trace_path, "w") as fh:
            json.dump(trace or {}, fh)
        invariants["trace_has_swap_span"] = "deploy.swap" in span_names
        results["trace"] = {"path": trace_path,
                            "events": len((trace or {}).get("traceEvents",
                                                            []))}

        # -- phase 3: poison + canary quarantine ------------------------
        poison = poison_newest(serve_store, keep_last, poison_kind)
        t_poison = time.monotonic()
        log(f"published poisoned generation {poison}")
        # force the poll — but the periodic watcher may already be
        # mid-cycle on the poison (409 is then the CORRECT busy answer),
        # so drive to the OUTCOME: the reload plane reports a rejection
        deadline = time.monotonic() + 120.0
        rejected = False
        while time.monotonic() < deadline and not rejected:
            status, body = http_json(
                "POST", f"{base}/admin/reload?block=1", {}, timeout=120.0)
            log(f"forced reload: {status} "
                f"{(body or {}).get('reload') or (body or {}).get('error')}")
            _, h = http_json("GET", f"{base}/healthz", timeout=5.0)
            rejected = ((h or {}).get("reload", {}).get("rejected", 0) >= 1)
            if not rejected:
                time.sleep(0.5)
        canary_s = time.monotonic() - t_poison
        # with the poison quarantined, a forced blocking poll finds
        # nothing newer and answers 200 — the admin route's happy path;
        # the rejecting cycle may still be winding down when healthz
        # first counts the rejection, and a periodic cycle may be running:
        # 409 is then the correct busy answer, so ask again
        status, body = http_json(
            "POST", f"{base}/admin/reload?block=1", {}, timeout=120.0)
        while status == 409 and time.monotonic() < deadline:
            time.sleep(0.5)
            status, body = http_json(
                "POST", f"{base}/admin/reload?block=1", {}, timeout=120.0)
        _, after = http_json("GET", f"{base}/healthz", timeout=5.0)
        note_canary(after)
        from gan_deeplearning4j_tpu_torch.resilience import CheckpointStore

        entry = CheckpointStore(serve_store,
                                keep_last=keep_last).entry(poison)
        reload_state = (after or {}).get("reload", {})
        results["poison_phase"] = {
            "poisoned_generation": poison,
            "admin_reload_status": status,
            "ledger_status": entry.get("status"),
            "quarantine_reason": entry.get("reason"),
            "served_generation_after": (after or {}).get("generation"),
            "reload": reload_state,
            "canary_s": canary_s,
        }
        invariants["poison_quarantined"] = (
            entry.get("status") == "quarantined"
            and "canary" in (entry.get("reason") or ""))
        invariants["poison_never_served"] = (
            poison not in generations_seen
            and (after or {}).get("generation") == final_gen)
        invariants["rejection_surfaced"] = (
            status == 200 and (reload_state.get("rejected") or 0) >= 1)

        # -- phase 4: ledgers + the gauge -------------------------------
        counts = load.finish()
        load = None
        results["requests"] = counts
        invariants["zero_lost"] = (
            counts["lost"] == 0 and counts["error"] == 0
            and counts["ok"] == counts["sent"])
        invariants["zero_shed_during_swaps"] = counts["shed"] == 0
        prom_gauge = None
        try:
            with urllib.request.urlopen(
                    f"{base}/metrics?format=prom", timeout=5.0) as resp:
                for line in resp.read().decode().splitlines():
                    if line.startswith("serving_generation "):
                        prom_gauge = float(line.split()[-1])
        except (urllib.error.URLError, OSError):
            pass
        results["serving_generation_gauge"] = prom_gauge
        invariants["gauge_tracks_served_generation"] = (
            prom_gauge is not None and final_gen is not None
            and int(prom_gauge) == int(final_gen))
    finally:
        if load is not None:
            load.finish()
        for proc in (worker, server):
            if proc is not None and proc.poll() is None:
                proc.terminate()
                try:
                    proc.wait(timeout=10.0)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait(timeout=10.0)

    return payload(bool(invariants) and all(invariants.values()))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--smoke", action="store_true",
                   help="CI shape: 24 steps, serve-publish every 2")
    p.add_argument("--cpu", action="store_true",
                   help="run the server and the trainer on the CPU (default: the card)")
    p.add_argument("--total-steps", type=int, default=None)
    p.add_argument("--serve-every", type=int, default=None)
    p.add_argument("--publish-every", type=int, default=None)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--keep-last", type=int, default=10,
                   help="serve-store retention (roomy: the server may read "
                        "an older generation while the trainer publishes)")
    p.add_argument("--poll", type=float, default=0.3,
                   help="server reload-plane poll interval")
    p.add_argument("--workdir", default=None,
                   help="keep work files here instead of a temp dir")
    p.add_argument("--output", default=None, metavar="PATH",
                   help="write the drill JSON here")
    p.add_argument("--record", default=None, metavar="TAG",
                   help="also write BENCH_reload_torch_<TAG>.json at the repo root")
    return p.parse_args(argv)


def main(argv=None) -> int:
    from gan_deeplearning4j_tpu_torch.resilience.drill import make_workload

    args = parse_args(argv)
    total = args.total_steps or (24 if args.smoke else 60)
    serve_every = args.serve_every or (2 if args.smoke else 3)
    publish_every = args.publish_every or (6 if args.smoke else 10)
    workdir = args.workdir or tempfile.mkdtemp(prefix="reload_drill_")
    cleanup = args.workdir is None
    os.makedirs(workdir, exist_ok=True)
    workload = make_workload(workdir, args.seed, use_accelerator=not args.cpu)
    payload = run_reload_drill(
        workload, workdir, total=total, serve_every=serve_every,
        publish_every=publish_every, keep_last=args.keep_last, poll=args.poll,
        seed=args.seed, smoke=args.smoke)
    ok = payload["ok"]
    text = json.dumps(payload, indent=2)
    print(text)
    if args.output:
        os.makedirs(os.path.dirname(os.path.abspath(args.output)),
                    exist_ok=True)
        with open(args.output, "w") as fh:
            fh.write(text + "\n")
    if args.record:
        with open(os.path.join(_REPO, f"BENCH_reload_torch_{args.record}.json"),
                  "w") as fh:
            fh.write(text + "\n")
    if cleanup and ok:
        shutil.rmtree(workdir, ignore_errors=True)
    elif not ok:
        log(f"INVARIANT BREACH — work files kept at {workdir}")
    for name, good in sorted(payload["invariants"].items()):
        log(f"invariant {name}: {'ok' if good else 'BREACH'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
