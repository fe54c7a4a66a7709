"""Entry points — the port's counterpart of ``__graft_entry__.py``.

- :func:`entry` returns the flagship model's inference forward (the stacked
  GAN graph ``D(G(z))``) and example arguments, on the card unless the
  caller asks for the CPU;
- :func:`spawn_multihost` / :func:`dryrun_multihost` start N OS processes of
  ``parallel/multihost.py`` that meet at a TCP coordinator on this host and
  check that they end bit-identical;
- :func:`dryrun_multichip` runs the JAX dryrun's six modes (``pmean``, its
  scan window, bf16 storage, ``param_averaging``, its scan window,
  WGAN-GP) one step each on an N-rank mesh through
  ``parallel/launch.py::spawn``, the MNIST modes at ``ExperimentConfig``'s
  defaults (the reference DCGAN at full width).

The JAX package's mesh is N devices in one process; here each rank is a
process, so where the JAX dryrun asserts every device's copy of a state
equal, every rank digests its states and the ranks' digests are
all-gathered and compared inside the group.
"""

from __future__ import annotations

import os
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

#: the repository root: the directory that holds this package
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: seconds the other processes of a smoke get after one has failed
_GRACE_S = 10.0
_POLL_S = 0.05
#: what each smoke process prints: one checksum per mode
SMOKE_MODES = ("pmean", "param_averaging", "wgan_gp")


def entry(device=None):
    """``(fn, (params, z))``: ``fn(params, z)`` is the stacked GAN graph's
    inference forward, ``z`` 64 rows of ``linspace(-1, 1)`` in two columns;
    ``device`` None is the card, where fp32 runs with TF32 off, as the
    serving engine runs an fp32 bundle."""
    import torch

    from gan_deeplearning4j_tpu_torch.models import dcgan_mnist
    from gan_deeplearning4j_tpu_torch.runtime.device import pin_fp32_precision, resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        pin_fp32_precision()
    graph = dcgan_mnist.build_gan()
    params = graph.init(device=dev)
    z = torch.from_numpy(np.linspace(-1.0, 1.0, 64 * 2, dtype=np.float32).reshape(64, 2)).to(dev)

    def fn(params, z):
        with torch.no_grad():
            return graph.output(params, z, train=False)

    return fn, (params, z)


# -- N processes at a coordinator ---------------------------------------------------

def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_multihost(n_processes: int, *, platform: str = "gpu", timeout: float = 280.0,
                  barrier_timeout: Optional[float] = None, process_ids: Optional[Sequence[int]] = None,
                  states_dir: Optional[str] = None) -> List[Tuple[int, str, str]]:
    """Start the ``process_ids`` (default: all) of an ``n_processes`` smoke
    at a coordinator on a free ``127.0.0.1`` port, with a fresh barrier
    directory (``barrier_timeout`` defaults to 0.75 of ``timeout``), and
    drain them all at once: ``(returncode, stdout, stderr)`` per process.
    Once one fails, the others get a few seconds and are then killed; past
    ``timeout`` every process left is killed (returncode -9)."""
    ids = list(range(n_processes)) if process_ids is None else list(process_ids)
    barrier_timeout = 0.75 * timeout if barrier_timeout is None else barrier_timeout
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (_ROOT, env.get("PYTHONPATH")) if p)
    if platform == "cpu":
        env["OMP_NUM_THREADS"] = "1"  # N processes share this host's cores
    port = _free_port()
    barrier_root = tempfile.mkdtemp(prefix="multihost_barrier_")
    try:
        procs = [subprocess.Popen(
            [sys.executable, "-m", "gan_deeplearning4j_tpu_torch.parallel.multihost",
             "--coordinator", f"127.0.0.1:{port}", "--num-processes", str(n_processes),
             "--process-id", str(i), "--platform", platform, "--barrier-root", barrier_root,
             "--barrier-timeout", str(barrier_timeout)]
            + (["--states-dir", states_dir] if states_dir else []),
            stdin=subprocess.DEVNULL, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env, cwd=_ROOT) for i in ids]
        # every pipe drained at once: a sequential communicate() deadlocks
        # when an undrained child fills its pipe before a collective
        outputs: List[Tuple[str, str]] = [("", "")] * len(procs)

        def drain(k):
            outputs[k] = procs[k].communicate()

        threads = [threading.Thread(target=drain, args=(k,), daemon=True)
                   for k in range(len(procs))]
        for t in threads:
            t.start()
        deadline, failed_at = time.monotonic() + timeout, None
        while any(p.poll() is None for p in procs):
            now = time.monotonic()
            if failed_at is None and any(p.returncode not in (None, 0) for p in procs):
                failed_at = now
            if now > deadline or (failed_at is not None and now > failed_at + _GRACE_S):
                break
            time.sleep(_POLL_S)
        for p in procs:
            if p.poll() is None:
                p.kill()
        for t in threads:
            t.join()
    finally:
        shutil.rmtree(barrier_root, ignore_errors=True)
    return [(p.returncode, out, err) for p, (out, err) in zip(procs, outputs)]


def checksums_of(results: Sequence[Tuple[int, str, str]]) -> List[List[str]]:
    """Each process's checksums, one per mode, from :func:`run_multihost`'s
    results; raises ``RuntimeError`` on a nonzero exit, a process that
    never printed its ``OK`` line, or one with fewer checksums than modes
    (an exit 0 with no checksum lines must not pass)."""
    out = []
    for i, (rc, stdout, stderr) in enumerate(results):
        if rc != 0:
            raise RuntimeError(f"multihost process {i} rc={rc}:\n{stdout}\n{stderr[-2000:]}")
        if f"[multihost] process {i} OK" not in stdout:
            raise RuntimeError(f"multihost process {i} never reported OK:\n{stdout}")
        sums = [line.split("checksum=")[1] for line in stdout.splitlines() if "checksum=" in line]
        if len(sums) != len(SMOKE_MODES):
            raise RuntimeError(f"multihost process {i}: expected {len(SMOKE_MODES)} checksums, "
                               f"got {sums}")
        out.append(sums)
    return out


def spawn_multihost(n_processes: int = 2, timeout: float = 280.0, echo=False, *,
                    platform: str = "gpu", states_dir: Optional[str] = None):
    """``n_processes`` OS processes of the smoke at a coordinator on this
    host, each checked (:func:`checksums_of`): their checksum lists, in
    process order. The free-port pick races (another process may bind the
    port before process 0's store does), so a failed round is retried once
    on a fresh port. ``echo``: True prints every process's ``[multihost]``
    lines, a callable is given each of them."""
    show = (lambda line: print(line, flush=True)) if echo is True else echo
    last_error = None
    for _ in range(2):
        results = run_multihost(n_processes, platform=platform, timeout=timeout,
                                states_dir=states_dir)
        try:
            sums = checksums_of(results)
        except RuntimeError as exc:
            last_error = exc
            continue
        if show:
            for _, stdout, _ in results:
                for line in stdout.splitlines():
                    if line.startswith("[multihost]"):
                        show(line)
        return sums
    raise last_error


def dryrun_multihost(n_processes: int = 2, platform: str = "gpu") -> None:
    """Spawn ``n_processes`` smoke processes (:func:`spawn_multihost`) and
    require that they end bit-identical in every mode."""
    checksums = spawn_multihost(n_processes, echo=True, platform=platform)
    if any(c != checksums[0] for c in checksums[1:]):
        raise RuntimeError(f"cross-process divergence: {checksums}")
    print(f"[dryrun_multihost] {n_processes} processes agree bit-identically", flush=True)


# -- the six modes on an N-rank mesh -------------------------------------------------

def _check_losses(losses: Dict[str, float], allow_nan=()) -> None:
    for name, value in losses.items():
        if name in allow_nan and np.isnan(value):
            continue
        if not np.isfinite(value):
            raise RuntimeError(f"non-finite {name}: {value}")


def multichip_modes(n_devices: int, use_accelerator: bool = True, states: Optional[Dict] = None,
                    draws: Optional[Dict] = None) -> Dict:
    """The rank program of :func:`dryrun_multichip`: the JAX dryrun's six
    modes in this rank of the default group, on the same numpy inputs
    (``default_rng(0)``, drawn in the JAX dryrun's order). ``states`` and
    ``draws`` inject, per experiment (``"pmean"``, ``"bf16"``,
    ``"param_averaging"``, ``"wgan_gp"``), its initial states and its
    draws by step, as ``parallel/drill.py::experiment_run`` takes them.
    Returns ``{mode: {"batch", "losses", "digests"}}``: each mode's losses
    (a window's last iteration) and every rank's digest of the
    experiment's states, equal across ranks or this raises."""
    import torch

    from gan_deeplearning4j_tpu_torch.harness import ExperimentConfig, make_experiment
    from gan_deeplearning4j_tpu_torch.harness.experiment import flatten_states
    from gan_deeplearning4j_tpu_torch.parallel.drill import _set_states
    from gan_deeplearning4j_tpu_torch.parallel.multihost import _flat, gathered_digests
    from gan_deeplearning4j_tpu_torch.runtime.environment import make_mesh

    mesh = make_mesh(use_accelerator=use_accelerator)
    if mesh.size != n_devices:
        raise RuntimeError(f"need {n_devices} ranks, the group has {mesh.size}")
    rng = np.random.default_rng(0)
    out: Dict = {"rank": mesh.rank}

    def build(name, **cfg):
        exp = make_experiment(ExperimentConfig(num_iterations=1, save_models=False,
                                               use_accelerator=use_accelerator, **cfg), mesh=mesh)
        if states is not None:
            _set_states(exp, states[name])
        if draws is not None:
            table = draws[name]
            if hasattr(exp, "critic_state"):
                exp.draw_source = lambda step, n_critic, rows: table[step]
            else:
                exp.z_source = lambda step, n: table[step]
        return exp

    def mnist_batch(shape):
        features = rng.random(shape + (784,), dtype=np.float32)
        return features, np.eye(10, dtype=np.float32)[rng.integers(0, 10, size=shape)]

    def record(mode, exp, batch, losses, allow_nan=()):
        losses = {k: float(v[-1] if np.ndim(v) else v) for k, v in losses.items()}
        _check_losses(losses, allow_nan)
        out[mode] = {"batch": batch, "losses": losses,
                     "digests": gathered_digests(mesh, flatten_states(exp.digest_states()))}

    # -- per-step pmean, then its device loop: a window of 2 -------------------
    batch = 2 * n_devices
    exp = build("pmean", batch_size_train=batch, batch_size_pred=batch, distributed="pmean")
    features, labels = mnist_batch((batch,))
    record("pmean", exp, batch, exp.train_iteration(features, labels))
    record("pmean_scan_window", exp, batch, exp.train_iterations(*mnist_batch((2, batch))))

    # -- bf16 parameter storage through the same step ---------------------------
    exp_bf = build("bf16", batch_size_train=batch, batch_size_pred=batch, distributed="pmean",
                   param_dtype="bf16")
    record("pmean_bf16_storage", exp_bf, batch, exp_bf.train_iteration(features, labels))
    leaks = [name for name, leaf in _flat({"params": exp_bf.dis_state.params,
                                           "opt_state": exp_bf.dis_state.opt_state}).items()
             if leaf.is_floating_point() and leaf.dtype != torch.bfloat16]
    if leaks:
        raise RuntimeError(f"bf16 storage leaked f32 leaves: {leaks[:5]}")

    # -- k-step parameter averaging, then its per-fit device loop ---------------
    freq, per_worker = 2, 2
    batch_pa = n_devices * freq * per_worker
    exp_pa = build("param_averaging", batch_size_train=batch_pa, batch_size_pred=batch_pa,
                   distributed="param_averaging", averaging_frequency=freq,
                   batch_size_per_worker=per_worker)
    record("param_averaging", exp_pa, batch_pa, exp_pa.train_iteration(*mnist_batch((batch_pa,))))
    record("param_averaging_scan_window", exp_pa, batch_pa,
           exp_pa.train_iterations(*mnist_batch((2, batch_pa))))

    # -- WGAN-GP: the critic round and the generator step on the mesh -----------
    n_critic = 2
    wbatch = n_critic * n_devices
    exp_w = build("wgan_gp", model_family="wgan_gp", height=8, width=8, channels=1,
                  num_features=64, z_size=4, batch_size_train=wbatch, batch_size_pred=wbatch,
                  n_critic=n_critic, distributed="pmean")
    record("wgan_gp", exp_w, wbatch,
           exp_w.train_iteration(rng.random((wbatch, 64), dtype=np.float32)),
           allow_nan=("cv_loss",))
    out["jax_loaded"] = "jax" in sys.modules
    return out


#: each mode's line: its extra field
MULTICHIP_MODES = {"pmean": "", "pmean_scan_window": "window=2",
                   "pmean_bf16_storage": "param_dtype=bf16",
                   "param_averaging": "freq=2 per_worker=2",
                   "param_averaging_scan_window": "window=2", "wgan_gp": "n_critic=2"}


def multichip_lines(n_devices: int, ranks: Sequence[Dict]) -> List[str]:
    """The JAX dryrun's summary lines for :func:`multichip_modes`' rank
    results, after checking every rank's digests equal in every mode."""
    lines = []
    for mode, extra in MULTICHIP_MODES.items():
        digests = {tuple(r[mode]["digests"]) for r in ranks}
        if len(digests) != 1 or len(set(next(iter(digests)))) != 1:
            raise RuntimeError(f"{mode}: ranks differ: {digests}")
        row = ranks[0][mode]
        vals = " ".join(f"{k}={v:.4f}" for k, v in row["losses"].items())
        lines.append(f"[dryrun_multichip] mode={mode} devices={n_devices} batch={row['batch']} "
                     f"{vals}{' ' + extra if extra else ''} replicas-identical=yes")
    lines.append(f"[dryrun_multichip] ALL MODES OK: pmean, param_averaging, wgan_gp on a "
                 f"{n_devices}-device mesh")
    return lines


def run_multichip(n_devices: int, use_accelerator: bool = True, *,
                  states: Optional[Dict] = None, draws: Optional[Dict] = None,
                  timeout: float = 600.0) -> List[Dict]:
    """The six modes (:func:`multichip_modes`) on ``n_devices`` ranks of one
    host, NCCL where it has a card per rank, else gloo (ranks sharing
    ``cuda:0``, or the CPU under ``use_accelerator=False``): the ranks'
    results."""
    from gan_deeplearning4j_tpu_torch.parallel.launch import spawn
    from gan_deeplearning4j_tpu_torch.runtime.environment import backend_for

    return spawn(multichip_modes, n_devices, (n_devices, use_accelerator, states, draws),
                 backend=backend_for(n_devices, use_accelerator),
                 use_accelerator=use_accelerator, timeout=timeout)


def dryrun_multichip(n_devices: int, use_accelerator: bool = True, **kwargs) -> List[Dict]:
    """:func:`run_multichip`, then its mode lines (:func:`multichip_lines`)
    printed; returns the ranks' results."""
    ranks = run_multichip(n_devices, use_accelerator, **kwargs)
    for line in multichip_lines(n_devices, ranks):
        print(line, flush=True)
    return ranks
