"""Multi-host smoke: N processes meet at a coordinator and train as one mesh
— the port's counterpart of ``scripts/multihost_smoke.py``.

Each process runs this module with a process id. They meet at process 0's
``TCPStore`` at ``--coordinator HOST:PORT``
(``runtime/environment.py::initialize_distributed``, the JAX package's
``jax.distributed`` keywords), form one ``torch.distributed`` group, and
run, each on its own rows of one global batch made from a seed:

1. one ``GraphTrainer`` ``pmean`` step (the per-step gradient mean);
2. one ``ParameterAveragingTrainer.fit_round`` (2 local steps, then the
   mean of params and updater state);
3. one WGAN-GP ``train_round`` (two critic steps with the gradient penalty,
   then the generator step), its draws those of the JAX smoke's
   ``PRNGKey(7)`` round, made for the global batch on the host
   (``runtime/threefry.py``) and sliced by rank.

After each mode a process prints ``[multihost] mode=... checksum=<16 hex>``
(sha256 over the params' bytes on the host, leaves sorted by name), and the
ranks all-gather their digests and check them equal inside the group; the
caller (``entry.spawn_multihost``) compares the printed checksums across
processes. That all-gather stands where the JAX smoke asserts its local
device replicas equal: here a process is one rank, so there are none.

Rendezvous discipline, as in the JAX smoke: with ``--barrier-root DIR`` the
processes meet at ``resilience/mesh.py`` file barriers, a ``boot`` barrier
before the store (a peer that never launched becomes exit 3 within
``--barrier-timeout`` seconds, never a store wait) and a ``done`` barrier
after the last mode. ``--barrier-timeout`` also bounds the store's waits.

The one difference from the JAX smoke: a process is one rank on one device,
so ``--local-devices`` is accepted at 1 only, and N processes here match the
JAX smoke's N processes at ``--local-devices 1``. ``--platform gpu`` (the
JAX script's ``tpu``) runs on the card, NCCL where the host has a card per
process and otherwise gloo with every rank on ``cuda:0``; ``--platform
cpu`` runs gloo on the CPU. Without a card ``--platform gpu`` exits 2.

Run one process per host::

    python -m gan_deeplearning4j_tpu_torch.parallel.multihost --coordinator HOST:PORT \\
        --num-processes N --process-id I [--platform cpu|gpu] \\
        [--barrier-root DIR] [--barrier-timeout S] [--states-dir DIR]
"""

from __future__ import annotations

import argparse
import hashlib
import os
import sys
from typing import Dict, Optional

import numpy as np
import torch

#: the JAX smoke's discriminator and WGAN-GP shapes
MLP_SHAPES = dict(num_features=8, z_size=2, hidden=(16,))
WGAN_SHAPES = dict(height=8, width=8, channels=1, z_size=4, base_filters=8, dense_width=32,
                   n_critic=2, seed=666)
#: the parameter-averaging round: frequency, rows a worker
FREQ, PER_WORKER = 2, 2
#: the WGAN-GP round's key: ``jax.random.PRNGKey(7)``
WGAN_KEY_SEED = 7
#: printed checksums: the first 16 hex digits of the sha256
CHECKSUM_HEX = 16


def _host_bytes(leaf) -> bytes:
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf).tobytes()
    t = leaf.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


def _flat(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    out = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, dict):
            out.update(_flat(value, name + "/"))
        else:
            out[name] = value
    return out


def digest(tree) -> bytes:
    """sha256 over every leaf of a nested dict of tensors (or host numbers),
    leaves sorted by name, each leaf's name and then its bytes on the host:
    two processes print one digest iff their states are bit-identical."""
    h = hashlib.sha256()
    for name, leaf in sorted(_flat(tree).items()):
        h.update(name.encode())
        h.update(_host_bytes(leaf))
    return h.digest()


def gathered_digests(mesh, tree) -> list:
    """Every rank's :func:`digest` of ``tree``, in rank order (one
    all-gather); raises when the ranks differ."""
    from gan_deeplearning4j_tpu_torch.parallel import collectives

    own = torch.tensor(list(digest(tree)), dtype=torch.uint8, device=mesh.device)
    rows = collectives.all_gather(own, mesh).cpu().view(mesh.size, -1)
    hexes = [bytes(r.tolist()).hex() for r in rows]
    if any(h != hexes[0] for h in hexes[1:]):
        raise RuntimeError(f"ranks diverged inside the group: {hexes}")
    return hexes


def global_batch(rows: int, features: int, seed: int):
    """The JAX smoke's global batch: ``rows`` feature rows in [0, 1) and
    binary labels, from ``default_rng(seed)``; every process makes all of
    it and keeps its own rows."""
    rng = np.random.default_rng(seed)
    feats = rng.random((rows, features), dtype=np.float32)
    labels = (rng.random((rows, 1)) > 0.5).astype(np.float32)
    return feats, labels


def wgan_draws(rows: int, z_size: int, n_critic: int, seed: int = WGAN_KEY_SEED):
    """The JAX ``WganGpTrainer.train_round``'s draws from ``PRNGKey(seed)``,
    for ``rows`` global rows: ``k_c, k_g = split(key)``; for each critic
    step ``key, sub = split(key)`` (from ``k_c``), ``k_z, k_gp = split(sub)``,
    z ~ N(0, 1) from ``k_z`` and ε ~ U[0, 1) from ``k_gp``; the generator
    step's z from ``k_g``. ``(zs (n, rows, z), epsilons (n, rows, 1), gen_z
    (rows, z))`` as float32 numpy."""
    from gan_deeplearning4j_tpu_torch.runtime import threefry

    k_c, k_g = threefry.split(threefry.PRNGKey(seed))
    key, zs, epsilons = k_c, [], []
    for _ in range(n_critic):
        key, sub = threefry.split(key)
        k_z, k_gp = threefry.split(sub)
        zs.append(threefry.normal(k_z, (rows, z_size), "float32"))
        epsilons.append(threefry.uniform(k_gp, (rows, 1), "float32"))
    return np.stack(zs), np.stack(epsilons), threefry.normal(k_g, (rows, z_size), "float32")


def run_modes(mesh=None, init: Optional[Dict] = None, use_accelerator: bool = False,
              emit=print) -> Dict:
    """The smoke's three modes on ``mesh`` (None: the default group's mesh,
    made on the card or, ``use_accelerator=False``, the CPU), each rank on its
    rows. ``init`` injects numpy params (``{"dis", "critic", "gen"}``; the
    port's own seeded init otherwise). Prints each mode's line through
    ``emit`` and returns ``{mode: {"losses", "checksum", "digests",
    "params"}}`` with ``rank``, ``world`` and ``jax_loaded``; a module-level
    rank program, so ``parallel/launch.py::spawn`` can run it."""
    from gan_deeplearning4j_tpu_torch.interop import params_from_numpy
    from gan_deeplearning4j_tpu_torch.models import mlp_gan
    from gan_deeplearning4j_tpu_torch.models.wgan_gp import WganGpConfig, WganGpTrainer
    from gan_deeplearning4j_tpu_torch.parallel import GraphTrainer, ParameterAveragingTrainer
    from gan_deeplearning4j_tpu_torch.parallel.drill import _numpy
    from gan_deeplearning4j_tpu_torch.runtime.device import (
        pin_deterministic_kernels,
        pin_fp32_precision,
    )
    from gan_deeplearning4j_tpu_torch.runtime.environment import make_mesh

    if mesh is None:
        mesh = make_mesh(use_accelerator=use_accelerator)
    if mesh.device.type == "cuda":
        pin_fp32_precision()
        pin_deterministic_kernels()
    n, dev = mesh.size, mesh.device

    def params(name, graph):
        return None if init is None else params_from_numpy(init[name], dev, graph=graph)

    def local(*arrays, rows=None):
        sl = mesh.rows(arrays[0].shape[0]) if rows is None else rows
        return [torch.from_numpy(np.ascontiguousarray(a[sl])).to(dev) for a in arrays]

    def report(mode, losses, tree):
        hexes = gathered_digests(mesh, tree)
        checksum = hexes[mesh.rank][:CHECKSUM_HEX]
        emit(f"[multihost] mode={mode} "
             + " ".join(f"{k}={v:.6f}" for k, v in losses.items())
             + f" checksum={checksum}")
        out[mode] = {"losses": losses, "checksum": checksum, "digests": hexes,
                     "params": _numpy(tree)}

    out: Dict = {"rank": mesh.rank, "world": n}
    graph = mlp_gan.build_discriminator(mlp_gan.MlpGanConfig(**MLP_SHAPES))

    # -- 1. the per-step gradient mean over the mesh --------------------------
    trainer = GraphTrainer(graph, mesh=mesh)
    state = trainer.init_state(params=params("dis", graph))
    feats, labels = global_batch(2 * n, MLP_SHAPES["num_features"], seed=1)
    state, loss = trainer.train_step(state, *local(feats, labels))
    report("pmean", {"loss": float(loss)}, state.params)

    # -- 2. one averaging round (FREQ local steps, then the mean) -------------
    pa = ParameterAveragingTrainer(graph, mesh, batch_size_per_worker=PER_WORKER,
                                   averaging_frequency=FREQ)
    pa_state = pa.init_state(params=params("dis", graph))
    feats, labels = global_batch(n * FREQ * PER_WORKER, MLP_SHAPES["num_features"], seed=2)
    # the round's rows are worker-major: the trainer takes this rank's block
    pa_state, losses = pa.fit_round(pa_state, feats, labels)
    gathered_digests(mesh, pa_state.opt_state)
    report("param_averaging", {"mean_loss": float(losses.mean())}, pa_state.params)

    # -- 3. one WGAN-GP round (critic steps, then the generator step) ---------
    wcfg = WganGpConfig(**WGAN_SHAPES)
    wtr = WganGpTrainer(wcfg, mesh=mesh)
    if init is None:
        critic_state, gen_state = wtr.init_states(seed=0, device=dev)
    else:
        critic_state = wtr.critic_trainer.init_state(params=params("critic", wtr.critic))
        gen_state = wtr.gen_trainer.init_state(params=params("gen", wtr.generator))
    real = np.random.default_rng(3).random((wcfg.n_critic, n, wcfg.num_features),
                                           dtype=np.float32)
    zs, epsilons, gen_z = wgan_draws(n, wcfg.z_size, wcfg.n_critic)
    rows = mesh.rows(n)
    real_local, zs, epsilons = local(real, zs, epsilons, rows=(slice(None), rows))
    (gen_z,) = local(gen_z, rows=rows)
    critic_state, gen_state, c_loss, g_loss = wtr.train_round(
        critic_state, gen_state, real_local, (zs, epsilons, gen_z))
    report("wgan_gp", {"c_loss": float(c_loss), "g_loss": float(g_loss)},
           {"critic": critic_state.params, "gen": gen_state.params})
    out["jax_loaded"] = "jax" in sys.modules
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m gan_deeplearning4j_tpu_torch.parallel.multihost",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--coordinator", required=True, help="host:port of process 0")
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--local-devices", type=int, default=1,
                    help="devices per process: 1 (a process is one rank)")
    ap.add_argument("--platform", default="cpu", choices=("cpu", "gpu"),
                    help="cpu (gloo ranks on the CPU) or gpu (the card)")
    ap.add_argument("--barrier-root", default=None, metavar="DIR",
                    help="shared dir for resilience.mesh file barriers; use a FRESH dir per "
                         "launch (stale arrival markers would satisfy the boot barrier); omit "
                         "to skip the barrier discipline")
    ap.add_argument("--barrier-timeout", type=float, default=240.0,
                    help="bound on each rendezvous and on the store's waits; a barrier's "
                         "expiry exits 3")
    ap.add_argument("--states-dir", default=None, metavar="DIR",
                    help="write this process's losses and params after each mode to "
                         "DIR/process<I>.npz, for a caller that compares runs")
    args = ap.parse_args(argv)
    if args.local_devices != 1:
        ap.error("--local-devices: a process is one rank here; only 1 is accepted")
    if not 0 <= args.process_id < args.num_processes:
        ap.error(f"--process-id {args.process_id} outside --num-processes {args.num_processes}")
    return args


def _write_states(directory: str, process_id: int, result: Dict) -> None:
    flat = {}
    for mode in ("pmean", "param_averaging", "wgan_gp"):
        for key, value in result[mode]["losses"].items():
            flat[f"{mode}/{key}"] = np.float64(value)
        for key, value in _flat(result[mode]["params"]).items():
            flat[f"{mode}/params/{key}"] = value
    path = os.path.join(directory, f"process{process_id}.npz")
    np.savez(path + ".tmp.npz", **flat)
    os.replace(path + ".tmp.npz", path)


def main(argv=None) -> int:
    args = parse_args(argv)
    use_accelerator = args.platform == "gpu"
    if use_accelerator and not torch.cuda.is_available():
        print("[multihost] --platform gpu: no CUDA device is available", file=sys.stderr,
              flush=True)
        return 2
    from gan_deeplearning4j_tpu_torch.resilience.mesh import MeshCoordinator, MeshTimeout

    barrier = None
    if args.barrier_root:
        # sweep=False: the smoke only borrows the barrier; a shared root may
        # hold a live checkpoint gang whose in-flight round a sweep would read
        # as a corpse
        barrier = MeshCoordinator(args.barrier_root, worker=args.process_id,
                                  world_size=args.num_processes, token="smoke",
                                  timeout_s=args.barrier_timeout, sweep=False)

    def rendezvous(name: str) -> None:
        if barrier is None:
            return
        try:
            barrier.barrier(name)
        except MeshTimeout as exc:
            print(f"[multihost] BARRIER TIMEOUT at {name!r}: {exc}", flush=True)
            raise SystemExit(3)

    # boot rendezvous BEFORE the store: a client's wait for a master that
    # was never launched is bounded only by the store's timeout
    rendezvous("boot")
    import torch.distributed as dist

    from gan_deeplearning4j_tpu_torch.runtime.environment import backend_for, make_mesh

    backend = backend_for(args.num_processes, use_accelerator)
    mesh = make_mesh(use_accelerator=use_accelerator, backend=backend,
                     coordinator_address=args.coordinator, num_processes=args.num_processes,
                     process_id=args.process_id, timeout=args.barrier_timeout)
    try:
        # explicit, not an assert: a half-formed group must die before a
        # collective hangs
        if dist.get_world_size() != args.num_processes:
            raise SystemExit(
                f"[multihost] expected {args.num_processes} processes, the group has "
                f"{dist.get_world_size()}: the coordinator / process_id flags disagree with "
                f"the group that formed")
        print(f"[multihost] process {args.process_id}/{args.num_processes} up: 1 local / "
              f"{mesh.size} global devices, platform={args.platform} backend={mesh.backend} "
              f"device={mesh.device}", flush=True)
        result = run_modes(mesh, emit=lambda line: print(line, flush=True))
        if args.states_dir:
            _write_states(args.states_dir, args.process_id, result)
        # done rendezvous: a peer that died after its own modes fails this
        # process too: all N or nobody
        rendezvous("done")
    finally:
        dist.destroy_process_group()
    print(f"[multihost] process {args.process_id} OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
