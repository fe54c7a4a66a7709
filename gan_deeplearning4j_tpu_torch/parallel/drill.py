"""Rank programs for checking data-parallel training: each runs in every
rank of a process group (``parallel/launch.py::spawn``), builds the mesh
over it, drives one scenario from numpy inputs and returns numpy outputs,
so a caller in another process (the CPU tests, which hold them against the
JAX package; ``chip_smoke.py`` on the card) compares them rank by rank.

The rank programs live in the package, not in the tests: a spawned child
imports the module that defines its function, and nothing here imports
JAX. Each result carries ``jax_loaded`` (whether ``jax`` is in the
child's ``sys.modules``) and the rank.

- :func:`graph_steps`: a graph's ``GraphTrainer`` steps on a mesh, each
  rank on its rows of the global batch, and the same steps in this process
  alone at the global batch (no mesh);
- :func:`experiment_run`: an experiment from given states and draws,
  single iterations or one window, then optionally its mesh checkpoint
  shards and a restore;
- :func:`averaging_rounds`: ``ParameterAveragingTrainer.fit_rounds`` on
  worker-major rounds and ``fit`` on a row-major stream;
- :func:`wgan_first_steps`: a WGAN-GP experiment's first critic step and
  generator step, their losses and mesh-mean gradients;
- :func:`load_generation`: a mesh checkpoint directory restored into a
  fresh experiment;
- :func:`stall`: one rank hangs and the others wait for it in a
  collective (what ``spawn``'s timeout is for).
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch

from gan_deeplearning4j_tpu_torch.harness.experiment import flatten_states
from gan_deeplearning4j_tpu_torch.runtime.environment import make_mesh


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        # a copy: the experiment's static buffers change in place later
        t = tree.detach().cpu().clone()
        return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
    return tree


def _result(mesh, **values) -> Dict:
    return {"rank": mesh.rank, "world": mesh.size, "jax_loaded": "jax" in sys.modules,
            **_numpy(values)}


def _state_dict(state) -> Dict:
    return {"params": state.params, "opt_state": state.opt_state, "step": state.step}


def _tree_opt_state(trainer, opt_state):
    """``(tree-form updater state, this rank's resident updater bytes)``."""
    if getattr(trainer, "shard_updates", False):
        return trainer.plan.unpack_state(opt_state), trainer.plan.resident_bytes(opt_state)
    return opt_state, sum(t.numel() * t.element_size()
                          for lp in opt_state.values() for s in lp.values() for t in s.values())


def graph_steps(topology: Dict, params: Dict, features: np.ndarray, labels: np.ndarray,
                steps: int = 3, shard_updates: bool = False, use_accelerator: bool = False) -> Dict:
    """``steps`` mesh steps of the graph from ``params`` on the same global
    batch, replicated and (``shard_updates``) with sharded updates, both
    gradient routes; on rank 0 also the steps of one process at the global
    batch."""
    from gan_deeplearning4j_tpu_torch.interop import params_from_numpy
    from gan_deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from gan_deeplearning4j_tpu_torch.parallel import GraphTrainer

    mesh = make_mesh(use_accelerator=use_accelerator)
    graph = ComputationGraph.from_dict(topology)
    rows = mesh.rows(features.shape[0])

    def run(trainer, x, y):
        state = trainer.init_state(params=params_from_numpy(params, mesh.device, graph=graph))
        xs, ys = (torch.from_numpy(np.ascontiguousarray(a)).to(mesh.device) for a in (x, y))
        losses = []
        for _ in range(steps):
            state, loss = trainer.train_step(state, xs, ys)
            losses.append(loss)
        opt_state, resident = _tree_opt_state(trainer, state.opt_state)
        return {"losses": torch.stack(losses), "resident_bytes": resident,
                "state": {"params": state.params, "opt_state": opt_state, "step": state.step}}

    out = {"pmean": run(GraphTrainer(graph, mesh=mesh), features[rows], labels[rows])}
    if shard_updates:
        out["sharded_reduce_scatter"] = run(
            GraphTrainer(graph, mesh=mesh, shard_updates=True, exact_grads=False),
            features[rows], labels[rows])
        trainer = GraphTrainer(graph, mesh=mesh, shard_updates=True)
        out["sharded"] = run(trainer, features[rows], labels[rows])
        # the plan's packing: tree → rows → tree, and the fresh rows
        plan = trainer.plan
        start = params_from_numpy(params, mesh.device, graph=graph)
        g = torch.Generator().manual_seed(0)  # the same tree on every rank
        tree = {layer: {n: {f: (torch.randn(t.shape, generator=g) if t.is_floating_point()
                                else torch.randint(0, 100, t.shape, generator=g)).to(t)
                            for f, t in fields.items()}
                        for n, fields in lp.items()}
                for layer, lp in plan.base.init(start).items()}
        back = plan.unpack_state(plan.pack_state(tree))
        fresh, packed_init = plan.init_packed(start), plan.pack_state(plan.base.init(start))
        out["plan"] = {
            "describe": plan.describe(),
            "round_trip": all(torch.equal(back[l][n][f], t) for l, lp in tree.items()
                              for n, fields in lp.items() for f, t in fields.items()),
            "init_packed": all(torch.equal(fresh[g][f], packed_init[g][f])
                               for g in fresh for f in fresh[g]),
            "updater_keys": plan.updater_keys_for_shard(mesh.rank),
            "split_keys": plan.element_split_state_keys(),
        }
    if mesh.rank == 0:
        out["solo"] = run(GraphTrainer(graph), features, labels)
    return _result(mesh, **out)


def _set_states(exp, states: Dict) -> None:
    """Put numpy states (``{model: {"params", "opt_state", "step"}}`` or, for
    the generator of the three-graph families, its params) into ``exp``, on
    its device, in its storage dtype, packed under update sharding."""
    from gan_deeplearning4j_tpu_torch.interop import params_from_numpy, train_state_from_numpy

    if hasattr(exp, "critic_state"):
        models = {"critic": ("critic_state", exp.trainer.critic_trainer),
                  "gen": ("gen_state", exp.trainer.gen_trainer)}
    else:
        models = {"dis": ("dis_state", exp.dis_trainer), "gan": ("gan_state", exp.gan_trainer),
                  "CV": ("cv_state", exp.cv_trainer)}
        exp.gen_params = exp._cast_state(params_from_numpy(states["gen"], exp.device, graph=exp.gen))
    for name, (attr, trainer) in models.items():
        if name in states and trainer is not None:
            state = train_state_from_numpy(states[name], exp.device, graph=trainer.graph)
            setattr(exp, attr, exp._stored(state, trainer))


def experiment_run(config: Dict, states: Optional[Dict], batches: np.ndarray,
                   labels: Optional[np.ndarray] = None, draws: Optional[Dict] = None,
                   window: bool = False, shards_dir: Optional[str] = None,
                   restore: bool = False, solo: bool = False, warm: int = 0,
                   timed: int = 0) -> Dict:
    """An experiment of ``config`` (an ``ExperimentConfig`` dict) on the mesh
    from ``states`` (None: its own init), trained on the global batches
    ``batches`` ``(K, B, F)`` one iteration at a time, or as one window.
    ``draws`` maps a step to the global draws (``z_source``'s, by dis step;
    WGAN-GP's ``draw_source`` triple, by generator step). With
    ``shards_dir`` every rank then writes its mesh checkpoint shard there
    and, with ``restore``, a fresh experiment loads the generation and
    takes the same K iterations again from it, as the first one does.
    With ``solo`` rank 0 also runs the same iterations alone at the global
    batch (no mesh). With
    ``timed``, ``warm`` then ``timed`` more iterations on the last batch,
    each timed by the host clock to the device's end, and the host seconds
    of the collectives' host staging among them."""
    from gan_deeplearning4j_tpu_torch.harness import ExperimentConfig, make_experiment

    cfg = ExperimentConfig(**config)
    mesh = make_mesh(use_accelerator=cfg.use_accelerator)

    def build(c=cfg, on=mesh):
        exp = make_experiment(c, mesh=on)
        if states is not None:
            _set_states(exp, states)
        if draws is not None:
            if hasattr(exp, "critic_state"):
                exp.draw_source = lambda step, n_critic, rows: draws[step]
            else:
                exp.z_source = lambda step, n: draws[step]
        return exp

    def train(exp):
        t0 = time.perf_counter()
        if window:
            out = exp.train_iterations(batches, labels)
            losses = [{k: v[i] for k, v in out.items()} for i in range(batches.shape[0])]
        else:
            losses = [exp.train_iteration(batches[i], None if labels is None else labels[i])
                      for i in range(batches.shape[0])]
        losses = [{k: float(v) for k, v in row.items()} for row in losses]
        return losses, time.perf_counter() - t0

    exp = build()
    losses, seconds = train(exp)
    result = {"losses": losses, "seconds": seconds,
              "states": _numpy(flatten_states(exp.digest_states())),
              "resident_bytes": _resident(exp)}
    if solo and mesh.rank == 0:
        # the same iterations in this process alone, at the global batch
        alone = build(dataclasses.replace(cfg, distributed="none", update_sharding=False), None)
        result["solo_losses"], _ = train(alone)
        result["solo_states"] = _numpy(flatten_states(alone.digest_states()))
    if shards_dir is not None:
        result["shard_files"] = exp.save_model_shard(shards_dir, mesh.rank, mesh.size)
        mesh.barrier()
        if restore:
            again = build()
            again.load_models(shards_dir)
            result["restored"] = _numpy(flatten_states(again.digest_states()))
            result["restored_losses"], _ = train(again)
            result["restored_then"] = flatten_states(again.digest_states())
            result["continued_losses"], _ = train(exp)
            result["continued"] = flatten_states(exp.digest_states())
    if timed:
        from gan_deeplearning4j_tpu_torch.parallel import collectives

        def one():
            exp.train_iteration(batches[-1], None if labels is None else labels[-1])
            if exp.device.type == "cuda":
                torch.cuda.synchronize(exp.device)

        for _ in range(warm):
            one()
        collectives.reset_staging()
        spent = []
        for _ in range(timed):
            t0 = time.perf_counter()
            one()
            spent.append(time.perf_counter() - t0)
        result["iteration_s"] = spent
        result["staging"] = dict(collectives.STAGING)
    return _result(mesh, **result)


def _resident(exp) -> int:
    """This rank's resident updater bytes over the experiment's models."""
    if hasattr(exp, "critic_state"):
        models = [(exp.trainer.critic_trainer, exp.critic_state),
                  (exp.trainer.gen_trainer, exp.gen_state)]
    else:
        models = [(exp.dis_trainer, exp.dis_state), (exp.gan_trainer, exp.gan_state),
                  (exp.cv_trainer, exp.cv_state)]
    total = 0
    for trainer, state in models:
        if trainer is not None:
            if getattr(trainer, "shard_updates", False):
                total += trainer.plan.resident_bytes(state.opt_state)
            else:
                total += _tree_opt_state(trainer, state.opt_state)[1]
    return total


def wgan_first_steps(config: Dict, batch: np.ndarray) -> Dict:
    """Loss and mesh-mean gradients of a WGAN-GP experiment's first critic
    step and of a generator step, at its initial state and its first
    round's draws, on this rank's rows of the global ``batch``."""
    from gan_deeplearning4j_tpu_torch.harness import ExperimentConfig, make_experiment
    from gan_deeplearning4j_tpu_torch.runtime import compute_dtype_scope

    cfg = ExperimentConfig(**config)
    mesh = make_mesh(use_accelerator=cfg.use_accelerator)
    exp = make_experiment(cfg, mesh=mesh)
    local = exp._local_rows(torch.as_tensor(batch)[None], batch.shape[0])[0]
    batches = exp._critic_batches(exp._to_device(local))
    rows = batches.shape[1]
    zs, epsilons, gen_z = exp._unpack_draws(
        exp._to_device(exp._step_draws(int(exp.gen_state.step), rows)), rows)
    trainer = exp.trainer
    with compute_dtype_scope(exp._compute_dtype):
        c_loss, c_grads = trainer.critic_grads(exp.critic_state.params, exp.gen_state.params,
                                               batches[0], zs[0], epsilons[0])
        c_grads, c_loss = trainer.critic_trainer.reduce(c_grads, c_loss)
        g_loss, g_grads, _ = trainer.gen_grads(exp.gen_state.params, exp.critic_state.params, gen_z)
        g_grads, g_loss = trainer.gen_trainer.reduce(g_grads, g_loss)
    return _result(mesh, losses={"critic": float(c_loss), "gen": float(g_loss)},
                   grads={"critic": c_grads, "gen": g_grads})


def load_generation(config: Dict, directory: str) -> Dict:
    """A fresh experiment of ``config`` on the mesh, restored from the mesh
    checkpoint (or whole-file) directory ``directory``."""
    from gan_deeplearning4j_tpu_torch.harness import ExperimentConfig, make_experiment

    cfg = ExperimentConfig(**config)
    mesh = make_mesh(use_accelerator=cfg.use_accelerator)
    exp = make_experiment(cfg, mesh=mesh)
    step = exp.load_models(directory)
    return _result(mesh, step=step, states=flatten_states(exp.digest_states()))


def averaging_rounds(topology: Dict, params: Dict, rounds_x: np.ndarray, rounds_y: np.ndarray,
                     freq: int, batch: int, stream_x: Optional[np.ndarray] = None,
                     stream_y: Optional[np.ndarray] = None, stream_batch: int = 8,
                     use_accelerator: bool = False) -> Dict:
    """``fit_rounds`` over ``(K, workers·freq·batch)`` worker-major rounds,
    and (given a row-major stream) ``fit`` over it in ``stream_batch``-row
    batches from the same start."""
    from gan_deeplearning4j_tpu_torch.data import ArrayDataSetIterator
    from gan_deeplearning4j_tpu_torch.interop import params_from_numpy
    from gan_deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from gan_deeplearning4j_tpu_torch.parallel import ParameterAveragingTrainer

    mesh = make_mesh(use_accelerator=use_accelerator)
    graph = ComputationGraph.from_dict(topology)
    trainer = ParameterAveragingTrainer(graph, mesh, batch_size_per_worker=batch,
                                        averaging_frequency=freq)
    state = trainer.init_state(params=params_from_numpy(params, mesh.device, graph=graph))
    state, losses = trainer.fit_rounds(state, rounds_x, rounds_y)
    out = {"losses": losses, "state": _state_dict(state)}
    if stream_x is not None:
        state = trainer.init_state(params=params_from_numpy(params, mesh.device, graph=graph))
        state, fit_losses = trainer.fit(
            state, ArrayDataSetIterator(stream_x, stream_y, batch_size=stream_batch))
        out["fit"] = {"losses": np.asarray(fit_losses), "state": _state_dict(state)}
    return _result(mesh, **out)


def stall(seconds: float = 3600.0) -> Dict:
    """The last rank hangs for ``seconds``; every other rank waits for it in
    an all-reduce."""
    mesh = make_mesh(use_accelerator=False)
    if mesh.rank == mesh.size - 1:
        time.sleep(seconds)
    torch.distributed.all_reduce(torch.zeros(1))
    return _result(mesh)


def run_all(scenarios: Dict) -> Dict:
    """Every scenario in one process group, in order: ``{name: (function
    name of this module, kwargs)}`` → ``{name: result}``."""
    return {name: globals()[fn](**kwargs) for name, (fn, kwargs) in scenarios.items()}
