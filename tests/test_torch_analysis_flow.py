"""torchlint's last eight counterpart rules: the flow through calls, modules,
pipelines and meshes (JG010-JG014, JG018-JG020).

- each rule: true positives showing its hazard in torch code, and true
  negatives in the port's own idiom (the sites named in each rule's
  docstring and ``analysis/CATALOGUE.md``); JG010 and JG014 also through
  two modules, JG010 also through a ``functools.partial``;
- the registries: the port's codes are the JAX package's 32;
- the project index's three facts the rules read (replayers, seeding
  parameters, the synchronous-I/O taint);
- ``chip_smoke.py`` (aa3): the analyzer's half of the pairs it runs on the
  card;
- the port and ``chip_smoke.py`` read once, in a module-scoped fixture:
  none of the eight rules finds anything there.
"""

import os
import sys

import pytest

from gan_deeplearning4j_tpu.analysis.rules import RULES_BY_CODE as JAX_RULES
from gan_deeplearning4j_tpu_torch.analysis import analyze_paths, analyze_sources, load_baseline
from gan_deeplearning4j_tpu_torch.analysis.engine import parse_module
from gan_deeplearning4j_tpu_torch.analysis.project import build_index
from gan_deeplearning4j_tpu_torch.analysis.rules import RULES_BY_CODE

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLOW_CODES = ("JG010", "JG011", "JG012", "JG013", "JG014", "JG018", "JG019", "JG020")
HEADER = ("import functools\n"
          "import os\n"
          "import time\n"
          "import torch\n"
          "import torch.distributed as dist\n"
          "from gan_deeplearning4j_tpu_torch.runtime.capture import capture_guard\n")


def codes(report):
    return [f.code for f in report.active]


def run(src, path="fx/mod.py"):
    return analyze_sources({path: HEADER + src})


def run_many(sources):
    return analyze_sources({path: HEADER + src for path, src in sources.items()})


def index_of(sources):
    return build_index([parse_module(HEADER + src, path) for path, src in sources.items()])


# ===========================================================================
# the registries and the index
# ===========================================================================

def test_the_port_registry_has_the_jax_registrys_codes():
    assert set(RULES_BY_CODE) == set(JAX_RULES)
    assert len(RULES_BY_CODE) == 32
    assert set(FLOW_CODES) <= set(RULES_BY_CODE)


HELPER = """
X = Y = GRAPH = None


def _capture(device):
    global X, Y, GRAPH
    X = torch.zeros(4, device=device)
    GRAPH = torch.cuda.CUDAGraph()
    with capture_guard(), torch.cuda.graph(GRAPH):
        Y = X * 2


def run(v, device="cuda:0"):
    if GRAPH is None:
        _capture(device)
    X.fill_(v)
    GRAPH.replay()
    return {ret}


class Doubled:
    def __init__(self, device):
        self.x = torch.zeros(4, device=device)
        self.graph = torch.cuda.CUDAGraph()
        with capture_guard(), torch.cuda.graph(self.graph):
            self.y = self.x * 2


def replay(cap, v):
    cap.x.copy_(v)
    cap.graph.replay()
    return cap.{attr}


def replay_into(cap, v, out):
    cap.x.copy_(v)
    cap.graph.replay()
    out.copy_(cap.y)
    return out


double = functools.partial(run, device="cuda:0")
"""


class TestIndexFacts:
    def test_replayers_and_their_buffer_params(self):
        idx = index_of({"h.py": HELPER.format(ret="Y", attr="y[:2]")})
        fns = idx.modules["h"].functions
        assert {q for q, s in fns.items() if s.replayer} == {"run", "replay"}
        assert fns["replay"].buffer_params == (0,) and fns["run"].buffer_params == ()
        assert idx.modules["h"].captured_attrs == {"y"}
        assert idx.modules["h"].captured_globals == {"Y"}
        assert idx.modules["h"].replayer_aliases == {"double": "h.run"}

    def test_a_copy_makes_no_replayer(self):
        idx = index_of({"h.py": HELPER.format(ret="Y.clone()", attr="y.clone()")})
        assert not any(s.replayer for s in idx.modules["h"].functions.values())
        assert idx.modules["h"].replayer_aliases == {}

    def test_seeding_params_direct_conditional_and_handed_down(self):
        idx = index_of({"s.py": """
def init(seed=None, cfg_seed=666):
    g = torch.Generator().manual_seed(cfg_seed if seed is None else seed)
    return torch.randn(3, generator=g)


def noise(n, seed):
    torch.manual_seed(int(seed))
    return torch.randn(n)


def build(n, s):
    return noise(n, s), init(seed=s)


def mixed(seed, step):
    g = torch.Generator().manual_seed(seed + step)
    return torch.randn(2, generator=g)
"""})
        fns = idx.modules["s"].functions
        got = {q: sorted(idx.seeding_params(s)) for q, s in fns.items()}
        assert got == {"init": ["cfg_seed", "seed"], "noise": ["seed"], "build": ["s"],
                       "mixed": []}

    def test_sync_io_taint_writes_only(self):
        idx = index_of({"w.py": """
def read(path):
    with open(path) as fh:
        return fh.read()


def write(path, blob):
    with open(path, mode="wb") as fh:
        fh.write(blob)
        os.fsync(fh.fileno())


def publish(path, blob):
    write(path + ".tmp", blob)


def probe(url):
    import urllib.request
    return urllib.request.urlopen(url, timeout=1)
"""})
        fns = idx.modules["w"].functions
        assert {q: idx.io_tainted(s) for q, s in fns.items()} == {
            "read": False, "write": True, "publish": True, "probe": True}


# ===========================================================================
# JG010 — a replayer's static output held across a second call
# ===========================================================================

class TestStaticOutputAcrossCalls:
    CALLER = """
from h import {name} as step


def main(device):
    a = step(1)
    step(3)
    return float(a[0])
"""

    def test_true_positive_imported_replayer_through_a_partial(self):
        # chip_smoke (aa3)'s shape: the caller wraps the imported helper
        r = run_many({"h.py": HELPER.format(ret="Y", attr="y"), "c.py": """
from h import run


def main(device):
    double = functools.partial(run, device=device)
    a = double(1)
    double(3)
    return float(a[0])
"""})
        assert codes(r) == ["JG010"]
        assert r.active[0].path == "c.py" and "h.run" in r.active[0].message

    def test_true_positive_attribute_output_and_an_imported_alias(self):
        r = run_many({"h.py": HELPER.format(ret="Y", attr="y"), "c.py": """
from h import replay


def main(cap):
    a = replay(cap, 1)
    replay(cap, 3)
    return float(a[0])
"""})
        assert codes(r) == ["JG010"]
        r = run_many({"h.py": HELPER.format(ret="Y", attr="y"),
                      "c.py": self.CALLER.format(name="double")})
        assert codes(r) == ["JG010"]

    def test_true_positive_partial_binding_the_graphs_buffers(self):
        r = run_many({"h.py": HELPER.format(ret="Y", attr="y"), "c.py": """
from h import Doubled, replay


def main(device):
    cap = Doubled(device)
    step = functools.partial(replay, cap)
    return step(1)
"""})
        assert codes(r) == ["JG010"]
        assert "binds `replay`'s argument `cap`" in r.active[0].message

    def test_true_negative_copies_in_the_helper_or_at_the_call(self):
        r = run_many({"h.py": HELPER.format(ret="Y.clone()", attr="y.clone()"),
                      "c.py": self.CALLER.format(name="run")})
        assert codes(r) == []
        r = run_many({"h.py": HELPER.format(ret="Y", attr="y"), "c.py": """
from h import run


def main(device):
    a = run(1).clone()
    b = run(3)
    return float(a[0]) + float(b[0])
"""})
        assert codes(r) == []

    def test_true_negative_engine_and_drill_shapes(self):
        # serving/engine.py's launch copies the static output out under the
        # replay lock; resilience/drill.py's one partial is over no replayer
        r = run_many({"h.py": HELPER.format(ret="Y", attr="y"), "c.py": """
from h import replay_into


def digests(shape, src):
    return [shape, src]


def main(cap, shapes):
    out = torch.empty(4)
    a = replay_into(cap, 1, out.clone())
    b = replay_into(cap, 3, out.clone())
    found = [functools.partial(digests, shape) for shape in shapes]
    return float(a[0]) + float(b[0]), found
"""})
        assert codes(r) == []

    def test_true_negative_read_before_the_second_call(self):
        r = run_many({"h.py": HELPER.format(ret="Y", attr="y"), "c.py": """
from h import run


def main():
    a = run(1)
    first = float(a[0])
    a = run(3)
    return first, float(a[0])
"""})
        assert codes(r) == []

    def test_one_defect_one_code(self):
        # an alias read after a later replay in the capturing function is
        # JG006's; JG010 does not report it again
        r = run("""
def main(device):
    x = torch.ones(4, device=device)
    graph = torch.cuda.CUDAGraph()
    with capture_guard(), torch.cuda.graph(graph):
        y = x * 2
    graph.replay()
    a = y
    x.fill_(3)
    graph.replay()
    return float(a[0])
""")
        assert codes(r) == ["JG006"]


# ===========================================================================
# JG014 — one seed handed to two seeding helpers
# ===========================================================================

SEEDERS = """
def init_params(shape, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g)


def draw_noise(n, seed=None):
    g = torch.Generator().manual_seed(0 if seed is None else seed)
    return torch.rand(n, generator=g)


def build(shape, s):
    return init_params(shape, s)


def step_generator(seed, step):
    import numpy as np
    state = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(state))
"""


class TestSeedHandedToTwoHelpers:
    def test_true_positive_one_seed_two_helpers_across_modules(self):
        r = run_many({"seeders.py": SEEDERS, "train.py": """
from seeders import draw_noise, init_params


def main(cfg_seed):
    w = init_params((4, 4), cfg_seed)
    z = draw_noise(64, seed=cfg_seed)
    return w, z
"""})
        assert codes(r) == ["JG014"]
        assert r.active[0].path == "train.py" and "cfg_seed" in r.active[0].message

    def test_true_positive_helper_and_direct_and_handed_down(self):
        r = run_many({"seeders.py": SEEDERS, "train.py": """
from seeders import build, draw_noise


def main(seed):
    w = build((4, 4), seed)
    torch.manual_seed(seed)
    return w, torch.randn(3)
"""})
        assert codes(r) == ["JG014"]

    def test_true_positive_hand_off_in_a_loop(self):
        r = run_many({"seeders.py": SEEDERS, "train.py": """
from seeders import draw_noise


def main(seed, steps):
    out = []
    for step in range(steps):
        out.append(draw_noise(64, seed))
    return out
"""})
        assert codes(r) == ["JG014"]
        assert "inside a loop" in r.active[0].message

    def test_true_negative_distinct_seeds_rebinds_and_step_keys(self):
        r = run_many({"seeders.py": SEEDERS, "train.py": """
from seeders import draw_noise, init_params, step_generator


def main(seed, steps):
    w = init_params((4, 4), seed)
    z = draw_noise(64, seed + 1)
    seed = seed + 2
    y = draw_noise(8, seed)
    draws = [draw_noise(64, seed + step) for step in range(steps)]
    for step in range(steps):
        draws.append(draw_noise(64, seed * 1000 + step))
        g1, g2 = step_generator(seed, step), step_generator(seed, step + 1)
    return w, z, y, draws
"""})
        assert codes(r) == []

    def test_true_negative_the_ports_own_seeding(self):
        # nn/graph.py::init and parallel/drill.py: one generator seeded once
        # for every draw; a method of an object is not resolved
        r = run_many({"seeders.py": SEEDERS, "train.py": """
def main(graph, cfg):
    params = graph.init(cfg.seed)
    gen = graph.init(cfg.seed)
    g = torch.Generator().manual_seed(0)
    a, b = torch.randn(3, generator=g), torch.randn(3, generator=g)
    return params, gen, a, b
"""})
        assert codes(r) == []

    def test_true_negative_direct_pairs_are_jg001s_and_tests_are_exempt(self):
        r = run("""
def main(seed):
    g1 = torch.Generator().manual_seed(seed)
    g2 = torch.Generator().manual_seed(seed)
    return torch.randn(2, generator=g1), torch.randn(2, generator=g2)
""")
        assert codes(r) == ["JG001"]
        r = run_many({"seeders.py": SEEDERS, "tests/test_seeders.py": """
from seeders import draw_noise, init_params


def test_same_seed_same_draws():
    assert torch.equal(draw_noise(4, 7), draw_noise(4, 7))
"""})
        assert codes(r) == []


# ===========================================================================
# JG019 — host sync in a prefetch transform, consumed in a timed window
# ===========================================================================

PIPE = """
from gan_deeplearning4j_tpu_torch.data.iterator import ArrayDataSetIterator, DevicePrefetchIterator


def steps(it, a):
    while it.has_next():
        a = a @ it.next().features


def main(features, a, level):
    inner = ArrayDataSetIterator(features, batch_size=8)
    it = DevicePrefetchIterator(inner, depth=2{transform})
    t0 = time.perf_counter()
{consume}    torch.cuda.synchronize()
    return time.perf_counter() - t0
"""
LOOP = ("    while it.has_next():\n"
        "        a = a @ it.next().features\n")


class TestHostSyncInPrefetchTransform:
    def test_true_positive_lambda_reads_item(self):
        r = run(PIPE.format(transform=", transform=lambda b: (level.item(), b)[1]",
                            consume=LOOP))
        assert codes(r) == ["JG019"]
        assert "DevicePrefetchIterator" in r.active[0].snippet

    def test_true_positive_a_read_two_calls_down_and_the_pipeline_handed_on(self):
        r = run_many({"probe.py": """
def _norm(batch):
    return float(batch.features.norm().cpu())


def log_norm(batch):
    _norm(batch)
    return batch
""", "train.py": PIPE.format(transform=", transform=log_norm",
                              consume="    steps(it, a)\n")
                 .replace("def main(", "from probe import log_norm\n\n\ndef main(")})
        assert codes(r) == ["JG019"]

    def test_true_negative_no_transform_and_a_host_transform(self):
        # harness/experiment.py: DevicePrefetchIterator(train_iterator,
        # depth=cfg.prefetch, device=self.device, mesh=mesh)
        assert codes(run(PIPE.format(transform="", consume=LOOP))) == []
        r = run("""
import numpy as np


def scale(batch):
    batch.features = np.clip(batch.features, 0, 1)
    return batch
""" + PIPE.format(transform=", transform=scale", consume=LOOP))
        assert codes(r) == []

    def test_true_negative_tainted_pipeline_consumed_outside_the_window(self):
        r = run(PIPE.format(transform=", transform=lambda b: (level.item(), b)[1]",
                            consume="")
                .replace("    t0 = time.perf_counter()\n", LOOP + "    t0 = time.perf_counter()\n"))
        assert codes(r) == []


# ===========================================================================
# JG020 — synchronous host I/O on a timed replay path
# ===========================================================================

REPLAYS = """
def _write(path, blob):
    with open(path, "wb") as fh:
        fh.write(blob)
        os.fsync(fh.fileno())


def log_step(directory, step, blob):
    _write(os.path.join(directory, "step.bin"), blob)


def main(graph, directory, blob, steps):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for step in range(steps):
        graph.replay()
{io}    torch.cuda.synchronize()
    return time.perf_counter() - t0
"""


class TestSyncIoOnTimedReplayPath:
    def test_true_positive_write_two_calls_down(self):
        r = run(REPLAYS.format(io="        log_step(directory, step, blob)\n"))
        assert codes(r) == ["JG020"]
        assert "log_step" in r.active[0].message

    def test_true_positive_direct_open_with_matmuls(self):
        r = run("""
def main(a, path):
    t0 = time.perf_counter()
    for _ in range(4):
        b = a @ a
        with open(path, "a") as fh:
            fh.write("step")
    torch.cuda.synchronize()
    return time.perf_counter() - t0
""")
        assert codes(r) == ["JG020"]

    def test_true_negative_no_io_a_read_and_io_after_the_window(self):
        assert codes(run(REPLAYS.format(io=""))) == []
        r = run(REPLAYS.format(io="        open(directory).close()\n"))
        assert codes(r) == []
        r = run(REPLAYS.format(io="").replace(
            "    return time.perf_counter() - t0\n",
            "    seconds = time.perf_counter() - t0\n"
            "    log_step(directory, 0, blob)\n"
            "    return seconds\n"))
        assert codes(r) == []

    def test_true_negative_a_phase_timer_around_helpers(self):
        # chip_smoke.py's phase seconds and the drills' phase timers: the
        # window calls helpers that train and publish, and measures no step
        # (the rule's first pass over the port flagged 28 such windows)
        r = run(REPLAYS.format(io="") + """

def train(graph, steps):
    for _ in range(steps):
        graph.replay()


def phase(graph, directory, blob):
    t0 = time.perf_counter()
    train(graph, 4)
    log_step(directory, 0, blob)
    torch.cuda.synchronize()
    return {"seconds": time.perf_counter() - t0}
""")
        assert codes(r) == []

    def test_true_negative_timed_io_without_device_work(self):
        # resilience/supervisor.py::_publish times the store's publish on
        # purpose; no step runs in its window
        r = run("""
def _write(path, blob):
    with open(path, "wb") as fh:
        fh.write(blob)
        os.fsync(fh.fileno())


class Supervisor:
    def _publish(self, step, blob):
        t0 = time.perf_counter()
        _write(f"gen{step}", blob)
        self.publish_s = time.perf_counter() - t0
""")
        assert codes(r) == []


# ===========================================================================
# JG013 — a collective over a group the mesh did not make
# ===========================================================================

class TestCollectiveOffTheMesh:
    def test_true_positive_default_group_under_a_sub_mesh(self):
        r = run("""
from gan_deeplearning4j_tpu_torch.runtime.environment import DataMesh


def main(t, device):
    pair = dist.new_group([0, 1])
    mesh = DataMesh(group=pair, rank=0, size=2, device=device, backend="nccl")
    dist.all_reduce(t)
    dist.all_reduce(t, group=mesh.group)
    return t
""")
        assert codes(r) == ["JG013"]
        assert "default group" in r.active[0].message

    def test_true_positive_a_new_group_no_mesh_was_built_on(self):
        r = run("""
from gan_deeplearning4j_tpu_torch.runtime.environment import make_mesh


def main(t):
    mesh = make_mesh(use_accelerator=False)
    evens = dist.new_group([0, 2])
    dist.broadcast(t, src=0, group=evens)
    return t
""")
        assert codes(r) == ["JG013"]

    def test_true_positive_a_dimension_the_mesh_lacks(self):
        r = run("""
from torch.distributed.device_mesh import init_device_mesh


def main(t):
    mesh = init_device_mesh("cuda", (2, 2), mesh_dim_names=("dp", "tp"))
    dist.all_reduce(t, group=mesh.get_group("pp"))
    dist.barrier()
    return mesh["dp"]
""")
        assert sorted(codes(r)) == ["JG013", "JG013"]

    def test_true_negative_the_ports_collectives_and_world_meshes(self):
        # parallel/collectives.py: group=mesh.group with the mesh a parameter;
        # runtime/environment.py: DataMesh(group=None) is the world's
        r = run("""
from gan_deeplearning4j_tpu_torch.runtime.environment import DataMesh, make_mesh
from torch.distributed.device_mesh import init_device_mesh


def all_reduce_(tensor, mesh, op=dist.ReduceOp.SUM):
    dist.all_reduce(tensor, op=op, group=mesh.group)
    return tensor


def world(t, device):
    mesh = DataMesh(group=None, rank=0, size=4, device=device, backend="gloo")
    dist.all_reduce(t)
    dist.barrier(group=mesh.group)
    return t


def sub(t, device):
    pair = dist.new_group([0, 1])
    mesh = DataMesh(group=pair, rank=0, size=2, device=device, backend="nccl")
    dist.all_reduce(t, group=pair)
    flat = init_device_mesh("cuda", (4,), mesh_dim_names=("dp",))
    dist.all_reduce(t)
    return mesh, flat["dp"]
""")
        assert codes(r) == []


# ===========================================================================
# JG018 — params and their updater state placed on different partitions
# ===========================================================================

PLACED = """
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor


def main(mesh, other, params, opt_state, rows):
    p = distribute_tensor(params, mesh, [{param}])
    o = distribute_tensor(opt_state, {mesh}, [{updater}])
    updater_rows = DTensor.from_local(rows, mesh, placements=[{updater}])
    return p, o, updater_rows
"""


class TestStatePlacementMismatch:
    def test_true_positive_replicated_params_sharded_state(self):
        r = run(PLACED.format(param="Replicate()", updater="Shard(0)", mesh="mesh"))
        assert codes(r) == ["JG018", "JG018"]
        assert "[Shard(0)]" in r.active[0].message and "[Replicate()]" in r.active[0].message

    def test_true_positive_named_by_the_assignment(self):
        r = run("""
from torch.distributed.tensor import Replicate, Shard, distribute_tensor


def main(mesh, w, m):
    gen_params = distribute_tensor(w, mesh, (Shard(0),))
    rms_updater = distribute_tensor(m, mesh, (Shard(1),))
    return gen_params, rms_updater
""")
        assert codes(r) == ["JG018"]

    def test_true_negative_agreeing_placements_other_meshes_and_unknowns(self):
        assert codes(run(PLACED.format(param="Shard(0)", updater="Shard(0)", mesh="mesh"))) == []
        r = run(PLACED.format(param="Replicate()", updater="Shard(0)", mesh="other")
                .replace("    updater_rows = DTensor.from_local(rows, mesh, placements=[Shard(0)])\n",
                         "    updater_rows = DTensor.from_local(rows, mesh, placements=spec)\n")
                .replace("rows):", "rows, spec=None):"))
        assert codes(r) == []

    def test_true_negative_the_update_sharding_plan(self):
        # parallel/update_sharding.py keys a slot's updater rows to its
        # param's owner (assign[anchor]): nothing placed by literals
        r = run("""
def plan_rows(params, assign, anchor, mesh):
    rows = {key: assign[anchor] for key in params}
    return [r for r in rows.values() if r == mesh.rank]
""")
        assert codes(r) == []
        r = analyze_sources({"tests/test_placed.py": HEADER + PLACED.format(
            param="Replicate()", updater="Shard(0)", mesh="mesh")})
        assert codes(r) == []


# ===========================================================================
# JG011 — torch.vmap in_dims that provably mismatch
# ===========================================================================

class TestVmapInDimsMismatch:
    def test_true_positive_arity_of_a_function_a_module_away(self):
        r = run_many({"losses.py": """
def pair_loss(x, y):
    return (x - y).pow(2).sum()
""", "train.py": """
from losses import pair_loss


def main(x, y, w):
    return torch.vmap(pair_loss, in_dims=(0, 0, None))(x, y, w)
"""})
        assert codes(r) == ["JG011"]
        assert "takes 2 positional" in r.active[0].message

    def test_true_positive_call_arity_and_mapped_sizes(self):
        r = run("""
def main(f):
    a = torch.zeros(4, 3)
    b = torch.randn((8, 3))
    per_row = torch.func.vmap(f, in_dims=(0, 0))
    c = per_row(a)
    return c, torch.vmap(f)(a, b)
""")
        assert codes(r) == ["JG011", "JG011"]
        assert any("`a` dim 0 has size 4, `b` dim 0 has size 8" in f.message for f in r.active)

    def test_true_negative_matching_defaults_varargs_and_none(self):
        r = run("""
def f(x, y, scale=1.0):
    return x * y * scale


def g(*xs):
    return sum(xs)


def main():
    a = torch.zeros(4, 3)
    b = torch.ones(4, 5)
    w = torch.ones(7)
    return (torch.vmap(f, in_dims=(0, 0))(a, a), torch.vmap(f, in_dims=(0, 0, None))(a, a, 2.0),
            torch.vmap(g, in_dims=(0, 0, 0, 0))(a, a, a, a), torch.vmap(f, in_dims=(0, None))(a, w),
            torch.vmap(f, in_dims=(1, 0))(b, torch.zeros(3, 5)), torch.vmap(f)(a, b))
""")
        assert codes(r) == []


# ===========================================================================
# JG012 — an in-place collective's input read afterwards as the local value
# ===========================================================================

class TestInPlaceCollectiveReadAsLocal:
    def test_true_positive_alias_read_after_all_reduce(self):
        r = run("""
def main(loss):
    local = loss.detach()
    dist.all_reduce(loss)
    return local.item(), loss.item()
""")
        assert codes(r) == ["JG012"]
        assert "`local` aliases `loss`" in r.active[0].message

    def test_true_positive_the_ports_wrapper_and_a_view(self):
        r = run("""
from gan_deeplearning4j_tpu_torch.parallel.collectives import all_reduce_


def main(flat, mesh, n):
    head = flat[:n]
    all_reduce_(flat, mesh)
    return head.sum()
""")
        assert codes(r) == ["JG012"]

    def test_true_positive_async_handles(self):
        r = run("""
def discarded(t):
    dist.all_reduce(t, async_op=True)
    return t


def early(t):
    work = dist.all_reduce(t, async_op=True)
    total = t.sum()
    work.wait()
    return total
""")
        assert codes(r) == ["JG012", "JG012"]

    def test_true_negative_clone_packed_and_waited(self):
        # parallel/collectives.py::_packed reads the reduced buffer on purpose;
        # ops/norm.py's all_reduce_sum reduces a copy
        r = run("""
from gan_deeplearning4j_tpu_torch.parallel.collectives import all_reduce_


def local_and_mean(loss):
    local = loss.clone()
    dist.all_reduce(loss)
    return local.item(), loss.item()


def _packed(tensors, mesh, op):
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    all_reduce_(flat, mesh, op)
    return [flat[:t.numel()].view(t.shape) for t in tensors]


def waited(t):
    work = dist.all_reduce(t, async_op=True)
    work.wait()
    return t.sum()
""")
        assert codes(r) == []


# ===========================================================================
# coverage, the chip's pairs, the clean tree
# ===========================================================================

#: code -> the class holding its true positives and true negatives
FLOW_COUNTERPARTS = {
    "JG010": TestStaticOutputAcrossCalls, "JG011": TestVmapInDimsMismatch,
    "JG012": TestInPlaceCollectiveReadAsLocal, "JG013": TestCollectiveOffTheMesh,
    "JG014": TestSeedHandedToTwoHelpers, "JG018": TestStatePlacementMismatch,
    "JG019": TestHostSyncInPrefetchTransform, "JG020": TestSyncIoOnTimedReplayPath,
}


@pytest.mark.parametrize("code", ["JG010", "JG019", "JG020"])
def test_the_chip_flow_pairs_fire_and_stay_silent(code):
    # chip_smoke.py (aa3) runs these pairs on the card; here, the analyzer's
    # half of each
    sys.path.insert(0, REPO)
    import chip_smoke

    tp, tn = chip_smoke.AA3_PAIRS[code]
    assert chip_smoke._aa3_codes(tp) == [code]
    assert chip_smoke._aa3_codes(tn) == []


@pytest.fixture(scope="module")
def port_report():
    rules = [RULES_BY_CODE[c] for c in FLOW_CODES]
    return analyze_paths(["gan_deeplearning4j_tpu_torch", "chip_smoke.py"],
                         rules=rules, baseline=load_baseline(), root=REPO)


@pytest.mark.parametrize("code", FLOW_CODES)
def test_the_port_is_clean_under_each_flow_rule(port_report, code):
    assert port_report.files > 100
    assert [f.render() for f in port_report.active if f.code == code] == []
    assert [f for f in port_report.suppressed + port_report.baselined if f.code == code] == []
