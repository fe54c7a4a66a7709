"""Transfer-learning graph surgery — counterpart of
``gan_deeplearning4j_tpu/nn/transfer.py`` (DL4J
``TransferLearning.GraphBuilder``), enough to build the transfer classifier
``cv`` from the discriminator:

- ``fine_tune_configuration`` re-applies the common hyperparams;
- ``set_feature_extractor(v)`` freezes every layer up to and including
  ``v`` ("frozen" = updater learning rate 0.0, the reference's own
  mechanism);
- ``remove_vertex_keep_connections`` drops the old output head;
- ``add_layer`` appends the new head.

``build()`` returns a new ``(graph, params)`` pair: retained layers carry
their params over, new layers come from the new graph's ``init`` on the
device of the source params.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from gan_deeplearning4j_tpu_torch.nn.graph import ComputationGraph, GraphBuilder, GraphConfig
from gan_deeplearning4j_tpu_torch.nn.layers import Layer
from gan_deeplearning4j_tpu_torch.optim.updaters import UpdaterSpec


@dataclasses.dataclass(frozen=True)
class FineTuneConfiguration:
    """Global training-config override applied to the surgered graph (DL4J
    FineTuneConfiguration). ``None`` fields keep the source graph's values."""

    seed: Optional[int] = None
    default_activation: Optional[str] = None
    weight_init: Optional[str] = None
    l2: Optional[float] = None
    gradient_clip: Optional[str] = None
    gradient_clip_value: Optional[float] = None
    updater: Optional[UpdaterSpec] = None
    optimization_algo: Optional[str] = None

    def apply_to(self, config: GraphConfig) -> GraphConfig:
        updates = {
            f.name: getattr(self, f.name)
            for f in dataclasses.fields(self)
            if getattr(self, f.name) is not None
        }
        return dataclasses.replace(config, **updates)


class TransferLearning:
    """DL4J ``TransferLearning.GraphBuilder`` analog, functional."""

    def __init__(self, graph: ComputationGraph, params: Dict):
        self._graph = graph
        self._params = params
        self._fine_tune: Optional[FineTuneConfiguration] = None
        self._freeze_until: Optional[str] = None
        self._removed: List[str] = []
        self._added: List[dict] = []
        self._new_outputs: Optional[List[str]] = None

    def fine_tune_configuration(self, cfg: FineTuneConfiguration) -> "TransferLearning":
        self._fine_tune = cfg
        return self

    def set_feature_extractor(self, vertex_name: str) -> "TransferLearning":
        """Freeze all layers up to and including ``vertex_name`` (LR→0.0)."""
        if vertex_name not in {v.name for v in self._graph.vertices}:
            raise KeyError(f"unknown vertex {vertex_name!r}")
        self._freeze_until = vertex_name
        return self

    def remove_vertex_keep_connections(self, name: str) -> "TransferLearning":
        """Drop a vertex, splicing its inputs into its consumers."""
        if name not in {v.name for v in self._graph.vertices}:
            raise KeyError(f"unknown vertex {name!r}")
        self._removed.append(name)
        return self

    def add_layer(self, name: str, layer: Layer, *inputs: str) -> "TransferLearning":
        self._added.append({"name": name, "layer": layer, "inputs": tuple(inputs)})
        return self

    def set_outputs(self, *names: str) -> "TransferLearning":
        self._new_outputs = list(names)
        return self

    def build(self) -> Tuple[ComputationGraph, Dict]:
        src = self._graph
        config = src.config
        if self._fine_tune is not None:
            config = self._fine_tune.apply_to(config)

        frozen = set()
        if self._freeze_until is not None:
            for v in src.vertices:
                frozen.add(v.name)
                if v.name == self._freeze_until:
                    break

        splice = {v.name: list(v.inputs) for v in src.vertices if v.name in self._removed}

        def rewire(inputs):
            out: List[str] = []
            for i in inputs:
                if i in splice:
                    out.extend(rewire(splice[i]))
                else:
                    out.append(i)
            return tuple(out)

        builder = GraphBuilder(config)
        builder.add_inputs(*src.input_names)
        builder.set_input_types(*src.input_types)
        kept: List[str] = []
        for v in src.vertices:
            if v.name in self._removed:
                continue
            inputs = rewire(v.inputs)
            # re-resolve inherited (None) fields against the fine-tuned config;
            # explicit fine-tune updater/l2 override retained non-frozen layers
            layer = v.raw_layer if v.raw_layer is not None else v.layer
            if v.name in frozen and v.layer.has_params():
                layer = dataclasses.replace(layer, updater=v.layer.updater.with_learning_rate(0.0))
            elif self._fine_tune is not None:
                overrides = {}
                if self._fine_tune.updater is not None:
                    overrides["updater"] = self._fine_tune.updater
                if self._fine_tune.l2 is not None:
                    overrides["l2"] = self._fine_tune.l2
                if overrides:
                    layer = dataclasses.replace(layer, **overrides)
            builder.add_layer(v.name, layer, *inputs, preprocessor=v.preprocessor)
            kept.append(v.name)
        for node in self._added:
            builder.add_layer(node["name"], node["layer"], *node["inputs"])

        outputs = self._new_outputs
        if outputs is None:
            # DL4J addLayer does not change outputs: keep surviving ones; only
            # when the removed head left none does the last added layer become
            # the output
            outputs = [o for o in src.output_names if o not in self._removed]
            if not outputs and self._added:
                outputs = [self._added[-1]["name"]]
            if not outputs:
                raise ValueError("no outputs survive surgery; call set_outputs")
        builder.set_outputs(*outputs)
        new_graph = builder.build()

        device = next(
            (t.device for lp in self._params.values() for t in lp.values()), None
        )
        fresh = None
        new_params = {}
        for v in new_graph.vertices:
            if not v.layer.has_params():
                continue
            if v.name in self._params and v.name in kept:
                new_params[v.name] = dict(self._params[v.name])
            else:
                if fresh is None:
                    fresh = new_graph.init(device=device)
                new_params[v.name] = fresh[v.name]
        return new_graph, new_params
