"""ComputationGraph of the PyTorch port — counterpart of
``gan_deeplearning4j_tpu/nn/graph.py``.

- ``GraphBuilder`` with the graph-level defaults that per-layer settings
  override (DL4J's config inheritance) and the automatic boundary
  preprocessors from declared InputTypes;
- ``ComputationGraph``: ``init``, ``apply`` (params in, outputs and the
  BatchNorm running-stat updates out; an optional ``torch.Generator`` for
  training-mode dropout), ``output``, ``feed_forward``, ``loss`` (the
  losses of the output and loss layers + L2 on weights), ``summary``, the
  named-param protocol ``get_param``/``set_param``/``copy_params`` (the
  reference's weight sync), ``param_shapes``/``param_count`` and
  ``to_dict``/``from_dict`` over the same ``topology.json`` schema, so a
  topology written by either package builds in the other.

Params are a plain dict of dicts of tensors, ``{layer: {name: tensor}}``,
keyed exactly as in the JAX package, and every method is functional: it
returns new dicts and never writes into a tensor it was given. The
combining vertices ``MergeVertex`` (concatenation on the trailing axis) and
``ElementWiseVertex`` (add, subtract, product) join through
``GraphBuilder.add_vertex``; they own no params, and their gradients flow
through autograd.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from gan_deeplearning4j_tpu_torch.nn.input_type import InputType
from gan_deeplearning4j_tpu_torch.nn.layers import (
    BatchNormalization,
    ConvolutionLayer,
    DenseLayer,
    Layer,
    LossLayer,
    OutputLayer,
    SubsamplingLayer,
    Upsampling2D,
    layer_from_dict,
)
from gan_deeplearning4j_tpu_torch.nn.preprocessors import (
    CnnToFeedForwardPreProcessor,
    FlatToCnnPreProcessor,
    preprocessor_from_dict,
)
from gan_deeplearning4j_tpu_torch.optim.updaters import RmsProp, UpdaterSpec, updater_from_dict
from gan_deeplearning4j_tpu_torch.runtime.device import DeviceLike, resolve_device

# Deconvolution2D subclasses ConvolutionLayer
_CNN_LAYERS = (ConvolutionLayer, SubsamplingLayer, Upsampling2D)
_FF_LAYERS = (DenseLayer,)  # OutputLayer subclasses DenseLayer


@dataclasses.dataclass(frozen=True)
class GraphConfig:
    """Graph-level defaults (DL4J NeuralNetConfiguration.Builder chain)."""

    seed: int = 666
    default_activation: str = "tanh"
    weight_init: str = "xavier"
    l2: float = 0.0
    gradient_clip: Optional[str] = None  # "elementwise" | "global_norm" | None
    gradient_clip_value: float = 1.0
    updater: UpdaterSpec = RmsProp(0.001)
    optimization_algo: str = "sgd"  # informational, as in the reference

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["updater"] = self.updater.to_dict()
        return d

    @staticmethod
    def from_dict(d: dict) -> "GraphConfig":
        d = dict(d)
        d["updater"] = updater_from_dict(d["updater"])
        return GraphConfig(**d)


@dataclasses.dataclass(frozen=True)
class MergeVertex:
    """Concatenate the inputs along the trailing feature or channel axis
    (DL4J MergeVertex)."""

    def apply(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        return torch.cat(list(xs), dim=-1)

    def output_type(self, in_types: Sequence[InputType]) -> InputType:
        kinds = {t.kind for t in in_types}
        if kinds == {"ff"}:
            return InputType.feed_forward(sum(t.shape[0] for t in in_types))
        if kinds == {"cnn"}:
            h, w, _ = in_types[0].shape
            return InputType.convolutional(h, w, sum(t.shape[2] for t in in_types))
        raise ValueError(f"MergeVertex: incompatible input kinds {kinds}")

    def to_dict(self) -> dict:
        return {"type": "MergeVertex"}


@dataclasses.dataclass(frozen=True)
class ElementWiseVertex:
    """Elementwise combine of the inputs, left to right (DL4J
    ElementWiseVertex: ``"add"``, ``"subtract"``, ``"product"``)."""

    op: str = "add"

    def apply(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        out = xs[0]
        for x in xs[1:]:
            if self.op == "add":
                out = out + x
            elif self.op == "product":
                out = out * x
            elif self.op == "subtract":
                out = out - x
            else:
                raise ValueError(f"unknown elementwise op {self.op!r}")
        return out

    def output_type(self, in_types: Sequence[InputType]) -> InputType:
        return in_types[0]

    def to_dict(self) -> dict:
        return {"type": "ElementWiseVertex", "op": self.op}


def _vertex_from_dict(d: dict):
    if d["type"] == "MergeVertex":
        return MergeVertex()
    if d["type"] == "ElementWiseVertex":
        return ElementWiseVertex(d["op"])
    raise KeyError(f"unknown vertex type {d['type']!r}")


@dataclasses.dataclass(frozen=True)
class VertexSpec:
    """A resolved node: a layer (with an optional preprocessor) or a
    combining vertex. ``raw_layer`` keeps the pre-default-resolution config
    (None fields = "inherit") so transfer learning can re-resolve it
    against a fine-tuned config."""

    name: str
    inputs: Tuple[str, ...]
    layer: Optional[Layer] = None
    vertex: Optional[object] = None
    preprocessor: Optional[object] = None
    in_type: Optional[InputType] = None
    out_type: Optional[InputType] = None
    raw_layer: Optional[Layer] = None


class GraphBuilder:
    """DL4J ``graphBuilder()`` analog."""

    def __init__(self, config: GraphConfig = GraphConfig()):
        self.config = config
        self._inputs: List[str] = []
        self._input_types: List[InputType] = []
        self._nodes: List[dict] = []
        self._outputs: List[str] = []
        self._names: set = set()

    def add_inputs(self, *names: str) -> "GraphBuilder":
        for n in names:
            if n in self._names:
                raise ValueError(f"duplicate name {n!r}")
            self._names.add(n)
        self._inputs.extend(names)
        return self

    def set_input_types(self, *types: InputType) -> "GraphBuilder":
        self._input_types = list(types)
        return self

    def add_layer(self, name: str, layer: Layer, *inputs: str, preprocessor=None) -> "GraphBuilder":
        if name in self._names:
            raise ValueError(f"duplicate name {name!r}")
        self._names.add(name)
        self._nodes.append(
            {"name": name, "layer": layer, "inputs": tuple(inputs), "preprocessor": preprocessor}
        )
        return self

    def add_vertex(self, name: str, vertex, *inputs: str) -> "GraphBuilder":
        if name in self._names:
            raise ValueError(f"duplicate name {name!r}")
        self._names.add(name)
        self._nodes.append({"name": name, "vertex": vertex, "inputs": tuple(inputs)})
        return self

    def set_outputs(self, *names: str) -> "GraphBuilder":
        self._outputs = list(names)
        return self

    def _resolve_layer_defaults(self, layer: Layer) -> Layer:
        """Fill in None fields from the graph config (DL4J inheritance)."""
        updates = {}
        if layer.activation is None and not isinstance(
            layer, (BatchNormalization, Upsampling2D, SubsamplingLayer)
        ):
            updates["activation"] = self.config.default_activation
        if layer.activation is None and isinstance(layer, BatchNormalization):
            updates["activation"] = "identity"
        if layer.weight_init is None:
            updates["weight_init"] = self.config.weight_init
        if layer.updater is None:
            updates["updater"] = self.config.updater
        if layer.l2 is None:
            updates["l2"] = self.config.l2
        return dataclasses.replace(layer, **updates) if updates else layer

    @staticmethod
    def _auto_preprocessor(layer: Layer, in_type: InputType):
        """DL4J's implicit InputType adaptation."""
        if isinstance(layer, (*_CNN_LAYERS, BatchNormalization)) and in_type.kind == "cnn_flat":
            h, w, c = in_type.shape
            return FlatToCnnPreProcessor(h, w, c)
        if isinstance(layer, _FF_LAYERS) and in_type.kind == "cnn":
            return CnnToFeedForwardPreProcessor()
        return None

    def build(self) -> "ComputationGraph":
        if not self._inputs:
            raise ValueError("graph has no inputs")
        if not self._outputs:
            raise ValueError("graph has no outputs (set_outputs)")
        if len(self._input_types) != len(self._inputs):
            raise ValueError(
                f"{len(self._inputs)} inputs but {len(self._input_types)} input types declared"
            )
        known: Dict[str, InputType] = dict(zip(self._inputs, self._input_types))
        specs: List[VertexSpec] = []
        pending = list(self._nodes)
        progress = True
        while pending and progress:  # topological resolve, any declaration order
            progress = False
            remaining = []
            for node in pending:
                if all(i in known for i in node["inputs"]):
                    specs.append(self._finalize_node(node, known))
                    known[node["name"]] = specs[-1].out_type
                    progress = True
                else:
                    remaining.append(node)
            pending = remaining
        if pending:
            missing = {i for n in pending for i in n["inputs"] if i not in known}
            raise ValueError(f"unresolvable graph: missing vertices {sorted(missing)}")
        for o in self._outputs:
            if o not in known:
                raise ValueError(f"output {o!r} is not a graph vertex")
        return ComputationGraph(
            config=self.config,
            input_names=tuple(self._inputs),
            input_types=tuple(self._input_types),
            vertices=tuple(specs),
            output_names=tuple(self._outputs),
        )

    def _finalize_node(self, node: dict, known: Dict[str, InputType]) -> VertexSpec:
        in_types = [known[i] for i in node["inputs"]]
        if "vertex" in node:
            vertex = node["vertex"]
            return VertexSpec(
                name=node["name"],
                inputs=node["inputs"],
                vertex=vertex,
                in_type=in_types[0],
                out_type=vertex.output_type(in_types),
            )
        layer = self._resolve_layer_defaults(node["layer"])
        if len(in_types) != 1:
            raise ValueError(f"layer {node['name']!r} must have exactly one input")
        in_type = in_types[0]
        pre = node.get("preprocessor") or self._auto_preprocessor(layer, in_type)
        if pre is not None:
            in_type = pre.output_type(in_type)
        elif in_type.kind == "cnn_flat" and isinstance(layer, _FF_LAYERS):
            in_type = InputType.feed_forward(in_type.features)
        return VertexSpec(
            name=node["name"],
            inputs=node["inputs"],
            layer=layer,
            preprocessor=pre,
            in_type=in_type,
            out_type=layer.output_type(in_type),
            raw_layer=node["layer"],
        )


class ComputationGraph:
    """Immutable graph topology + init/forward over dicts of tensors."""

    def __init__(self, config, input_names, input_types, vertices, output_names):
        self.config: GraphConfig = config
        self.input_names: Tuple[str, ...] = input_names
        self.input_types: Tuple[InputType, ...] = input_types
        self.vertices: Tuple[VertexSpec, ...] = vertices
        self.output_names: Tuple[str, ...] = output_names
        self._by_name = {v.name: v for v in vertices}

    def vertex(self, name: str) -> VertexSpec:
        return self._by_name[name]

    def layer_names(self) -> List[str]:
        return [v.name for v in self.vertices if v.layer is not None]

    def _param_layers(self) -> List[VertexSpec]:
        """The vertices whose layer owns params (combining vertices own none)."""
        return [v for v in self.vertices if v.layer is not None and v.layer.has_params()]

    def layer_updaters(self) -> Dict[str, UpdaterSpec]:
        """Per-layer updater specs of the layers that own params (what
        ``GraphOptimizer`` applies)."""
        return {v.name: v.layer.updater for v in self._param_layers()}

    def param_roles(self) -> Dict[str, Dict[str, str]]:
        return {v.name: v.layer.param_roles() for v in self._param_layers()}

    def output_layers(self) -> List[VertexSpec]:
        return [
            v for v in self.vertices
            if v.name in self.output_names and isinstance(v.layer, (OutputLayer, LossLayer))
        ]

    # -- params -------------------------------------------------------------
    def param_shapes(self) -> Dict[str, Dict[str, Tuple[int, ...]]]:
        """``{layer: {name: shape}}`` for every layer that owns params, without
        allocating anything."""
        return {v.name: v.layer.param_shapes(v.in_type) for v in self._param_layers()}

    def param_count(self, params: Optional[Dict] = None) -> int:
        if params is not None:
            return sum(int(p.numel()) for lp in params.values() for p in lp.values())
        return sum(
            math.prod(shape) for shapes in self.param_shapes().values() for shape in shapes.values()
        )

    def init(self, seed: Optional[int] = None, *, device: DeviceLike = None) -> Dict[str, Dict[str, torch.Tensor]]:
        """Fresh params from one ``torch.Generator`` seeded with the config
        seed (the reference seeds every graph with 666), drawn layer by layer
        in vertex order on the CPU, then moved to ``device`` (the card unless
        the caller asks for another)."""
        dev = resolve_device(device)
        generator = torch.Generator().manual_seed(self.config.seed if seed is None else seed)
        params: Dict[str, Dict[str, torch.Tensor]] = {}
        for v in self._param_layers():
            params[v.name] = {
                k: t.to(dev) for k, t in v.layer.init(generator, v.in_type).items()
            }
        return params

    # -- forward ------------------------------------------------------------
    def _traverse(self, params: Dict, inputs, *, train: bool, generator=None):
        """Shared forward walk: ``(activations by vertex, new_params)``.
        Dropout layers draw their masks from ``generator`` in vertex order."""
        if not isinstance(inputs, dict):
            if len(self.input_names) != 1:
                raise ValueError("graph has multiple inputs; pass a dict")
            inputs = {self.input_names[0]: inputs}
        acts: Dict[str, torch.Tensor] = dict(inputs)
        new_params = dict(params)
        for v in self.vertices:
            if v.vertex is not None:
                acts[v.name] = v.vertex.apply([acts[i] for i in v.inputs])
                continue
            x = acts[v.inputs[0]]
            if v.preprocessor is not None:
                x = v.preprocessor(x)
            y, updates = v.layer.apply(params.get(v.name, {}), x, train=train, generator=generator)
            if updates:
                new_params[v.name] = {**params[v.name], **updates}
            acts[v.name] = y
        return acts, new_params

    def apply(self, params: Dict, inputs, *, train: bool = False, generator=None):
        """Feed-forward: ``(outputs by name, new_params)``. With
        ``train=True`` BatchNorm normalizes by the batch and ``new_params``
        carries its updated running statistics; otherwise it is ``params``.
        ``generator`` feeds training-mode dropout (required when the graph
        has a dropout layer and ``train=True``)."""
        acts, new_params = self._traverse(params, inputs, train=train, generator=generator)
        return {o: acts[o] for o in self.output_names}, new_params

    def output(self, params: Dict, inputs, *, train: bool = False):
        """Inference (DL4J ``graph.output(x)``): the single output tensor, or a
        dict for multi-output graphs."""
        outs, _ = self.apply(params, inputs, train=train)
        if len(self.output_names) == 1:
            return outs[self.output_names[0]]
        return outs

    def feed_forward(self, params: Dict, inputs, *, train: bool = False, generator=None):
        """Per-vertex activation map (DL4J ``ComputationGraph.feedForward``):
        ``{vertex name: activation}``, inputs included."""
        return self._traverse(params, inputs, train=train, generator=generator)[0]

    # -- loss ---------------------------------------------------------------
    def l2_penalty(self, params: Dict) -> torch.Tensor:
        """``0.5 · l2 · ‖W‖²`` summed over weight-role params (DL4J's L2 score
        term). Biases, BatchNorm gains and running stats are exempt, which
        torch's ``weight_decay`` would not respect."""
        total = None
        for v in self._param_layers():
            l2 = v.layer.l2 or 0.0
            if l2 <= 0.0:
                continue
            for pname, role in v.layer.param_roles().items():
                if role == "weight":
                    term = 0.5 * l2 * torch.sum(params[v.name][pname].float() ** 2)
                    total = term if total is None else total + term
        if total is None:
            leaf = next((t for lp in params.values() for t in lp.values()), None)
            total = torch.zeros((), device=None if leaf is None else leaf.device)
        return total

    def loss(self, params: Dict, inputs, labels, *, train: bool = True, generator=None):
        """Total training loss: the losses of the output and loss layers +
        the L2 penalty. Returns ``(loss, (outputs, new_params))``."""
        outs, new_params = self.apply(params, inputs, train=train, generator=generator)
        if not isinstance(labels, dict):
            if len(self.output_names) != 1:
                raise ValueError("graph has multiple outputs; pass labels as a dict")
            labels = {self.output_names[0]: labels}
        out_layers = self.output_layers()
        if not out_layers:
            raise ValueError("graph has no loss-bearing output layers")
        total = None
        for v in out_layers:
            term = v.layer.loss_fn(outs[v.name], labels[v.name])
            total = term if total is None else total + term
        return total + self.l2_penalty(params), (outs, new_params)

    # -- named-parameter protocol ------------------------------------------
    @staticmethod
    def get_param(params: Dict, layer: str, name: str) -> torch.Tensor:
        """DL4J ``graph.getLayer(l).getParam(n)``."""
        return params[layer][name]

    @staticmethod
    def set_param(params: Dict, layer: str, name: str, value) -> Dict:
        """Functional DL4J ``setParam``: returns a new params tree."""
        if layer not in params:
            raise KeyError(f"unknown layer {layer!r}")
        if name not in params[layer]:
            raise KeyError(f"layer {layer!r} has no param {name!r}")
        if tuple(params[layer][name].shape) != tuple(value.shape):
            raise ValueError(
                f"shape mismatch setting {layer}/{name}: "
                f"{tuple(params[layer][name].shape)} vs {tuple(value.shape)}"
            )
        return {**params, layer: {**params[layer], name: value}}

    @staticmethod
    def copy_params(src_params: Dict, dst_params: Dict, mapping: Dict[str, str]) -> Dict:
        """Bulk named-parameter copy, the reference's weight-sync protocol
        (dis→gan, gan→gen and dis→classifier) as one functional op.
        ``mapping`` is ``{src_layer: dst_layer}``; every param of each layer
        is rebound. Tensors are shared, not copied: no caller writes into
        a tensor in place."""
        out = dict(dst_params)
        for src_layer, dst_layer in mapping.items():
            if src_layer not in src_params:
                raise KeyError(f"source layer {src_layer!r} not in params")
            if dst_layer not in out:
                raise KeyError(f"dest layer {dst_layer!r} not in params")
            for pname, value in src_params[src_layer].items():
                if pname not in out[dst_layer]:
                    raise KeyError(f"dest layer {dst_layer!r} has no param {pname!r}")
                if tuple(out[dst_layer][pname].shape) != tuple(value.shape):
                    raise ValueError(
                        f"shape mismatch copying {src_layer}/{pname} -> {dst_layer}: "
                        f"{tuple(value.shape)} vs {tuple(out[dst_layer][pname].shape)}"
                    )
            out[dst_layer] = {**out[dst_layer], **dict(src_params[src_layer])}
        return out

    # -- reporting ----------------------------------------------------------
    def summary(self, params: Optional[Dict] = None) -> str:
        """DL4J ``graph.summary()`` analog."""
        if params is not None:
            counts = {k: sum(int(t.numel()) for t in lp.values()) for k, lp in params.items()}
        else:
            counts = {
                k: sum(math.prod(s) for s in shapes.values())
                for k, shapes in self.param_shapes().items()
            }
        rows = [("Name (type)", "In", "Out", "# Params")]
        for name, t in zip(self.input_names, self.input_types):
            rows.append((f"{name} (Input)", "-", str(t), "0"))
        total = 0
        for v in self.vertices:
            n = counts.get(v.name, 0)
            total += n
            kind = v.layer.kind if v.layer is not None else type(v.vertex).__name__
            pre = f" [+{type(v.preprocessor).__name__}]" if v.preprocessor is not None else ""
            rows.append((f"{v.name} ({kind}){pre}", str(v.in_type), str(v.out_type), str(n)))
        widths = [max(len(r[i]) for r in rows) for i in range(4)]
        lines = ["  ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip() for r in rows]
        lines.insert(1, "-" * (sum(widths) + 6))
        lines.append("-" * (sum(widths) + 6))
        lines.append(f"Total params: {total}")
        return "\n".join(lines)

    # -- serialization ------------------------------------------------------
    def to_dict(self) -> dict:
        nodes = []
        for v in self.vertices:
            node = {"name": v.name, "inputs": list(v.inputs)}
            if v.layer is not None:
                node["layer"] = v.layer.to_dict()
                if v.preprocessor is not None:
                    node["preprocessor"] = v.preprocessor.to_dict()
            else:
                node["vertex"] = v.vertex.to_dict()
            nodes.append(node)
        return {
            "config": self.config.to_dict(),
            "inputs": list(self.input_names),
            "input_types": [t.to_dict() for t in self.input_types],
            "nodes": nodes,
            "outputs": list(self.output_names),
        }

    @staticmethod
    def from_dict(d: dict) -> "ComputationGraph":
        builder = GraphBuilder(GraphConfig.from_dict(d["config"]))
        builder.add_inputs(*d["inputs"])
        builder.set_input_types(*[InputType.from_dict(t) for t in d["input_types"]])
        for node in d["nodes"]:
            if "layer" not in node:
                builder.add_vertex(node["name"], _vertex_from_dict(node["vertex"]), *node["inputs"])
                continue
            pre = preprocessor_from_dict(node["preprocessor"]) if "preprocessor" in node else None
            builder.add_layer(
                node["name"], layer_from_dict(node["layer"]), *node["inputs"], preprocessor=pre
            )
        builder.set_outputs(*d["outputs"])
        return builder.build()
