"""Graph (DAG) container (counterpart of bigdl_tpu/nn/graph.py).

Usage is the JAX package's functional construction::

    inp  = Input()
    conv = SpatialConvolution(3, 8, 3).inputs(inp)
    relu = ReLU().inputs(conv)
    model = Graph([inp], [relu])

Children are keyed exactly as bigdl_tpu/nn/graph.py:57-69 keys them: in
topological order, a module's name, then ``_1``, ``_2``, ... on a
repeat.  So the port's ``state_dict`` keys are the JAX pytree's paths
with ``.`` as the separator.
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Sequence

from bigdl_tpu_torch.nn.module import Container, Module, Seed, call_child

_ids = itertools.count(1)


class Node:
    """A module instance wired into a DAG."""

    def __init__(self, module: Optional[Module], inputs: List["Node"]):
        self.module = module
        self.in_nodes = list(inputs)
        self.id = next(_ids)

    def __repr__(self):
        m = self.module.name if self.module is not None else "Input"
        return f"Node({m}#{self.id})"


def Input(name: Optional[str] = None) -> Node:
    """Placeholder node for a graph input."""
    return Node(None, [])


class Graph(Container):
    def __init__(self, inputs: Sequence[Node], outputs: Sequence[Node],
                 name: Optional[str] = None):
        super().__init__(name=name)
        self.input_nodes = list(inputs)
        self.output_nodes = list(outputs)
        self._order = self._topo_sort()
        self._node_key: Dict[int, str] = {}
        self._key_idx: Dict[str, int] = {}
        counts: Dict[str, int] = {}
        for node in self._order:
            if node.module is None:
                continue
            base = node.module.name
            n = counts.get(base, 0)
            counts[base] = n + 1
            key = base if n == 0 else f"{base}_{n}"
            self._node_key[node.id] = key
            self._key_idx[key] = len(self._keys)
            self._register_child(key, node.module)

    def replace_child(self, key: str, module: Module) -> Module:
        """Replace the child under ``key``, in the node that holds it too."""
        old = super().replace_child(key, module)
        for node in self._order:
            if node.module is old:
                node.module = module
        return old

    def _topo_sort(self) -> List[Node]:
        """DFS topological order over the nodes reachable from outputs."""
        state: Dict[int, int] = {}  # 0 = in progress, 1 = done
        order: List[Node] = []

        def visit(node: Node):
            st = state.get(node.id)
            if st == 1:
                return
            if st == 0:
                raise ValueError("Graph has a cycle")
            state[node.id] = 0
            for p in node.in_nodes:
                visit(p)
            state[node.id] = 1
            order.append(node)

        for out in self.output_nodes:
            visit(out)
        return order

    def forward(self, *inputs, rng: Optional[Seed] = None):
        """The outputs for ``inputs``; the child under key ``k`` gets the
        seed ``split_rng(rng, i)``, ``i`` the key's position, when it
        takes one (bigdl_tpu/nn/graph.py:93-115)."""
        if len(inputs) == 1 and isinstance(inputs[0], (tuple, list)):
            inputs = tuple(inputs[0])
        values: Dict[int, object] = {}
        for i, node in enumerate(self.input_nodes):
            if i < len(inputs):
                values[node.id] = inputs[i]
        for node in self._order:
            if node.module is None:
                if node.id not in values:
                    raise ValueError(f"Unbound graph input {node}")
                continue
            args = [values[p.id] for p in node.in_nodes]
            x = args[0] if len(args) == 1 else tuple(args)
            key = self._node_key[node.id]
            values[node.id] = call_child(self._modules[key], x, rng,
                                         self._key_idx[key])
        outs = tuple(values[n.id] for n in self.output_nodes)
        return outs[0] if len(outs) == 1 else outs
