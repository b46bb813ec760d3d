"""Graph: DAG of Blocks with static rate planning and JSON-spec parity (port
of tpusdr/graph/graph.py).

All lengths are solved at build time: rate ratios are static rationals, so
a demanded output length propagates backward through source-fed branches
and forward from the exposed inputs in closed form.  Execution is one eager
pass over the nodes in topological order with a state dict keyed by node
name.  The plan of a tick length is solved once and kept: the chains are
bound by the host, and the plan depends on the length alone.

A ``Graph`` is an ``nn.Module``, so ``graph.to(device)`` moves every node's
buffers.  JSON node names may hold characters a module path refuses (a
dot), so the nodes sit in an ``nn.ModuleList`` and ``nodes`` maps each name
to its module.  A ``SourceBlock`` makes its samples on the device of the
graph's input, or of its state when it has no input.

Spec format (dict or JSON string), mirroring the reference Component schema:

    {
      "nodes": {
        "osc": {"type": "Cosine", "sampleRate": 1e6, "frequency": -2e5,
                 "sampleType": "FloatComplex"},
        "mix": {"type": "Multiply"},
        "lp":  {"type": "Fir", "taps": [...], "decimation": 4},
        "dem": {"type": "QuadDemod", "modulation": "Fm",
                 "sampleRate": 250e3, "fskDeviation": 75e3}
      },
      "connections": [
        {"source": "osc", "sink": "mix", "sinkPort": 1},
        {"source": "mix", "sink": "lp"},
        {"source": "lp", "sink": "dem"}
      ],
      "inputPorts": [{"exposedPort": 0, "mapped": {"node": "mix", "port": 0}}],
      "outputPort": "dem"
    }

Unknown and CUDA-plumbing keys (commandQueueId, description, ...) are
ignored, node type "Component" nests recursively, and camelCase keys are
translated, so reference-style graph JSON ports over directly.
"""

from __future__ import annotations

import json as _json
import math
import re
from dataclasses import dataclass, field
from fractions import Fraction
from typing import Any, Mapping, Sequence

import torch
from torch import nn

from tpusdr_torch.graph.block import Block, SourceBlock
from tpusdr_torch.graph.registry import create_block
from tpusdr_torch.utils.logging import get_logger
from tpusdr_torch.utils.numerics import lcm

log = get_logger("graph")


@dataclass(frozen=True)
class Edge:
    src: str
    src_port: int
    dst: str
    dst_port: int


class Graph(Block):
    """A DAG of named Blocks, itself usable as a Block (the reference's
    composite "Component")."""

    def __init__(
        self,
        nodes: Mapping[str, Block],
        connections: Sequence[tuple | Edge],
        input_map: Sequence[tuple[int, str, int]] | None = None,
        output: str | Sequence[str] = (),
    ):
        super().__init__()
        self._members = nn.ModuleList(nodes.values())
        # name -> node beside the list; a plain dict is not registered
        self.nodes: dict[str, Block] = dict(nodes)
        self._plans: dict[int, dict[str, tuple[int, int]]] = {}
        self.edges = [
            e if isinstance(e, Edge) else Edge(*(list(e) + [0] * (4 - len(e))))
            for e in connections
        ]
        self.input_map = list(input_map or [])
        self.outputs = [output] if isinstance(output, str) else list(output)

        # incoming[node][port] = Edge
        self.incoming: dict[str, dict[int, Edge]] = {n: {} for n in self.nodes}
        for e in self.edges:
            if e.dst not in self.nodes or e.src not in self.nodes:
                raise KeyError(f"connection references unknown node: {e}")
            if e.dst_port in self.incoming[e.dst]:
                raise ValueError(
                    f"sink port already connected: {e.dst}:{e.dst_port} "
                    "(one source per port)"
                )
            self.incoming[e.dst][e.dst_port] = e

        self._exposed: dict[tuple[str, int], int] = {}
        for exposed_port, node, port in self.input_map:
            self._exposed[(node, port)] = exposed_port
        self.n_inputs = len(self.input_map)

        self._topo = self._topo_sort()
        self._validate_arity()

        # Aggregate rate ratio (single-input, single-output graphs).
        if self.n_inputs == 1 and len(self.outputs) == 1:
            r = self._path_ratio()
            if r is not None:
                self.up, self.down = r.numerator, r.denominator

        # Composite dtype/channel metadata (the Chain._recompute_plan
        # analog) so a Graph satisfies the same Block surface the
        # time-sharding machinery consumes (parallel/halo.py).
        if self.n_inputs == 1:
            self.in_dtype = self.nodes[self.input_map[0][1]].in_dtype
        if len(self.outputs) == 1:
            self.out_dtype = self.nodes[self.outputs[0]].out_dtype
        for b in self.nodes.values():
            if b.adds_channel_axis:
                self.adds_channel_axis = True
                self.num_channels = b.num_channels

    # ------------------------------------------------------------------
    # construction helpers
    # ------------------------------------------------------------------

    def _topo_sort(self) -> list[str]:
        indeg = {n: 0 for n in self.nodes}
        for e in self.edges:
            indeg[e.dst] += 1
        ready = sorted(n for n, d in indeg.items() if d == 0)
        order: list[str] = []
        outs: dict[str, list[Edge]] = {n: [] for n in self.nodes}
        for e in self.edges:
            outs[e.src].append(e)
        while ready:
            n = ready.pop()
            order.append(n)
            for e in outs[n]:
                indeg[e.dst] -= 1
                if indeg[e.dst] == 0:
                    ready.append(e.dst)
        if len(order) != len(self.nodes):
            cyc = set(self.nodes) - set(order)
            raise ValueError(f"graph has a cycle involving {sorted(cyc)}")
        return order

    def _validate_arity(self) -> None:
        for name, b in self.nodes.items():
            n_connected = len(self.incoming[name])
            n_exposed = sum(1 for (nn, _p) in self._exposed if nn == name)
            if isinstance(b, SourceBlock):
                if n_connected or n_exposed:
                    raise ValueError(f"source node {name!r} cannot have inputs")
                continue
            if n_connected + n_exposed != b.n_inputs:
                raise ValueError(
                    f"node {name!r} needs {b.n_inputs} inputs, has "
                    f"{n_connected} connections + {n_exposed} exposed ports"
                )

    def _path_ratio(self) -> Fraction | None:
        """Rate ratio from the exposed input to the output, if well-defined."""
        (start_node, _p), *_ = list(self._exposed.keys()) or [((None, 0), 0)]
        if start_node is None:
            return None
        ratio: dict[str, Fraction] = {start_node: Fraction(
            self.nodes[start_node].up, self.nodes[start_node].down
        )}
        for n in self._topo:
            if n in ratio:
                continue
            for port, e in self.incoming[n].items():
                if e.src in ratio:
                    b = self.nodes[n]
                    ratio[n] = ratio[e.src] * Fraction(b.up, b.down)
                    break
        out = self.outputs[0] if self.outputs else None
        return ratio.get(out)

    # ------------------------------------------------------------------
    # static rate planning
    # ------------------------------------------------------------------

    def plan(self, in_len: int) -> dict[str, tuple[int, int]]:
        """Every node's (input_len, output_len) for a tick of ``in_len``
        samples at each exposed input port; solved once per length."""
        return dict(self._plan_for(in_len))

    def _plan_for(self, in_len: int) -> dict[str, tuple[int, int]]:
        if in_len not in self._plans:
            self._plans[in_len] = self._solve_plan(in_len)
        return self._plans[in_len]

    def _solve_plan(self, in_len: int) -> dict[str, tuple[int, int]]:
        nodes = self.nodes
        out_len: dict[str, int] = {}

        def demand(name: str, n: int) -> None:
            """Push a required output length upstream through a flexible
            (source-fed) branch."""
            b = nodes[name]
            if isinstance(b, SourceBlock):
                prev = out_len.get(name)
                if prev is not None and prev != n:
                    raise ValueError(
                        f"source {name!r} demanded at inconsistent lengths "
                        f"{prev} vs {n}"
                    )
                out_len[name] = n
                return
            n_in = n * b.down
            if n_in % b.up:
                raise ValueError(
                    f"node {name!r}: demanded output {n} not producible "
                    f"with ratio {b.up}/{b.down}"
                )
            n_in //= b.up
            out_len[name] = n
            for port, e in self.incoming[name].items():
                if e.src not in out_len:
                    demand(e.src, n_in)

        for n in self._topo:
            b = nodes[n]
            if isinstance(b, SourceBlock):
                continue  # resolved by demand from consumers
            exposed_here = [(nn, p) for (nn, p) in self._exposed if nn == n]
            in_lens: list[int] = []
            unresolved: list[Edge] = []
            if exposed_here:
                in_lens.append(in_len)
            for port, e in self.incoming[n].items():
                if e.src in out_len:
                    in_lens.append(out_len[e.src])
                else:
                    unresolved.append(e)
            if not in_lens:
                continue  # fully source-fed; resolved on demand downstream
            first = in_lens[0]
            if any(v != first for v in in_lens):
                raise ValueError(
                    f"node {n!r}: input lengths disagree: {in_lens} "
                    "(pick a tick divisible by every branch's granule)"
                )
            for e in unresolved:
                demand(e.src, first)
            out_len[n] = b.out_len(first)

        # Any remaining source-fed chains feeding outputs directly.
        for out in self.outputs:
            if out not in out_len:
                raise ValueError(
                    f"output node {out!r} length unresolved: graph has no "
                    "exposed input on its ancestry; demand it explicitly via "
                    "run(..., source_len=...)"
                )

        plan: dict[str, tuple[int, int]] = {}
        for n in self._topo:
            if n not in out_len:
                continue
            b = nodes[n]
            o = out_len[n]
            i = 0 if isinstance(b, SourceBlock) else o * b.down // b.up
            plan[n] = (i, o)
        return plan

    @property
    def granule(self) -> int:
        """Smallest valid tick at the exposed input."""
        nodes = self.nodes
        g = 1
        # Walk every path from exposed inputs, accumulating granule
        # constraints exactly as Chain does.
        ratio: dict[str, Fraction] = {}
        for (node, _port), _ in self._exposed.items():
            ratio[node] = Fraction(1)
        for n in self._topo:
            b = nodes[n]
            r = None
            if n in ratio:
                r = ratio[n]
            else:
                for port, e in self.incoming[n].items():
                    if e.src in ratio:
                        r = ratio[e.src]
                        break
            if r is None:
                continue
            num, den = r.numerator, r.denominator
            need = b.granule * den
            g = lcm(g, need // math.gcd(num, need))
            ratio[n] = r * Fraction(b.up, b.down)
        return g

    def get_block(self, name: str) -> Block:
        try:
            return self.nodes[name]
        except KeyError:
            raise KeyError(f"no node named {name!r} in graph") from None

    def update_block_parameters(self, name: str, **params) -> None:
        """Node::updateParameters parity through a Graph composite
        (Filter.h:36).  Rate-changing updates are rejected: they would
        invalidate every downstream shape; rebuild the graph for those."""
        b = self.get_block(name)
        old_rate = (b.up, b.down)
        b.update_parameters(**params)
        if (b.up, b.down) != old_rate:
            raise ValueError(
                f"update of {name!r} changed its rate {old_rate} -> "
                f"{(b.up, b.down)}; rebuild the graph instead"
            )

    def update_block_parameters_json(self, name: str, payload) -> None:
        """JSON-payload form of update_block_parameters (camelCase keys
        accepted — Filter.h:36 updateParameters(json) parity)."""
        if isinstance(payload, str):
            payload = _json.loads(payload)
        self.update_block_parameters(name, **translate_params(payload))

    # ------------------------------------------------------------------
    # time-sharding hooks (parallel/halo.py) — the Chain equivalents
    # generalized over the DAG via the rate plan
    # ------------------------------------------------------------------

    def _shard_ratios(self) -> dict[str, tuple[Fraction, Fraction]]:
        """Per node: (input, output) samples per exposed-input sample,
        derived from one granule-sized rate plan (single exposed input)."""
        if self.n_inputs != 1:
            raise ValueError("time-sharding hooks need exactly one exposed input")
        g = self.granule
        plan = self.plan(g)
        return {
            n: (Fraction(i, g), Fraction(o, g)) for n, (i, o) in plan.items()
        }

    @property
    def history(self) -> int:
        """Worst-path input-rate lookback (the halo size): max over DAG
        paths of each node's history rescaled to the exposed-input rate —
        the Chain.history sum generalized to a max-plus DP over the DAG."""
        ratios = self._shard_ratios()
        nodes = self.nodes
        lb: dict[str, Fraction] = {}
        best = Fraction(0)
        for n in self._topo:
            if n not in ratios:
                continue
            b = nodes[n]
            base = max(
                (lb[e.src] for e in self.incoming[n].values() if e.src in lb),
                default=Fraction(0),
            )
            if isinstance(b, SourceBlock):
                lb[n] = base  # closed-form state: no lookback needed
            else:
                lb[n] = base + Fraction(b.history, 1) / ratios[n][0]
            best = max(best, lb[n])
        return int(best.__ceil__())

    def shift_state(self, state: dict, offset_samples) -> dict:
        """Closed-form state shift by an exposed-input-sample offset (a
        Python int), rescaled per node through the rate plan (exact: offsets
        are granule multiples).  Sources shift by their *output* offset."""
        o = int(offset_samples)
        ratios = self._shard_ratios()
        nodes = self.nodes
        new = dict(state)
        for n, (rin, rout) in ratios.items():
            b = nodes[n]
            r = rout if isinstance(b, SourceBlock) else rin
            new[n] = b.shift_state(state[n], (o * r.numerator) // r.denominator)
        return new

    def advance_state(self, state: dict, num_samples: int) -> dict:
        ratios = self._shard_ratios()
        nodes = self.nodes
        new = dict(state)
        for n, (rin, rout) in ratios.items():
            b = nodes[n]
            r = rout if isinstance(b, SourceBlock) else rin
            new[n] = b.advance_state(
                state[n], num_samples * r.numerator // r.denominator
            )
        return new

    def split_shardable(self) -> tuple["Graph", Any]:
        """Split into (time-shardable head Graph, sequential tail Chain).

        Non-shardable nodes (IIR — unbounded memory) must form part of a
        linear suffix ending at the single output; that suffix runs
        post-gather on the decimated stream (Chain.split_shardable
        semantics lifted to the DAG)."""
        if self.n_inputs != 1 or len(self.outputs) != 1:
            raise ValueError("split_shardable needs 1 exposed input, 1 output")
        nonshard = {n for n, b in self.nodes.items() if not b.time_shardable}
        if not nonshard:
            return self, None

        outgoing: dict[str, list[Edge]] = {n: [] for n in self.nodes}
        for e in self.edges:
            outgoing[e.src].append(e)
        exposed_nodes = {n for (n, _p) in self._exposed}

        # Maximal linear suffix [deepest ... output].
        suffix = [self.outputs[0]]
        while True:
            cur = suffix[-1]
            inc = list(self.incoming[cur].values())
            if (
                len(inc) != 1
                or cur in exposed_nodes
                or len(outgoing[inc[0].src]) != 1
                or isinstance(self.nodes[inc[0].src], SourceBlock)
                or inc[0].src in exposed_nodes
            ):
                break
            suffix.append(inc[0].src)
        suffix.reverse()

        # Tail starts at the first non-shardable node of the suffix; every
        # non-shardable node must land inside the tail.
        starts = [i for i, n in enumerate(suffix) if n in nonshard]
        if not starts or not nonshard <= set(suffix[starts[0] :]):
            raise ValueError(
                f"non-shardable nodes {sorted(nonshard)} are not a linear "
                "suffix of the graph; cannot time-shard"
            )
        tail_names = suffix[starts[0] :]
        from tpusdr_torch.graph.chain import Chain

        tail = Chain([(n, self.nodes[n]) for n in tail_names])
        head_output = list(self.incoming[tail_names[0]].values())[0].src
        tail_set = set(tail_names)
        head = Graph(
            {n: b for n, b in self.nodes.items() if n not in tail_set},
            [e for e in self.edges if e.src not in tail_set and e.dst not in tail_set],
            self.input_map,
            head_output,
        )
        return head, tail

    # ------------------------------------------------------------------
    # execution
    # ------------------------------------------------------------------

    def init_state(self, batch_shape: Sequence[int] = (), device=None):
        """Every node's carry.  A node's batch shape is the widest of its
        inputs' (``batch_shape`` where it has none), and a node that adds a
        channel axis widens it by ``(num_channels,)`` for the nodes it
        feeds, in topological order along the edges.  (The JAX package's
        Graph passes one batch shape to every node, so a node after a
        Channelizer gets a carry without the channel axis.)"""
        out_shape: dict[str, tuple] = {}
        state = {}
        for n in self._topo:
            b = self.nodes[n]
            shape = max((out_shape[e.src] for e in self.incoming[n].values()), key=len,
                        default=tuple(batch_shape))
            state[n] = b.init_state(shape, device)
            out_shape[n] = shape + (b.num_channels,) if b.adds_channel_axis else shape
        return {n: state[n] for n in self.nodes}

    def _source_device(self, state: dict, xs) -> torch.device:
        """Where sources make their samples: the input's device, else the
        device of the state's tensors, else of the graph's buffers."""
        if xs:
            return xs[0].device
        t = _first_tensor(state)
        if t is None:
            t = next(iter(self.buffers()), None)
        return t.device if t is not None else torch.device("cpu")

    def apply(self, state: dict, *xs):
        if len(xs) != self.n_inputs:
            raise ValueError(f"graph takes {self.n_inputs} inputs, got {len(xs)}")
        in_len = xs[0].shape[-1] if xs else 0
        plan = self._plan_for(in_len)
        nodes = self.nodes
        values: dict[str, Any] = {}
        new_state: dict[str, Any] = dict(state)
        for n in self._topo:
            if n not in plan:
                continue
            b = nodes[n]
            if isinstance(b, SourceBlock):
                new_state[n], values[n] = b.generate(
                    state[n], plan[n][1], self._source_device(state, xs)
                )
                continue
            args: list[Any] = [None] * b.n_inputs
            for (nn, p), exposed_port in self._exposed.items():
                if nn == n:
                    args[p] = xs[exposed_port]
            for port, e in self.incoming[n].items():
                args[port] = values[e.src]
            if any(a is None for a in args):
                raise RuntimeError(f"node {n!r}: unbound input port")
            new_state[n], values[n] = b.apply(state[n], *args)
        outs = tuple(values[o] for o in self.outputs)
        return new_state, outs[0] if len(outs) == 1 else outs

    # ------------------------------------------------------------------
    # JSON spec parity
    # ------------------------------------------------------------------

    @staticmethod
    def from_spec(spec: Mapping | str) -> "Graph":
        return build_graph(spec)


def _first_tensor(tree):
    if isinstance(tree, torch.Tensor):
        return tree
    if isinstance(tree, dict):
        tree = tuple(tree.values())
    if isinstance(tree, (tuple, list)):
        for v in tree:
            t = _first_tensor(v)
            if t is not None:
                return t
    return None


_SNAKE_RE = re.compile(r"(?<!^)(?=[A-Z])")

#: spec keys that are CUDA plumbing in the reference and meaningless here
_IGNORED_KEYS = {"command_queue_id", "description", "tap_type", "input_sample_types"}

_KEY_ALIASES = {
    "fsk_deviation": "channel_width",
    "add_value_to_vector_length": "add_value_to_magnitude",
}


def _snake(k: str) -> str:
    return _SNAKE_RE.sub("_", k).lower()


def translate_params(spec: Mapping) -> dict:
    """Reference-schema (camelCase) node parameters -> Block kwargs.

    Shared by build_graph and the JSON updateParameters surface
    (Block.update_parameters_json): same key translation on construction
    and on runtime reconfiguration, so a JSON-spec-driven app can retune a
    named node with the same vocabulary it built it with (Filter.h:36)."""
    params = {}
    for k, v in spec.items():
        sk = _snake(k)
        sk = _KEY_ALIASES.get(sk, sk)
        if sk in _IGNORED_KEYS:
            continue
        params[sk] = v
    return params


def build_graph(spec: Mapping | str) -> Graph:
    """Build a Graph from a dict / JSON string in the reference Component
    schema."""
    if isinstance(spec, str):
        spec = _json.loads(spec)

    nodes: dict[str, Block] = {}
    for name, node_spec in spec.get("nodes", {}).items():
        node_spec = dict(node_spec)
        type_name = node_spec.pop("type")
        if type_name == "Component":
            nodes[name] = build_graph(node_spec)
            continue
        nodes[name] = create_block(type_name, translate_params(node_spec))

    connections = [
        Edge(
            c["source"],
            int(c.get("sourcePort", 0)),
            c["sink"],
            int(c.get("sinkPort", 0)),
        )
        for c in spec.get("connections", [])
    ]

    input_map = [
        (
            int(p.get("exposedPort", 0)),
            p["mapped"]["node"],
            int(p["mapped"].get("port", 0)),
        )
        for p in spec.get("inputPorts", [])
    ]

    output = spec.get("outputPort", ())
    if isinstance(output, Mapping):  # {"node": ..., "port": ...} form
        output = output["node"]
    return Graph(nodes, connections, input_map, output)


def tapped(chain, taps: Sequence[str]) -> Graph:
    """Expose intermediate stages of a Chain as extra Graph outputs.

    The reference fans one source port out to multiple sinks with per-port
    output copiers; here no block writes into its input, so a tap is just
    an extra output reading the same node value.  Output 0 is the chain's
    final output; outputs 1.. are the named taps, in order: feed the
    resulting Graph to StreamRunner.run with a matching list of sinks
    (e.g. audio + raw IF in one pass).
    """
    from tpusdr_torch.graph.chain import Chain

    if not isinstance(chain, Chain):
        raise TypeError(f"tapped() wraps a Chain, got {type(chain).__name__}")
    names = [n for n, _ in chain.blocks]
    for t in taps:
        if t not in names:
            raise KeyError(f"no stage named {t!r} in chain (stages: {names})")
        if t == names[-1]:
            raise ValueError(f"{t!r} is the chain output; it is already port 0")
    connections = [
        Edge(names[i], 0, names[i + 1], 0) for i in range(len(names) - 1)
    ]
    return Graph(
        dict(chain.blocks),
        connections,
        input_map=[(0, names[0], 0)],
        output=[names[-1], *taps],
    )
