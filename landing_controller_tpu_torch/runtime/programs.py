"""Traced programs and their file format, for saved solvers and stream steps.

:func:`trace_program` records a function of tensors as a ``torch.fx`` graph
of aten ops (and the port's custom ops): ``make_fx`` runs it on real
tensors, which lowers the ``torch.func`` transforms to plain ops.  A file
(:func:`write_programs`) holds a magic line, one JSON header line, then one
``torch.save`` payload: each program's graph as JSON and its constant
tensors.  :func:`read_programs` rebuilds each graph as a
``torch.fx.GraphModule`` without running any code from the file (the
payload loads with ``weights_only=True``).

Why not ``torch.export``: it cannot follow the ``torch.func`` transforms
itself, and on the ``make_fx`` graph of a saved solver's init (about 20,000
nodes) its export, save and load take 50-100 times as long as this format's
write and read, for a graph that runs no faster once loaded
(``tests/probe_artifact_routes.py`` times both routes).
"""

from __future__ import annotations

import io
import json
import operator

import torch
from torch.utils import _pytree


def trace_program(fn, args: tuple):
    """``fn`` at the example ``args`` (pytrees of tensors) as a
    ``GraphModule`` over the flattened leaves of ``args``; returns (module,
    the pytree spec of ``fn``'s output).

    The trace runs ``fn`` on the real tensors (a fake-tensor trace fails on
    the structured step's vmapped ``jacfwd``), so the graph holds no branch
    on values that the trace took; the transforms' shape probes leave dead
    nodes behind, which are dropped."""
    from torch._guards import TracingContext, tracing
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.fx.experimental.proxy_tensor import make_fx

    leaves, in_spec = _pytree.tree_flatten(args)
    out_spec = None

    def flat(*xs):
        nonlocal out_spec
        out, out_spec = _pytree.tree_flatten(fn(*_pytree.tree_unflatten(list(xs), in_spec)))
        return tuple(out)

    # distinct inputs: two arguments that share a tensor (a fresh state's z
    # and best_z) would be traced as one
    leaves = tuple(t.clone() for t in leaves)
    # one fake mode for the nodes' metadata (make_fx otherwise makes one per node)
    with tracing(TracingContext(FakeTensorMode(allow_fallback_kernels=True))):
        gm = make_fx(flat, tracing_mode="real")(*leaves)
    gm.graph.eliminate_dead_code()
    gm.recompile()
    return gm, out_spec


class Program:
    """A program called with pytrees of tensors, as it was traced, and
    returning its output pytree (``out_spec``)."""

    def __init__(self, module, out_spec):
        self.module = module
        self.out_spec = out_spec

    def __call__(self, *args):
        return _pytree.tree_unflatten(list(self.module(*_pytree.tree_leaves(args))),
                                      self.out_spec)


# ---------------------------------------------------------------- the format
_SCALARS = (bool, int, float, str, type(None))


def _encode(a):
    if isinstance(a, torch.fx.Node):
        return {"node": a.name}
    if isinstance(a, _SCALARS):
        return a
    if isinstance(a, list):
        return [_encode(x) for x in a]
    if isinstance(a, tuple):
        return {"tuple": [_encode(x) for x in a]}
    if isinstance(a, torch.dtype):
        return {"dtype": str(a).removeprefix("torch.")}
    if isinstance(a, torch.device):
        return {"device": str(a)}
    if isinstance(a, torch.layout):
        return {"layout": str(a).removeprefix("torch.")}
    if isinstance(a, torch.memory_format):
        return {"memory_format": str(a).removeprefix("torch.")}
    raise TypeError(f"cannot save a graph argument of type {type(a).__name__}: {a!r}")


def _decode(a, nodes):
    if isinstance(a, list):
        return [_decode(x, nodes) for x in a]
    if not isinstance(a, dict):
        return a
    (kind, v), = a.items()
    if kind == "node":
        return nodes[v]
    if kind == "tuple":
        return tuple(_decode(x, nodes) for x in v)
    if kind == "device":
        return torch.device(v)
    return getattr(torch, v)  # dtype, layout, memory_format


def _target_name(target) -> str:
    if target is operator.getitem:
        return "getitem"
    if isinstance(target, torch._ops.OpOverload):
        return f"{target._schema.name}.{target._overloadname}"
    raise TypeError(f"cannot save a call to {target!r}")


def _target(name: str):
    if name == "getitem":
        return operator.getitem
    ns, op = name.split("::")
    op, overload = op.rsplit(".", 1)
    return getattr(getattr(getattr(torch.ops, ns), op), overload)


def _graph_to_json(gm) -> str:
    nodes = []
    for n in gm.graph.nodes:
        if n.op == "call_function":
            target = _target_name(n.target)
        elif n.op in ("placeholder", "get_attr"):
            target = n.target
        else:
            target = None
        kwargs = {k: _encode(v) for k, v in n.kwargs.items()}
        nodes.append([n.op, n.name, target, _encode(n.args), kwargs])
    return json.dumps(nodes)


def _graph_from_json(text: str, constants: dict) -> torch.fx.GraphModule:
    graph = torch.fx.Graph()
    nodes = {}
    for op, name, target, args, kwargs in json.loads(text):
        args = _decode(args, nodes)
        kwargs = {k: _decode(v, nodes) for k, v in kwargs.items()}
        if op == "placeholder":
            node = graph.placeholder(target)
        elif op == "get_attr":
            node = graph.get_attr(target)
        elif op == "call_function":
            node = graph.call_function(_target(target), tuple(args), kwargs)
        else:
            node = graph.output(args[0])
        nodes[name] = node
    return torch.fx.GraphModule(constants, graph)


def write_programs(path: str, magic: bytes, header: dict, modules) -> None:
    """``magic``, the header as one JSON line, then the programs' graphs and
    constants as one ``torch.save`` payload."""
    payload = [{"graph": _graph_to_json(gm),
                "constants": {n.target: getattr(gm, n.target).detach()
                              for n in gm.graph.nodes if n.op == "get_attr"}}
               for gm in modules]
    with open(path, "wb") as f:
        f.write(magic)
        f.write((json.dumps(header) + "\n").encode())
        torch.save(payload, f)


def read_programs(f, device) -> list:
    """The programs of an open file, read past its header, with their
    constants on ``device``; raises on a truncated or damaged file."""
    payload = torch.load(io.BytesIO(f.read()), map_location=device, weights_only=True)
    return [_graph_from_json(p["graph"], p["constants"]) for p in payload]
