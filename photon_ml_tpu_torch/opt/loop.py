"""The solvers' loop: the port's counterpart of ``lax.while_loop``, and the
replay of a loop's pure parts as CUDA graphs.

Every solver loop of ``opt/`` (L-BFGS and its strong-Wolfe search, OWLQN
and its backtracking, TRON and its truncated CG, SoA Newton and its
backtracking) is a ``cond`` / ``body`` pair over a tuple of tensors, as
the reference writes each of them for ``lax.while_loop``.  ``body`` takes
no decision on the host and reads nothing there: every stop, per lane or
for a single solve, is a tensor.  ``cond`` returns a 0-d bool tensor, and
``while_loop`` reads it once a trip, at one line: that read is the only
host read of every solver loop.

``replay(fn, *args)`` is ``fn(*args)`` for a pure function of tensors
(nested in tuples; any other argument is a constant).  On the card it is
captured once as a CUDA graph per function, constants and tensor shapes,
and each call copies the tensors into the graph's inputs and replays it:
the many small launches of a solver's bookkeeping become one.  Its
outputs are the graph's own buffers: they hold until the same graph is
replayed again, so a caller uses them before that, or copies them.  A
body that reads nothing on the host and makes no tensor from host data is
such a function.  Every solver of ``opt/`` (L-BFGS, single and over lanes;
OWLQN; TRON; SoA Newton) replays its bookkeeping so on the card: the
objectives, and the kernels they launch, run eagerly between the replays,
and no design passes through a graph's inputs.  ``captured()`` counts the
graphs.
"""

from __future__ import annotations

from typing import Callable, TypeVar

import torch

State = TypeVar("State")


def while_loop(cond: Callable[[State], torch.Tensor], body: Callable[[State], State],
               state: State) -> State:
    """``state = body(state)`` while ``cond(state)`` holds; the final state."""
    while bool(cond(state)):
        state = body(state)
    return state


# (function, argument structure, constants, shapes) -> (inputs, outputs, graph)
_GRAPHS: dict = {}


def _flatten(x, leaves: list):
    """``x``'s leaves appended to ``leaves`` (tuples, named or not, are
    walked); its structure returned."""
    if isinstance(x, tuple):
        return type(x), tuple(_flatten(y, leaves) for y in x)
    leaves.append(x)
    return None


def _unflatten(structure, leaves):
    """The value of ``structure`` over an iterator of leaves."""
    if structure is None:
        return next(leaves)
    kind, parts = structure
    items = [_unflatten(p, leaves) for p in parts]
    return kind(*items) if hasattr(kind, "_fields") else kind(items)


def _replays(t: torch.Tensor) -> bool:
    """Whether ``replay`` captures a call whose first tensor is ``t``: on
    the card."""
    return t.is_cuda


def replay(fn: Callable, *args):
    """``fn(*args)``, replayed as a captured CUDA graph where its tensors lie
    on the card (module docstring)."""
    leaves: list = []
    structure = _flatten(args, leaves)
    tensors = [x for x in leaves if isinstance(x, torch.Tensor)]
    if not tensors or not _replays(tensors[0]):
        return fn(*args)
    key = (fn, structure) + tuple((x.shape, x.dtype, x.device) if isinstance(x, torch.Tensor)
                                  else x for x in leaves)
    entry = _GRAPHS.get(key)
    if entry is None:
        entry = _GRAPHS[key] = _capture(fn, leaves, structure, tensors[0].device)
    inputs, outputs, graph = entry
    for dst, src in zip(inputs, tensors):
        dst.copy_(src)
    graph.replay()
    return outputs


def captured() -> int:
    """The graphs ``replay`` has captured in this process: one per function,
    argument structure, constants and shapes, so a second fit over the same
    shapes captures none."""
    return len(_GRAPHS)


def _capture(fn: Callable, leaves: list, structure, device: torch.device):
    """``fn`` captured over copies of the tensor leaves: (the copies, its
    outputs, the graph)."""
    leaves = [x.clone() if isinstance(x, torch.Tensor) else x for x in leaves]
    args = _unflatten(structure, iter(leaves))
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        fn(*args)  # what a first call sets up (library handles) is set up outside the capture
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin(capture_error_mode="thread_local")
        outputs = fn(*args)
        graph.capture_end()
    torch.cuda.current_stream(device).wait_stream(side)
    return [x for x in leaves if isinstance(x, torch.Tensor)], outputs, graph
