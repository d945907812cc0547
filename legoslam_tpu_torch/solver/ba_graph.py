"""Window BA's LM attempts on a card, each one replay of a CUDA graph.

An attempt of `lm.solve_ba` is ~450 small launches at shapes fixed by the
solve (K poses, L landmarks, E edges, the `BAOrder` tables' widths), and
once `lm.lm_select` takes the accept decision on the device its one read
is the [accept, stop] flags.  Issuing the launches, not running them, was
the attempt's time.  So each solve signature is captured once: one graph
for the first assembly and lambda (`lm.lm_begin`, with the prior's
products), one for an attempt (`lm.lm_select`), both over static
buffers.  A solve copies its inputs into the buffers, replays the first
graph, then the second once per attempt with a read of the flags after
each (`lm.lm_run`), and hands back copies of the results.  The graphs run
the kernels the same loop runs op by op, on the same data: the same bits.

The signature is what capture bakes in: the inputs' device, dtypes and
shapes (the order tables' widths among them), whether a prior is given,
the intrinsics (Python floats, constants in the kernels), the robust
kernel, delta and the LM settings an attempt reads.  Capture runs at a
signature's first solve, on a side stream, with
`capture_error_mode="thread_local"`, so the async backend's worker thread
captures and replays while the frame loop's thread launches work.  Where
capture raises, that signature runs the same loop op by op
(`lm.lm_optimize`) from then on, with a warning naming the line, and its
`lm_attempt` spans say `graph` 0.  A signature's buffers and graphs live as long as the process.
"""

from __future__ import annotations

import threading
import traceback
import warnings
from typing import Dict, List

import torch

from legoslam_tpu_torch.solver import lm
from legoslam_tpu_torch.utils import timer


def _leaves(tree) -> List[torch.Tensor]:
    """The tensors of a nest of tuples, in order."""
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, tuple):
        return [t for x in tree for t in _leaves(x)]
    return []


def _map(fn, tree):
    """The nest with `fn` applied to each of its tensors."""
    if torch.is_tensor(tree):
        return fn(tree)
    if isinstance(tree, tuple):
        out = [_map(fn, x) for x in tree]
        return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)
    return tree


def _copy(dst, src) -> None:
    for d, s in zip(_leaves(dst), _leaves(src)):
        d.copy_(s)


class _Solver:
    """One signature's static buffers and its two graphs."""

    def __init__(self):
        self.lock = threading.Lock()
        self.graphs = None  # (first, attempt) once captured; False where capture raised
        self.idle = torch.cuda.Event()  # the last solve's copies out are done

    def solve(self, inputs, kernel, delta, cfg):
        with self.lock:
            if self.graphs is None:
                with timer.span("lm_capture"):
                    self._capture(inputs, kernel, delta, cfg)
            if not self.graphs:
                return None
            torch.cuda.current_stream().wait_event(self.idle)
            _copy(self.inputs, inputs)
            first, attempt = self.graphs

            def begin():
                first.replay()
                return self.carry

            def step(_):
                attempt.replay()
                return self.carry, self.flags

            res = lm.lm_run(begin, step, cfg, graph=1)
            state = lm.BAState(*(t.clone() for t in res.state))
            res = res._replace(state=state, chi=res.chi.clone(), lam=res.lam.clone())
            self.idle.record()
        return state, res

    def _capture(self, inputs, kernel, delta, cfg) -> None:
        self.inputs = graph, poses, points, order, pose_prior = _map(torch.clone, inputs)
        main, side = torch.cuda.current_stream(), torch.cuda.Stream()
        try:
            # One attempt op by op first, on the capture's stream: the
            # libraries' handles and workspaces exist before capture, and
            # its results give the buffers' shapes.
            side.wait_stream(main)
            with torch.cuda.stream(side):
                prior = lm.ba_prior(pose_prior) if pose_prior is not None else None
                fns = lm.ba_functions(graph, order, prior, kernel, delta, cfg)
                warm = lm.lm_select(fns, lm.lm_begin(fns, lm.BAState(poses, points), cfg), cfg)
            main.wait_stream(side)
            self.prior, (self.carry, self.flags) = _map(torch.empty_like, (prior, warm))
            fns = lm.ba_functions(graph, order, self.prior, kernel, delta, cfg)
            first, attempt = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
            with torch.cuda.graph(first, stream=side, capture_error_mode="thread_local"):
                if pose_prior is not None:
                    _copy(self.prior, lm.ba_prior(pose_prior))
                _copy(self.carry, lm.lm_begin(fns, lm.BAState(poses, points), cfg))
            with torch.cuda.graph(attempt, pool=first.pool(), stream=side, capture_error_mode="thread_local"):
                _copy((self.carry, self.flags), lm.lm_select(fns, self.carry, cfg))
            main.wait_stream(side)
            self.graphs = (first, attempt)
        except RuntimeError as e:
            where = traceback.extract_tb(e.__traceback__)[-1]
            warnings.warn(f"window BA's LM attempt was not captured as a CUDA graph and runs op by op"
                          f" ({where.filename}:{where.lineno}: {where.line}): {e}", RuntimeWarning)
            self.graphs = False


_SOLVERS: Dict[tuple, _Solver] = {}
_LOCK = threading.Lock()


def _signature(inputs, kernel: str, delta: float, cfg: lm.LMConfig) -> tuple:
    graph, pose_prior = inputs[0], inputs[-1]
    return (tuple((t.device, t.dtype, tuple(t.shape)) for t in _leaves(inputs)), pose_prior is not None,
            tuple(graph.intr), kernel, float(delta), cfg._replace(iterations=0, false_cnt_threshold=0, trace=False))


def solve(graph, poses, points, order, pose_prior, kernel: str, delta: float, cfg: lm.LMConfig):
    """`lm.solve_ba`'s (state, result) on a card through the signature's
    graphs, captured here at its first solve; None where capture raised."""
    inputs = (graph, poses, points, order, pose_prior)
    key = _signature(inputs, kernel, delta, cfg)
    with _LOCK:
        solver = _SOLVERS.get(key)
        if solver is None:
            solver = _SOLVERS[key] = _Solver()
    with torch.cuda.device(poses.device):
        return solver.solve(inputs, kernel, delta, cfg)
