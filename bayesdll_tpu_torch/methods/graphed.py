"""The fused multi-step path: a segment of K training steps of one runner,
or of one chain of a multi-chain run, with no host hook in between
(counterpart of the JAX package's scanned segment,
bayesdll_tpu/methods/base.py:239-265).

On the card, one step is captured as a CUDA graph and each step of a
segment is one `replay()`: no Python runs and no ATen op is dispatched per
step.  A graph reads and writes fixed addresses, so each runner or chain
keeps static buffers, and a segment is
  * one copy of its stacked batches into a static [cap, B, ...] buffer and
    of its scalars into static [cap, 3] and [cap, 5] tables (from pinned
    host memory when they come from the host; PyTorch's pinned allocator
    keeps that memory until the copy has run);
  * a reset of the step index (int64 [1] on the card) and of the moments'
    count (fp32 0-d, set from the host's count);
  * K steps, each a replay of the graph for its collect flag (below).
    Each selects its batch and its scalars at the step index, runs the
    method's `_step` on them (with `fused_scalars`), copies the new
    BatchNorm statistics into the static `net_state`, writes its loss and
    error at the index and advances the index.

The scalars are what the per-step path computes on the host
(`BaseRunner.fused_rows`, through `step_scalars` and
`bias_corrections`): per step the int64 (seed, step, gate) that the
kernels read, and the fp32 (lr_body, lr_head,
collect, bc1, bc2), the last two Adam's bias corrections.  The graph only
indexes into them, so it computes the per-step path's bits.

The host knows which steps collect a sample, so each runner or chain has
two graphs, one for the steps that collect (their moments update, masked
by the collect flag, `update_masked`) and one for those that do not (no
moments work at all); the host picks the graph per step.  A graph is
captured at its flag's first step, and again when the addresses of the
state, the net_state or the buffers, the target, or `_fused_key(ep)`
change: that step runs eagerly, as a real step, on a side stream (so the
kernels, library handles and workspaces the capture meets exist, and the
host branch of a state's first SGD step is behind it), and the capture
follows on that stream (capture runs the Python body but no device work,
so the host counters it moves are put back).  Each replay adds the launches
its graph recorded to the kernels' counters (ops/kernels.py), and one to
each of the state's host step counts (`step`, and Adam's `t`); the host's
moments count advances at the segment's end by its collect flags.  A step
must write its state's tensors in place (the Adam methods' v_mom, m and v2
included): a graph reads the addresses it captured, so a step that binds a
state field to a new tensor raises here.

On the CPU the same body runs eagerly for every step, on the same static
buffers and tables; so it does on the card for a step whose collectives a
graph cannot hold (a rank's step over gloo, parallel/shard.py).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from bayesdll_tpu_torch.ops import kernels


# the fp32 table's columns: lr_body, lr_head, collect, bc1, bc2
FLOAT_COLUMNS = 5
# the host counts of a state that every step advances by one
HOST_COUNTS = ("step", "t")


def fused_scalars(row_i, row_f, count) -> dict:
    """The scalars `_step` takes on the fused path, as views of the static
    rows: `dev` (seed, step, gate) int64 [3] for the kernels and the draws,
    `lr` the (body, head) pair of 0-d fp32, `collect` 0-d fp32 (1 or 0),
    `bc` Adam's bias corrections (1 - b1^t, 1 - b2^t) as fp32 [2] (the
    row adam_sghmc_update reads), and `count` 0-d fp32, the moments' count
    before the step."""
    return {"dev": row_i[0], "lr": (row_f[0, 0], row_f[0, 1]),
            "collect": row_f[0, 2], "bc": row_f[0, 3:5],
            "count": count, "should_sample": None}


def segments(batches, n: int, ends, budget: int):
    """The fused path's segments of an epoch of n steps (the JAX package's
    `_train_one_epoch_fused` cuts): from the (x, y) `batches` (host arrays,
    or tensors where the set is staged on the device), stacked (xs, ys,
    at_end) cut after each step index in `ends` (at_end True) and whenever
    the stacked bytes would pass `budget`."""
    ends = iter(sorted(set(ends) | {n}))
    next_end = next(ends)
    max_k = None
    buf_x, buf_y = [], []
    for i, (x, y) in enumerate(batches):
        if max_k is None:
            max_k = max(1, budget // (x.nbytes + y.nbytes))
        buf_x.append(x)
        buf_y.append(y)
        at_end = i + 1 == next_end
        if len(buf_x) == max_k or at_end:
            stack = torch.stack if isinstance(x, torch.Tensor) else np.stack
            yield stack(buf_x), stack(buf_y), at_end
            buf_x, buf_y = [], []
            if at_end:
                next_end = next(ends, n + 1)


def _tensors(tree):
    """The tensors of a state (a dataclass), a net_state (nested dicts) or
    a list of them, in a fixed order."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from _tensors(getattr(tree, f.name))
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _tensors(tree[k])
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _tensors(t)


def _copy_tree_(dst, src):
    """dst's tensors <- src's, in place (a net_state's nested dicts)."""
    if dst is src:
        return
    if isinstance(dst, dict):
        for k in dst:
            _copy_tree_(dst[k], src[k])
    else:
        dst.copy_(src)


def _put(dst: torch.Tensor, src):
    """dst <- src without waiting on the host: a host array goes through
    pinned memory to a card."""
    src = torch.as_tensor(src)
    if dst.is_cuda and not src.is_cuda:
        src = src.contiguous().pin_memory()
    dst.copy_(src, non_blocking=True)


def _host_counts(state) -> dict:
    return {n: getattr(state, n) for n in HOST_COUNTS if hasattr(state, n)}


def _tensor_fields(state) -> dict:
    """The tensor fields of a state (a dataclass), by name."""
    return {f.name: getattr(state, f.name) for f in dataclasses.fields(state)
            if isinstance(getattr(state, f.name), torch.Tensor)}


def _moments_count(state) -> int:
    m = getattr(state, "moments", None)
    return 0 if m is None else getattr(m, "cnt", getattr(m, "n", 0))


class StepGraph:
    """The static buffers and the captured steps of one runner or chain: a
    graph for the steps that collect a sample and one for those that do
    not, sharing one memory pool (no value passes between them through the
    pool: every step reads and writes the static buffers and the state)."""

    def __init__(self):
        self.bufs = None
        self.graphs = {}  # collect flag -> captured step
        self.launches = {}  # collect flag -> kernel launches of its step
        self.key = None  # what the graphs were captured against
        self.target = None  # the target they run (kept: its id is in key)
        self.pool = None
        self.side = None  # the stream of the eager steps and the captures
        self.capture_s = 0.0  # host seconds of its eager steps and captures

    def _buffers(self, k: int, xs: torch.Tensor, ys: torch.Tensor, device):
        """Static buffers for segments of up to k steps of batches shaped as
        xs[0] and ys[0]; new ones (and no graph) when these do not fit."""
        b = self.bufs
        if b is not None and b["xs"].shape[0] >= k \
                and b["xs"].shape[1:] == xs.shape[1:] \
                and b["ys"].shape[1:] == ys.shape[1:] \
                and b["xs"].dtype == xs.dtype and b["ys"].dtype == ys.dtype \
                and b["xs"].device == device:
            return b
        self.bufs = None
        self._drop_graphs()
        kw = dict(device=device)
        b = {"xs": torch.empty((k,) + xs.shape[1:], dtype=xs.dtype, **kw),
             "ys": torch.empty((k,) + ys.shape[1:], dtype=ys.dtype, **kw),
             "ints": torch.zeros((k, kernels.DEV_SCALARS), dtype=torch.int64,
                                 **kw),
             "flts": torch.zeros((k, FLOAT_COLUMNS), dtype=torch.float32,
                                 **kw),
             "idx": torch.zeros(1, dtype=torch.int64, **kw),
             "count": torch.zeros((), dtype=torch.float32, **kw),
             "loss": torch.zeros(k, dtype=torch.float32, **kw),
             "err": torch.zeros(k, dtype=torch.int64, **kw)}
        b["x"] = torch.empty((1,) + xs.shape[1:], dtype=xs.dtype, **kw)
        b["y"] = torch.empty((1,) + ys.shape[1:], dtype=ys.dtype, **kw)
        b["row_i"] = torch.zeros((1, kernels.DEV_SCALARS), dtype=torch.int64,
                                 **kw)
        b["row_f"] = torch.zeros((1, FLOAT_COLUMNS), dtype=torch.float32,
                                 **kw)
        on = fused_scalars(b["row_i"], b["row_f"], b["count"])
        b["scalars"] = {True: on, False: {**on, "collect": None}}
        self.bufs = b
        return b

    def _drop_graphs(self):
        self.graphs, self.launches = {}, {}
        self.key = self.target = self.pool = None

    def _key(self, runner, ep: int):
        # the target (its module and forward) by identity: the graphs keep
        # a reference to the one they captured, so no other object takes
        # its id
        return (runner._fused_key(ep), id(runner.target),
                tuple(t.data_ptr() for t in _tensors(
                    [runner.state, runner.net_state])),
                self.bufs["xs"].data_ptr())

    def _step(self, runner, collect: bool):
        """One fused step: the body that runs eagerly and that is captured;
        `collect` picks the scalars with or without the moments update."""
        b = self.bufs
        idx = b["idx"]
        torch.index_select(b["ints"], 0, idx, out=b["row_i"])
        torch.index_select(b["flts"], 0, idx, out=b["row_f"])
        torch.index_select(b["xs"], 0, idx, out=b["x"])
        torch.index_select(b["ys"], 0, idx, out=b["y"])
        ns = runner.net_state
        static = _tensor_fields(runner.state)
        runner.state, new_ns, (loss, err) = runner._step(
            runner.state, ns, b["x"][0], b["y"][0], None,
            b["scalars"][collect])
        moved = [k for k, t in _tensor_fields(runner.state).items()
                 if t is not static.get(k)]
        if moved:
            raise RuntimeError(
                f"{runner.method_name}: the fused path needs the step to "
                f"write its state in place; it rebound {moved}")
        _copy_tree_(ns, new_ns)
        b["loss"].index_copy_(0, idx, loss.reshape(1).float())
        b["err"].index_copy_(0, idx, err.reshape(1).long())
        idx.add_(1)

    def _eager_then_capture(self, runner, collect: bool):
        """One real step eagerly on the side stream, then the capture of
        the step with this collect flag on that stream.  The capture runs
        the Python body and no device work: the host counts it moves are
        put back, and the launches it counts are taken off and kept to add
        per replay."""
        tic = time.perf_counter()
        main = torch.cuda.current_stream(runner.device)
        self.side.wait_stream(main)
        with torch.cuda.stream(self.side):
            self._step(runner, collect)
        graph = torch.cuda.CUDAGraph()
        before = kernels.launch_counts()
        counts0 = _host_counts(runner.state)
        with torch.cuda.graph(graph, pool=self.pool, stream=self.side):
            self._step(runner, collect)
        for name, n in counts0.items():
            setattr(runner.state, name, n)
        self.launches[collect] = {
            n: c - before[n] for n, c in kernels.launch_counts().items()}
        kernels.set_launch_counts(before)
        self.graphs[collect] = graph
        self.pool = graph.pool()
        main.wait_stream(self.side)
        self.capture_s += time.perf_counter() - tic

    def run(self, runner, ep: int, xs, ys, bi0: int):
        """K = len(xs) fused steps of `runner` (its state, net_state and seed)
        from global step bi0.  Returns (loss[K], err[K]) on the device."""
        k = len(xs)
        device = runner.device
        xs, ys = torch.as_tensor(xs), torch.as_tensor(ys)
        ints, flts = runner.fused_rows(ep, bi0, k)
        b = self._buffers(k, xs, ys, device)
        for name, src in (("xs", xs), ("ys", ys), ("ints", ints),
                          ("flts", flts)):
            _put(b[name][:k], src)
        b["idx"].zero_()
        b["count"].fill_(float(_moments_count(runner.state)))
        collects = flts[:, 2] > 0
        if device.type != "cuda" or not getattr(runner.shard, "capturable",
                                                True):
            for c in collects:
                self._step(runner, bool(c))
        else:
            key = self._key(runner, ep)
            if key != self.key:
                self._drop_graphs()
                self.key, self.target = key, runner.target
            if self.side is None:
                self.side = torch.cuda.Stream(device)
            replays = {True: 0, False: 0}
            for c in map(bool, collects):
                graph = self.graphs.get(c)
                if graph is None:
                    self._eager_then_capture(runner, c)
                else:
                    graph.replay()
                    replays[c] += 1
            for c, n in replays.items():
                if n:
                    for name, v in _host_counts(runner.state).items():
                        setattr(runner.state, name, v + n)
                    counts = kernels.launch_counts()
                    kernels.set_launch_counts({
                        name: v + n * self.launches[c][name]
                        for name, v in counts.items()})
        if hasattr(runner.state, "moments"):
            runner.state.moments.advance(int(collects.sum()))
        runner.bi = bi0 + k
        return b["loss"][:k].clone(), b["err"][:k].clone()
