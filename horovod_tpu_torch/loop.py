"""K training steps per dispatch: the counterpart of
``horovod_tpu.jax.make_scan_train_loop``.

The JAX package compiles K steps into one ``lax.scan`` program. On the
card the counterpart of that one program is a CUDA graph: the loop
captures one whole step (the batch drawn from a ``data.DeviceCache`` with
its device counter, forward, loss, backward, the bucket allreduces and the
optimizer) and replays it K times per dispatch, with no host work between
steps and one read of the mean loss per dispatch by the caller.

Before capture, a few warm-up steps run on a side stream: they load the
kernel libraries, create the NCCL communicators and the optimizer's state,
so that nothing is built or allocated for the first time inside the graph.
Then the parameters, the optimizer state, the counter and, where the
caller passes the module, its buffers (BatchNorm's running statistics) are
put back as they were before the warm-up (state the warm-up created is
zeroed, which is where Adam's and momentum SGD's first step start from),
so a dispatch runs exactly the K steps that K eager calls would. On the
CPU, which the caller must ask for, a dispatch is the same K steps run
eagerly. On the card there is no eager path: a capture that fails raises.
"""

from __future__ import annotations

import itertools
import time

import torch

from .common import basics
from .data import DeviceCache
from .parallel import telemetry
from .tracing import record_compiled_plan

WARMUP_STEPS = 3

# The captures of this process, numbered from 1 in the compiled-plan lines.
_CAPTURES = itertools.count(1)

# One warm-up stream per device: cuBLAS keeps a workspace for every stream
# it has run on until the process ends, so a stream made per capture would
# leave one behind at each capture (a graph captured again per autotune
# candidate or controller change).
_WARMUP_STREAMS: dict = {}


def warmup_stream(device: torch.device) -> torch.cuda.Stream:
    """The side stream the warm-up runs on: one per device, for the
    process."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _WARMUP_STREAMS:
        _WARMUP_STREAMS[index] = torch.cuda.Stream(device)
    return _WARMUP_STREAMS[index]


class TrainingState:
    """The parameters and optimizer state of ``optimizer``, a step counter
    and the buffers of ``module`` (BatchNorm's running statistics, which a
    training step updates in place), as they are now; ``restore()`` puts
    them back in place (the same tensors, which a captured graph keeps
    pointing at). Optimizer state created after the snapshot is zeroed:
    where Adam's and momentum SGD's first step start from."""

    def __init__(self, optimizer, counter: torch.Tensor, module=None) -> None:
        self.optimizer = optimizer
        self.params = [p for g in optimizer.param_groups for p in g["params"]]
        self.saved = [p.detach().clone() for p in self.params]
        self.state = {p: {k: v.clone() for k, v in st.items() if torch.is_tensor(v)}
                      for p, st in optimizer.state.items()}
        self.counter = counter
        self.saved_counter = counter.clone()
        self.buffers = list(module.buffers()) if module is not None else []
        self.saved_buffers = [b.detach().clone() for b in self.buffers]

    @torch.no_grad()
    def restore(self) -> None:
        for p, s in zip(self.params, self.saved):
            p.copy_(s)
        for p, st in self.optimizer.state.items():
            before = self.state.get(p, {})
            for k, v in st.items():
                if not torch.is_tensor(v):
                    continue
                if k in before:
                    v.copy_(before[k])
                else:
                    v.zero_()
        self.counter.copy_(self.saved_counter)
        for b, s in zip(self.buffers, self.saved_buffers):
            b.copy_(s)


class ScanTrainLoop:
    """``loop() -> mean loss`` of ``steps_per_dispatch`` steps; see the
    module docstring. ``losses`` holds the last dispatch's per-step losses
    (on the device), ``counter`` the cache's step counter, ``capture_s`` the
    host time of the warm-up and the capture."""

    def __init__(self, train_step, cache: DeviceCache, steps_per_dispatch: int,
                 optimizer, module=None) -> None:
        if steps_per_dispatch < 1:
            raise ValueError(f"steps_per_dispatch must be >= 1, got "
                             f"{steps_per_dispatch}")
        if getattr(optimizer, "backward_passes_per_step", 1) > 1:
            # DistributedOptimizer counts passes in Python, which a graph
            # replay would never run.
            raise ValueError("backward_passes_per_step > 1 keeps a host "
                             "counter that a CUDA graph cannot replay")
        self.train_step = train_step
        self.cache = cache
        self.k = steps_per_dispatch
        self.optimizer = getattr(optimizer, "optimizer", optimizer)
        self.module = module
        self.plan = getattr(optimizer, "compiled_plan", None)
        self.counter = cache.counter()
        self.device = self.counter.device
        self.losses = torch.zeros(self.k, device=self.device)
        self.graph = None
        self.warmed_up = False
        self.capture_s = None

    def _step(self) -> None:
        x, y, nxt = self.cache.sample(self.counter)
        loss = self.train_step(x, y)
        self.losses.index_copy_(0, (self.counter % self.k).reshape(1),
                                loss.detach().float().reshape(1))
        self.counter.copy_(nxt)

    def warm_up(self) -> None:
        """Run the warm-up steps on a side stream, then restore the
        parameters, the optimizer state, the counter and the module's
        buffers."""
        if self.device.type != "cuda":
            raise RuntimeError("the warm-up prepares a CUDA graph; on the "
                               "CPU the loop runs eagerly")
        t0 = time.perf_counter()
        before = TrainingState(self.optimizer, self.counter, self.module)
        side = warmup_stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_STEPS):
                self._step()
        torch.cuda.current_stream(self.device).wait_stream(side)
        before.restore()
        torch.cuda.synchronize(self.device)
        self.warmed_up = True
        self.capture_s = time.perf_counter() - t0

    def capture(self) -> None:
        """Warm up if not done yet, then capture one step in a CUDA graph."""
        if not self.warmed_up:
            self.warm_up()
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        try:
            with telemetry.capture_guard(), \
                    torch.cuda.graph(graph, capture_error_mode="thread_local"):
                self._step()
        except RuntimeError as e:
            raise RuntimeError(
                f"capturing the training step in a CUDA graph failed: {e}") from e
        torch.cuda.synchronize(self.device)
        self.graph = graph
        if self.plan is not None:
            # The port's counterpart of a compile: the plan is fixed into
            # the graph, which no later replay reports on.
            record_compiled_plan(*self.plan, capture=next(_CAPTURES))
        self.capture_s += time.perf_counter() - t0

    def __call__(self) -> torch.Tensor:
        """Run one dispatch of K steps; return their mean loss, a 0-d
        tensor on the device (reading it is the dispatch's one host sync)."""
        if self.device.type != "cuda":
            for _ in range(self.k):
                self._step()
            return self.losses.mean()
        if self.graph is None:
            self.capture()
        for _ in range(self.k):
            self.graph.replay()
        return self.losses.mean()


def make_scan_train_loop(train_step, cache: DeviceCache,
                         steps_per_dispatch: int = 8, *, optimizer,
                         module=None) -> ScanTrainLoop:
    """A loop of ``steps_per_dispatch`` steps per dispatch fed by ``cache``.

    ``train_step(x, y) -> loss`` is one whole step: zero_grad, forward,
    loss, backward and ``optimizer.step()``; the loss a 0-d tensor.
    ``optimizer`` is the step's optimizer (a ``DistributedOptimizer`` or a
    ``torch.optim`` one), whose parameters and state the warm-up restores;
    on the card build ``torch.optim.Adam`` with ``capturable=True``.
    ``module``, where the step updates buffers in place (BatchNorm's
    running statistics: the JAX package folds them into the loop's state),
    has its buffers restored after the warm-up too.
    """
    basics.require_not_elastic("make_scan_train_loop() (the CUDA-graphed loop)")
    return ScanTrainLoop(train_step, cache, steps_per_dispatch, optimizer,
                         module)
