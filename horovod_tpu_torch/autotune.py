"""Autotuning of the training step's exchange knobs: the port of
``horovod_tpu/jax/autotune.py``.

The knobs of ``DistributedOptimizer`` (fusion threshold, bucket count,
wire compression, the hierarchical ladder) and the mesh shape are fixed
when the optimizer is built, as they are trace-time constants of a jitted
step in the JAX package. So tuning means rebuilding the step for each
candidate and timing real steps: where the JAX package re-jits, the port
rebuilds the optimizer and, for a graphed step, captures the CUDA graph
again (``train.TuneStepFactory``). The categorical knobs (wire dtype,
ladder, mesh shape) are explored exhaustively as branches; the fusion
threshold, alone or jointly with the bucket count, is seeded with a
coarse log-spaced grid and refined per branch by expected improvement
over ``gp_fit_predict``, the native ``GaussianProcess`` of the port's own
core (``cc/src/autotuner.h``, built by ``cc/__init__.py``), as the JAX
package's ``tune`` ranks with its core's. The two cores are one source
built with the same flags, so their GPs agree bit for bit and a near tie
between two candidates' expected improvements breaks the same way in both
packages. A GP in Python agrees only to rounding: ``-march=native`` lets
the compiler fuse the Cholesky's multiply-adds, and at 8-11 points a
prediction moved by 1.1e-12 (of 34.8) against the same arithmetic with
every product rounded.

    def step_factory(fusion_threshold, compression):
        ...rebuild the optimizer and the step...
        return run, sync           # run dispatches, sync fences

    report = tune(step_factory, compressions=("none", "bf16"))

``measure_steps_per_s`` is the timing method of every rate the port
reports (``transformer_benchmark`` takes it from here). ``tune`` calls
it through this module at call time, so a test can script the rates.
``OnlineTuner`` is the warm-startable online face of the same acquisition
that ``control.TrainingController`` asks for its next candidate.

The port runs one process per card, so a multi-rank job has one tuner per
rank. Each rate is agreed before anything is decided from it
(``agreed_max``: the slowest rank's), so every rank visits the same
candidates and builds the same fusion plan, and their collectives keep
matching. The JAX package's single controller process needs no such step.
Counterparts: ``Measurement``/``TuneReport`` (``:47``, ``:73``),
``measure_steps_per_s`` (``:111``), ``_expected_improvement`` (``:136``),
``_ei_suggest`` (``:146``), ``_ei_suggest_joint`` (``:178``), ``tune``
(``:230``) and ``OnlineTuner`` (``:392``).

The native core's own tuner is here too, as in ``horovod_tpu.autotune``:
``ParameterManager`` (the eager engine embeds one under
``HOROVOD_AUTOTUNE=1``; this is the same object over ctypes) and
``gp_fit_predict``.
"""

from __future__ import annotations

import ctypes
import math
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

import numpy as np
import torch


# The coarse seed grid of fusion thresholds, 1 to 256 MiB.
DEFAULT_THRESHOLDS = (1 << 20, 4 << 20, 16 << 20, 64 << 20, 256 << 20)


@dataclass
class Measurement:
    """One measured candidate config."""

    branch: dict
    fusion_threshold: int
    steps_per_s: float
    num_buckets: int = 1
    compression: str = "none"
    hierarchical: bool = False
    mesh_shape: str = ""

    @property
    def config(self) -> dict:
        out = {**self.branch, "fusion_threshold": self.fusion_threshold,
               "num_buckets": self.num_buckets}
        if self.compression != "none":
            out["compression"] = self.compression
        if self.hierarchical:
            out["hierarchical"] = True
        if self.mesh_shape:
            out["mesh"] = self.mesh_shape
        return out


@dataclass
class TuneReport:
    best: Measurement
    table: list = field(default_factory=list)  # all measurements, best first

    def knob_curve(self) -> str:
        """The measured knob curve, one row per candidate."""
        with_buckets = any(m.num_buckets != 1 for m in self.table)
        with_comp = any(m.compression != "none" for m in self.table)
        with_hier = any(m.hierarchical for m in self.table)
        with_mesh = any(m.mesh_shape for m in self.table)
        head = "branch | fusion_threshold | "
        if with_buckets:
            head += "num_buckets | "
        if with_comp:
            head += "compression | "
        if with_hier:
            head += "ladder | "
        if with_mesh:
            head += "mesh | "
        lines = [head + "steps/s"]
        for m in sorted(self.table,
                        key=lambda m: (str(m.branch), m.fusion_threshold,
                                       m.num_buckets, m.compression,
                                       m.hierarchical, m.mesh_shape)):
            b = ",".join(f"{k}={v}" for k, v in sorted(m.branch.items())) or "-"
            mid = f"{m.fusion_threshold >> 20} MiB | "
            if with_buckets:
                mid += f"{m.num_buckets} | "
            if with_comp:
                mid += f"{m.compression} | "
            if with_hier:
                mid += ("hier | " if m.hierarchical else "flat | ")
            if with_mesh:
                mid += f"{m.mesh_shape or '-'} | "
            lines.append(f"{b} | {mid}{m.steps_per_s:.2f}")
        return "\n".join(lines)


def measure_steps_per_s(run_step: Callable[[], None], warmup: int = 2,
                        iters: int = 5, reps: int = 3,
                        sync: Optional[Callable[[], None]] = None) -> float:
    """Median-window step rate: ``warmup`` calls, then ``reps`` windows of
    ``iters`` calls with one ``sync`` at each window's end; the rate of the
    median window. ``run_step`` may block itself (then omit ``sync``) or
    dispatch asynchronously with ``sync`` as the window's fence."""
    fence = sync or (lambda: None)
    for _ in range(warmup):
        run_step()
    fence()
    windows = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(iters):
            run_step()
        fence()
        windows.append(time.perf_counter() - t0)
    windows.sort()
    return iters / windows[len(windows) // 2]


def agreed_max(values: Sequence[float]) -> list[float]:
    """Each value's maximum over the ranks of ``init()``'s world, the same
    floats on every rank; before ``init()`` or in a world of one, the
    values as they are. Every rank takes part, once per call."""
    from .common import basics

    if not basics.is_initialized() or basics.size() == 1:
        return [float(v) for v in values]
    t = torch.tensor([float(v) for v in values], dtype=torch.float64,
                     device=basics.device())
    torch.distributed.all_reduce(t, op=torch.distributed.ReduceOp.MAX)
    return t.tolist()


def _expected_improvement(mu: float, sigma: float, best: float) -> float:
    if sigma <= 1e-12:
        return max(0.0, mu - best)
    z = (mu - best) / sigma
    pdf = math.exp(-0.5 * z * z) / math.sqrt(2 * math.pi)
    cdf = 0.5 * (1.0 + math.erf(z / math.sqrt(2)))
    return (mu - best) * cdf + sigma * pdf


def _ei_suggest(measured: dict[int, float], lo: int, hi: int) -> Optional[int]:
    """Next threshold to try in [lo, hi]: argmax EI over a log2 grid, using
    the GP fit on (log2 threshold -> normalized score)."""
    if len(measured) < 2:
        return None
    xs = [math.log2(t) for t in measured]
    ys = list(measured.values())
    mean = sum(ys) / len(ys)
    std = (sum((y - mean) ** 2 for y in ys) / len(ys)) ** 0.5 or 1.0
    yn = [(y - mean) / std for y in ys]
    best = max(yn)
    X = [[x] for x in xs]
    cand_best, ei_best = None, 1e-6  # below this EI, the curve is flat: stop
    steps = 33
    for i in range(steps):
        x = math.log2(lo) + (math.log2(hi) - math.log2(lo)) * i / (steps - 1)
        t = int(round(2 ** x))
        # skip near-duplicates of measured points (within 10%)
        if any(abs(math.log2(t) - mx) < 0.14 for mx in xs):
            continue
        try:
            mu, sigma = gp_fit_predict(X, yn, [x])
        except RuntimeError:
            return None
        ei = _expected_improvement(mu, sigma, best)
        if ei > ei_best:
            cand_best, ei_best = t, ei
    return cand_best


def _ei_suggest_joint(measured: dict[tuple[int, int], float],
                      th_bounds: tuple[int, int],
                      nb_bounds: tuple[int, int]) -> Optional[tuple[int, int]]:
    """2-D EI over (fusion_threshold, num_buckets), keys (threshold, buckets).

    Both knobs are log2-mapped and normalized to [0, 1] per dimension before
    the GP fit (the kernel has one fixed length scale, so raw log2
    coordinates would weight the dimensions arbitrarily). The suggestion is
    the argmax of expected improvement over a candidate grid, skipping
    near-duplicates of measured configs."""
    if len(measured) < 3:            # a plane needs 3 points before EI helps
        return None
    t_lo, t_hi = math.log2(th_bounds[0]), math.log2(th_bounds[1])
    b_lo, b_hi = math.log2(max(1, nb_bounds[0])), math.log2(max(1, nb_bounds[1]))
    t_span = (t_hi - t_lo) or 1.0
    b_span = (b_hi - b_lo) or 1.0

    def unit(th, nb):
        return [(math.log2(th) - t_lo) / t_span,
                (math.log2(max(1, nb)) - b_lo) / b_span]

    X = [unit(th, nb) for th, nb in measured]
    ys = list(measured.values())
    mean = sum(ys) / len(ys)
    std = (sum((y - mean) ** 2 for y in ys) / len(ys)) ** 0.5 or 1.0
    yn = [(y - mean) / std for y in ys]
    best = max(yn)
    cand_best, ei_best = None, 1e-6
    t_steps, b_steps = 17, max(2, int(b_span) * 2 + 1)
    for i in range(t_steps):
        tx = i / (t_steps - 1)
        th = int(round(2 ** (t_lo + tx * t_span)))
        for j in range(b_steps):
            bx = j / (b_steps - 1)
            nb = int(round(2 ** (b_lo + bx * b_span)))
            q = unit(th, nb)
            if any(abs(q[0] - p[0]) < 0.05 and abs(q[1] - p[1]) < 0.05
                   for p in X):
                continue
            try:
                mu, sigma = gp_fit_predict(X, yn, q)
            except RuntimeError:
                return None
            ei = _expected_improvement(mu, sigma, best)
            if ei > ei_best:
                cand_best, ei_best = (th, nb), ei
    return cand_best


def tune(step_factory: Callable[..., Callable[[], None]],
         thresholds: Sequence[int] = DEFAULT_THRESHOLDS,
         branches: Optional[Sequence[dict]] = None,
         num_buckets: Optional[Sequence[int]] = None,
         compressions: Optional[Sequence[str]] = None,
         hierarchicals: Optional[Sequence[bool]] = None,
         mesh_shapes: Optional[Sequence[str]] = None,
         warmup: int = 2, iters: int = 5, reps: int = 3,
         gp_rounds: int = 2, log_path: Optional[str] = None,
         verbose: bool = False) -> TuneReport:
    """Measure every (branch x seed threshold), then refine each branch's
    threshold with ``gp_rounds`` of GP/EI suggestions. Returns the report
    with the best config first.

    ``step_factory(fusion_threshold=..., **branch)`` returns either a
    zero-arg callable that runs ONE training step and blocks, or a ``(run,
    sync)`` pair where ``run`` dispatches asynchronously and ``sync``
    fences at window ends. Rebuilding the step inside the factory is the
    tuning mechanism.

    Each grid below joins the search as a dimension and adds its keyword
    to the factory's call; left None, the factory's signature and the
    log's columns stay without it:

    - ``num_buckets`` (e.g. ``(1, 4, 8)``): the seeds cover the cross
      product with the thresholds and the GP/EI refinement runs in the 2-D
      (threshold, buckets) plane; ``num_buckets=``.
    - ``compressions`` (HOROVOD_COMPRESSION names, ``"topk@<ratio>"``
      specs included): categorical, explored exhaustively, the continuous
      refinement run per value; ``compression=``.
    - ``hierarchicals`` (e.g. ``(False, True)``): the ladder, categorical
      the same way; ``hierarchical=``.
    - ``mesh_shapes`` (``"<batch>x<shard>"`` or
      ``"<batch>x<shard>x<model>"`` HOROVOD_MESH specs): categorical; the
      factory rebuilds its step over that layout; ``mesh_shape=``.

    ``log_path`` gets one CSV row per candidate, in measurement order.
    In a multi-rank world every rank calls ``tune`` with the same
    arguments; each candidate's rate is the slowest rank's.
    """
    branches = list(branches) if branches is not None else [{}]
    tune_buckets = num_buckets is not None
    bucket_grid = tuple(num_buckets) if tune_buckets else (1,)
    tune_comp = compressions is not None
    comp_grid = tuple(compressions) if tune_comp else ("none",)
    tune_hier = hierarchicals is not None
    hier_grid = tuple(hierarchicals) if tune_hier else (False,)
    tune_mesh = mesh_shapes is not None
    mesh_grid = tuple(mesh_shapes) if tune_mesh else ("",)
    table: list[Measurement] = []
    log_rows = []

    def run(branch: dict, th: int, nb: int = 1,
            comp: str = "none", hier: bool = False,
            mesh: str = "") -> Measurement:
        kw = dict(branch)
        if tune_buckets:
            kw["num_buckets"] = nb
        if tune_comp:
            kw["compression"] = comp
        if tune_hier:
            kw["hierarchical"] = hier
        if tune_mesh:
            kw["mesh_shape"] = mesh
        made = step_factory(fusion_threshold=th, **kw)
        step, sync = made if isinstance(made, tuple) else (made, None)
        # The slowest rank's rate: the longest window, on every rank.
        rate = -agreed_max(
            [-measure_steps_per_s(step, warmup, iters, reps, sync=sync)])[0]
        m = Measurement(branch, th, rate, nb, comp, hier, mesh)
        table.append(m)
        token = ";".join(f"{k}={v}" for k, v in sorted(branch.items())) or "-"
        row = [token, str(th)]
        if tune_buckets:
            row.append(str(nb))
        if tune_comp:
            row.append(comp)
        if tune_hier:
            row.append("hier" if hier else "flat")
        if tune_mesh:
            row.append(mesh or "-")
        log_rows.append(",".join(row + [f"{rate:.4f}"]))
        if verbose:
            buckets_txt = f" buckets={nb}" if tune_buckets else ""
            comp_txt = f" wire={comp}" if tune_comp else ""
            hier_txt = (" ladder=hier" if hier else " ladder=flat") \
                if tune_hier else ""
            mesh_txt = f" mesh={mesh}" if tune_mesh else ""
            print(f"  autotune: {branch} threshold={th >> 20}MiB"
                  f"{buckets_txt}{comp_txt}{hier_txt}{mesh_txt} -> "
                  f"{rate:.2f} steps/s",
                  file=sys.stderr, flush=True)
        return m

    for branch in branches:
        for comp in comp_grid:
            for hier in hier_grid:
                for mesh in mesh_grid:
                    measured: dict[tuple[int, int], float] = {}
                    for th in thresholds:
                        for nb in bucket_grid:
                            measured[(th, nb)] = run(branch, th, nb, comp,
                                                     hier, mesh).steps_per_s
                    lo, hi = min(thresholds), max(thresholds)
                    for _ in range(gp_rounds):
                        if tune_buckets:
                            nxt = _ei_suggest_joint(
                                measured, (lo, hi),
                                (min(bucket_grid), max(bucket_grid)))
                        else:
                            flat = {th: v for (th, _), v in measured.items()}
                            th_next = _ei_suggest(flat, lo, hi)
                            nxt = (th_next, 1) if th_next is not None else None
                        if nxt is None or nxt in measured:
                            break
                        measured[nxt] = run(branch, *nxt, comp,
                                            hier, mesh).steps_per_s

    table.sort(key=lambda m: -m.steps_per_s)
    if log_path:
        with open(log_path, "w") as f:
            cols = ["branch", "fusion_threshold"]
            if tune_buckets:
                cols.append("num_buckets")
            if tune_comp:
                cols.append("compression")
            if tune_hier:
                cols.append("ladder")
            if tune_mesh:
                cols.append("mesh")
            f.write(",".join(cols + ["steps_per_s"]) + "\n")
            f.write("\n".join(log_rows) + "\n")
    return TuneReport(best=table[0], table=table)


class OnlineTuner:
    """The online face of ``tune``'s GP/EI acquisition: a running job feeds
    it (threshold, num_buckets) -> steps/s observations as its canaries
    commit, and asks for the next continuous-knob candidate without an
    offline sweep.

    ``seed`` warm-starts the model: a ``TuneReport``, its ``table`` list,
    or a ``{(threshold, buckets): steps_per_s}`` dict. Observations of the
    live job overwrite seeded points at the same coordinates."""

    def __init__(self, th_bounds: tuple = (
            DEFAULT_THRESHOLDS[0], DEFAULT_THRESHOLDS[-1]),
            nb_bounds: tuple = (1, 32),
            seed=None) -> None:
        self.th_bounds = (int(th_bounds[0]), int(th_bounds[1]))
        self.nb_bounds = (int(nb_bounds[0]), int(nb_bounds[1]))
        self.measured: dict[tuple[int, int], float] = {}
        if seed is not None:
            self.warm_start(seed)

    def warm_start(self, seed) -> int:
        """Fold an offline model in; returns the number of points loaded."""
        table = getattr(seed, "table", seed)
        n = 0
        if isinstance(table, dict):
            for key, rate in table.items():
                th, nb = (key if isinstance(key, tuple) else (key, 1))
                self.measured[(int(th), int(nb))] = float(rate)
                n += 1
            return n
        for m in table:
            self.measured[(int(m.fusion_threshold),
                           int(m.num_buckets))] = float(m.steps_per_s)
            n += 1
        return n

    def observe(self, threshold: int, num_buckets: int,
                steps_per_s: float) -> None:
        self.measured[(int(threshold), int(num_buckets))] = \
            float(steps_per_s)

    def best(self) -> Optional[tuple[int, int]]:
        if not self.measured:
            return None
        return max(self.measured, key=self.measured.get)

    def suggest(self) -> Optional[tuple[int, int]]:
        """Next (threshold, num_buckets) to canary: argmax EI over the
        joint space, or the 1-D threshold acquisition while the bucket
        dimension has no spread. A cold model (fewer than 3 points) probes
        both threshold extremes, then one bucketed mid-point, the spread
        the GP needs before the acquisition takes over. None: nothing left
        worth a canary."""
        if len(self.measured) < 3:
            mid = int(round((self.th_bounds[0] * self.th_bounds[1]) ** 0.5))
            for cand in ((self.th_bounds[1], self.nb_bounds[0]),
                         (self.th_bounds[0], self.nb_bounds[0]),
                         (mid, min(max(4, self.nb_bounds[0]),
                                   self.nb_bounds[1]))):
                if cand not in self.measured:
                    return cand
            return None
        nbs = {nb for _, nb in self.measured}
        if len(nbs) > 1:
            nxt = _ei_suggest_joint(self.measured, self.th_bounds,
                                    self.nb_bounds)
            if nxt is not None and nxt not in self.measured:
                return nxt
            return None
        nb = next(iter(nbs), 1)
        flat = {th: v for (th, _), v in self.measured.items()}
        th = _ei_suggest(flat, *self.th_bounds)
        if th is None or (th, nb) in self.measured:
            return None
        return (int(th), int(nb))


# ---------------------------------------------- the native core's tuner

def _lib():
    from .cc import lib_path

    lib = ctypes.CDLL(lib_path())
    lib.hvd_pm_create.restype = ctypes.c_void_p
    lib.hvd_pm_create.argtypes = [ctypes.c_longlong, ctypes.c_double,
                                  ctypes.c_int, ctypes.c_int]
    lib.hvd_pm_destroy.argtypes = [ctypes.c_void_p]
    lib.hvd_pm_update.restype = ctypes.c_int
    lib.hvd_pm_update.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_double]
    lib.hvd_pm_active.restype = ctypes.c_int
    lib.hvd_pm_active.argtypes = [ctypes.c_void_p]
    lib.hvd_pm_fusion_threshold.restype = ctypes.c_longlong
    lib.hvd_pm_fusion_threshold.argtypes = [ctypes.c_void_p]
    lib.hvd_pm_cycle_time_ms.restype = ctypes.c_double
    lib.hvd_pm_cycle_time_ms.argtypes = [ctypes.c_void_p]
    lib.hvd_pm_set_log.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.hvd_pm_set_hierarchy.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_int,
                                         ctypes.c_int]
    lib.hvd_pm_enable_hierarchy.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                            ctypes.c_int]
    lib.hvd_pm_hier_allreduce.restype = ctypes.c_int
    lib.hvd_pm_hier_allreduce.argtypes = [ctypes.c_void_p]
    lib.hvd_pm_hier_allgather.restype = ctypes.c_int
    lib.hvd_pm_hier_allgather.argtypes = [ctypes.c_void_p]
    lib.hvd_pm_set_num_buckets.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                           ctypes.c_int]
    lib.hvd_pm_num_buckets.restype = ctypes.c_int
    lib.hvd_pm_num_buckets.argtypes = [ctypes.c_void_p]
    lib.hvd_gp_fit_predict.restype = ctypes.c_int
    lib.hvd_gp_fit_predict.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
    ]
    return lib


def gp_fit_predict(X: Sequence[Sequence[float]], y: Sequence[float],
                   xstar: Sequence[float]) -> tuple[float, float]:
    """Fit the native GP and predict (mu, sigma) at ``xstar``."""
    lib = _lib()
    Xa = np.ascontiguousarray(X, dtype=np.float64)
    ya = np.ascontiguousarray(y, dtype=np.float64)
    xs = np.ascontiguousarray(xstar, dtype=np.float64)
    mu = ctypes.c_double()
    sigma = ctypes.c_double()
    rc = lib.hvd_gp_fit_predict(
        Xa.shape[0], Xa.shape[1],
        Xa.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ya.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        xs.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.byref(mu), ctypes.byref(sigma),
    )
    if rc != 0:
        raise RuntimeError("GP fit failed (matrix not positive definite?)")
    return mu.value, sigma.value


class ParameterManager:
    """Tunes (fusion_threshold, cycle_time_ms) from throughput samples;
    pass ``num_buckets`` to open the overlap scheduler's bucket-count
    dimension and search (fusion_threshold, num_buckets) jointly."""

    def __init__(self, fusion_threshold: int = 64 << 20,
                 cycle_time_ms: float = 5.0,
                 threshold_pinned: bool = False, cycle_pinned: bool = False,
                 num_buckets: Optional[int] = None,
                 num_buckets_pinned: bool = False,
                 log_path: Optional[str] = None) -> None:
        self._lib = _lib()
        self._h = self._lib.hvd_pm_create(
            fusion_threshold, cycle_time_ms, int(threshold_pinned),
            int(cycle_pinned))
        if num_buckets is not None:
            self._lib.hvd_pm_set_num_buckets(self._h, int(num_buckets),
                                             int(num_buckets_pinned))
        if log_path:
            self._lib.hvd_pm_set_log(self._h, log_path.encode())

    def update(self, bytes_moved: int, seconds: float) -> bool:
        """Record one sample; returns True when the knobs changed."""
        return bool(self._lib.hvd_pm_update(self._h, bytes_moved, seconds))

    @property
    def active(self) -> bool:
        return bool(self._lib.hvd_pm_active(self._h))

    @property
    def fusion_threshold(self) -> int:
        return int(self._lib.hvd_pm_fusion_threshold(self._h))

    @property
    def cycle_time_ms(self) -> float:
        return float(self._lib.hvd_pm_cycle_time_ms(self._h))

    @property
    def num_buckets(self) -> int:
        return int(self._lib.hvd_pm_num_buckets(self._h))

    def set_num_buckets(self, num_buckets: int, pinned: bool = False) -> None:
        """Seed the overlap scheduler's bucket count and open (default) or
        pin its joint search dimension."""
        self._lib.hvd_pm_set_num_buckets(self._h, int(num_buckets),
                                         int(pinned))

    def set_hierarchy(self, allreduce_on: bool, allgather_on: bool,
                      allreduce_pinned: bool = False,
                      allgather_pinned: bool = False) -> None:
        """Seed the categorical hierarchical knobs (and optionally pin them
        out of the search), mirroring the env-seeded values the eager
        engine's embedded manager starts from."""
        self._lib.hvd_pm_set_hierarchy(
            self._h, int(allreduce_on), int(allgather_on),
            int(allreduce_pinned), int(allgather_pinned))

    def enable_hierarchy(self, allreduce_capable: bool = True,
                         allgather_capable: bool = True) -> None:
        """Open the categorical hierarchical dimensions for exploration
        (reference parameter_manager.h:172 tunes the same flags). Only
        meaningful on a multi-host topology; the eager engine's embedded
        manager calls this automatically after registration."""
        self._lib.hvd_pm_enable_hierarchy(
            self._h, int(allreduce_capable), int(allgather_capable))

    @property
    def hier_allreduce(self) -> bool:
        return bool(self._lib.hvd_pm_hier_allreduce(self._h))

    @property
    def hier_allgather(self) -> bool:
        return bool(self._lib.hvd_pm_hier_allgather(self._h))

    def close(self) -> None:
        if self._h:
            self._lib.hvd_pm_destroy(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass
