"""Roofline of a training step on the card, from the device profile: the
port of ``horovod_tpu/utils/roofline.py`` (``profile_device_ops`` ``:42``,
``format_report`` ``:122``).

``profile_device_ops(run_step)`` runs the step under ``torch.profiler``
and sums, per class of kernel, the device time, the bytes and the FLOPs,
then divides by the card's own peaks. The report keeps the JAX module's
keys (``ok``, ``steps``, ``device_ms_per_step``,
``model_bytes_gb_per_step``, ``achieved_gbs``, ``pct_hbm_roof``,
``model_tflop_per_step``, ``achieved_tflops``, ``categories``,
``top_ops``, ``logdir``) and adds the peaks with their inputs.

- **Device time** is the sum of kernel durations, by class: the classes
  of ``trace_step.kernel_class``, plus one class per kernel of the port
  (B1-B6: ``flash_fwd``, ``flash_bwd_dq``, ``flash_bwd_dkv`` and the three
  ``ring_flash_*``), told apart by their names (``fwd_tc_kernel<D, 0, BQ,
  BK>``, ``fwd_kernel<D, 0>`` and so on; the variant 0 is flash, 3 ring;
  the tensor-core kernels carry their tile pair after it).
- **FLOPs** of GEMMs and convolutions are the profiler's own
  (``with_flops``), which counts only those aten ops. The port's kernels
  are launched through ``ctypes`` and have no aten op: their FLOPs are
  counted from the shapes each launch ran with (``ops.flash_attention
  .launch_log``), as ``chip_smoke.py``'s ``flops`` counts them: 2 D per
  live (q, k) pair and product, 2, 3 and 4 products for the forward, dQ
  and dK/dV, live pairs causal or from the ring's positions. The same
  work counts the same whatever implements it.
- **Bytes** are operand bytes: of an aten op, the sizes of its recorded
  input shapes and dtypes (outputs are not recorded, and an operand read
  twice counts once); of B1-B6, each input read once and each output
  written once. They are a model of the traffic, not a DRAM counter, as
  XLA's ``bytes_accessed`` is in the JAX module. An op that launches
  several kernels shares its bytes and FLOPs among them by duration.
- A CUDA graph's replays run no host op and launch nothing through the
  wrappers, so nothing attributes work to their kernels: pass ``costs=``
  the ``kernel_costs`` of a report of the same step run eagerly (launches,
  FLOPs and bytes by kernel name, B1-B6 included). Kernels left without a
  cost count time only, in ``unattributed_ms_per_step``.
- **Records**: ``port_kernel_records`` counts the trace's kernels of each
  of B1-B6. A trace can hold fewer kernels than ran (the profiler drops
  device records it cannot place or store), and then every sum above is
  short: a caller that knows its launches holds the two counts equal and
  profiles again if they are not. The window opens and closes on an idle
  device with ``WINDOW_MARGIN_S`` of margin, so the first and last
  kernels lie well inside it.
- **Peaks** come from the device (``device_peaks``): dense bf16 FLOP/s =
  SMs x SM clock x 4096 FLOP per clock per SM, HBM bytes/s = 2 x memory
  clock x bus width / 8, with the SM count, the SM clock, the memory clock
  and the bus width read through the CUDA driver. The shares divide by
  these; the report also carries NVIDIA's data-sheet 989 TFLOP/s and
  3.35 TB/s, which the kernels' bounds in PERF.md use.

On the CPU there is no device profile: the report is ``ok=False`` with
the reason.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import re
import subprocess
import time
from collections import defaultdict
from dataclasses import asdict, dataclass
from typing import Callable, Optional

import torch

# NVIDIA's data-sheet figures for the H100 SXM (dense bf16, HBM3), which
# chip_smoke.py's kernel bounds divide by.
DATA_SHEET_BF16_FLOPS = 989e12
DATA_SHEET_HBM_BYTES = 3.35e12
# Dense bf16 tensor-core FLOP per clock per SM on Hopper.
BF16_FLOP_PER_CLOCK_PER_SM = 4096

# CUdevice_attribute values of cuda.h.
_ATTRIBUTES = {"sms": 16, "sm_clock_khz": 13, "mem_clock_khz": 36,
               "bus_width_bits": 37}

# Products per live (q, k) pair of each kernel of the port.
PRODUCTS = {"flash_fwd": 2, "flash_bwd_dq": 3, "flash_bwd_dkv": 4,
            "ring_flash_fwd": 2, "ring_flash_bwd_dq": 3, "ring_flash_bwd_dkv": 4}
_PORT_KERNEL = re.compile(
    r"\b(fwd|dq|dkv)(?:_tc)?_kernel<\s*\d+\s*,\s*(\d+)\s*(?:,\s*\d+\s*)*>")
# Idle seconds at each end of a profile's window.
WINDOW_MARGIN_S = 0.2
_PASSES = {"fwd": "fwd", "dq": "bwd_dq", "dkv": "bwd_dkv"}
_VARIANTS = {"0": "flash", "3": "ring_flash"}


@dataclass
class DevicePeaks:
    """A card's peaks and what they were computed from."""

    name: str
    sms: int
    sm_clock_hz: float
    mem_clock_hz: float
    bus_width_bits: int
    bf16_flops: float           # dense, FLOP/s
    hbm_bytes_per_s: float
    source: str

    def describe(self) -> str:
        return (f"{self.name}: dense bf16 {self.bf16_flops / 1e12:.1f} TFLOP/s "
                f"= {self.sms} SMs x {self.sm_clock_hz / 1e6:.0f} MHz x "
                f"{BF16_FLOP_PER_CLOCK_PER_SM} FLOP/clock (data sheet "
                f"{DATA_SHEET_BF16_FLOPS / 1e12:.0f}); HBM "
                f"{self.hbm_bytes_per_s / 1e12:.3f} TB/s = 2 x "
                f"{self.mem_clock_hz / 1e6:.0f} MHz x {self.bus_width_bits} "
                f"bits / 8 (data sheet {DATA_SHEET_HBM_BYTES / 1e12:.2f}); "
                f"inputs from {self.source}; the shares divide by these "
                f"device-read peaks")


def peaks_from(sms: int, sm_clock_hz: float, mem_clock_hz: float,
               bus_width_bits: int, name: str = "",
               source: str = "given") -> DevicePeaks:
    """The peaks of a card with these SMs and clocks."""
    return DevicePeaks(
        name=name, sms=int(sms), sm_clock_hz=float(sm_clock_hz),
        mem_clock_hz=float(mem_clock_hz), bus_width_bits=int(bus_width_bits),
        bf16_flops=sms * sm_clock_hz * BF16_FLOP_PER_CLOCK_PER_SM,
        hbm_bytes_per_s=2 * mem_clock_hz * bus_width_bits / 8, source=source)


def device_peaks(device=None) -> DevicePeaks:
    """The peaks of a CUDA device, from its SM count, maximum SM clock,
    memory clock and bus width as the CUDA driver reports them; raises
    without a card."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_peaks needs a CUDA device")
    index = 0 if device is None else (torch.device(device).index or 0)
    torch.cuda.init()
    lib = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_int()
    if lib.cuInit(0) or lib.cuDeviceGet(ctypes.byref(handle), index):
        raise RuntimeError(f"the CUDA driver did not open device {index}")
    got = {}
    for key, attribute in _ATTRIBUTES.items():
        value = ctypes.c_int()
        if lib.cuDeviceGetAttribute(ctypes.byref(value), attribute, handle):
            raise RuntimeError(f"cuDeviceGetAttribute({attribute}) failed")
        got[key] = value.value
    return peaks_from(got["sms"], got["sm_clock_khz"] * 1e3,
                      got["mem_clock_khz"] * 1e3, got["bus_width_bits"],
                      name=torch.cuda.get_device_name(index),
                      source="cuDeviceGetAttribute (SM count, clock rate, "
                             "memory clock rate, global memory bus width)")


def smi_max_clocks(index: int = 0) -> Optional[str]:
    """nvidia-smi's maximum SM and memory clocks, as it prints them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm,clocks.max.memory",
             "--format=csv,noheader", f"--id={index}"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() or None


def roofline_class(name: str) -> str:
    """A kernel's class: one per kernel of the port, else trace_step's."""
    from ..trace_step import kernel_class

    m = _PORT_KERNEL.search(name)
    if m and m.group(2) in _VARIANTS:
        return f"{_VARIANTS[m.group(2)]}_{_PASSES[m.group(1)]}"
    return kernel_class(name)


@contextlib.contextmanager
def record_launches():
    """Collect the geometry of every launch of the port's kernels in the
    scope (a CUDA graph's capture, for example) into the list it yields."""
    from ..ops import flash_attention as fa

    before, fa.launch_log = fa.launch_log, []
    try:
        yield fa.launch_log
    finally:
        fa.launch_log = before


def launch_cost(entry) -> tuple[str, float, float]:
    """(kernel, FLOPs, bytes) of one ``launch_log`` entry."""
    name, rows_q, rows_kv, t, d, itemsize, mask = entry
    if isinstance(mask, tuple):
        qpos, kpos = mask
        pairs = int((qpos.reshape(-1, 1) >= kpos.reshape(1, -1)).sum())
    else:
        pairs = t * (t + 1) // 2 if mask else t * t
    flops = 2.0 * d * pairs * PRODUCTS[name] * rows_q
    q, kv, row = rows_q * t * d * itemsize, rows_kv * t * d * itemsize, rows_q * t * 4
    if name.startswith("ring"):
        carry_q, carry_kv, pos = rows_q * t * d * 4, rows_kv * t * d * 4, 2 * t * 4
        moved = pos + {"ring_flash_fwd": q + 2 * kv + 2 * carry_q + 4 * row,
                       "ring_flash_bwd_dq": 2 * q + 2 * kv + 2 * row + 2 * carry_q,
                       "ring_flash_bwd_dkv": 2 * q + 2 * kv + 2 * row + 4 * carry_kv,
                       }[name]
    else:
        moved = {"flash_fwd": 2 * q + 2 * kv + row,
                 "flash_bwd_dq": 3 * q + 2 * kv + 2 * row,
                 "flash_bwd_dkv": 2 * q + 4 * kv + 2 * row}[name]
    return name, flops, float(moved)


# Bytes per element of the dtypes the profiler records, by its names.
_ITEMSIZE = {"float": 4, "double": 8, "c10::Half": 2, "c10::BFloat16": 2,
             "long int": 8, "int": 4, "short int": 2, "bool": 1,
             "unsigned char": 1, "signed char": 1}


def _operand_bytes(shapes, dtypes) -> float:
    """Bytes of an aten op's recorded tensor inputs."""
    total = 0.0
    for shape, dtype in zip(shapes or (), dtypes or ()):
        if shape and dtype in _ITEMSIZE and all(isinstance(n, int) for n in shape):
            n = _ITEMSIZE[dtype]
            for size in shape:
                n *= size
            total += n
    return total


def _input_dtypes(prof) -> dict:
    """Each recorded op's input dtypes, by its correlation id (the
    profiler's own events carry them; its FunctionEvents do not on every
    version)."""
    return {e.correlation_id(): e.dtypes()
            for e in prof.profiler.kineto_results.events()}


def _unavailable(reason: str) -> dict:
    return {"ok": False, "reason": reason}


def profile_device_ops(run_step: Callable[[], None], steps: int = 5,
                       sync: Optional[Callable[[], None]] = None,
                       logdir: Optional[str] = None, costs: Optional[dict] = None,
                       peaks: Optional[DevicePeaks] = None) -> dict:
    """Profile ``steps`` calls of ``run_step`` (warmed up by the caller)
    and aggregate the device's kernels; see the module docstring.
    ``logdir``: also write the Chrome trace there (``trace.json``).
    ``steps`` counts calls: a call that replays a graph of K steps is one."""
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        return _unavailable("no CUDA device: the trace holds no device kernels "
                            "(the step ran on the CPU)")
    fence = sync or torch.cuda.synchronize
    fence()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   record_shapes=True, with_flops=True)
    with record_launches() as log, prof:
        fence()
        time.sleep(WINDOW_MARGIN_S)
        for _ in range(steps):
            run_step()
        fence()
        time.sleep(WINDOW_MARGIN_S)
    if logdir:
        os.makedirs(logdir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    events = list(prof.events())
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation]
    if not kernels:
        return _unavailable("no CUDA kernels in the trace (a CUDA graph's "
                            "replays may be hidden from the profiler)")
    # Each op's FLOPs and bytes, shared among the kernels it launched by
    # duration, summed by kernel name: (launches, FLOPs, bytes).
    named = defaultdict(lambda: [0, 0.0, 0.0])
    dtypes = _input_dtypes(prof)
    for op in events:
        if op.device_type != torch.autograd.DeviceType.CPU or not op.kernels:
            continue
        total = sum(k.duration for k in op.kernels) or 1.0
        flops = float(op.flops or 0)
        moved = _operand_bytes(op.input_shapes, dtypes.get(op.id))
        for k in op.kernels:
            entry = named[k.name]
            entry[0] += 1
            entry[1] += flops * k.duration / total
            entry[2] += moved * k.duration / total
    # The port's kernels have no aten op: their FLOPs and bytes come from
    # the shapes of this run's launches, averaged by class, and join the
    # table by kernel name (a graph's profile then takes them from costs=).
    port = defaultdict(list)
    for entry in log:
        name, f, b = launch_cost(entry)
        port[name].append((f, b))
    port_named = {}
    for k in kernels:
        shapes = port.get(roofline_class(k.name))
        if shapes:
            entry = port_named.setdefault(k.name, [0, 0.0, 0.0])
            entry[0] += 1
            entry[1] += sum(f for f, _ in shapes) / len(shapes)
            entry[2] += sum(b for _, b in shapes) / len(shapes)
    named.update(port_named)
    cat = defaultdict(lambda: [0.0, 0.0, 0.0])        # us, bytes, flops
    by_name = defaultdict(lambda: [0.0, 0.0, 0.0, 0])
    records = defaultdict(int)
    unattributed_us = 0.0
    for k in kernels:
        us = k.time_range.elapsed_us()
        cls = roofline_class(k.name)
        n, f, b = named.get(k.name) or (costs or {}).get(k.name) or (0, 0.0, 0.0)
        if n:
            f, b = f / n, b / n
        else:
            unattributed_us += us
        for table, key in ((cat, cls), (by_name, k.name)):
            table[key][0] += us
            table[key][1] += b
            table[key][2] += f
        by_name[k.name][3] += 1
        records[cls] += 1
    peaks = peaks or device_peaks()
    tot_t = sum(v[0] for v in cat.values()) / 1e6
    tot_b = sum(v[1] for v in cat.values())
    tot_f = sum(v[2] for v in cat.values())

    def row(key, us, b, f):
        t = us / 1e6
        return {"name": key, "ms_per_step": round(t / steps * 1e3, 3),
                "gbs": round(b / t / 1e9, 1) if t else 0.0,
                "pct_hbm_roof": round(b / t / peaks.hbm_bytes_per_s * 100, 1) if t else 0.0,
                "tflops": round(f / t / 1e12, 2) if t else 0.0}

    return {
        "ok": True,
        "steps": steps,
        "device_ms_per_step": round(tot_t / steps * 1e3, 2),
        "model_bytes_gb_per_step": round(tot_b / steps / 1e9, 2),
        "achieved_gbs": round(tot_b / tot_t / 1e9, 1),
        "pct_hbm_roof": round(tot_b / tot_t / peaks.hbm_bytes_per_s * 100, 1),
        "model_tflop_per_step": round(tot_f / steps / 1e12, 3),
        "achieved_tflops": round(tot_f / tot_t / 1e12, 1),
        "pct_bf16_peak": round(tot_f / tot_t / peaks.bf16_flops * 100, 1),
        "unattributed_ms_per_step": round(unattributed_us / steps / 1e3, 3),
        "port_kernel_tflop_per_step": {
            n: v[2] / steps / 1e12 for n, v in cat.items() if n in PRODUCTS},
        "port_kernel_records": {n: c for n, c in records.items() if n in PRODUCTS},
        "categories": [row(k, *v) for k, v in
                       sorted(cat.items(), key=lambda kv: -kv[1][0])],
        "top_ops": [row(k, *v[:3]) for k, v in
                    sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]],
        "kernel_costs": {n: tuple(v) for n, v in named.items()},
        "peaks": asdict(peaks),
        "data_sheet": {"bf16_flops": DATA_SHEET_BF16_FLOPS,
                       "hbm_bytes_per_s": DATA_SHEET_HBM_BYTES},
        "logdir": logdir,
    }


def format_report(rep: dict) -> str:
    if not rep.get("ok"):
        return f"roofline: unavailable ({rep.get('reason')})"
    peaks = rep["peaks"]
    lines = [
        f"device busy {rep['device_ms_per_step']} ms/step | "
        f"operand bytes {rep['model_bytes_gb_per_step']} GB/step | "
        f"achieved {rep['achieved_gbs']} GB/s "
        f"({rep['pct_hbm_roof']}% of {peaks['hbm_bytes_per_s'] / 1e12:.3f} TB/s HBM) | "
        f"{rep['achieved_tflops']} TFLOP/s "
        f"({round(rep['achieved_tflops'] * 1e12 / peaks['bf16_flops'] * 100, 1)}% "
        f"of {peaks['bf16_flops'] / 1e12:.1f} TFLOP/s bf16 peak)",
        f"peaks read from {peaks['name'] or 'the device'}: {peaks['sms']} SMs x "
        f"{peaks['sm_clock_hz'] / 1e6:.0f} MHz x {BF16_FLOP_PER_CLOCK_PER_SM} "
        f"FLOP/clock; 2 x {peaks['mem_clock_hz'] / 1e6:.0f} MHz x "
        f"{peaks['bus_width_bits']} bits / 8 (data sheet "
        f"{rep['data_sheet']['bf16_flops'] / 1e12:.0f} TFLOP/s, "
        f"{rep['data_sheet']['hbm_bytes_per_s'] / 1e12:.2f} TB/s; shares divide "
        f"by the device-read peaks)",
        f"{'category':<24}{'ms/step':>9}{'GB/s':>8}{'%roof':>7}{'TFLOP/s':>9}",
    ]
    for r in rep["categories"]:
        if r["ms_per_step"] < 0.01:
            continue
        lines.append(f"{r['name']:<24}{r['ms_per_step']:>9}{r['gbs']:>8}"
                     f"{r['pct_hbm_roof']:>7}{r['tflops']:>9}")
    return "\n".join(lines)
