"""The port's roofline (``horovod_tpu_torch/utils/roofline.py``) on the
CPU, beside the JAX module's tests (tests/test_roofline.py): a CPU run
degrades to ``ok=False`` with its reason and the formatter prints that;
the report of synthetic numbers prints its categories and both roofs;
the peaks from given SMs and clocks; the classes of the port's kernels by
name; and the work of a launch, which ``chip_smoke.py``'s bounds take
from ``launch_cost``, against the closed forms of its pairs and bytes.
The device numbers come from the chip run (``chip_smoke.py`` phase
22c)."""

import importlib.util
import os

import pytest
import torch

from horovod_tpu_torch.utils import roofline
from launch_util import REPO


def test_cpu_profile_degrades_gracefully():
    calls = []
    rep = roofline.profile_device_ops(lambda: calls.append(1), steps=2)
    assert rep["ok"] is False and "CPU" in rep["reason"]
    assert "unavailable" in roofline.format_report(rep)
    with pytest.raises(RuntimeError, match="CUDA"):
        roofline.device_peaks()


def test_peaks_from_sms_and_clocks():
    # NVIDIA's 989 TFLOP/s is 132 SMs at 1830 MHz; 3.35 TB/s is HBM3 at
    # 2619 MHz on a 5120-bit bus.
    p = roofline.peaks_from(132, 1830e6, 2619e6, 5120, name="card")
    assert p.bf16_flops == 132 * 1830e6 * 4096
    assert abs(p.bf16_flops - roofline.DATA_SHEET_BF16_FLOPS) / 989e12 < 1e-3
    assert p.hbm_bytes_per_s == 2 * 2619e6 * 5120 / 8
    assert abs(p.hbm_bytes_per_s - roofline.DATA_SHEET_HBM_BYTES) / 3.35e12 < 1e-3
    fast = roofline.peaks_from(132, 1980e6, 2619e6, 5120)
    assert fast.bf16_flops / p.bf16_flops == pytest.approx(1980 / 1830)
    text = p.describe()
    for piece in ("132 SMs", "1830 MHz", "4096", "2619 MHz", "5120 bits",
                  "data sheet 989", "data sheet 3.35", "device-read"):
        assert piece in text


def _synthetic_report():
    p = roofline.peaks_from(132, 1980e6, 2619e6, 5120, name="NVIDIA H100")
    return {
        "ok": True, "steps": 3, "device_ms_per_step": 47.1,
        "model_bytes_gb_per_step": 61.2, "achieved_gbs": 1299.4,
        "pct_hbm_roof": 38.8, "model_tflop_per_step": 10.45,
        "achieved_tflops": 221.9,
        "categories": [
            {"name": "gemm", "ms_per_step": 30.12, "gbs": 910.2,
             "pct_hbm_roof": 27.2, "tflops": 301.7},
            {"name": "flash_bwd_dkv", "ms_per_step": 2.515, "gbs": 120.0,
             "pct_hbm_roof": 3.6, "tflops": 328.0},
            {"name": "tiny", "ms_per_step": 0.001, "gbs": 1.0,
             "pct_hbm_roof": 0.0, "tflops": 0.0}],
        "top_ops": [], "peaks": vars(p),
        "data_sheet": {"bf16_flops": roofline.DATA_SHEET_BF16_FLOPS,
                       "hbm_bytes_per_s": roofline.DATA_SHEET_HBM_BYTES},
        "logdir": None}


def test_report_formatting_from_synthetic():
    rep = _synthetic_report()
    out = roofline.format_report(rep)
    assert "gemm" in out and "flash_bwd_dkv" in out and "301.7" in out
    assert "tiny" not in out                 # rows under 0.01 ms are dropped
    peak = rep["peaks"]["bf16_flops"]
    assert f"{round(221.9e12 / peak * 100, 1)}% of {peak / 1e12:.1f}" in out
    assert "3.352 TB/s HBM" in out and "38.8%" in out
    assert "132 SMs x 1980 MHz" in out and "data sheet 989 TFLOP/s" in out


@pytest.mark.parametrize("name,cls", [
    ("void fwd_tc_kernel<128, 0>(CUtensorMap_st, CUtensorMap_st, int)", "flash_fwd"),
    ("void dq_tc_kernel<64, 0>(CUtensorMap_st)", "flash_bwd_dq"),
    ("void dkv_tc_kernel<128, 0>(CUtensorMap_st)", "flash_bwd_dkv"),
    ("void fwd_tc_kernel<128, 3>(CUtensorMap_st)", "ring_flash_fwd"),
    ("void dq_kernel<32, 3>(Args)", "ring_flash_bwd_dq"),
    ("void dkv_kernel<128, 3>(Args)", "ring_flash_bwd_dkv"),
    ("void fwd_kernel<64, 0>(Args)", "flash_fwd"),
    ("void fwd_tc_kernel<128, 0, 64, 128>(CUtensorMap_st, int)", "flash_fwd"),
    ("void dq_tc_kernel<128, 3, 128, 64>(CUtensorMap_st)", "ring_flash_bwd_dq"),
    ("void dkv_tc_kernel<32, 0, 64, 128>(CUtensorMap_st)", "flash_bwd_dkv"),
    ("nvjet_tst_256x128_64x4_1x2_h_ssched_bz_coopA_TNT", "gemm"),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL", "nccl"),
    ("void at::native::vectorized_elementwise_kernel<8, CUDAFunctor_add<c10::BFloat16>>",
     "elementwise"),
])
def test_kernel_classes(name, cls):
    assert roofline.roofline_class(name) == cls


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# Products per live (q, k) pair: S and O = PV forward; S, dP and dQ for
# dQ; S, dP, dV and dK for dK/dV.
PRODUCTS = {"fwd": 2, "bwd_dq": 3, "bwd_dkv": 4}


def _moved(name, q, kv, row):
    """Bytes of a flash launch, each input read once and each output
    written once: forward q, k, v in, O and the log-sum-exp out; dQ q, k,
    v, dO, L and delta in, dQ out; dK/dV q, k, v, dO, L and delta in, dK
    and dV out."""
    return {"flash_fwd": 2 * q + 2 * kv + row,
            "flash_bwd_dq": 3 * q + 2 * kv + 2 * row,
            "flash_bwd_dkv": 2 * q + 4 * kv + 2 * row}[name]


@pytest.mark.parametrize("name", ["flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"])
@pytest.mark.parametrize("b,t,h,hkv,d,causal", [
    (1, 4096, 8, 8, 128, True), (2, 96, 4, 2, 32, False), (1, 1024, 8, 2, 64, True)])
def test_flash_launch_counts_the_bound_s_operations(name, b, t, h, hkv, d, causal):
    cs = _chip_smoke()
    entry = (name, b * h, b * hkv, t, d, 2, causal)
    kernel, flops, moved = roofline.launch_cost(entry)
    pairs = t * (t + 1) // 2 if causal else t * t
    assert kernel == name
    assert flops == 2 * d * pairs * PRODUCTS[name.removeprefix("flash_")] * b * h
    assert moved == _moved(name, b * h * t * d * 2, b * hkv * t * d * 2, b * h * t * 4)
    f, ms, by = cs.bound(entry, "bfloat16")
    want = max(flops / cs.PEAK_FLOPS["bfloat16"], moved / cs.PEAK_BYTES) * 1e3
    assert f == flops and ms == pytest.approx(want, rel=1e-12)
    assert by == ("operations" if flops / cs.PEAK_FLOPS["bfloat16"] >=
                  moved / cs.PEAK_BYTES else "bytes")


@pytest.mark.parametrize("name", ["ring_flash_fwd", "ring_flash_bwd_dq",
                                  "ring_flash_bwd_dkv"])
def test_ring_launch_counts_the_live_pairs(name):
    cs = _chip_smoke()
    from horovod_tpu_torch.ops.ring_flash import ring_positions

    b, t, h, hkv, d, n = 1, 96, 4, 2, 32, 4
    qpos = ring_positions(1, t, n, True, "cpu")
    kpos = ring_positions(0, t, n, True, "cpu")
    live = sum(int(qp >= kp) for qp in qpos.tolist() for kp in kpos.tolist())
    assert 0 < live < t * t
    entry = (name, b * h, b * hkv, t, d, 2, (qpos, kpos))
    _, flops, moved = roofline.launch_cost(entry)
    assert flops == 2 * d * live * PRODUCTS[name.removeprefix("ring_flash_")] * b * h
    f, ms, _ = cs.bound(entry, "bfloat16")
    assert f == flops
    assert ms == pytest.approx(max(flops / cs.PEAK_FLOPS["bfloat16"],
                                   moved / cs.PEAK_BYTES) * 1e3, rel=1e-12)


def test_record_launches_restores_the_log():
    from horovod_tpu_torch.ops import flash_attention as fa

    assert fa.launch_log is None
    with roofline.record_launches() as log:
        assert fa.launch_log is log == []
        # On the CPU the wrappers run their plain versions: no launch.
        q = torch.randn(1, 16, 2, 32)
        fa.flash_attention(q, q, q)
    assert log == [] and fa.launch_log is None
