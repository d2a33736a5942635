"""The traced stretch's arithmetic: interval unions, idle gaps, the
breakdown and the readers that take a trace."""

import math

import devtrace
import harness


def trace(device, host=(), window=(0, 100), units=2):
    return devtrace.Trace(window=window, device=list(device), host=list(host), units=units)


def test_union_counts_overlaps_once():
    assert devtrace.union_ns([(0, 10), (5, 15), (20, 30), (22, 25)]) == 25
    assert devtrace.union_ns([]) == 0
    # kernels on two streams at once: the union, not the sum
    spans = [(0, 40, "a", 1), (10, 50, "b", 2), (60, 70, "c", 1)]
    t = trace(spans)
    assert math.isclose(t.busy_s(), 60e-9)
    assert math.isclose(t.busy_s([spans[0]]), 40e-9)


def test_gaps_and_clipping():
    assert devtrace.gaps_ns([(10, 20), (15, 30), (50, 60)], 0, 100) == [
        (0, 10), (30, 50), (60, 100)]
    t = trace([(-20, 10, "early", 1), (90, 130, "late", 1)])
    assert t.clipped(t.device) == [(0, 10), (90, 100)]
    assert math.isclose(t.busy_s(), 20e-9)


def test_breakdown_names_ops_and_gaps():
    device = [(0, 10, "k1", 1), (20, 30, "k1", 1), (40, 45, "k2", 1)]
    host = [(0, 100, "outer"), (12, 18, "inner"), (31, 39, "cudaEventSynchronize")]
    b = devtrace.breakdown(trace(device, host))
    assert b["device_ops"] == [["k1", 20e-9], ["k2", 5e-9]]
    names = [name for name, _ in b["idle_gaps"]]
    assert b["idle_gaps"][0] == ["outer", 55e-9]  # 45..100
    assert "outer > inner" in names and "outer > cudaEventSynchronize" in names


def test_kernel_buckets():
    cat = devtrace.kernel_category
    assert cat("void fused_conv3x3_kernel<float, 0, 1>(...)") == "fused_conv3x3"
    assert cat("fused_conv3x3_dgrad_pack_kernel") == "fused_conv3x3_dgrad"
    assert cat("sm90_xmma_fprop_implicit_gemm_f32f32") == "cudnn conv"
    assert cat("cudnn::engines_precompiled::nchwToNhwcKernel") == "copies / layout"


def test_readers_on_a_trace():
    cell = harness.cell("fp-kitti.dump.b12")
    device = [(0, 30, "sm90_xmma_fprop_implicit_gemm", 1), (10, 40, "sm90_xmma_dgrad", 2),
              (50, 60, "void fused_conv3x3_kernel<float>", 1),
              (60, 62, "Memcpy DtoH (Device -> Pinned)", 3)]
    m = harness.Measure(cell=cell, window_s=1.0, units=2,
                        trace=trace(device, units=2), flops_per_unit=1.0)
    read = lambda name: harness.metric_reader(name).read(m)  # noqa: E731
    assert math.isclose(read("cudnn_conv_ms_per_img.dump"), 40e-6 / 2)
    assert math.isclose(read("device_idle_pct.dump"), 100 * (1 - 52 / 100))
    assert read("kernels_per_img.predict") == 1.5
    bound = harness.load_module(f"{harness.HERE}/flops.py", "f").fused_bound_s(
        harness.reference_model(cell.config), 12, 192, 640, "float32", False)
    assert math.isclose(read("fused_conv3x3_roofline.dump"), 100 * bound / 12 * 2 / 10e-9)
    # nothing of the kernel traced: no roofline
    m.trace.device = device[:2]
    assert read("fused_conv3x3_roofline.dump") is None
