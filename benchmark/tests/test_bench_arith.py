"""The benchmark's frozen arithmetic on hand-made inputs: the model's
operation counts, the layers' least times, and the interval arithmetic of
the device trace (busy time, exposed NCCL, a layer's device time, idle
gaps by host range)."""

import pytest

from benchmark import counts, trace

SWIN_B = dict(patch_size=4, embed_dim=128, depths=(2, 2, 18, 2))


@pytest.mark.parametrize("img,batch,window", [(512, 8, 7), (1024, 2, 7), (512, 8, 12)])
def test_train_count_is_the_ports(img, batch, window):
    from semantic_segmentation_of_stylegan2_artifacts_tpu_torch.utils import flops

    params = 152_681_680
    assert counts.train_step_flops(img, batch, params, window_size=window, **SWIN_B) == \
        pytest.approx(flops.train_step_flops(img, batch, window_size=window, params=params,
                                             **SWIN_B), rel=1e-12)


def test_forward_count_is_a_third_of_the_step_without_adamw():
    fwd = counts.forward_flops(1024, 4, **SWIN_B)
    assert counts.train_step_flops(1024, 4, 0, **SWIN_B) == pytest.approx(3 * fwd)
    # 1024^2 b4: the forward count the issue quotes, 8.37 TFLOP
    assert fwd / 1e12 == pytest.approx(8.37, abs=0.01)


def test_every_swin_block_is_counted_once():
    blocks = list(counts.attention_blocks(1024, 4, 128, (2, 2, 18, 2), (4, 8, 16, 32)))
    # encoder 24, main decoder 22, cent1 4, cent2 2
    assert len(blocks) == 52
    assert blocks.count((256, 128, 4)) == 8 and blocks.count((64, 512, 16)) == 36


def test_layer_least_times_by_hand():
    # one attention call at grid 8, width 32, 2 heads, window 4, batch 1, forward
    t, c, n = 64, 32, 16
    ops = 2 * t * c * 3 * c + 4 * t * n * c + 2 * t * c * c
    params = 3 * c * c + 3 * c + c * c + c + 49 * 2
    want = max(ops / counts.PEAK_BF16_FLOP_S,
               (2 * (t * c + t * c) + 4 * params) / counts.PEAK_HBM_BYTES_S) * 1e3
    got = counts.attention_ms(1, 4, False, img_size=32, patch_size=4, embed_dim=32,
                              depths=(1, 0, 0, 0), num_heads=(2, 2, 2, 2))
    # the encoder's block and its mirror in each of the three decoders
    assert got == pytest.approx(4 * want)
    head = counts.refine_head_ms(2, 1024, 4, 128, True)
    conv = 2.0 * 2 * 1024 * 1024 * 128 * 9 * 128
    proj = 2.0 * 2 * 256 * 256 * 128 * 2048
    assert head == pytest.approx(3 * (2 * conv + proj) / counts.PEAK_BF16_FLOP_S * 1e3)


def test_interval_arithmetic():
    assert trace.union([(5, 7), (0, 2), (1, 3), (7, 8)]) == [(0, 3), (5, 8)]
    assert trace.length([(0, 2), (1, 3)]) == 3
    assert trace.subtract([(0, 10)], [(2, 3), (5, 7), (9, 12)]) == [(0, 2), (3, 5), (7, 9)]
    assert trace.gaps([(1, 2), (4, 6)], (0, 8)) == [(0, 1), (2, 4), (6, 8)]
    assert trace.clip([(-1, 1), (2, 3), (9, 11)], (0, 10)) == [(0, 1), (2, 3), (9, 10)]


def _x(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid,
            "args": args}


def _events():
    """Window 0-100 on thread 1; an attention span 10-30 launching kernel A
    (forward, seq 7); the backward of seq 7 on thread 2 launching kernel B;
    kernel C outside the layer; NCCL 60-90 overlapping C at 60-70; an
    optimizer range launching D."""
    return [
        _x(trace.WINDOW_SPAN, "user_annotation", 0, 100),
        _x("bench.attn", "user_annotation", 10, 20),
        _x("aten::mm", "cpu_op", 12, 2, **{"Sequence number": 7}),
        _x("cudaLaunchKernel", "cuda_runtime", 13, 1, correlation=1),
        _x("kA", "kernel", 14, 6, tid=7, correlation=1),
        _x(trace.BACKWARD_PREFIX + "MmBackward0", "cpu_op", 40, 10, tid=2,
           **{"Sequence number": 7}),
        _x("cudaLaunchKernel", "cuda_runtime", 41, 1, tid=2, correlation=2),
        _x("kB", "kernel", 42, 8, tid=7, correlation=2),
        _x("aten::add", "cpu_op", 54, 2, **{"Sequence number": 8}),
        _x("cudaLaunchKernel", "cuda_runtime", 55, 1, correlation=3),
        _x("kC", "kernel", 56, 14, tid=7, correlation=3),
        _x("ncclDevKernel_AllReduce", "kernel", 60, 30, tid=8, correlation=4),
        _x("Optimizer.step#AdamW.step", "user_annotation", 91, 6),
        _x("cudaLaunchKernel", "cuda_runtime", 92, 1, correlation=5),
        _x("kD", "kernel", 93, 3, tid=7, correlation=5),
        _x("aten::item", "cpu_op", 20, 19),
    ]


def test_device_only_trace_takes_its_window_from_the_marker():
    events = [e for e in _events() if e["cat"] in trace.DEVICE_CATS] + [
        _x("at::cuda::(anonymous namespace)::spin_kernel(long)", "kernel", 1, 4, tid=7),
        _x("fill", "kernel", 0, 1, tid=7)]
    tr = trace.from_events(events, steps=2)
    assert tr.window == (5, 96)
    assert tr.busy_us() == 6 + 8 + 14 + 3


def test_trace_readings():
    tr = trace.from_events(_events(), steps=2)
    assert tr.window_us == 100
    assert tr.busy_us() == 6 + 8 + 14 + 3
    assert tr.nccl_exposed_us() == 20  # 70-90
    assert tr.layer_us("bench.attn") == 6 + 8  # forward and its backward
    assert tr.layer_us("bench.head") is None
    assert tr.span_device_us("Optimizer.step#") == 3
    assert tr.top_ops(2) == [["ncclDevKernel_AllReduce", 30e-6], ["kC", 14e-6]]
    idle = dict(tr.idle_by_host())
    # gaps 0-14, 20-42, 50-56, 70-93, 96-100: by the range begun last at each start
    assert idle[trace.WINDOW_SPAN] == pytest.approx((14 + 6 + 23) * 1e-6)
    assert idle["aten::item"] == pytest.approx(22e-6)
    assert idle["Optimizer.step#AdamW.step"] == pytest.approx(4e-6)


def test_metric_readers_on_a_hand_made_trace():
    from benchmark import metrics
    from conftest import tiny_cell

    cell = tiny_cell("train")
    cell.chips = 4
    tr = trace.from_events(_events(), steps=2)
    ctx = metrics.Context(cell=cell, trace=tr, device_trace=tr, params=1000)
    assert metrics.reader("idle_share.train").read(ctx) == pytest.approx(100 * (1 - 31 / 100))
    assert metrics.reader("idle_share.predict").read(ctx) is None
    assert metrics.reader("nccl_exposed_ms.train").read(ctx) == pytest.approx(20e-3 / 2)
    assert metrics.reader("optimizer_ms.train").read(ctx) == pytest.approx(3e-3 / 2)
    share = metrics.reader("attn_roofline.train").read(ctx)
    least = counts.attention_ms(2, 4, True, **counts.arch_kwargs(cell.config))
    assert share == pytest.approx(100 * least * 2 / 14e-3)
    assert metrics.reader("refine_head_roofline.train").read(ctx) is None
    assert metrics.reader("nccl_exposed_ms.train").combine([1.0, 3.0]) == 3.0
    assert metrics.reader("mfu.train").combine([1.0, 3.0]) == 2.0


def test_the_train_rate_is_read_from_the_untraced_window():
    from benchmark import metrics
    from conftest import tiny_cell

    tr = trace.from_events(_events(), steps=2)
    rate = metrics.reader("img_per_s.train")
    cell = tiny_cell("train")
    ctx = metrics.Context(cell=cell, trace=tr, device_trace=tr, params=1000, steps_per_s=2.5)
    assert rate.read(ctx) == pytest.approx(2.5 * cell.batch)
    assert rate.read(metrics.Context(cell=cell, trace=tr, device_trace=tr, params=1000)) is None
    assert rate.read(metrics.Context(cell=tiny_cell("predict"), trace=tr, device_trace=tr,
                                     params=1000, steps_per_s=2.5)) is None
    assert rate.combine([1.0, 3.0]) == 4.0
