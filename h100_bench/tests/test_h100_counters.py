"""The operation count and the kernels' least times against hand counts."""
from __future__ import annotations

import pytest
import torch

from h100_bench.bench import roofline, work
from h100_bench.bench.context import load
from h100_bench.reference import ops

SXM = roofline.CARDS["SXM"]


def test_a_conv_counts_two_operations_a_multiply_add():
    x = torch.empty(2, 3, 10, 12, device="meta")
    w = torch.empty(5, 3, 3, 3, device="meta")
    with ops.counting() as box:
        ops.conv2d(x, w, None, padding=1)
    assert box[0] == 2 * (2 * 5 * 10 * 12) * (3 * 9)
    with ops.counting() as box:
        ops.conv2d(x, w, None, stride=2, padding=1)
    assert box[0] == 2 * (2 * 5 * 5 * 6) * 27


def test_a_training_conv_counts_its_backward_products():
    x = torch.empty(1, 4, 6, 6, device="meta", requires_grad=True)
    w = torch.empty(8, 4, 3, 3, device="meta", requires_grad=True)
    fwd = 2 * (8 * 36) * 36
    with ops.counting() as box:
        ops.conv2d(x, w, None, padding=1)
    assert box[0] == 3 * fwd
    with ops.counting() as box, torch.no_grad():
        ops.conv2d(x, w, None, padding=1)
    assert box[0] == fwd
    x0 = torch.empty(1, 4, 6, 6, device="meta")
    with ops.counting() as box:
        ops.conv2d(x0, w, None, padding=1)
    assert box[0] == 2 * fwd  # no gradient for the input


def test_a_deformable_conv_counts_its_contraction():
    x = torch.empty(2, 8, 5, 6, device="meta")
    off = torch.empty(2, 2 * 18, 5, 6, device="meta")
    mask = torch.empty(2, 2 * 9, 5, 6, device="meta")
    w = torch.empty(4, 8, 3, 3, device="meta")
    with ops.counting() as box:
        ops.deform_conv2d(x, off, mask, w, None, 1, 2)
    assert box[0] == 2 * 2 * 4 * 30 * 8 * 9


def test_a_small_refinenet_clip_counts_by_hand():
    """Counted on a frame cut to 1×1 and scaled back: the count is exact."""
    cfg = load("configs", "refinenet_x4")
    kw = cfg["net"]["kwargs"]
    kw.update(num_features=[4, 4], num_stages=1)
    shapes = work.shapes_of(work.build_net(cfg["net"], "cpu"))
    B, T, h, w, U, F = 1, 14, 8, 8, 6, 4
    Tc = T - 2 * U
    n = work.count_ops(cfg, shapes, lambda net, cut: net.forward(
        torch.zeros(B, T, h // cut, w // cut, 1), torch.zeros(B, T, 1)), False, 1)
    hw = h * w
    in_block = T * hw * F * 9
    lstm = 2 * T * 2 * hw * (4 * F) * (2 * F * 9)  # 2 directions, 2 layers
    C = 2 * F + 1
    refine = (T - 4) * hw * (C * 5 * C * 9 + F * C * 9)
    out = 3 * Tc * (hw * 4 * F * F * 9 + 4 * hw * 4 * F * F * 9 + 16 * hw * F * 9)
    assert n == 2 * (in_block + lstm + refine + out)


def test_the_gate_bounds_are_the_kernel_tables():
    serve = roofline.gate_bounds(1, 64, 64, 64, SXM)
    train = roofline.gate_bounds(16, 64, 32, 32, SXM)
    assert serve["lstm_gates_kernel"] * 1e6 == pytest.approx(2.19, abs=0.01)
    assert train["lstm_gates_kernel"] * 1e6 == pytest.approx(8.76, abs=0.01)
    assert train["lstm_gates_bwd_kernel"] * 1e6 == pytest.approx(15.02, abs=0.01)


def test_the_dcn_bounds_are_the_kernel_tables():
    b = roofline.dcn_bounds(16, 128, 32, 32, 8, 9, SXM)
    assert b["deform_im2col_kernel"] * 1e6 == pytest.approx(29.27, abs=0.01)
    assert b["deform_col2im_kernel"] * 1e6 == pytest.approx(29.27, abs=0.01)
    assert b["deform_col2im_coord_kernel"] * 1e6 == pytest.approx(33.49, abs=0.01)
    serve = roofline.dcn_bounds(1, 128, 64, 64, 8, 9, SXM)
    assert serve["deform_im2col_kernel"] * 1e6 == pytest.approx(7.32, abs=0.01)


def test_a_bound_takes_the_operations_where_they_dominate():
    rates = (1e15, 1e9, 0)  # a card with plenty of bytes and few operations
    b = roofline.gate_bounds(1, 1, 1, 1, rates)
    assert b["lstm_gates_kernel"] == pytest.approx(roofline.GATE_OPS / 1e9)


@pytest.mark.parametrize("name,part", [("NVIDIA H100 80GB HBM3", "SXM"), ("NVIDIA H100 PCIe", "PCIe"),
                                       ("NVIDIA H100 NVL", "NVL")])
def test_the_part_is_read_from_the_cards_name(name, part):
    assert roofline.part(name) == part
    assert roofline.peaks(name)[1] == roofline.CARDS[part][1]
