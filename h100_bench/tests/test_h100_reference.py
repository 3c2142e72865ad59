"""The frozen plain reference against the port at narrow widths on the CPU:
RefineNet's forward and training gradients, EDVR with its deformable convs,
the deformable im2col alone, the phase codes and Adam."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.ops import (
    deform_conv,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.tools import (
    serve as port_serve,
)
from h100_bench.bench import phantom, work
from h100_bench.bench.context import load
from h100_bench.reference import edvr, ops, refine_net
from h100_bench.reference.adam import Adam
from h100_bench.reference.phase_code import phase_code


NARROW = {"RefineNet": {"num_features": [8, 8], "num_stages": 2},
          "EDVRNet": {"nf": 16, "groups": 2, "front_RBs": 1, "back_RBs": 2}}


def _narrow(name: str) -> dict:
    cfg = load("configs", name)
    cfg["net"]["kwargs"].update(NARROW[cfg["net"]["name"]])
    return cfg


def _pair(cfg, seed):
    """The port's net and the reference over the same seeded weights."""
    net = work.build_net(cfg["net"], "cpu")
    params = work.seeded_weights(cfg, work.shapes_of(net), seed, "cpu")
    net.load_state_dict(params)
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    return net, leaves, work.reference_net(cfg, leaves)


def _grad_gap(net, loss_port, leaves, loss_ref) -> float:
    names = [n for n, _ in net.named_parameters()]
    g1 = torch.autograd.grad(loss_port, list(net.parameters()), allow_unused=True)
    g2 = torch.autograd.grad(loss_ref, [leaves[n] for n in names], allow_unused=True)
    worst = 0.0
    for a, b in zip(g1, g2):
        assert (a is None) == (b is None)
        if a is not None:
            worst = max(worst, float((a - b).abs().max() / b.abs().max().clamp_min(1e-12)))
    return worst


@pytest.mark.parametrize("seed", [3, 2**31 + 5])
def test_refinenet_forward_and_step_gradients_match_the_port(seed):
    cfg = _narrow("refinenet_x4")
    net, leaves, ref = _pair(cfg, seed)
    g = torch.Generator().manual_seed(seed)
    lr = torch.randn(2, 19, 12, 12, 1, generator=g)
    pos = torch.randn(2, 19, 1, generator=g)
    hr = torch.randn(2, 7, 48, 48, 1, generator=g)
    outs, routs = net(lr, pos), ref.forward(lr, pos)
    assert len(outs) == len(routs) == 6
    for a, b in zip(outs, routs):
        torch.testing.assert_close(a, b, rtol=0, atol=2e-6)
    l1 = refine_net.train_loss(outs, hr, 2)
    l2 = refine_net.loss(ref, {"lr_imgs": lr, "pos_code": pos, "hr_imgs": hr}, cfg)
    assert abs(l1.item() - l2.item()) <= 1e-6 * abs(l2.item())
    assert _grad_gap(net, l1, leaves, l2) < 1e-5


def test_refinenet_serving_clip_matches_the_port():
    cfg = _narrow("refinenet_x4")
    net, leaves, ref = _pair(cfg, 11)
    g = torch.Generator().manual_seed(1)
    lr, pos = torch.randn(1, 20, 16, 16, 1, generator=g), torch.randn(1, 20, 1, generator=g)
    with torch.no_grad():
        torch.testing.assert_close(net(lr, pos)[-1], ref.forward(lr, pos)[-1], rtol=0, atol=2e-6)


def test_edvr_with_deformable_convs_matches_the_port():
    cfg = _narrow("edvr_x4")
    net, leaves, ref = _pair(cfg, 5)
    g = torch.Generator().manual_seed(2)
    lr, hr = torch.randn(2, 5, 16, 16, 1, generator=g), torch.randn(2, 64, 64, 1, generator=g)
    out, rout = net(lr), ref.forward(lr)
    torch.testing.assert_close(out, rout, rtol=0, atol=5e-6)
    loss_port = edvr.charbonnier(out, hr, 1e-6)
    loss_ref = edvr.loss(ref, {"lr_imgs": lr, "hr_img": hr}, cfg)
    assert _grad_gap(net, loss_port, leaves, loss_ref) < 1e-4


@pytest.mark.parametrize("scale", [0.0, 0.7, 6.0])
def test_deformable_im2col_matches_the_ports_plain_version(scale):
    g = torch.Generator().manual_seed(4)
    B, C, H, W, dg = 2, 8, 7, 9, 2
    x = torch.randn(B, C, H, W, generator=g)
    offset = scale * torch.randn(B, dg * 18, H, W, generator=g)
    mask = torch.rand(B, dg * 9, H, W, generator=g)
    weight = torch.randn(5, C, 3, 3, generator=g)
    mine = ops.deform_conv2d(x, offset, mask, weight, None, 1, dg)
    port = deform_conv.deform_conv2d_reference(x, offset, weight, mask=mask, padding=1,
                                               deformable_groups=dg)
    torch.testing.assert_close(mine, port, rtol=0, atol=2e-5)


def test_phase_codes_match_the_daemons_on_seeded_phantoms():
    gen = torch.Generator().manual_seed(2**31 + 99)
    seqs = phantom.sequences(gen, 6, 30, 256, 4, "cpu")
    for seq in seqs:
        lr = seq.permute(1, 2, 0).numpy()
        np.testing.assert_array_equal(phase_code(lr), port_serve.generate_phase_code(lr[:, :, None]))


def test_phase_code_falls_back_to_the_neutral_code_on_a_blank_sequence():
    blank = np.full((16, 16, 12), 40.0, np.float32)
    np.testing.assert_array_equal(phase_code(blank), port_serve.generate_phase_code(blank[:, :, None]))


def test_adam_matches_torch():
    g = torch.Generator().manual_seed(0)
    p0 = {"a": torch.randn(7, 3, generator=g), "b": torch.randn(5, generator=g)}
    mine = {k: v.clone() for k, v in p0.items()}
    theirs = [v.clone().requires_grad_(True) for v in p0.values()]
    opt, adam = torch.optim.Adam(theirs, lr=4e-4), Adam(mine, lr=4e-4)
    for _ in range(3):
        grads = {k: torch.randn(v.shape, generator=g) for k, v in p0.items()}
        for t, gr in zip(theirs, grads.values()):
            t.grad = gr.clone()
        opt.step()
        adam.step(grads)
    for t, k in zip(theirs, mine):
        torch.testing.assert_close(mine[k], t.detach(), rtol=0, atol=1e-7)
