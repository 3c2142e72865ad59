"""RefineNet (Lin et al., MICCAI 2020, arXiv:2005.10626) in plain PyTorch.

The published net, written from its description and the layer equations
of the original code, as a function of a parameter dict whose keys are the
original ``state_dict``'s:

* in-block: conv 3×3 (C → F) + PReLU on every frame;
* per stage, a forward and a backward ConvLSTM of ``len(features)``
  layers: gates = conv 3×3 over [x ‖ h] with bias, split (i, f, o, g),
  ``c' = σ(f)·c + σ(i)·tanh(g)``, ``h' = σ(o)·tanh(c')``; the
  ``U`` warm-up frames at each end advance the state without a gradient;
* the refine block: for each window of ``window`` frames, the frames'
  [fwd_h ‖ bwd_h ‖ phase code] maps concatenated along channels (frame d
  at channels d·C …) through a 3×3 conv to 2F + 1 channels, then a 3×3
  conv to F; only the windows centred on core frames carry a gradient;
* three branches a stage (forward, backward, fused), each
  ``out_block(core + branch)``: (conv 3×3 to 4F, PixelShuffle(2)) twice,
  then conv 3×3 to the output channels;
* between stages, the core features gain the fused maps and the warm-up
  features the neighbouring hidden and refine maps (no gradient).

Every conv runs through :mod:`ops`, so the same call counts its operations.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .ops import conv2d


def _per_frame(fn, x):
    B, T = x.shape[:2]
    y = fn(x.reshape(B * T, *x.shape[2:]))
    return y.reshape(B, T, *y.shape[1:])


class RefineNet:
    """``forward(lr (B, T, h, w, C), pos (B, T, 1))`` → the 3·stages outputs
    (B, T − 2U, 4h, 4w, C), in the order forward, backward, fused."""

    def __init__(self, params: dict, kwargs: dict):
        self.p = params
        self.features = list(kwargs["num_features"])
        self.stages = int(kwargs["num_stages"])
        self.U = int(kwargs["num_updated_frames"])
        self.window = int(kwargs["refine_window_size"])
        self.scale = int(kwargs["upscale_factor"])
        if not kwargs.get("positional_encoding"):
            raise ValueError("the reference covers the phase-coded refine block only")

    # ------------------------------------------------------------ blocks
    def _in_block(self, x):
        y = conv2d(x, self.p["in_block.conv.weight"], self.p["in_block.conv.bias"], padding=1)
        return F.prelu(y, self.p["in_block.prelu.weight"])

    def _out_block(self, x):
        for i in range({2: 1, 4: 2, 8: 3}[self.scale]):
            x = conv2d(x, self.p[f"out_block.conv{i + 1}.weight"],
                       self.p[f"out_block.conv{i + 1}.bias"], padding=1)
            x = F.pixel_shuffle(x, 2)
        n = {2: 1, 4: 2, 8: 3}[self.scale] + 1
        return conv2d(x, self.p[f"out_block.conv{n}.weight"], self.p[f"out_block.conv{n}.bias"],
                      padding=1)

    def _lstm_steps(self, block, state, xs):
        """Run the layers of ``block`` over the frames ``xs`` (B, n, F, h, w)
        from ``state``; returns the new state and the last layer's maps."""
        hs = []
        for t in range(xs.shape[1]):
            x = xs[:, t]
            new = []
            for layer, (h, c) in enumerate(state):
                w = self.p[f"{block}.cell_list.{layer}.conv.weight"]
                b = self.p[f"{block}.cell_list.{layer}.conv.bias"]
                gates = conv2d(torch.cat([x, h], dim=1), w, b, padding=1)
                i, f, o, g = torch.chunk(gates, 4, dim=1)
                c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
                h = torch.sigmoid(o) * torch.tanh(c)
                new.append((h, c))
                x = h
            state = new
            hs.append(x)
        return state, torch.stack(hs, dim=1)

    def _lstm(self, block, feats):
        B, T, _, H, W = feats.shape
        U = self.U
        state = [(feats.new_zeros(B, f, H, W), feats.new_zeros(B, f, H, W))
                 for f in self.features]
        with torch.no_grad():
            state, pre = self._lstm_steps(block, state, feats[:, :U])
        state, core = self._lstm_steps(block, state, feats[:, U:T - U])
        with torch.no_grad():
            _, suf = self._lstm_steps(block, state, feats[:, T - U:])
        return torch.cat([pre, core, suf], dim=1)

    def _refine(self, fwd_h, bwd_h, pos):
        B, T, _, H, W = fwd_h.shape
        n = self.window
        half, U = n // 2, self.U
        code = pos.to(fwd_h.dtype)[:, :, :, None, None].expand(B, T, 1, H, W)
        feats = torch.cat([fwd_h, bwd_h, code], dim=2)
        K = T - n + 1
        maps = []
        for k in range(K):
            stacked = torch.cat([feats[:, k + d] for d in range(n)], dim=1)
            m = conv2d(stacked, self.p["refine_block.body.conv1.weight"],
                       self.p["refine_block.body.conv1.bias"], padding=1)
            m = conv2d(m, self.p["refine_block.body.conv2.weight"],
                       self.p["refine_block.body.conv2.bias"], padding=1)
            # only windows centred on a core frame carry a gradient
            maps.append(m if U <= k + half < T - U else m.detach())
        return torch.stack(maps, dim=1)

    # ----------------------------------------------------------- forward
    def forward(self, lr, pos):
        U, half = self.U, self.window // 2
        B, T = lr.shape[:2]
        Tc = T - 2 * U
        if U < half:
            raise ValueError("the reference covers U >= window // 2")
        x = lr.permute(0, 1, 4, 2, 3)
        core = _per_frame(self._in_block, x[:, U:T - U])
        with torch.no_grad():
            fwd_warm = _per_frame(self._in_block, x[:, :U])
            bwd_warm = _per_frame(self._in_block, x[:, T - U:])
        outputs = []
        for stage in range(self.stages):
            feats = torch.cat([fwd_warm, core, bwd_warm], dim=1)
            fwd_h = self._lstm("forward_lstm_block", feats)
            bwd_h = torch.flip(self._lstm("backward_lstm_block", torch.flip(feats, [1])), [1])
            refine = self._refine(fwd_h, bwd_h, pos)
            fused = refine[:, U - half:U - half + Tc]
            for branch in (fwd_h[:, U:U + Tc], bwd_h[:, U:U + Tc], fused):
                y = _per_frame(self._out_block, core + branch)
                outputs.append(y.permute(0, 1, 3, 4, 2))
            if stage < self.stages - 1:
                K = refine.shape[1]
                n_ref = U - half
                start = T - U - half
                with torch.no_grad():
                    fwd_warm = fwd_warm + torch.cat([fwd_h[:, :half], refine[:, :n_ref]], dim=1)
                    bwd_warm = bwd_warm + torch.cat(
                        [refine[:, start:min(K, start + n_ref)], bwd_h[:, T - half:]], dim=1)
                core = core + fused
        return outputs


def train_loss(outputs, target, stages: int):
    """The stage-discounted L1 of the training step: each branch's mean
    absolute error, weighted 0.5^(stages − 1 − stage)."""
    total = 0
    for i, out in enumerate(outputs):
        total = total + torch.mean(torch.abs(out - target)) * (0.5 ** (stages - 1 - i // 3))
    return total


NET = RefineNet


def loss(net: RefineNet, batch: dict, cfg: dict):
    """The training step's loss on a batch of device tensors."""
    return train_loss(net.forward(batch["lr_imgs"], batch["pos_code"]), batch["hr_imgs"],
                      net.stages)


def item_frames(t: int, T: int, kwargs: dict) -> tuple[list, list]:
    """Frames of a training item centred on frame ``t`` of a T-frame cycle:
    the LR window of ``num_frames`` ending at t plus U warm-up frames each
    side, and its HR core, indexed circularly."""
    n, U = int(kwargs["num_frames"]), int(kwargs["num_updated_frames"])
    first = t - n + 1
    return ([(first - U + j) % T for j in range(n + 2 * U)], [(first + j) % T for j in range(n)])
