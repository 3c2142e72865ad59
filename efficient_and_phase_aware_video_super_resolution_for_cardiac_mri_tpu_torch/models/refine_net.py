"""RefineNet — the paper's phase-aware bidirectional ConvLSTM VSR model.

The port's counterpart of the JAX package's ``models/refine_net.py`` (itself
a rebuild of reference ``src/model/nets/refine_net.py:10-344``).  The public
layout is the JAX package's: ``forward(lr (B, T, h, w, C), pos_codes
(B, T, 1))`` returns 3·num_stages tensors (B, Tc, h·r, w·r, C).  Between
the blocks, features are contiguous (B, T, C, H, W) tensors, time after
batch.

* The recurrence over time is a Python loop of :meth:`ConvLSTM.step` (the
  JAX ``ConvLSTMStep`` scan body).  Its gate conv runs without a bias; the
  bias goes to the gate tail, the fused CUDA kernel (``ops/lstm_gates.py``)
  on the card and the plain version on the CPU.  Inside the loop, frames,
  carries and gate-conv weights are in the layout of
  :func:`recurrence_format`: channels-last in bf16 (the JAX package's layout
  and the one cuDNN's tensor-core convs compute in, so no gate conv
  transposes its operands and the kernel reads the gates as rows of
  (M, 4F)), NCHW in fp32.
* ``remat=True`` (the JAX package's per-step ``nn.remat``) checkpoints each
  core step (``torch.utils.checkpoint``, non-reentrant): the backward
  recomputes a step from its carry instead of keeping its gate-conv
  activations, so activation memory stops growing with T · stages.  The
  values and gradients do not move.
* The warm-up frames, which the JAX package cuts with ``stop_gradient``,
  run under ``torch.no_grad()`` as in the reference (``refine_net.py:86-93``):
  the same values and gradients, and no autograd graph is recorded for
  frames whose graph would be thrown away.
* The refine block's sliding window over time is one 3D conv, VALID over
  time, on the 2D weight the reference stores (``_WindowConv``).
* Under a spatial axis (``parallel/halo.shard_spatially``; the JAX
  package's ``spatial`` mesh axis) each rank holds a band of rows of every
  frame, and every conv with a 3-wide window in H exchanges one halo row
  with its neighbours: the gate conv, the window conv (not its 1×1 form
  without the phase code), the refine block's second conv, the in-block
  and the out-block.  The gate tail is elementwise and runs unchanged on
  (B, 4F, H/S, W); the phase code has no H axis.  A checkpointed step
  repeats its exchanges in the recompute, in the same order on every rank.

Replicated quirk (SURVEY.md §5) #3: the refine body applies no activation
between its convs; its registered PReLU is a dead parameter.  Fixed as in the
JAX package, #4: any ``num_updated_frames`` below ``refine_window_size // 2``
is handled by edge-replicating the fused maps.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.lstm_gates import fused_lstm_gates
from ..parallel.halo import HaloConv2d, halo_conv2d, halo_conv3d
from .common import InBlock, PReLU, UpsampleBlock, conv2d, conv_format, init_uniform_, per_frame


class ConvLSTMCell(nn.Module):
    """One layer of a ConvLSTM step: the gate conv over [x ‖ h] (or [x ‖ x]
    with ``memory=False``, reference ``refine_net.py:251-255``) and the gate
    tail, split (i, f, o, g)."""

    #: the spatial axis the gate conv exchanges its halo over (None: whole frames)
    spatial_axis = None

    def __init__(self, in_features: int, hidden: int, memory: bool,
                 generator: torch.Generator):
        super().__init__()
        self.memory = memory
        in_ch = in_features + hidden if memory else 2 * in_features
        self.conv = conv2d(in_ch, 4 * hidden, 3, generator)
        #: the gate tail; :func:`set_gate_tail` swaps it to compare the
        #: kernel with its plain version through the whole net
        self.gate_tail = fused_lstm_gates

    def forward(self, x, h, c, weight, bias):
        """The step with the gate conv's ``weight`` and ``bias`` passed in:
        :class:`ConvLSTM` looks them up once per sequence, so a checkpointed
        step recomputes with the tensors its forward used (the compute-dtype
        copies, which exist only while the forward runs).  The conv runs
        without its bias, which the gate tail adds."""
        combined = torch.cat([x, h] if self.memory else [x, x], dim=1)
        gates = halo_conv2d(combined, weight, None, self.conv.padding, self.spatial_axis)
        return self.gate_tail(gates, c, dim=1, bias=bias)


def recurrence_format(dtype: torch.dtype) -> torch.memory_format:
    """The memory layout of the ConvLSTM recurrence for ``dtype``.

    bf16 (and any half type): channels-last, the layout of cuDNN's
    tensor-core implicit-GEMM convs, which otherwise transpose their input,
    weight and output around every gate conv.  fp32: NCHW, in which cuDNN
    runs its fp32 convs (FFT or implicit GEMM on the CUDA cores); in
    channels-last it transposes around them instead, and the fp32 clip and
    step take longer (``tools/profile_layout.py`` measures both).
    """
    return conv_format(dtype)


class ConvLSTM(nn.Module):
    """Stacked ConvLSTM run over time, with warm-up segments.

    ``num_updated_frames`` leading and trailing frames advance the state but
    pass no gradient: they run under ``torch.no_grad()``, the reference's
    blocks at ``refine_net.py:86-93`` (``stop_gradient`` in the JAX package).
    With ``remat`` each core step that records a graph is checkpointed.
    """

    def __init__(self, input_dim: int, hidden_dims: Sequence[int], memory: bool,
                 generator: torch.Generator, remat: bool = False):
        super().__init__()
        self.hidden_dims = tuple(hidden_dims)
        self.remat = remat
        dims = [input_dim, *self.hidden_dims[:-1]]
        self.cell_list = nn.ModuleList(
            ConvLSTMCell(d, hd, memory, generator) for d, hd in zip(dims, self.hidden_dims)
        )

    def step(self, carry, x, weights):
        """One timestep through every layer (the JAX ``ConvLSTMStep``);
        ``weights`` holds each layer's gate-conv (weight, bias)."""
        new_carry = []
        for cell, (w, b), (h, c) in zip(self.cell_list, weights, carry):
            h, c = cell(x, h, c, w, b)
            new_carry.append((h, c))
            x = h
        return new_carry, x

    def _run(self, carry, xs, weights, perm):
        """The steps over xs[:, t]; the last layer's states stacked as
        (B, T, ·) rows in their storage order (``perm`` of (B, F, H, W))."""
        remat = self.remat and torch.is_grad_enabled()
        hs = []
        for t in range(xs.shape[1]):
            if remat:
                # the step is deterministic: no RNG state to stash and restore
                carry, h = checkpoint(self.step, carry, xs[:, t], weights,
                                      use_reentrant=False, preserve_rng_state=False)
            else:
                carry, h = self.step(carry, xs[:, t], weights)
            hs.append(h.permute(perm).reshape(h.shape[0], -1))  # a view: h is dense in perm
        return carry, torch.stack(hs, dim=1)

    def forward(self, xs: torch.Tensor, num_updated_frames: int = 0) -> torch.Tensor:
        """xs (B, T, C, H, W) → hidden states of the last layer (B, T, F, H, W),
        contiguous."""
        B, T, _, H, W = xs.shape
        U = num_updated_frames
        fmt = recurrence_format(xs.dtype)
        perm = (0, 2, 3, 1) if fmt == torch.channels_last else (0, 1, 2, 3)  # storage order
        # one copy a call: each frame xs[:, t] is then a view in the layout
        xs = xs.permute(0, 1, *(d + 1 for d in perm[1:])).contiguous()
        xs = xs.permute(0, 1, *(perm.index(d) + 1 for d in range(1, 4)))
        weights = [(cell.conv.weight.contiguous(memory_format=fmt), cell.conv.bias)
                   for cell in self.cell_list]
        carry = [tuple(torch.empty(B, hd, H, W, dtype=xs.dtype, device=xs.device,
                                   memory_format=fmt).zero_() for _ in range(2))
                 for hd in self.hidden_dims]
        if U == 0:
            out = self._run(carry, xs, weights, perm)[1]
        else:
            with torch.no_grad():
                carry, h_pre = self._run(carry, xs[:, :U], weights, perm)
            carry, h_core = self._run(carry, xs[:, U : T - U], weights, perm)
            with torch.no_grad():
                _, h_suf = self._run(carry, xs[:, T - U :], weights, perm)
            out = torch.cat([h_pre, h_core, h_suf], dim=1)
        F_ = self.hidden_dims[-1]
        out = out.view(B, T, *(((B, F_, H, W)[d]) for d in perm[1:]))
        # back to (B, T, F, H, W): one copy a call (none in NCHW)
        return out.permute(0, 1, *(perm.index(d) + 1 for d in range(1, 4))).contiguous()


class _WindowConv(nn.Module):
    """Sliding-window-over-time conv, stored with the reference's 2D layout.

    The weight keeps the reference's shape (out, window·C, ks, ks), channel
    index ``d·C + c`` for frame ``d`` of the window.  At call time it is
    viewed as a 3D kernel (out, C, window, ks, ks) and run as one
    ``F.conv3d`` over (B, C, T, H, W), VALID over time — the
    window-times-larger concat of the reference is never built.
    """

    #: the spatial axis the 3×3 window exchanges its halo over
    spatial_axis = None

    def __init__(self, in_channels: int, features: int, window: int, kernel_size: int,
                 generator: torch.Generator):
        super().__init__()
        self.window = window
        self.kernel_size = kernel_size
        self.weight = nn.Parameter(torch.empty(features, in_channels, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(features))
        fan_in = in_channels * kernel_size * kernel_size
        init_uniform_(self.weight, fan_in, generator)
        init_uniform_(self.bias, fan_in, generator)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        """feats (B, T, C, H, W) → (B, T - window + 1, out, H, W)."""
        out, in_ch, ks, _ = self.weight.shape
        C = in_ch // self.window
        w3 = self.weight.view(out, self.window, C, ks, ks).permute(0, 2, 1, 3, 4)
        y = halo_conv3d(feats.transpose(1, 2), w3, self.bias, (0, ks // 2, ks // 2),
                        self.spatial_axis)
        return y.transpose(1, 2)


class RefineBlock(nn.Module):
    """Sliding-window fusion of [fwd_h ‖ bwd_h ‖ pos_code]
    (reference ``_RefineBlock``, ``refine_net.py:138-185``).

    With the phase code: a 3×3 window conv from window·(2F+1) to 2F+1
    channels, then a 3×3 conv to F.  Without: a 1×1 window conv from
    window·2F to F.  No activation between them (quirk #3); ``prelu`` is the
    reference's registered but unused parameter.
    """

    def __init__(self, num_features: int, window: int, num_updated_frames: int,
                 positional_encoding: bool, generator: torch.Generator):
        super().__init__()
        self.window = window
        self.num_updated_frames = num_updated_frames
        self.positional_encoding = positional_encoding
        C = 2 * num_features + (1 if positional_encoding else 0)
        if positional_encoding:
            self.body = nn.ModuleDict({
                "conv1": _WindowConv(window * C, C, window, 3, generator),
                "conv2": conv2d(C, num_features, 3, generator, cls=HaloConv2d),
            })
        else:
            self.body = nn.ModuleDict({
                "conv1": _WindowConv(window * C, num_features, window, 1, generator),
            })
        self.prelu = PReLU()  # dead parameter, never called (quirk #3)

    def forward(self, fwd_h, bwd_h, pos_codes):
        """fwd_h, bwd_h (B, T, F, H, W); pos_codes (B, T, 1) → maps
        (B, T - window + 1, F, H, W)."""
        B, T, _, H, W = fwd_h.shape
        half = self.window // 2
        U = self.num_updated_frames
        if self.positional_encoding:
            pos = pos_codes.to(fwd_h.dtype)[:, :, :, None, None].expand(B, T, 1, H, W)
            feats = torch.cat([fwd_h, bwd_h, pos], dim=2)
        else:
            feats = torch.cat([fwd_h, bwd_h], dim=2)
        K = T - self.window + 1
        maps = self.body["conv1"](feats)
        if self.positional_encoding:
            maps = per_frame(self.body["conv2"], maps)

        # no-grad windows: gradient only where U <= center < T - U (ref :179-183)
        k_lo = max(0, U - half)
        k_hi = min(K, T - U - half)
        if k_lo > 0 or k_hi < K:
            maps = torch.cat(
                [maps[:, :k_lo].detach(), maps[:, k_lo:k_hi], maps[:, k_hi:].detach()], dim=1
            )
        return maps


class RefineNet(nn.Module):
    """Phase-aware multi-stage bidirectional ConvLSTM VSR
    (reference ``RefineNet``, ``refine_net.py:10-135``).

    Input:  ``lr`` (B, T, h, w, C) with T = num_core + 2·num_updated_frames,
            ``pos_codes`` (B, T, 1).
    Output: list of 3·num_stages tensors (B, num_core, h·r, w·r, C) in the
            reference's branch order per stage: forward, backward, fused.

    Weights are drawn from ``generator`` (a fixed-seed one when None), never
    from torch's global RNG.  ``remat`` checkpoints the ConvLSTMs' core steps
    (the JAX package's ``RefineNet.remat``).
    """

    #: registered but never called (quirk #3): no gradient, no optimizer state
    unused_parameters = ("refine_block.prelu.weight",)

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        num_features: Sequence[int],
        num_stages: int = 1,
        refine_window_size: int = 5,
        upscale_factor: int = 4,
        update_memory: bool = False,
        num_updated_frames: int = 0,
        memory: bool = True,
        positional_encoding: bool = False,
        remat: bool = False,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        if upscale_factor not in (2, 3, 4, 8):
            raise ValueError(f"The upscale factor should be 2, 3, 4 or 8. Got {upscale_factor}.")
        if not update_memory and num_updated_frames != 0:
            raise ValueError('The "update_memory" is not activated!')
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        F_ = num_features[0]
        self.num_stages = num_stages
        self.refine_window_size = refine_window_size
        self.num_updated_frames = num_updated_frames
        self.in_block = InBlock(in_channels, F_, generator)
        self.forward_lstm_block = ConvLSTM(F_, num_features, memory, generator, remat)
        self.backward_lstm_block = ConvLSTM(F_, num_features, memory, generator, remat)
        self.refine_block = RefineBlock(
            num_features[-1], refine_window_size, num_updated_frames, positional_encoding,
            generator,
        )
        self.out_block = UpsampleBlock(F_, out_channels, upscale_factor, generator)

    def forward(self, lr: torch.Tensor, pos_codes: torch.Tensor | None = None):
        U = self.num_updated_frames
        half = self.refine_window_size // 2
        B, T = lr.shape[:2]
        Tc = T - 2 * U
        x = lr.permute(0, 1, 4, 2, 3)  # (B, T, C, h, w)

        core = per_frame(self.in_block, x[:, U : T - U])
        if U > 0:
            with torch.no_grad():
                fwd_warm = per_frame(self.in_block, x[:, :U])
                bwd_warm = per_frame(self.in_block, x[:, T - U :])

        outputs = []
        for stage in range(self.num_stages):
            feats = torch.cat([fwd_warm, core, bwd_warm], dim=1) if U > 0 else core
            fwd_h = self.forward_lstm_block(feats, U)
            bwd_h = torch.flip(self.backward_lstm_block(torch.flip(feats, [1]), U), [1])
            refine = self.refine_block(fwd_h, bwd_h, pos_codes)
            K = refine.shape[1]

            # Fused maps aligned to the core frames: the reference's slice
            # (``:112``) for U >= half, edge-replicated for U < half (quirk #4).
            start = U - half
            if start >= 0:
                fused = refine[:, start : start + Tc]
            else:
                pieces = [refine[:, :1].expand(-1, -start, -1, -1, -1)]
                n_mid = min(K, Tc + start)
                pieces.append(refine[:, :n_mid])
                n_back = Tc + start - K
                if n_back > 0:
                    pieces.append(refine[:, -1:].expand(-1, n_back, -1, -1, -1))
                fused = torch.cat(pieces, dim=1)

            # Three output branches (reference :99-113): forward, backward, fused.
            for branch in (fwd_h[:, U : U + Tc], bwd_h[:, U : U + Tc], fused):
                y = per_frame(self.out_block, core + branch)
                outputs.append(y.permute(0, 1, 3, 4, 2))

            # Residual feature update feeding the next stage (reference :118-133).
            if self.num_stages > 1 and stage < self.num_stages - 1:
                if U > 0:
                    n_ref = max(0, U - half)
                    b_start = min(K, max(0, T - U - half))
                    with torch.no_grad():
                        fwd_warm = fwd_warm + torch.cat(
                            [fwd_h[:, : min(half, U)], refine[:, :n_ref]], dim=1
                        )
                        bwd_warm = bwd_warm + torch.cat(
                            [refine[:, b_start : b_start + n_ref], bwd_h[:, T - min(half, U) :]],
                            dim=1,
                        )
                core = core + fused

        return outputs


def set_gate_tail(net: nn.Module, fn) -> None:
    """Route every ConvLSTM gate tail of ``net`` through ``fn``, called as
    ``fn(gates, c, dim=1, bias=bias)`` on the bias-free conv output in the
    recurrence's layout (for example ``lstm_gates_reference``, to hold the
    whole forward against the kernel)."""
    for m in net.modules():
        if isinstance(m, ConvLSTMCell):
            m.gate_tail = fn
