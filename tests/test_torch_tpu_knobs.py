"""The PyTorch port's accelerator knobs against the JAX package's, on the CPU.

The flagship's ``_tpu`` configurations set ``remat``, ``compute_dtype:
bfloat16``, ``int_feed``, ``grad_accum_steps``, ``t_bucket``, ``aot_cache``
and a ``parallel:`` section; each must compute in the port what it computes
in the JAX package.  Tolerances, each stated where it is held:

* ``remat``: on vs off in the port, outputs and gradients bit-identical;
  against JAX ``RefineNet(remat=True)`` at ``test_torch_refine_net.py``'s
  atol 5e-5 / rtol 1e-4.
* bf16 (``compute_dtype``): XLA:CPU fuses bf16 elementwise chains and rounds
  once, ATen rounds after every op, so the port's bf16 is held to JAX's bf16
  at ~2.5x the measured deviation, per log key (below); the size of its
  bf16-vs-fp32 output gap to JAX's; and its Test log's gap to fp32 to the
  bound of ``tests/test_end_to_end.py:333-334`` (|ΔPSNR| < 0.5,
  |ΔSSIM| < 0.05).
* ``int_feed`` vs the host ``Normalize``: rtol 5e-5 / atol 1e-6
  (``tests/test_int_feed.py:147``); the bf16 LR wire at 2e-2 (``:194``).
* ``grad_accum_steps`` 2 vs 1: ``tests/test_runner_variants.py:463-470``.
* ``int_feed`` (integer and fractional trees, the latter under bf16) and
  ``grad_accum_steps: 2`` against the JAX trainer with the same knob: per
  log key and per parameter at ~3x the measured deviation
  (``TRAINER_KNOBS_VS_JAX``).
* ``t_bucket``: the Test log within ``test_torch_predict.py``'s 2e-3.
"""
import logging
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu import losses as JL
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu import metrics as JM
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.config import (
    Cfg as JaxCfg,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.data import (
    VSRRefineNetDataset as JaxDataset,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.data.loader import (
    Dataloader as JaxDataloader,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.main import (
    test_from_config as run_jax_test,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.models import (
    RefineNet as JaxRefineNet,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.runner import (
    common as jax_common,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.runner.optim import (
    Optimizer as JaxOptimizer,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.runner.predictors import (
    VSRRefineNetPredictor as JaxPredictor,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.runner.trainers import (
    VSRRefineNetTrainer as JaxTrainer,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.utils import nifti
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.utils.casting import (
    cast_floating as jax_cast_floating,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu.utils.torch_export import (
    save_torch_checkpoint,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch import losses as PL
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch import metrics as PM
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.config import (
    DATASETS,
    Cfg,
    load_config,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.data import (
    Dataloader,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.main import (
    test_from_config as run_port_test,
    train_from_config as run_port_train,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.models import (
    RefineNet,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.models.refine_net import (
    set_gate_tail,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.ops import (
    lstm_gates,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.runner import (
    common as port_common,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.runner.optim import (
    Optimizer,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.runner.predictors import (
    VSRRefineNetPredictor,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.runner.trainers import (
    VSRRefineNetTrainer,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.utils.casting import (
    cast_floating,
    forward_in,
    resolve_dtype,
)
from efficient_and_phase_aware_video_super_resolution_for_cardiac_mri_tpu_torch.utils.jax_weights import (
    state_dict_from_jax_params,
)
from fixtures import make_acdc_tree

REPO_ROOT = Path(__file__).resolve().parent.parent

FRAMES, U, SCALE = 6, 3, 4
NET = dict(in_channels=1, out_channels=1, num_features=[6, 6], num_stages=2,
           refine_window_size=5, upscale_factor=SCALE, update_memory=True,
           num_updated_frames=U, positional_encoding=True)
NORM = [{"name": "Normalize", "kwargs": {"means": [54.089], "stds": [48.084]}},
        {"name": "ToTensor"}]
# bf16 port vs bf16 JAX on these inputs, relative, held at ~2.5x the measured
# deviation.  With the gate conv's bias added by the gate tail (in bf16, as
# XLA adds it after the bf16 conv) rather than inside the conv: Test log Loss
# 3.9e-5, PSNR 1.8e-5, SSIM 4.6e-4, CardiacPSNR 3.8e-6, CardiacSSIM 2.8e-4
# (with the bias inside the conv: 3.9e-5, 2.0e-5, 8.2e-4, 4.1e-5, 1.6e-3).
# The 12-step trainer's logs: Loss 3.4e-6, PSNR 1.5e-5, SSIM 2.4e-3 (bias in
# the conv: 3.1e-6, 2.1e-5, 3.1e-3; SSIM of noise is ~0.01-0.03).
BF16_LOG_RTOL = {"Loss": 1e-4, "L1Loss": 1e-4, "PSNR": 5e-5, "SSIM": 1.2e-3,
                 "CardiacPSNR": 1e-5, "CardiacSSIM": 7e-4}
BF16_TRAIN_RTOL = {"Loss": 8e-6, "PSNR": 4e-5, "SSIM": 6e-3}
# The raw outputs of a bf16 forward: the port's bf16 differs from JAX's bf16
# about as much as either differs from fp32 (rms 0.0041-0.0043 of the output
# against 0.0042-0.0044: each rounds at other points), so no limit on
# port-vs-JAX tells bf16 from fp32.  What does: the size of each framework's
# bf16-vs-fp32 gap.  The port's is 0.84-0.86 of JAX's over 4 seeds; an fp32
# run has 0, and a run that only rounds its outputs to bf16 0.40-0.41.
BF16_GAP_RATIO = (0.6, 1.5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small tensors: test workers that run
    side by side then do not stall on each other's thread pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return make_acdc_tree(tmp_path_factory.mktemp("acdc"), patients_per_split=1, slices=2,
                          frames=FRAMES, hr_size=(48, 48))


@pytest.fixture(scope="module")
def jax_params():
    lr = np.zeros((1, FRAMES + 2 * U, 12, 12, 1), np.float32)
    pos = np.zeros((1, FRAMES + 2 * U, 1), np.float32)
    params = JaxRefineNet(**NET).init(jax.random.PRNGKey(0), lr, pos)["params"]
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def ckpt(jax_params, tmp_path_factory):
    path = tmp_path_factory.mktemp("ckpt") / "model.pth"
    save_torch_checkpoint(jax_params, path)
    return path


def _port_net(jax_params, **kwargs):
    net = RefineNet(**{**NET, **kwargs})
    net.load_state_dict(state_dict_from_jax_params(jax_params), strict=True)
    return net


# ---------------------------------------------------------------- casting
def test_cast_floating_casts_floating_tensors_only():
    tree = {"a": torch.ones(2), "i": torch.arange(3), "t": (torch.zeros(1, dtype=torch.float64),
                                                          [torch.ones(1)]), "s": "x"}
    out = cast_floating(tree, torch.bfloat16)
    assert out["a"].dtype == out["t"][0].dtype == out["t"][1][0].dtype == torch.bfloat16
    assert out["i"] is tree["i"] and out["s"] == "x" and isinstance(out["t"], tuple)
    assert resolve_dtype(None) is None and resolve_dtype("bfloat16") == torch.bfloat16
    with pytest.raises(ValueError):
        resolve_dtype("int8")


# ------------------------------------------------------------------ remat
def _inputs(seed=7, b=2):
    rng = np.random.default_rng(seed)
    lr = rng.standard_normal((b, FRAMES + 2 * U, 8, 8, 1)).astype(np.float32)
    pos = rng.uniform(-1, 1, (b, FRAMES + 2 * U, 1)).astype(np.float32)
    return lr, pos


@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["fp32", "bf16"])
def test_remat_is_bit_identical_and_recomputes_the_core_steps(jax_params, dtype):
    lr, pos = _inputs()
    results = []
    for remat in (False, True):
        net = _port_net(jax_params, remat=remat)
        calls = [0]

        def counting(gates, c, dim=-1, bias=None):
            calls[0] += 1
            return lstm_gates.fused_lstm_gates(gates, c, dim, bias)

        set_gate_tail(net, counting)
        outputs = forward_in(net, dtype, torch.from_numpy(lr), torch.from_numpy(pos))
        forward_calls = calls[0]
        sum(o.abs().mean() for o in outputs).backward()
        grads = {n: p.grad for n, p in net.named_parameters() if p.grad is not None}
        results.append((outputs, grads, forward_calls, calls[0]))
    (out0, g0, f0, n0), (out1, g1, f1, n1) = results
    layer_steps = 2 * 2 * 2  # layers × directions × stages
    assert f0 == f1 == layer_steps * (FRAMES + 2 * U)
    assert n0 == f0 and n1 == f1 + layer_steps * FRAMES  # the core steps rerun once
    assert all(torch.equal(a, b) for a, b in zip(out0, out1))
    assert g0.keys() == g1.keys()
    for name in g0:
        assert g0[name].dtype == torch.float32
        assert torch.equal(g0[name], g1[name]), name


def test_remat_matches_jax_remat(jax_params):
    lr, pos = _inputs(seed=11)
    jax_net = JaxRefineNet(**NET, remat=True)

    def fused_sum(params):
        return jnp.sum(jax_net.apply({"params": params}, lr, pos)[-1])

    params = jax.tree.map(jnp.asarray, jax_params)
    want_out = jax.jit(jax_net.apply)({"params": params}, lr, pos)
    want_grads = state_dict_from_jax_params(jax.tree.map(np.asarray, jax.grad(fused_sum)(params)))
    net = _port_net(jax_params, remat=True)
    got = net(torch.from_numpy(lr), torch.from_numpy(pos))
    got[-1].sum().backward()
    for g, w in zip(got, want_out):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=5e-5, rtol=1e-4)
    for name, p in net.named_parameters():
        if p.grad is not None:
            np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(), atol=5e-5,
                                       rtol=1e-4, err_msg=name)


# --------------------------------------------------------------- int_feed
@pytest.mark.parametrize("values,dtype", [
    ([0, 1, 254, 255], np.uint8), ([-7, 300], np.int16), ([1.5, 2.0], None), ([70000.0], None),
    ([np.nan, 1.0], None), ([], None),
])
def test_compact_lossless_equals_jax(values, dtype):
    x = np.array(values, np.float32)
    got, want = port_common.compact_lossless(x), jax_common.compact_lossless(x)
    assert got.dtype == want.dtype and np.array_equal(got, want, equal_nan=True)
    assert (got is x) == (dtype is None)
    already = np.array([1, 2], np.uint8)
    assert port_common.compact_lossless(already) is already


def _train_loaders(tree, split_batch=2):
    loaders = []
    for split in ("train", "valid"):
        ds = DATASETS.get("AcdcVSRRefineNetDataset")(
            data_dir=tree["videos_dir"], type=split, downscale_factor=SCALE, transforms=NORM,
            augments=[{"name": "RandomCropPatch", "kwargs": {"size": [6, 6], "ratio": SCALE}}],
            num_frames=3, num_updated_frames=2, pos_code_path=tree["pos_code_path"],
        )
        loaders.append(Dataloader(ds, batch_size=split_batch if split == "train" else 1))
    return loaders


def _feed_trainer(tree, jax_params, **kwargs):
    train_loader, valid_loader = _train_loaders(tree)
    return VSRRefineNetTrainer(
        device="cpu", train_dataloader=train_loader, valid_dataloader=valid_loader,
        net=_port_net(jax_params, num_updated_frames=2), loss_fns=[PL.L1Loss()],
        metric_fns=[PM.PSNR(), PM.SSIM()], optimizer=Optimizer("Adam", lr=1e-3),
        num_epochs=2, **kwargs,
    )


def test_int_feed_matches_host_normalize(tree, jax_params):
    ref = _feed_trainer(tree, jax_params)
    alt = _feed_trainer(tree, jax_params, int_feed=True)
    assert alt._feed_norm is not None and alt.train_dataloader.dataset.deferrable_normalize() is None
    batch = next(iter(alt.train_dataloader))
    wire = alt._wire(batch)
    assert wire["hr_imgs"].dtype == wire["lr_imgs"].dtype == torch.uint8  # integer trees
    assert wire["pos_code"].dtype == torch.float32 and batch["hr_imgs"].dtype == np.float32
    for mode in ("training", "validation", "training"):
        log_ref, _, _ = ref._run_epoch(mode)
        log_alt, _, _ = alt._run_epoch(mode)
        assert log_ref.keys() == log_alt.keys()
        for key in log_ref:
            np.testing.assert_allclose(log_alt[key], log_ref[key], rtol=5e-5, atol=1e-6,
                                       err_msg=f"{mode}:{key}")


@pytest.fixture(scope="module")
def frac_tree(tmp_path_factory):
    """LR frames made fractional, like the k-space-degraded LR trees: they
    fail the lossless guard and exercise the bf16 wire."""
    tree = make_acdc_tree(tmp_path_factory.mktemp("acdc_frac"), patients_per_split=1, slices=2,
                          frames=FRAMES, hr_size=(48, 48), splits=("train", "valid"))
    for f in Path(tree["videos_dir"]).rglob("LR/**/*.nii.gz"):
        img = nifti.load(f)
        nifti.save(np.asarray(img.data, np.float32) * np.float32(0.7317), f)
    return tree


def test_bf16_lr_wire_under_bf16_compute(frac_tree, jax_params):
    ref = _feed_trainer(frac_tree, jax_params, compute_dtype="bfloat16")
    alt = _feed_trainer(frac_tree, jax_params, compute_dtype="bfloat16", int_feed=True)
    batch = next(iter(alt.train_dataloader))
    wire = alt._wire(batch)
    assert wire["lr_imgs"].dtype == torch.bfloat16  # fractional input → bf16 wire
    assert wire["hr_imgs"].dtype == torch.uint8  # the target never travels as bf16
    assert wire["lr_imgs"].element_size() * wire["lr_imgs"].numel() * 2 == batch["lr_imgs"].nbytes
    for mode in ("training", "validation"):
        log_ref, _, _ = ref._run_epoch(mode)
        log_alt, _, _ = alt._run_epoch(mode)
        for key in log_ref:
            np.testing.assert_allclose(log_alt[key], log_ref[key], rtol=2e-2, atol=2e-2,
                                       err_msg=f"{mode}:{key}")
    fp32 = _feed_trainer(frac_tree, jax_params, int_feed=True)
    assert fp32._wire(batch)["lr_imgs"].dtype == torch.float32  # no bf16 compute, no bf16 wire


def test_int_feed_disabled_without_deferrable_normalize(caplog, jax_params):
    class _Items:
        def __len__(self):
            return 2

        def __getitem__(self, i):
            rng = np.random.default_rng(i)
            return {"lr_imgs": rng.standard_normal((7, 6, 6, 1)).astype(np.float32),
                    "hr_imgs": rng.standard_normal((3, 24, 24, 1)).astype(np.float32),
                    "pos_code": rng.uniform(-1, 1, (7, 1)).astype(np.float32)}

    loader = Dataloader(_Items(), batch_size=2)
    with caplog.at_level(logging.WARNING):
        trainer = VSRRefineNetTrainer(
            device="cpu", train_dataloader=loader, valid_dataloader=loader,
            net=_port_net(jax_params, num_updated_frames=2), loss_fns=[PL.L1Loss()],
            optimizer=Optimizer("Adam", lr=1e-3), int_feed=True)
    assert trainer.int_feed is False and trainer._feed_norm is None
    assert any("int_feed disabled" in r.message for r in caplog.records)
    log, _, _ = trainer._run_epoch("training")
    assert np.isfinite(log["Loss"])


# ------------------------------------------------------------- grad_accum
def test_grad_accum_matches_the_plain_step(tree, jax_params):
    runs = []
    for accum in (1, 2):
        trainer = _feed_trainer(tree, jax_params, grad_accum_steps=accum)
        trainer.train_dataloader.batch_size = 4
        logs = [trainer._run_epoch("training")[0] for _ in range(2)]
        _, _, outputs = trainer._run_epoch("training")
        runs.append((logs, trainer.net.state_dict(), outputs))
    (logs1, sd1, out1), (logs2, sd2, out2) = runs
    for l1, l2 in zip(logs1, logs2):
        assert l2["Loss"] == pytest.approx(l1["Loss"], rel=1e-5)
        assert l2["PSNR"] == pytest.approx(l1["PSNR"], rel=1e-4)  # microbatch-mean PSNR
    for name in sd1:
        np.testing.assert_allclose(sd2[name].numpy(), sd1[name].numpy(), atol=1e-5, rtol=1e-5,
                                   err_msg=name)
    assert out2.shape == out1.shape  # the display covers the whole batch
    np.testing.assert_allclose(out2.numpy(), out1.numpy(), atol=1e-4, rtol=1e-4)


CROP = [{"name": "RandomCropPatch", "kwargs": {"size": [6, 6], "ratio": SCALE}}]


def _trained_pair(tree, jax_params, batch_size=2, **knobs):
    """The port's and the JAX package's trainers with the same knobs, on the
    same tree, weights and epoch seeds, each trained for 2 epochs."""
    def loaders(dataset, loader):
        return [loader(dataset(data_dir=tree["videos_dir"], type=split, downscale_factor=SCALE,
                               transforms=NORM, augments=CROP if split == "train" else None,
                               num_frames=3, num_updated_frames=2,
                               pos_code_path=str(tree["pos_code_path"])),
                       batch_size=batch_size if split == "train" else 1)
                for split in ("train", "valid")]

    kwargs = dict(device="cpu", num_epochs=2, **knobs)
    train, valid = loaders(DATASETS.get("AcdcVSRRefineNetDataset"), Dataloader)
    port = VSRRefineNetTrainer(
        train_dataloader=train, valid_dataloader=valid,
        net=_port_net(jax_params, num_updated_frames=2), loss_fns=[PL.L1Loss()],
        metric_fns=[PM.PSNR(), PM.SSIM()], optimizer=Optimizer("Adam", lr=1e-3, weight_decay=0),
        **kwargs)
    port.train()
    train, valid = loaders(JaxDataset, JaxDataloader)
    opt = JaxOptimizer("Adam", lr=1e-3, weight_decay=0)
    ref = JaxTrainer(train_dataloader=train, valid_dataloader=valid,
                     net=JaxRefineNet(**{**NET, "num_updated_frames": 2}), loss_fns=[JL.L1Loss()],
                     metric_fns=[JM.PSNR(), JM.SSIM()], optimizer=opt, **kwargs)
    ref.params = jax.tree.map(jnp.asarray, jax_params)
    ref.opt_state = opt.init(ref.params)
    ref.train()
    return port, ref


def _log_devs(port, ref) -> dict:
    """Per log key, the largest relative deviation over both splits and all
    epochs of the port's per-epoch logs from the JAX trainer's."""
    devs = {}
    for split in ("train", "valid"):
        for got, want in zip(port.history[split], ref.history[split], strict=True):
            for key in want:
                devs[key] = max(devs.get(key, 0.0), abs(got[key] - want[key]) / abs(want[key]))
    return devs


def _param_dev(port, ref) -> float:
    """The largest deviation of a final parameter of the port from the JAX
    trainer's, relative to that parameter's largest magnitude."""
    want = state_dict_from_jax_params(jax.tree.map(np.asarray, ref.params))
    got = port.net.state_dict()
    return max(((got[n] - w).abs().max() / w.abs().max()).item()
               for n, w in want.items() if w.is_floating_point() and w.abs().max() > 0)


# case → (tree fixture, trainer knobs, train batch, log rtol by key, parameter
# tolerance relative to each parameter's largest magnitude): the port against
# the JAX trainer with the same knob, 2 epochs of 6 (batch 2) or 3 (batch 4)
# steps.  The limits are ~3x the deviations measured on these inputs:
# int_feed Loss 6.4e-6, PSNR 3.2e-6, SSIM 4.7e-4, parameters 1.0e-5 (what
# the port and JAX give without the knob); bf16 + int_feed on the fractional
# tree Loss 2.1e-4, PSNR 5.6e-5, SSIM 1.7e-2, parameters 3.7e-2 (Adam turns
# bf16's gradient noise into steps of +-lr; with the bias inside the gate conv
# 2.2e-4, 6.2e-5, 8.9e-3, 4.3e-2, against which the limits were set);
# grad_accum 2 Loss 1.2e-6, PSNR
# 9.6e-7, SSIM 1.7e-4, parameters 3.1e-5.  SSIM of noise is ~0.01-0.03, so
# its relative deviation is the largest.
TRAINER_KNOBS_VS_JAX = {
    "int_feed": ("tree", {"int_feed": True}, 2,
                 {"Loss": 2e-5, "L1Loss": 2e-5, "PSNR": 1e-5, "SSIM": 1.5e-3}, 3e-5),
    "int_feed_frac_bf16": ("frac_tree", {"int_feed": True, "compute_dtype": "bfloat16"}, 2,
                           {"Loss": 7e-4, "L1Loss": 7e-4, "PSNR": 2e-4, "SSIM": 2.5e-2}, 0.13),
    "grad_accum_2": ("tree", {"grad_accum_steps": 2}, 4,
                     {"Loss": 5e-6, "L1Loss": 5e-6, "PSNR": 3e-6, "SSIM": 5e-4}, 1e-4),
}


@pytest.mark.parametrize("case", list(TRAINER_KNOBS_VS_JAX))
def test_trainer_knob_matches_jax_trainer(case, request, jax_params):
    tree_name, knobs, batch, log_rtol, param_tol = TRAINER_KNOBS_VS_JAX[case]
    port, ref = _trained_pair(request.getfixturevalue(tree_name), jax_params, batch, **knobs)
    assert (port._feed_norm is None) == (ref._feed_norm is None) == ("int_feed" not in knobs)
    assert [list(h) for h in port.history["train"]] == [list(h) for h in ref.history["train"]]
    devs = _log_devs(port, ref)
    assert devs.keys() == log_rtol.keys()
    assert all(devs[k] <= log_rtol[k] for k in devs), devs
    assert _param_dev(port, ref) <= param_tol


def test_grad_accum_rejects_an_indivisible_batch(tree, jax_params):
    trainer = _feed_trainer(tree, jax_params, grad_accum_steps=3)
    with pytest.raises(ValueError, match="grad_accum_steps=3 must divide"):
        trainer._run_epoch("training")  # batch size 2


# ------------------------------------------------------- bf16 vs JAX bf16
class _ListDataset:
    def __init__(self, items):
        self.items = items

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def test_bf16_trainer_steps_match_jax_bf16(jax_params):
    rng = np.random.default_rng(4)
    items = [{"lr_imgs": rng.standard_normal((5 + 2 * U, 8, 8, 1)).astype(np.float32),
              "hr_imgs": rng.standard_normal((5, 32, 32, 1)).astype(np.float32),
              "pos_code": rng.uniform(-1, 1, (5 + 2 * U, 1)).astype(np.float32)} for _ in range(8)]
    jax_opt = JaxOptimizer("Adam", lr=1e-3, weight_decay=0)
    jax_loader = JaxDataloader(_ListDataset(items), batch_size=4, shuffle=False)
    jax_trainer = JaxTrainer(device="cpu", train_dataloader=jax_loader, valid_dataloader=jax_loader,
                             net=JaxRefineNet(**NET), loss_fns=[JL.L1Loss()],
                             metric_fns=[JM.PSNR(), JM.SSIM()], optimizer=jax_opt, num_epochs=3,
                             compute_dtype="bfloat16")
    jax_trainer.params = jax.tree.map(jnp.asarray, jax_params)
    jax_trainer.opt_state = jax_opt.init(jax_trainer.params)
    jax_trainer.train()

    loader = Dataloader(_ListDataset(items), batch_size=4, shuffle=False)
    trainer = VSRRefineNetTrainer(
        device="cpu", train_dataloader=loader, valid_dataloader=loader, net=_port_net(jax_params),
        loss_fns=[PL.L1Loss()], metric_fns=[PM.PSNR(), PM.SSIM()],
        optimizer=Optimizer("Adam", lr=1e-3, weight_decay=0), num_epochs=3,
        compute_dtype="bfloat16")
    trainer.train()
    for split in ("train", "valid"):
        for got, want in zip(trainer.history[split], jax_trainer.history[split], strict=True):
            for key, rtol in BF16_TRAIN_RTOL.items():
                np.testing.assert_allclose(got[key], want[key], rtol=rtol, atol=0,
                                           err_msg=f"{split} {key}")
    # the masters and Adam's state stay fp32; the trajectory moved
    assert all(p.dtype == torch.float32 for p in trainer.net.parameters())
    assert all(v.dtype == torch.float32 for st in trainer.opt.state.values()
               for v in st.values() if torch.is_tensor(v) and v.dim())
    losses = [h["Loss"] for h in trainer.history["train"]]
    assert abs(losses[0] - losses[-1]) > 1e-4


@pytest.mark.parametrize("seed", [5, 7])
def test_bf16_forward_gap_to_fp32_matches_jax(jax_params, seed):
    """The raw outputs: the port's bf16-vs-fp32 gap is the size of JAX's
    (``BF16_GAP_RATIO``), every bf16 output is a bf16 value, and the bound
    fails both an fp32 forward and one that only rounds its outputs."""
    lr, pos = _inputs(seed=seed)
    jax_net = JaxRefineNet(**NET)
    params = jax.tree.map(jnp.asarray, jax_params)
    apply = jax.jit(jax_net.apply)
    jax32 = apply({"params": params}, lr, pos)
    inputs16 = jax_cast_floating((jnp.asarray(lr), jnp.asarray(pos)), jnp.bfloat16)
    jax16 = jax_cast_floating(apply({"params": jax_cast_floating(params, jnp.bfloat16)}, *inputs16),
                              jnp.float32)
    net = _port_net(jax_params)
    with torch.no_grad():
        port16 = forward_in(net, torch.bfloat16, torch.from_numpy(lr), torch.from_numpy(pos))
        port32 = net(torch.from_numpy(lr), torch.from_numpy(pos))

    def norm(a, b):
        return math.sqrt(sum(float(np.sum((np.asarray(x, np.float64) - np.asarray(y)) ** 2))
                             for x, y in zip(a, b, strict=True)))

    jax_gap = norm(jax16, jax32)
    rounded = [o.to(torch.bfloat16).float() for o in port32]
    assert all(torch.equal(o, o.to(torch.bfloat16).float()) for o in port16)  # bf16 values
    ratio = norm(port16, port32) / jax_gap
    assert BF16_GAP_RATIO[0] <= ratio <= BF16_GAP_RATIO[1], ratio
    assert norm(port32, port32) / jax_gap < BF16_GAP_RATIO[0]  # fp32: 0
    assert norm(rounded, port32) / jax_gap < BF16_GAP_RATIO[0]  # outputs-only rounding


def _test_cfg(tree, saved_dir, ckpt, **pred_kwargs):
    coords = str(tree["coordinates_path"])
    return {
        "main": {"saved_dir": str(saved_dir), "loaded_path": str(ckpt)},
        "dataset": {"name": "AcdcVSRRefineNetDataset", "kwargs": {
            "data_dir": str(tree["videos_dir"]), "downscale_factor": SCALE, "transforms": NORM,
            "num_frames": 5, "num_updated_frames": U, "pos_code_path": str(tree["pos_code_path"])}},
        "dataloader": {"name": "Dataloader", "kwargs": {"batch_size": 1, "shuffle": False}},
        "net": {"name": "RefineNet", "kwargs": NET},
        "losses": [{"name": "L1Loss", "weight": 1.0}],
        "metrics": [{"name": "PSNR"}, {"name": "SSIM"},
                    {"name": "CardiacPSNR", "kwargs": {"coordinates_path": coords}},
                    {"name": "CardiacSSIM", "kwargs": {"coordinates_path": coords}}],
        "predictor": {"name": "AcdcVSRRefineNetPredictor", "kwargs": {
            "device": "cpu", "saved_dir": str(saved_dir), "exported": True, **pred_kwargs}},
    }


def _runs(tree, ckpt, tmp_path, **pred_kwargs):
    """(port predictor, JAX predictor) on the same weights and knobs."""
    port = run_port_test(Cfg(_test_cfg(tree, tmp_path / "port", ckpt, **pred_kwargs)))
    jax_pred = run_jax_test(JaxCfg(_test_cfg(tree, tmp_path / "jax", ckpt, **pred_kwargs)))
    return port, jax_pred


def _csv_rows(path):
    with open(path) as f:
        return [line.split(",") for line in f.read().splitlines()]


def test_bf16_predictor_matches_jax_bf16_and_tracks_fp32(tree, ckpt, tmp_path):
    port, jax_pred = _runs(tree, ckpt, tmp_path, compute_dtype="bfloat16")
    assert port.log.keys() == jax_pred.log.keys() == BF16_LOG_RTOL.keys()
    for key, rtol in BF16_LOG_RTOL.items():
        np.testing.assert_allclose(port.log[key], jax_pred.log[key], rtol=rtol, atol=0,
                                   err_msg=key)
    fp32 = run_port_test(Cfg(_test_cfg(tree, tmp_path / "fp32", ckpt)))
    assert abs(port.log["PSNR"] - fp32.log["PSNR"]) < 0.5
    assert abs(port.log["SSIM"] - fp32.log["SSIM"]) < 0.05
    assert port.log != fp32.log  # the knob is live


def test_t_bucket_matches_jax(tree, ckpt, tmp_path):
    port, jax_pred = _runs(tree, ckpt, tmp_path, t_bucket=4)
    for key in jax_pred.log:
        np.testing.assert_allclose(port.log[key], jax_pred.log[key], rtol=2e-3, atol=2e-3,
                                   err_msg=key)
    rows_port = _csv_rows(tmp_path / "port" / "results.csv")
    rows_jax = _csv_rows(tmp_path / "jax" / "results.csv")
    assert len(rows_port) == len(rows_jax) == 1 + 2 * FRAMES  # header + true frames only
    assert [r[0] for r in rows_port] == [r[0] for r in rows_jax]
    assert port.throughput["frames"] == 2 * FRAMES


def test_bucket_batch_equals_jax():
    rng = np.random.default_rng(0)
    T = 5
    batch = {"hr_imgs": rng.standard_normal((1, T, 8, 8, 1)).astype(np.float32),
             "lr_imgs": rng.standard_normal((1, T + 2 * 2, 2, 2, 1)).astype(np.float32),
             "pos_code": rng.standard_normal((1, T + 2 * 2, 1)).astype(np.float32),
             "index": np.array([0])}
    for tb in (0, 4, 5, 8):
        got, got_T = VSRRefineNetPredictor(device="cpu", t_bucket=tb)._bucket_batch(batch)
        want, want_T = JaxPredictor(device="cpu", loss_fns=[], metric_fns=[],
                                    t_bucket=tb)._bucket_batch(batch)
        assert got_T == want_T and got.keys() == want.keys()
        for key in want:
            np.testing.assert_array_equal(got[key], want[key])
        assert (got is batch) == (want is batch)


def test_aot_cache_is_accepted_and_changes_nothing(tree, ckpt, tmp_path, caplog):
    plain = run_port_test(Cfg(_test_cfg(tree, tmp_path / "a", ckpt)))
    with caplog.at_level(logging.INFO):
        cached = run_port_test(Cfg(_test_cfg(tree, tmp_path / "b", ckpt,
                                             aot_cache=str(tmp_path / "aot"))))
    assert cached.log == plain.log
    assert any("aot_cache" in r.message for r in caplog.records)
    assert not (tmp_path / "aot").exists()


# --------------------------------------------------------------- parallel
@pytest.mark.parametrize("parallel,error,match", [
    ({"num_devices": 1}, None, None),
    ({"num_devices": 1, "spatial_parallel": 1, "multi_host": False}, None, None),
    # a mesh of 8 ranks needs them: main.run spawns them (test_torch_parallel_main)
    ({"num_devices": 8}, ValueError, "num_devices=8 but the process group has 1"),
    ({"num_devices": 1, "spatial_parallel": 2}, ValueError, "not divisible by spatial_parallel=2"),
    ({"num_devices": 1, "model_parallel": 2}, ValueError, "not divisible"),
    ({"num_devices": 1, "multi_host": True}, ValueError, "multi_host"),
])
def test_parallel_section_one_device(tree, ckpt, tmp_path, parallel, error, match):
    """The predictor in the process itself: a section of one device runs in
    a process group of one (same log as without it); what one process
    cannot be raises the JAX package's errors (2 spatial ranks among them)."""
    cfg = Cfg({**_test_cfg(tree, tmp_path, ckpt, exported=False), "parallel": parallel})
    if error is None:
        predictor = run_port_test(cfg)
        assert np.isfinite(predictor.log["Loss"]) and predictor.mesh.shape == {"data": 1}
    else:
        with pytest.raises(error, match=match):
            run_port_test(cfg)


# ------------------------------------------------ the three _tpu configs
def _shrunk_tpu_config(name, tree, ckpt, tmp_path):
    """A shipped ``_tpu`` YAML with data paths patched into the tree, the net
    shrunk, ``num_devices: 1``, ``logger:`` dropped, and the tile (of the
    tiled config) scaled to the tree's 12×12 LR frames."""
    cfg = load_config(REPO_ROOT / "configs" / name)
    kw = cfg.dataset.kwargs
    kw.update(data_dir=str(tree["videos_dir"]), pos_code_path=str(tree["pos_code_path"]),
              num_frames=3, num_updated_frames=2)
    for aug in kw.get("augments") or []:
        if aug.name == "RandomCropPatch":
            aug.kwargs.size = [6, 6]
    cfg.net.kwargs.update(num_features=[4, 4], num_stages=2, num_updated_frames=2)
    for metric in cfg.get("metrics") or []:
        if "coordinates_path" in (metric.get("kwargs") or {}):
            metric.kwargs.coordinates_path = str(tree["coordinates_path"])
    cfg.main.saved_dir = str(tmp_path / "run")
    cfg.pop("logger", None)
    if cfg.get("parallel"):
        cfg.parallel.num_devices = 1
    engine = cfg.trainer if "trainer" in cfg else cfg.predictor
    engine.kwargs.update(device="cpu", aot_cache=str(tmp_path / "aot"))
    if "trainer" in cfg:
        engine.kwargs.num_epochs = 1
        cfg.dataloader.kwargs.update(train_batch_size=4, num_workers=2)
    else:
        cfg.main.loaded_path = str(ckpt)
        engine.kwargs.saved_dir = cfg.main.saved_dir
        cfg.dataloader.kwargs.num_workers = 2
        if "tile" in engine.kwargs:
            engine.kwargs.update(tile=8, tile_overlap=2)
    return cfg


@pytest.fixture(scope="module")
def small_ckpt(tmp_path_factory):
    net = RefineNet(**{**NET, "num_features": [4, 4], "num_updated_frames": 2})
    path = tmp_path_factory.mktemp("small") / "model.pth"
    torch.save({"net": net.state_dict()}, path)
    return path


@pytest.mark.parametrize("name", ["train/refine_net/exp1_x4_tpu.yaml",
                                  "test/refine_net/exp1_x4_tpu.yaml",
                                  "test/refine_net/exp1_x4_dsb15_tile_tpu.yaml"])
def test_tpu_configs_run_through_the_port_main(name, tree, small_ckpt, tmp_path, caplog):
    cfg = _shrunk_tpu_config(name, tree, small_ckpt, tmp_path)
    with caplog.at_level(logging.INFO):
        if "trainer" in cfg:
            trainer = run_port_train(cfg)
            assert trainer.compute_dtype == torch.bfloat16 and trainer._feed_norm is not None
            assert trainer.net.forward_lstm_block.remat
            logs = trainer.history["train"] + trainer.history["valid"]
            assert (tmp_path / "run" / "checkpoints").is_dir()
        else:
            predictor = run_port_test(cfg)
            assert predictor.compute_dtype == torch.bfloat16
            logs = [predictor.log]
            assert (tmp_path / "run" / "results.csv").is_file()
    assert logs and all(np.isfinite(v) for log in logs for v in log.values())
    messages = [r.message for r in caplog.records]
    assert not any("int_feed disabled" in m for m in messages)
    assert any("aot_cache" in m for m in messages)
    if "tile" in name:
        assert any("tile seam" in m for m in messages)
