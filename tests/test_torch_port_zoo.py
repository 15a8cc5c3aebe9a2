"""The port's segmentation zoo (``--model``) against the JAX package's on
the CPU: the U-Net family's eval and train parity
(``_torch_port_zoo_common``: JAX in float64, one compile an arch), and the
wiring: the registry over every ``SEG_ARCHS`` name, ``--model``'s choices,
the trainer's five refusals in JAX's words, deep supervision in the plain
and the ``grad_accum`` step, one tiny ``Trainer`` epoch of ``res3dunet``
and a tiny CLI run. The other archs' parity and the pins are in
test_torch_port_zoo_models.py (two files, so the suite's workers share
the JAX references' cost)."""

from __future__ import annotations

import ast
import dataclasses
import functools
import inspect

import numpy as np
import pytest
import torch

from _torch_port_common import one_torch_thread  # noqa: F401
from _torch_port_zoo_common import TINY, check_eval, check_train
from glfusion_tpu import arch_names as jarch
from glfusion_tpu.train import trainer as jtrainer
from glfusion_tpu_torch import arch_names, cli
from glfusion_tpu_torch.config import ModelConfig
from glfusion_tpu_torch.models import build_model
from glfusion_tpu_torch.train.losses import bce_with_logits_sum
from glfusion_tpu_torch.train.step import make_train_step
from glfusion_tpu_torch.train.trainer import Trainer

ARCHS = ("unet", "unet:plain", "unet:r2", "unet:att", "unet:r2att")
ALL_ARCHS = ARCHS + ("multiview_unet", "utnet", "cen", "res3dunet")


@pytest.mark.parametrize("arch", ARCHS)
def test_zoo_eval_matches_jax(arch):
    check_eval(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_zoo_train_grads_match_jax(arch):
    check_train(arch)


def test_registry_covers_seg_archs():
    """Every SEG_ARCHS name builds, or for the AVS family and the legacy
    kinds raises the error naming ROADMAP Queue 1; --model's choices are
    JAX's SEG_ARCHS."""
    assert arch_names.SEG_ARCHS == jarch.SEG_ARCHS
    for name in ("AVS_FLAVORS", "LEGACY_KINDS", "UNET_KINDS"):
        assert getattr(arch_names, name) == getattr(jarch, name)
    action = next(a for a in cli.build_parser()._actions
                  if a.dest == "model")
    assert tuple(action.choices) == jarch.SEG_ARCHS
    assert action.default == "glfusion"
    assert cli.config_from_args(cli.build_parser().parse_args(
        ["--tiny", "--model", "utnet"])).model.arch == "utnet"
    built = []
    for arch in jarch.SEG_ARCHS:
        cfg = dataclasses.replace(TINY.model, arch=arch)
        if arch.startswith(("avs_", "legacy:")):
            with pytest.raises(NotImplementedError, match="ROADMAP Queue 1"):
                build_model(cfg, hw=32)
        else:
            with torch.device("meta"):
                m, cps = build_model(cfg, hw=32)
            built.append(arch)
            assert not cps and isinstance(m, torch.nn.Module)
    assert set(built) == {"glfusion"} | set(ALL_ARCHS)
    with pytest.raises(ValueError, match="unknown arch"):
        build_model(dataclasses.replace(TINY.model, arch="nope"))


@functools.lru_cache(maxsize=None)
def _jax_strings():
    """Every string constant of JAX's trainer (adjacent literals joined)."""
    tree = ast.parse(inspect.getsource(jtrainer))
    return {n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)}


@pytest.fixture(scope="module")
def corpus_root(tmp_path_factory):
    from glfusion_tpu_torch.data.synthetic import generate_synthetic_dataset
    root = tmp_path_factory.mktemp("zoo")
    generate_synthetic_dataset(root, TINY.data, views=TINY.model.views)
    return root


@pytest.fixture(scope="module")
def corpus(corpus_root):
    return cli.data_paths_from_root(str(corpus_root), TINY)


def _cfg(tmp_path, arch, **train):
    return TINY.replace(
        model=dataclasses.replace(TINY.model, arch=arch),
        train=dataclasses.replace(TINY.train, num_epochs=1,
                                  eval_every_epochs=0, save_every_epochs=0,
                                  save_dir=str(tmp_path / "ckpt"),
                                  log_dir=str(tmp_path / "log"), **train))


def test_trainer_refuses_options_for_zoo_in_jax_words(tmp_path, corpus):
    for opt in ("cycle_light", "temporal", "fuse_passes"):
        with pytest.raises(ValueError) as err:
            Trainer(_cfg(tmp_path, "unet", **{opt: True}), data_paths=corpus,
                    device="cpu", verbose=False)
        assert str(err.value) in _jax_strings(), opt
    trainer = Trainer(_cfg(tmp_path, "unet"), data_paths=corpus,
                      device="cpu", verbose=False)
    for load in (trainer.load_torch_checkpoint,
                 trainer.load_imagenet_backbone):
        with pytest.raises(ValueError) as err:
            load(str(tmp_path / "missing.pth"))
        assert str(err.value) in _jax_strings(), load.__name__


class _AuxStub(torch.nn.Module):
    """Logits a·x (mask) and b·x, c·x (two mask_aux maps)."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.tensor([0.5, -1.0, 2.0]))

    def forward(self, x):
        z = (x - 0.5).expand(*x.shape[:-1], 5)
        return {"mask": self.w[0] * z, "mask_aux": (self.w[1] * z,
                                                    self.w[2] * z)}


@pytest.mark.parametrize("accum", [1, 2])
def test_deep_supervision_reaches_the_loss(accum):
    """The step's supervised loss sums every mask_aux map, in the plain
    and the microbatched (grad_accum) pass, and so does its gradient."""
    cfg = TINY.replace(train=dataclasses.replace(
        TINY.train, use_cycle=False, grad_accum=accum))
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.rand(3, 4, 6, 6, 1).astype(np.float32))
    masks = torch.from_numpy((rs.rand(3, 4, 6, 6, 5) > 0.5).astype(
        np.float32))
    model = _AuxStub()
    opt = torch.optim.SGD(model.parameters(), lr=0.0)
    step = make_train_step(cfg, model, opt)
    metrics = step({"images": x, "masks": masks}, torch.Generator())
    out = model(x)
    terms = [out["mask"], *out["mask_aux"]]
    want = sum(bce_with_logits_sum(t[vi], masks[vi]) for t in terms
               for vi in range(3))
    plain = sum(bce_with_logits_sum(out["mask"][vi], masks[vi])
                for vi in range(3))
    assert abs(metrics["seg_loss"].item() - want.item()) <= 1e-4 * want
    assert abs(want.item() - plain.item()) > 1.0
    assert (model.w.grad != 0).all()  # each aux map's weight has gradient
    assert step.seg_loss(out, masks).item() == pytest.approx(want.item())


def test_res3dunet_trains_one_tiny_epoch(tmp_path, corpus):
    """One Trainer epoch of res3dunet on the CPU: finite loss, the
    parameters move, and the loss of the model's output reads mask_aux."""
    trainer = Trainer(_cfg(tmp_path, "res3dunet"), data_paths=corpus,
                      device="cpu", verbose=False)
    before = {k: p.detach().clone()
              for k, p in trainer.model.named_parameters()}
    metrics = trainer.train()
    assert metrics["steps"] > 0 and np.isfinite(metrics["loss"])
    moved = [k for k, p in trainer.model.named_parameters()
             if not torch.equal(p, before[k])]
    assert len(moved) == len(before)
    host = next(trainer.train_loader.batches(TINY.train.batch_size, 0))
    with trainer.step_randomness(0, 0) as gen:
        batch = trainer.train_batch(host, None, gen)
    with torch.no_grad():
        out = trainer.model.eval()(batch["images"])
        plain = {k: v for k, v in out.items() if k != "mask_aux"}
        seg = trainer.train_step.seg_loss
        assert len(out["mask_aux"]) == 3
        assert seg(out, batch["masks"]) > seg(plain, batch["masks"])


def test_cli_trains_a_zoo_arch(tmp_path, corpus_root):
    """``--model`` through the CLI, tiny on the CPU, then val."""
    args = ["--tiny", "--platform", "cpu", "--model", "unet:att",
            "--data-root", str(corpus_root), "--epochs", "1",
            "--save-dir", str(tmp_path / "ckpt"),
            "--log-dir", str(tmp_path / "log")]
    assert cli.main(["--mode", "train"] + args) == 0
    assert cli.main(["--mode", "val"] + args) == 0
    assert ModelConfig().arch == "glfusion"
