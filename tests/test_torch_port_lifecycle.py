"""The port's training lifecycle and output modes on the CPU: exact resume,
the checkpoint manager, SIGTERM stop and SIGKILL resume through the CLI, the
checkpoint sweep, the ImageNet overlay, the PNG visualization, infer and
serve against JAX's eval forward, the CLI's guards and its TF32 policy.

Tiny widths; same numpy inputs through both packages where JAX is the
reference; each test states its tolerance.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import (FAST_COMPILE, one_torch_thread,  # noqa: F401
                                random_variables)
from glfusion_tpu import config as jconfig
from glfusion_tpu.models import GlobalAndLocal as JGlobalAndLocal
from glfusion_tpu.utils import imagenet_init as jimagenet
from glfusion_tpu.utils import visualize as jvis
from glfusion_tpu_torch import cli
from glfusion_tpu_torch import config as pconfig
from glfusion_tpu_torch.data.nifti import read_nifti_py
from glfusion_tpu_torch.data.synthetic import generate_synthetic_dataset
from glfusion_tpu_torch.experiments.stem_module import swap_in_fused_stems
from glfusion_tpu_torch.models import GlobalAndLocal
from glfusion_tpu_torch.serve import serve_test_clips
from glfusion_tpu_torch.train.trainer import Trainer
from glfusion_tpu_torch.utils import imagenet_init, summary, visualize
from glfusion_tpu_torch.utils.checkpoint import CheckpointManager
from glfusion_tpu_torch.utils.convert import state_dict_from_jax

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The tiny synthetic corpus, written once: (root, data paths)."""
    cfg = pconfig.tiny_config()
    root = tmp_path_factory.mktemp("corpus")
    return root, generate_synthetic_dataset(root, cfg.data,
                                            views=cfg.model.views,
                                            seed=cfg.train.seed)


def _cfg(tmp: Path, **train):
    cfg = pconfig.tiny_config()
    return cfg.replace(train=dataclasses.replace(
        cfg.train, eval_every_epochs=0, save_dir=str(tmp / "ckpt"),
        log_dir=str(tmp / "log"), **train))


# ------------------------------------------------------------ exact resume

class CarriedRngTrainer(Trainer):
    """The randomness before the repair: one generator seeded once (crops,
    cycle starts) and the global RNG seeded once (dropout), carried from
    step to step."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self._carried = torch.Generator().manual_seed(self.cfg.train.seed + 1)

    @contextlib.contextmanager
    def step_randomness(self, epoch, step):
        yield self._carried


def _train_state(tr: Trainer) -> dict:
    opt = tr.optimizer.state_dict()
    out = {f"net.{k}": v for k, v in tr.model.state_dict().items()}
    for i, st in opt["state"].items():
        out.update({f"adam.{i}.{k}": v for k, v in st.items()})
    out["lr"] = torch.tensor([g["lr"] for g in opt["param_groups"]],
                             dtype=torch.float64)
    out["scheduler_epoch"] = torch.tensor(tr.scheduler.last_epoch)
    return out


@pytest.mark.parametrize("trainer_cls, bitwise", [
    (Trainer, True), (CarriedRngTrainer, False)], ids=["per_step", "carried"])
def test_resume_is_bitwise_the_uninterrupted_run(corpus, tmp_path,
                                                 trainer_cls, bitwise):
    """With the cycle loss on, a run stopped after epoch 0 of 2 and resumed
    in a fresh trainer from its checkpoint ends bitwise equal to the
    uninterrupted run: every weight and BN buffer, Adam's moments and step
    counts, the learning rate and the schedule's epoch (as JAX's
    tests/test_crash_resume.py:264). With the randomness carried in one
    generator, as before the repair, the two runs differ."""
    _, paths = corpus
    assert pconfig.tiny_config().train.use_cycle
    solo = trainer_cls(_cfg(tmp_path / "solo", save_every_epochs=0),
                       data_paths=paths, verbose=False, device="cpu")
    solo.train(2)
    first = trainer_cls(_cfg(tmp_path / "split"), data_paths=paths,
                        verbose=False, device="cpu")
    first.train(1)
    resumed = trainer_cls(_cfg(tmp_path / "split"), data_paths=paths,
                          verbose=False, device="cpu")
    assert resumed.load_latest() and resumed.epoch == 1
    resumed.train(2)
    a, b = _train_state(solo), _train_state(resumed)
    assert a.keys() == b.keys()
    same = {k: torch.equal(a[k], b[k]) for k in a}
    assert int(a["scheduler_epoch"]) == 2
    if bitwise:
        assert all(same.values()), [k for k, v in same.items() if not v][:5]
    else:
        assert not all(same.values())


# ------------------------------------------------------ checkpoint manager

def _payload(seed: int) -> dict:
    g = torch.Generator().manual_seed(seed)
    return {"network": {"w": torch.randn(3, 4, generator=g),
                        "n": torch.tensor(seed)},
            "optimizer": {"state": {0: {"step": torch.tensor(float(seed))}},
                          "param_groups": [{"lr": 0.1 * seed,
                                            "betas": (0.9, 0.999)}]},
            "scheduler": {"last_epoch": seed}}


def _same(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return a == b


def test_checkpoint_round_trip_retention_and_order(tmp_path):
    """A saved payload comes back equal; the net file is the reference's
    ``{'network': state_dict}``; many asynchronous saves land in order and
    ``max_to_keep`` keeps the newest, each save's size and times recorded;
    a save taken before a tensor changes
    keeps the old value; a re-save of an epoch overwrites it."""
    mgr = CheckpointManager(tmp_path / "a")
    live = _payload(1)
    mgr.save(live, 1)
    live["network"]["w"].add_(1.0)  # after save(): must not reach the file
    got, nxt = mgr.restore_latest()
    assert nxt == 2 and _same(got, {**_payload(1), "epoch": 1})
    assert set(torch.load(mgr.paths(1)[0], weights_only=True)) == {"network"}
    assert mgr.restore_step(1, train_state=False).keys() == {"network"}

    kept = CheckpointManager(tmp_path / "b", max_to_keep=3)
    for e in range(12):
        kept.save(_payload(e), e)
    assert kept.all_steps() == [9, 10, 11]
    assert sorted(p.name for p in (tmp_path / "b").iterdir()) == sorted(
        f"{k}_{e:05}.pth" for k in ("net", "state") for e in (9, 10, 11))
    assert [r["epoch"] for r in kept.saves] == list(range(12))
    assert all(r["bytes"] > 0 and r["write_s"] > 0 for r in kept.saves)
    kept.save(_payload(40), 11)
    kept.wait()
    assert _same(kept.restore_step(11), {**_payload(40), "epoch": 11})


def test_checkpoint_failures_and_partial_pairs(tmp_path):
    """An empty directory restores nothing; a net file without its sidecar
    (a save cut between the two renames) and a leftover temporary file are
    not steps; ``wait()`` re-raises a failed write."""
    mgr = CheckpointManager(tmp_path / "c")
    assert mgr.all_steps() == [] and mgr.restore_latest() is None
    mgr.save(_payload(0), 0)
    mgr.wait()
    torch.save({"network": {}}, mgr.paths(1)[0])  # no sidecar
    (mgr.directory / ".tmp_state_00002.pth").write_bytes(b"partial")
    assert mgr.all_steps() == [0]
    assert mgr.restore_step(1) is None and mgr.restore_latest()[1] == 1

    mgr.save({"network": {"x": torch.zeros(1)}, "bad": lambda: 0}, 5)
    with pytest.raises(RuntimeError, match="async checkpoint save failed"):
        mgr.wait()
    mgr.wait()  # the error is reported once
    assert 5 not in mgr.all_steps()


# -------------------------------------------------------- CLI subprocesses

def _cli(corpus_root, tmp: Path, *extra):
    return [sys.executable, "-m", "glfusion_tpu_torch", "--mode", "train",
            "--tiny", "--platform", "cpu", "--data-root", str(corpus_root),
            "--eval-every", "0", "--save-dir", str(tmp / "ckpt"),
            "--log-dir", str(tmp / "log"), *extra]


def _wait_for(proc, cond, what: str, timeout: float = 60.0) -> None:
    deadline = time.time() + timeout
    while not cond():
        if proc.poll() is not None:
            pytest.fail(f"training exited before {what}:\n"
                        + proc.stdout.read())
        if time.time() > deadline:
            proc.kill()
            pytest.fail(f"no {what} within {timeout} s")
        time.sleep(0.1)


def _env():
    return {**os.environ, "OMP_NUM_THREADS": "1"}


def test_cli_sigterm_checkpoints_the_epoch_in_flight(corpus, tmp_path):
    """SIGTERM during a long run: the CLI finishes the epoch in flight,
    checkpoints it off the save cadence (``--save-every 100``), and exits
    0 with that epoch durable."""
    root, _ = corpus
    proc = subprocess.Popen(
        _cli(root, tmp_path, "--epochs", "50", "--save-every", "100"),
        cwd=ROOT, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    metrics = tmp_path / "log" / "metrics.jsonl"
    try:
        _wait_for(proc, lambda: metrics.exists() and metrics.read_text(),
                  "completed epoch")
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
    finally:
        proc.kill()
    assert proc.returncode == 0, out
    assert "stop requested: checkpointed epoch" in out, out
    steps = CheckpointManager(tmp_path / "ckpt").all_steps()
    assert len(steps) == 1 and steps[0] >= 0, steps
    assert f"stop requested: checkpointed epoch {steps[0]}," in out


def test_cli_sigkill_then_resume_continues(corpus, tmp_path, capsys):
    """SIGKILL once a checkpoint is durable, then ``--resume`` (in process)
    continues from the newest whole epoch and trains to the end."""
    root, _ = corpus
    proc = subprocess.Popen(_cli(root, tmp_path, "--epochs", "50"),
                            cwd=ROOT, env=_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    mgr = CheckpointManager(tmp_path / "ckpt")
    try:
        _wait_for(proc, lambda: mgr._scan(), "durable checkpoint")
    finally:
        proc.kill()
        proc.communicate()
    survived = mgr.all_steps()
    assert survived
    target = max(survived) + 2
    assert cli.main(_cli(root, tmp_path, "--epochs", str(target),
                         "--resume")[3:]) == 0
    out = capsys.readouterr().out
    assert f"restored checkpoint at epoch {max(survived) + 1}" in out, out
    assert f"epoch {max(survived)}:" not in out
    assert mgr.all_steps()[-1] == target - 1


# ------------------------------------------------------------------ sweep

@pytest.mark.parametrize("dice, best", [
    ({10: 0.9, 49: 0.8, 50: 0.3, 60: 0.5}, 60),  # the ≥ 50 rule
    ({0: 0.2, 1: 0.6, 2: 0.4}, 1),               # a short run: all count
], ids=["min_epoch", "short_run"])
def test_sweep_picks_the_best_val_epoch(corpus, tmp_path, dice, best):
    """Every saved epoch is loaded and validated (validation stubbed: it
    reads which epoch's weights are in the model); the best Inner-val mean
    Dice at epoch ≥ 50 wins, or over all epochs when none reaches 50; the
    trainer's own weights and epoch are put back."""
    _, paths = corpus
    tr = Trainer(_cfg(tmp_path), data_paths=paths, verbose=False,
                 device="cpu")
    marker = tr.model.global_attn.norm_layer.bias
    for e in dice:
        with torch.no_grad():
            marker[0] = e
        tr.save(e)
    with torch.no_grad():
        marker[0] = -1.0
    tr.epoch = 7
    seen = []

    def stub():
        e = int(marker.detach()[0])
        seen.append(e)
        assert tr.epoch == e
        return {"Inner-val": {"views": {"1": {"dice": dice[e]},
                                        "3": {"dice": dice[e]}}},
                "Inner-test": {"epoch": e}}

    tr.validation_and_test = stub
    res = tr.sweep_checkpoints()
    assert seen == sorted(dice)
    assert res["epoch"] == best and res["val_dice"] == dice[best]
    assert res["test"] == {"epoch": best}
    assert float(marker.detach()[0]) == -1.0 and tr.epoch == 7


# ---------------------------------------------------------- ImageNet init

def _torchvision_sd(cfg, seed: int = 0) -> dict:
    """A seeded state dict with torchvision resnet50's names at the tiny
    widths (conv1 and fc included: the overlay skips them)."""
    g = torch.Generator().manual_seed(seed)
    sd = {"conv1.weight": torch.randn(cfg.stem_width, 3, 7, 7, generator=g),
          "fc.weight": torch.randn(10, cfg.backbone_out_channels,
                                   generator=g),
          "fc.bias": torch.randn(10, generator=g)}

    def bn(k, c):
        sd[f"{k}.weight"] = torch.rand(c, generator=g) + 0.5
        sd[f"{k}.bias"] = torch.randn(c, generator=g)
        sd[f"{k}.running_mean"] = torch.randn(c, generator=g)
        sd[f"{k}.running_var"] = torch.rand(c, generator=g) + 0.5
        sd[f"{k}.num_batches_tracked"] = torch.tensor(1000)

    bn("bn1", cfg.stem_width)
    cin = cfg.stem_width
    for s, (blocks, w) in enumerate(zip(cfg.block_sizes, cfg.widths), 1):
        cout = w * cfg.expansion
        for b in range(blocks):
            k = f"layer{s}.{b}"
            for j, shape in ((1, (w, cin, 1, 1)), (2, (w, w, 3, 3)),
                             (3, (cout, w, 1, 1))):
                sd[f"{k}.conv{j}.weight"] = torch.randn(*shape, generator=g)
                bn(f"{k}.bn{j}", shape[0])
            if b == 0:
                sd[f"{k}.downsample.0.weight"] = torch.randn(
                    cout, cin, 1, 1, generator=g)
                bn(f"{k}.downsample.1", cout)
            cin = cout
    return sd


@pytest.fixture(scope="module")
def tiny_jax_variables():
    """JAX variables of the trainer's tiny flagship (random, traced with
    ``jax.eval_shape``) and the port's state dict of them."""
    jcfg = jconfig.tiny_config()
    jm = JGlobalAndLocal(jcfg.model)
    x = jnp.zeros((3, 1, 32, 32, 1), jnp.float32)
    v = random_variables(lambda: jm.init(jax.random.PRNGKey(0), x, False), 3)
    return jm, v, state_dict_from_jax(v, pconfig.tiny_config().model)


def test_imagenet_overlay_matches_jax(tiny_jax_variables, tmp_path):
    """The overlay of a torchvision file onto the flagship equals JAX's
    ``convert_torchvision_resnet`` + ``merge_backbone`` mapped through
    ``state_dict_from_jax``, key by key and exactly, with plain and with
    fused stems; conv1, fc and the BN counters are not taken."""
    _, v, sd0 = tiny_jax_variables
    cfg, jcfg = pconfig.tiny_config(), jconfig.tiny_config()
    tv = _torchvision_sd(cfg.model)
    conv = jimagenet.convert_torchvision_resnet(tv, jcfg.model)
    want = state_dict_from_jax(
        {k: jimagenet.merge_backbone(v[k], conv[k])
         for k in ("params", "batch_stats")}, cfg.model)
    path = tmp_path / "resnet50.pth"
    torch.save({"state_dict": tv}, path)
    for fused in (False, True):
        model = GlobalAndLocal(cfg.model)
        model.load_state_dict(sd0)
        if fused:
            swap_in_fused_stems(model)
        got = imagenet_init.merge_backbone(
            model.state_dict(),
            imagenet_init.load_imagenet_backbone(str(path), cfg.model))
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), k
    assert not torch.equal(want["init_block.1.1.weight"],
                           sd0["init_block.1.1.weight"])
    assert torch.equal(want["init_block.1.0.weight"],
                       sd0["init_block.1.0.weight"])


@pytest.mark.parametrize("fault", ["shape", "unknown", "missing"])
def test_imagenet_overlay_raises_as_jax(tiny_jax_variables, fault):
    """A wrong shape and a name the model lacks raise ``ValueError``, a key
    missing from the file ``KeyError``, in both packages."""
    _, v, sd0 = tiny_jax_variables
    cfg, jcfg = pconfig.tiny_config(), jconfig.tiny_config()
    tv = _torchvision_sd(cfg.model)
    if fault == "missing":
        del tv["layer2.0.bn1.running_var"]
        for conv_fn, c in ((jimagenet.convert_torchvision_resnet, jcfg),
                           (imagenet_init.convert_torchvision_resnet, cfg)):
            with pytest.raises(KeyError):
                conv_fn(tv, c.model)
        return
    if fault == "shape":
        tv["layer3.0.conv2.weight"] = tv["layer3.0.conv2.weight"][:, :, :1]
        jconv = jimagenet.convert_torchvision_resnet(tv, jcfg.model)
        conv = imagenet_init.convert_torchvision_resnet(tv, cfg.model)
        match = "shape mismatch"
    else:
        jconv = {"params": {"backbone": {"bogus": np.zeros(3)}}}
        conv = {"bogus.weight": torch.zeros(3)}
        match = "lacks"
    with pytest.raises(ValueError, match=match):
        jimagenet.merge_backbone(v["params"], jconv["params"])
    with pytest.raises(ValueError, match=match):
        imagenet_init.merge_backbone(sd0, conv)


# ----------------------------------------------------------- visualization

def test_visualization_matches_jax(tmp_path):
    """Class map, colours, the PNG bytes and the directory layout equal
    JAX's on seeded logits, ties and all-background pixels included."""
    rs = np.random.RandomState(5)
    logits = rs.randn(3, 6, 7, 5).astype(np.float32)
    logits[0, 0] = -1.0  # background
    logits[0, 1] = 1.0   # every channel fires: the first wins
    cmap = visualize.class_map(torch.from_numpy(logits)).numpy()
    np.testing.assert_array_equal(
        cmap, np.asarray(jvis.class_map(jnp.asarray(logits))))
    np.testing.assert_array_equal(visualize.COLOR_TABLE, jvis.COLOR_TABLE)
    np.testing.assert_array_equal(visualize.colorize(cmap),
                                  jvis.colorize(cmap))
    n = visualize.save_clip_visualization(tmp_path / "p", "m", "0_1", "4",
                                          torch.from_numpy(logits))
    assert n == jvis.save_clip_visualization(tmp_path / "j", "m", "0_1", "4",
                                             logits) == 3
    for t in range(3):
        rel = Path("m", "192_data", "0_1", "4", f"pred_{t}.png")
        png = (tmp_path / "p" / rel).read_bytes()
        assert png == (tmp_path / "j" / rel).read_bytes()
        assert png.startswith(b"\x89PNG\r\n\x1a\n")
    with pytest.raises(ValueError, match="RGBA"):
        visualize.write_png(tmp_path / "x.png", np.zeros((2, 2, 3)))


# ------------------------------------------------- infer, serve, visual

@pytest.fixture(scope="module")
def infer_run(corpus, tiny_jax_variables, tmp_path_factory):
    """A CPU trainer on JAX's random weights, loaded as a reference
    ``{'network': ...}`` file through ``load_torch_checkpoint``, and its
    infer outputs."""
    _, paths = corpus
    _, _, sd = tiny_jax_variables
    tmp = tmp_path_factory.mktemp("infer")
    torch.save({"network": sd}, tmp / "net_00003.pth")
    tr = Trainer(_cfg(tmp), data_paths=paths, verbose=False, device="cpu")
    tr.load_torch_checkpoint(str(tmp / "net_00003.pth"))
    n = tr.infer(str(tmp / "infer"))
    return tr, tmp, n


def _volumes(d: Path) -> dict:
    return {p.name: read_nifti_py(p) for p in sorted(d.glob("*.nii.gz"))}


def test_infer_matches_jax_eval_forward(infer_run, tiny_jax_variables):
    """``Trainer.infer`` writes (5, H, W, T) uint8 masks of every test clip
    and view, equal to JAX's jitted eval forward thresholded at 0 on the
    same weights, except where JAX's logit lies within 1e-3 of 0 (the
    forwards agree to 2e-4)."""
    from glfusion_tpu.data.pipeline import TestClipLoader as JTestClipLoader

    tr, tmp, n = infer_run
    jm, v, _ = tiny_jax_variables
    vols = _volumes(tmp / "infer")
    views = tr.cfg.model.views
    assert n == len(vols) == len(tr.test_infos) * len(views)
    fwd = jax.jit(lambda x: jm.apply(v, x, False)["mask"],
                  compiler_options=FAST_COMPILE)
    clips = JTestClipLoader(tr.test_infos, sorted(tr.test_infos), views,
                            tr.cfg.data.clip_length).clips()
    flips = 0
    for clip in clips:
        logits = np.asarray(fwd(jnp.asarray(clip["images"])))
        for vi, view in enumerate(views):
            got = vols[f"pred_{clip['clip_id']}_v{view}.nii.gz"]
            want = np.transpose(logits[vi], (3, 1, 2, 0))
            assert got.dtype == np.uint8 and got.shape == want.shape
            differ = got != (want > 0)
            assert np.all(np.abs(want[differ]) < 1e-3)
            flips += int(differ.sum())
    assert flips <= 5


def test_serve_writes_the_infer_volumes(infer_run):
    """``serve_test_clips`` (``ClipPipeline``) writes the same files with
    the same bytes' volumes as ``Trainer.infer``."""
    tr, tmp, n = infer_run
    stats = serve_test_clips(tr, out_dir=str(tmp / "serve"), depth=2,
                             threads=2)
    assert stats["written"] == n and stats["clips"] == len(tr.test_infos)
    assert stats["clips_per_s"] > 0
    a, b = _volumes(tmp / "infer"), _volumes(tmp / "serve")
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_visualize_writes_a_png_per_frame(infer_run):
    """``Trainer.test_visualize``: one PNG per test clip, view and frame in
    the reference's layout."""
    tr, tmp, _ = infer_run
    n = tr.test_visualize("m", str(tmp / "vis"))
    pngs = sorted((tmp / "vis" / "m" / "192_data").rglob("pred_*.png"))
    assert n == len(pngs) > 0
    assert {p.parent.parent.name for p in pngs} == set(tr.test_infos)
    assert {p.parent.name for p in pngs} == set(tr.cfg.model.views)


# ------------------------------------------------------------ CLI modes

def test_cli_output_modes(corpus, tmp_path, capsys, monkeypatch):
    """train with ``--log-histograms``, then ``val --sweep``, ``visual``,
    ``infer`` and ``serve`` on its checkpoints; ``--ckpt-keep 1`` keeps the
    newest epoch only."""
    root, _ = corpus
    monkeypatch.chdir(tmp_path)
    base = _cli(root, tmp_path)[3:]
    assert cli.main(base + ["--log-histograms", "--ckpt-keep", "1"]) == 0
    assert CheckpointManager(tmp_path / "ckpt").all_steps() == [1]
    events = b"".join(p.read_bytes() for p in (tmp_path / "log").glob(
        "events.out.tfevents.*"))
    if summary.SummaryWriter(str(tmp_path / "tb")).active:
        assert b"params/global_attn.theta.weight" in events
        assert b"seg_loss" in events
    for mode in ("val", "visual", "infer", "serve"):
        extra = ["--sweep"] if mode == "val" else []
        assert cli.main([*base, "--mode", mode, "--out-dir",
                         str(tmp_path / mode), *extra]) == 0
    out = capsys.readouterr().out
    assert "best val epoch 1" in out
    assert "wrote 30 prediction volumes" in out
    assert "served 10 clips" in out
    pngs = list((tmp_path / "visualze_for_ppt" / "glfusion_tpu_torch")
                .rglob("pred_*.png"))
    assert f"wrote {len(pngs)} prediction frames" in out and pngs
    assert _volumes(tmp_path / "infer").keys() == \
        _volumes(tmp_path / "serve").keys()


def test_cli_guards(corpus, tmp_path):
    """``--imagenet-backbone`` with ``--torch-ckpt`` exits; ``val`` and
    ``serve`` with no weights exit."""
    root, _ = corpus
    base = _cli(root, tmp_path)[3:]
    with pytest.raises(SystemExit, match="pick one"):
        cli.main(base + ["--imagenet-backbone", "a.pth", "--torch-ckpt",
                         "b.pth"])
    for mode in ("val", "serve"):
        with pytest.raises(SystemExit, match="found no weights"):
            cli.main(base + ["--mode", mode])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cli_tf32_policy(corpus, tmp_path, dtype):
    """After ``cli.main`` in float32, TF32 is off for cuBLAS and cuDNN; in
    bfloat16 PyTorch's flags are left as they were."""
    root, _ = corpus
    flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
    before = [f.allow_tf32 for f in flags]
    try:
        for f in flags:
            f.allow_tf32 = True
        with pytest.raises(SystemExit):
            cli.main(_cli(root, tmp_path)[3:] + [
                "--dtype", dtype, "--imagenet-backbone", "a.pth",
                "--torch-ckpt", "b.pth"])
        want = dtype == "bfloat16"
        assert [f.allow_tf32 for f in flags] == [want, want]
    finally:
        for f, b in zip(flags, before):
            f.allow_tf32 = b


def test_summary_writer_inactive_says_so_once(tmp_path, capsys,
                                              monkeypatch):
    """Without tensorboard the writer is inactive, says so once on
    stderr, and its calls do nothing."""
    def missing():
        raise ImportError("No module named 'tensorboard'")

    monkeypatch.setattr(summary, "_tensorboard_writer_class", missing)
    w = summary.SummaryWriter(str(tmp_path))
    w.add_scalar("a", 1.0, 0)
    w.add_histogram("h", np.zeros(3), 0)
    w.flush()
    err = capsys.readouterr().err
    assert not w.active and err.count("TensorBoard writer disabled") == 1
