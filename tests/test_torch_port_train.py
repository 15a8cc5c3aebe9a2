"""The port's training slice against the JAX package on the CPU: crops,
masks, the device preprocess, the host loaders and the synthetic corpus,
losses, metrics, Adam and the cosine schedule, one whole train step, and
the CLI's train → val → checkpoint round trip.

Same numpy inputs through both packages; each test states its tolerance.
"""

from __future__ import annotations

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_port_common import (FAST_COMPILE, one_torch_thread,  # noqa: F401
                                random_variables)
from glfusion_tpu import config as jconfig
from glfusion_tpu.data import pipeline as jpipe
from glfusion_tpu.data.infos import PatientIndex as JPatientIndex
from glfusion_tpu.data.synthetic import generate_synthetic_dataset as jgen
from glfusion_tpu.models.glfusion import PointwiseConv, _per_view
from glfusion_tpu.models.resnet import IEKDStem
from glfusion_tpu.ops import crops as jcrops
from glfusion_tpu.ops import masks as jmasks
from glfusion_tpu.ops.resize import resize_bilinear as j_resize_bilinear
from glfusion_tpu.train import losses as jlosses
from glfusion_tpu.train import metrics as jmetrics
from glfusion_tpu.train.step import make_train_step as j_make_train_step
from glfusion_tpu.train.train_state import TrainState
from glfusion_tpu.train.train_state import make_optimizer as j_make_optimizer
from glfusion_tpu.utils.torch_convert import load_torch_checkpoint
from glfusion_tpu_torch import cli
from glfusion_tpu_torch import config as pconfig
from glfusion_tpu_torch.data import pipeline
from glfusion_tpu_torch.data.infos import PatientIndex, load_infos, load_split
from glfusion_tpu_torch.data.synthetic import generate_synthetic_dataset
from glfusion_tpu_torch.experiments.stem_module import FusedIEKDStem
from glfusion_tpu_torch.models import GlobalAndLocal
from glfusion_tpu_torch.ops import crops, masks
from glfusion_tpu_torch.ops.resize import resize_bilinear_nchw
from glfusion_tpu_torch.train import losses, metrics
from glfusion_tpu_torch.train.step import make_train_step
from glfusion_tpu_torch.train.train_state import (make_optimizer,
                                                  make_scheduler)
from glfusion_tpu_torch.utils.convert import load_checkpoint

TOL = dict(atol=2e-4, rtol=2e-4)


# ------------------------------------------------------------------ ops

def test_crops_match_jax():
    """Center crop (MONAI start rule) and a crop at the offsets JAX's
    random_crop draws: exactly equal."""
    x = np.random.RandomState(0).rand(2, 11, 9, 3).astype(np.float32)
    np.testing.assert_array_equal(
        crops.center_crop(torch.from_numpy(x), (6, 5)).numpy(),
        np.asarray(jcrops.center_crop(jnp.asarray(x), (6, 5))))
    key = jax.random.PRNGKey(3)
    kh, kw = jax.random.split(key)
    start = (int(jax.random.randint(kh, (), 0, 11 - 6 + 1)),
             int(jax.random.randint(kw, (), 0, 9 - 5 + 1)))
    np.testing.assert_array_equal(
        crops.random_crop(torch.from_numpy(x), (6, 5), start).numpy(),
        np.asarray(jcrops.random_crop(key, jnp.asarray(x), (6, 5))))
    off = crops.random_offsets(torch.Generator().manual_seed(0), (11, 9),
                               (6, 5), 50)
    assert off.shape == (50, 2) and off.min() >= 0
    assert off[:, 0].max() <= 5 and off[:, 1].max() <= 4
    with pytest.raises(ValueError, match="exceeds"):
        crops.center_crop(torch.from_numpy(x), (12, 5))


@pytest.mark.parametrize("view", ["1", "2", "3", "4"])
def test_mask_to_allclass_matches_jax(view):
    """Every view's remap, out-of-range labels (−2, 5, 6) as background."""
    np.testing.assert_array_equal(masks.view_label_table(),
                                  jmasks.view_label_table())
    raw = np.random.RandomState(1).randint(-2, 7, (3, 6, 5)).astype(np.int32)
    np.testing.assert_array_equal(
        masks.mask_to_allclass(torch.from_numpy(raw), view).numpy(),
        np.asarray(jmasks.mask_to_allclass(jnp.asarray(raw), view)))


def _jax_crop_offsets(rng, v, b, r, c):
    """The windows JAX's _preprocess_core draws for each (view, sample)."""
    def draw(k):
        kh, kw = jax.random.split(k, 2)
        return jnp.stack([jax.random.randint(kh, (), 0, r - c + 1),
                          jax.random.randint(kw, (), 0, r - c + 1)])

    out = jax.vmap(draw)(jax.random.split(rng, v * b))
    return torch.from_numpy(np.asarray(out)).long().reshape(v, b, 2)


@pytest.mark.parametrize("is_train", [True, False])
def test_preprocess_batch_matches_jax(is_train):
    """Crop (train: JAX's own windows handed to the port), /255, remap:
    masks exactly equal, images within one float32 rounding (XLA divides
    by 255 as a multiply by its reciprocal)."""
    rs = np.random.RandomState(2)
    imgs = (rs.rand(3, 2, 20, 20) * 255).astype(np.float32)
    raw = rs.randint(0, 5, (3, 2, 20, 20)).astype(np.int32)
    view_ids = (0, 2, 3)
    rng = jax.random.PRNGKey(4)
    want = jpipe.preprocess_batch(rng, jnp.asarray(imgs), jnp.asarray(raw),
                                  crop_hw=12, is_train=is_train,
                                  view_ids=view_ids)
    offsets = _jax_crop_offsets(rng, 3, 2, 20, 12) if is_train else None
    got = pipeline.preprocess_batch(
        torch.from_numpy(imgs), torch.from_numpy(raw), crop_hw=12,
        is_train=is_train, view_ids=view_ids, offsets=offsets)
    np.testing.assert_allclose(got["images"].numpy(),
                               np.asarray(want["images"]), rtol=2e-7)
    np.testing.assert_array_equal(got["masks"].numpy(),
                                  np.asarray(want["masks"]))
    assert pipeline.view_ids_tuple(("1", "3", "4")) == \
        jpipe.view_ids_tuple(("1", "3", "4"))


# ----------------------------------------------------------------- data

@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """The tiny synthetic corpus written by each package from one seed."""
    cfg = pconfig.tiny_config()
    jcfg = jconfig.tiny_config()
    port = generate_synthetic_dataset(tmp_path_factory.mktemp("port"),
                                      cfg.data, seed=11)
    ref = jgen(tmp_path_factory.mktemp("jax"), jcfg.data, seed=11)
    return cfg, jcfg, port, ref


def test_synthetic_corpus_matches_jax(corpora):
    """Same seed → the same infos, splits and volumes."""
    _, _, port, ref = corpora
    for name in ("infos", "unlab_infos", "test_infos"):
        a, b = load_infos(port[name]), load_infos(ref[name])
        assert list(a) == list(b)
        for pid in a:
            for kind in ("views_images", "views_labels"):
                for view, path in a[pid][kind].items():
                    from glfusion_tpu_torch.data.nifti import read_nifti_py
                    np.testing.assert_array_equal(
                        read_nifti_py(path),
                        read_nifti_py(b[pid][kind][view]))
    for split in ("train_list", "val_list", "test_list"):
        assert (load_split(f"{port['data_list_dir']}/{split}.npy")
                == load_split(f"{ref['data_list_dir']}/{split}.npy"))


def test_host_loaders_match_jax(corpora):
    """SegFrameLoader (train and eval), AlignedClipLoader and TestClipLoader
    yield the JAX loaders' arrays on the same corpus and seed."""
    cfg, jcfg, port, _ = corpora
    views = cfg.model.views
    ids = load_split(f"{port['data_list_dir']}/train_list.npy")
    infos = load_infos(port["infos"])
    idx, jidx = (PatientIndex.from_infos(infos, cfg.data.use_data),
                 JPatientIndex.from_infos(infos, jcfg.data.use_data))
    for is_train in (True, False):
        got = list(pipeline.SegFrameLoader(idx, ids, views, cfg, is_train,
                                           seed=5).batches(2, epoch=1))
        want = list(jpipe.SegFrameLoader(jidx, ids, views, jcfg, is_train,
                                         seed=5).batches(2, epoch=1))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])
    unlab = load_infos(port["unlab_infos"])
    uidx, ujidx = (PatientIndex.from_infos(unlab, cfg.data.use_data),
                   JPatientIndex.from_infos(unlab, jcfg.data.use_data))
    got = list(pipeline.AlignedClipLoader(uidx, ids, views, cfg,
                                          seed=5).clips(1))
    want = list(jpipe.AlignedClipLoader(ujidx, ids, views, jcfg,
                                        seed=5).clips(1))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    test_infos = load_infos(port["test_infos"])
    got = list(pipeline.TestClipLoader(test_infos, ["0_0", "0_3"], views,
                                       cfg.data.clip_length).clips())
    want = list(jpipe.TestClipLoader(test_infos, ["0_0", "0_3"], views,
                                     jcfg.data.clip_length).clips())
    assert [g["clip_id"] for g in got] == [w["clip_id"] for w in want]
    for g, w in zip(got, want):
        for k in ("images", "masks"):
            np.testing.assert_array_equal(g[k], w[k])


# ------------------------------------------------------- losses, metrics

CYC = dict(target_region=6, cyc_off=1, chunk=2, temperature=10.0)


def test_losses_match_jax():
    """BCE-sum; the cycle loss from an explicit start; the dense loss with
    its gradient.
    float32, atol = rtol = 2e-4."""
    rs = np.random.RandomState(6)
    x, t = rs.randn(4, 7).astype(np.float32), (rs.rand(4, 7) > 0.5)
    np.testing.assert_allclose(
        losses.bce_with_logits_sum(torch.from_numpy(x),
                                   torch.from_numpy(t).float()).item(),
        float(jlosses.bce_with_logits_sum(jnp.asarray(x),
                                          jnp.asarray(t, jnp.float32))),
        **TOL)
    feat = rs.randn(12, 5).astype(np.float32)
    s = CYC["target_region"] - (CYC["chunk"] + CYC["cyc_off"]) + 1
    onehot = np.eye(s, dtype=np.float32)[2]
    np.testing.assert_allclose(
        losses._cycle_from_start(torch.from_numpy(feat),
                                 torch.from_numpy(onehot), 6, 1, 2,
                                 10.0).item(),
        float(jlosses._cycle_from_start(jnp.asarray(feat),
                                        jnp.asarray(onehot), 6, 1, 2, 10.0)),
        **TOL)
    # one JAX compile: soft labels and non-overlapping starts at once (the
    # train step's hard, overlapping form is held in the step test)
    kw = dict(CYC, soft_label=True, is_overlap=False)
    ft = torch.from_numpy(feat).requires_grad_(True)
    got = losses.dense_seg_cycle_loss(ft, **kw)
    got.backward()
    want, gw = jax.value_and_grad(
        lambda f: jlosses.dense_seg_cycle_loss(f, **kw))(jnp.asarray(feat))
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    np.testing.assert_allclose(ft.grad.numpy(), np.asarray(gw), **TOL)


def test_seg_cycle_loss_draws_its_start_from_the_generator():
    """The sampled start is the generator's next draw in [0, S)."""
    feat = torch.from_numpy(np.random.RandomState(7).randn(12, 5).astype(
        np.float32))
    s = CYC["target_region"] - (CYC["chunk"] + CYC["cyc_off"]) + 1
    gen = torch.Generator().manual_seed(9)
    start = int(torch.randint(0, s, (), generator=torch.Generator()
                              .manual_seed(9)))
    got = losses.seg_cycle_loss(gen, feat, **CYC)
    want = losses._cycle_from_start(feat, torch.eye(s)[start], 6, 1, 2,
                                    10.0)
    assert got.item() == want.item()


def test_metrics_match_jax():
    """Confusion counts (whole tensor and per view), overlap metrics and
    per-part Dice: equal within 1e-6."""
    rs = np.random.RandomState(8)
    logits = rs.randn(3, 2, 6, 6, 5).astype(np.float32)
    target = (rs.rand(3, 2, 6, 6, 5) > 0.6).astype(np.float32)
    pred = (logits > 0).astype(np.float32)
    for axis in (None, (1, 2, 3, 4)):
        got = metrics.confusion_counts(torch.from_numpy(pred),
                                       torch.from_numpy(target), dim=axis)
        want = jmetrics.confusion_counts(jnp.asarray(pred),
                                         jnp.asarray(target), axis=axis)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        gm = metrics.overlap_metrics(got)
        wm = jmetrics.overlap_metrics(want)
        for k in wm:
            np.testing.assert_allclose(gm[k].numpy(), np.asarray(wm[k]),
                                       atol=1e-6)
    np.testing.assert_allclose(
        metrics.per_part_dice(torch.from_numpy(logits),
                              torch.from_numpy(target)).numpy(),
        np.asarray(jmetrics.per_part_dice(jnp.asarray(logits),
                                          jnp.asarray(target))), atol=1e-6)


def test_adam_and_cosine_match_optax():
    """torch Adam (L2 before the moments) with the per-epoch LambdaLR
    cosine against the JAX package's optax chain over 5 steps at 2 steps an
    epoch and T_max = 1, so the clamp past T_max is hit. rtol 1e-5."""
    cfg = pconfig.Config(opt=pconfig.OptConfig(lr=1e-2, cosine_t_max=1,
                                               weight_decay=1e-2))
    jcfg = jconfig.Config(opt=jconfig.OptConfig(lr=1e-2, cosine_t_max=1,
                                                weight_decay=1e-2))
    rs = np.random.RandomState(10)
    p0 = rs.randn(4, 3).astype(np.float32)
    grads = rs.randn(5, 4, 3).astype(np.float32)
    tx = j_make_optimizer(jcfg, steps_per_epoch=2)
    jp, state = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    update = jax.jit(tx.update)
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = make_optimizer(cfg, [p])
    sched = make_scheduler(cfg, opt)
    for t in range(5):
        upd, state = update(jnp.asarray(grads[t]), state, jp)
        jp = optax.apply_updates(jp, upd)
        p.grad = torch.from_numpy(grads[t])
        opt.step()
        if (t + 1) % 2 == 0:
            sched.step()
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp),
                                   rtol=1e-5, atol=1e-7, err_msg=str(t))


def test_zero_fill_grads_updates_unused_leaves_as_optax():
    """A parameter the loss does not reach gets optax's zero gradient: the
    L2 term, the moments and the step count move it (about lr·sign(p)),
    as JAX's chain does, while the used one takes its gradient's update.
    Without the helper torch's Adam skips it."""
    from glfusion_tpu_torch.train.train_state import zero_fill_grads

    cfg, jcfg = pconfig.Config(), jconfig.Config()
    used = torch.nn.Parameter(torch.ones(3))
    unused = torch.nn.Parameter(torch.tensor([1.0, -0.5, 2.0]))
    opt = make_optimizer(cfg, [used, unused])
    opt.zero_grad(set_to_none=True)
    (used * torch.tensor([1.0, 2.0, -3.0])).sum().backward()
    assert unused.grad is None
    zero_fill_grads(opt)
    opt.step()
    tx = j_make_optimizer(jcfg, steps_per_epoch=1)
    leaves = {"used": jnp.ones(3), "unused": jnp.asarray([1.0, -0.5, 2.0])}
    grads = {"used": jnp.asarray([1.0, 2.0, -3.0]),
             "unused": jnp.zeros(3)}
    upd, _ = tx.update(grads, tx.init(leaves), leaves)
    want = optax.apply_updates(leaves, upd)
    for name, p in (("used", used), ("unused", unused)):
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(want[name]), rtol=1e-6,
                                   err_msg=name)
    assert (unused.detach().numpy() != [1.0, -0.5, 2.0]).all()


# ------------------------------------------------------- one train step

STEP_VIEWS = ("1", "3", "4")
C = 8


class _JStemNet(fnn.Module):
    """The smallest flagship-shaped model for the step: per-view IEKD stem
    (its features are ``f4_global``) → per-view 1×1 classifier → bilinear
    upsample (``mask``)."""

    @fnn.compact
    def __call__(self, x, train=False, **_):
        f = _per_view(IEKDStem)(stem_width=C, name="stem")(x, train)
        logits = _per_view(PointwiseConv)(5, name="cls")(f, train)
        mask = j_resize_bilinear(logits, x.shape[2:4])
        return {"mask": mask, "f4_global": f}


class _StemNet(torch.nn.Module):
    """The port's counterpart, with the fused stem module in every view."""

    def __init__(self):
        super().__init__()
        self.stem = torch.nn.ModuleDict({v: FusedIEKDStem(C)
                                         for v in STEP_VIEWS})
        self.cls = torch.nn.ModuleDict({v: torch.nn.Conv2d(C, 5, 1)
                                        for v in STEP_VIEWS})

    def forward(self, x):
        feats, logits = [], []
        for i, v in enumerate(STEP_VIEWS):
            f = self.stem[v](x[i].permute(0, 3, 1, 2).contiguous())
            feats.append(f)
            logits.append(resize_bilinear_nchw(self.cls[v](f), x.shape[2:4]))
        return {"mask": torch.stack(logits).permute(0, 1, 3, 4, 2),
                "f4_global": torch.stack(feats).permute(0, 1, 3, 4, 2)}


def _port_params(v) -> dict:
    """JAX stacked per-view variables → the port model's state dict."""
    p, s = v["params"], v["batch_stats"]
    sd = {}
    for i, view in enumerate(STEP_VIEWS):
        k = np.asarray(p["stem"]["stem_conv"]["kernel"][i])
        sd[f"stem.{view}.0.weight"] = np.transpose(k, (3, 2, 0, 1))
        sd[f"stem.{view}.0.bias"] = p["stem"]["stem_conv"]["bias"][i]
        sd[f"stem.{view}.1.weight"] = p["stem"]["stem_bn"]["scale"][i]
        sd[f"stem.{view}.1.bias"] = p["stem"]["stem_bn"]["bias"][i]
        sd[f"stem.{view}.1.running_mean"] = s["stem"]["stem_bn"]["mean"][i]
        sd[f"stem.{view}.1.running_var"] = s["stem"]["stem_bn"]["var"][i]
        ck = np.asarray(p["cls"]["conv"]["kernel"][i])
        sd[f"cls.{view}.weight"] = np.transpose(ck, (3, 2, 0, 1))
        sd[f"cls.{view}.bias"] = p["cls"]["conv"]["bias"][i]
    out = {k: torch.from_numpy(np.array(a, np.float32)) for k, a in
           sd.items()}
    for view in STEP_VIEWS:
        out[f"stem.{view}.1.num_batches_tracked"] = torch.tensor(0)
    return out


def test_train_step_matches_jax():
    """One train step of each package on the same weights and batch: the
    supervised BCE-sum over test views '1' and '4', the dense cycle loss on
    an 8-frame clip, their weighted total, the confusion counts, every
    gradient, and the BN running statistics threaded supervised → cycle.

    The steps are the packages' own (``make_train_step``) around a
    flagship-shaped model small enough to compile at once: per-view fused
    stem → 1×1 classifier (JAX compiles the full flagship's train step in
    53 s on one core). Both take plain SGD at lr 1 so the update IS the
    gradient (Adam is held against optax above). Tolerances: losses and
    gradients atol 2e-4·max|g| + rtol 2e-4; the stem conv-bias gradient,
    cancelled by train BN, atol 5e-3·max|g|; running means 2e-4; running
    variances through torch's n/(n−1) factor, rtol 2e-3 (flax's one-pass
    variance, ROADMAP Queue 3).
    """
    jcfg = jconfig.tiny_config()
    jcfg = jcfg.replace(train=dataclasses.replace(
        jcfg.train, test_views=("1", "4"), dense_cyc=True))
    cfg = pconfig.tiny_config()
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, test_views=("1", "4"), dense_cyc=True))
    rs = np.random.RandomState(12)
    images = rs.rand(3, 2, 16, 16, 1).astype(np.float32)
    target = (rs.rand(3, 2, 16, 16, 5) > 0.7).astype(np.float32)
    clips = (rs.rand(3, 8, 16, 16, 1) * 255).astype(np.float32)

    jm = _JStemNet()
    v = random_variables(lambda: jm.init(jax.random.PRNGKey(0),
                                         jnp.asarray(images), False), 13)
    state = TrainState.create(apply_fn=jm.apply, params=v["params"],
                              batch_stats=v["batch_stats"],
                              tx=optax.sgd(1.0))
    jbatch = {"images": jnp.asarray(images), "masks": jnp.asarray(target),
              "clips": jnp.asarray(clips)}
    jstate, jmetrics_ = j_make_train_step(jcfg, jm, compiler_options=None)(
        state, jbatch, jax.random.PRNGKey(1))

    model = _StemNet()
    model.load_state_dict(_port_params(v))
    before = {k: t.clone() for k, t in model.state_dict().items()}
    step = make_train_step(cfg, model,
                           torch.optim.SGD(model.parameters(), lr=1.0))
    got = step({"images": torch.from_numpy(images),
                "masks": torch.from_numpy(target),
                "clips": torch.from_numpy(clips)},
               torch.Generator().manual_seed(0))

    for k in ("loss", "seg_loss", "cyc_loss", "tp", "fp", "fn", "tn"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(jmetrics_[k]),
                                   **TOL, err_msg=k)
    assert float(got["cyc_loss"]) > 0
    want_sd = _port_params({"params": jstate.params,
                            "batch_stats": jstate.batch_stats})
    after = model.state_dict()
    n_sup, n_cyc = 2 * 14 * 14, 8 * 14 * 14
    for k, w in want_sd.items():
        if k.endswith("num_batches_tracked"):
            assert int(after[k]) == 2, k
            continue
        if k.endswith("running_var"):
            # flax: .81 v0 + .09 σ²_sup + .1 σ²_cyc; torch: each σ² × n/(n−1)
            view = STEP_VIEWS.index(k.split(".")[1])
            z_sup, z_cyc = (torch.nn.functional.conv2d(
                torch.from_numpy(a[view]).permute(0, 3, 1, 2),
                before[k.replace("1.running_var", "0.weight")],
                before[k.replace("1.running_var", "0.bias")], padding=2)
                for a in (images, clips))
            var_s, var_c = (z.var(dim=(0, 2, 3), unbiased=False)
                            for z in (z_sup, z_cyc))
            expect = (w + 0.09 * var_s / (n_sup - 1)
                      + 0.1 * var_c / (n_cyc - 1))
            np.testing.assert_allclose(after[k].numpy(), expect.numpy(),
                                       rtol=2e-3, err_msg=k)
            continue
        if k.endswith("running_mean"):
            np.testing.assert_allclose(after[k].numpy(), w.numpy(), **TOL,
                                       err_msg=k)
            continue
        g_port = (before[k] - after[k]).numpy()
        g_jax = (before[k] - w).numpy()
        scale = np.abs(g_jax).max()
        if k.startswith("stem") and k.endswith("0.bias"):
            # cancelled by train BN: noise, held at the weight grad's scale
            wk = k.replace("bias", "weight")
            scale = np.abs((before[wk] - want_sd[wk]).numpy()).max()
            atol = 5e-3 * scale
        else:
            atol = 2e-4 * scale
        np.testing.assert_allclose(g_port, g_jax, atol=atol, rtol=2e-4,
                                   err_msg=k)


# -------------------------------------------------------------- the CLI

def test_per_view_init_is_identical():
    """Every view starts from the same weights (deep copies of one view),
    as in the reference and the JAX package; the copies share no tensor."""
    model = GlobalAndLocal(pconfig.tiny_config().model)
    sd = model.state_dict()
    views = model.cfg.views
    per_view = [k for k in sd if k.startswith(("init_block.", "layer",
                                               "classifier.", "centerness."))]
    assert len(per_view) > 100
    for k in per_view:
        head, view, rest = k.split(".", 2)
        assert view in views
        assert torch.equal(sd[k], sd[f"{head}.{views[0]}.{rest}"]), k
    a, b = (model.init_block[v][0].weight for v in views[:2])
    assert a.data_ptr() != b.data_ptr()


def test_cli_train_then_val_and_jax_scores_the_checkpoint(tmp_path, capsys):
    """``--mode train --tiny --platform cpu`` (2 epochs, validation after
    the second; each epoch's net file and its training-state sidecar), then
``--mode val``; the saved ``net_00001.pth`` loads back into
    the port and converts for the JAX model (``load_torch_checkpoint``,
    the JAX CLI's ``--torch-ckpt``), whose eval forward on a test clip
    gives the port's logits (atol = rtol = 2e-4)."""
    args = ["--tiny", "--platform", "cpu", "--save-dir",
            str(tmp_path / "ckpt"), "--log-dir", str(tmp_path / "log")]
    assert cli.main(["--mode", "train", "--eval-every", "2"] + args) == 0
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == [
        "net_00000.pth", "net_00001.pth", "state_00000.pth",
        "state_00001.pth"]
    assert cli.main(["--mode", "val"] + args) == 0
    out = capsys.readouterr().out
    assert "epoch 1:" in out and "Inner-test view 4" in out

    cfg = pconfig.tiny_config()
    model = GlobalAndLocal(cfg.model).eval()
    model.load_state_dict(load_checkpoint(str(tmp_path / "ckpt"
                                              / "net_00001.pth")))
    paths = generate_synthetic_dataset(tmp_path / "data", cfg.data,
                                       seed=cfg.train.seed)
    clip = next(pipeline.TestClipLoader(load_infos(paths["test_infos"]),
                                        ["0_0"], cfg.model.views,
                                        cfg.data.clip_length).clips())
    with torch.no_grad():
        got = model(torch.from_numpy(clip["images"]))["mask"].numpy()
    from glfusion_tpu.models import GlobalAndLocal as JGlobalAndLocal
    jcfg = jconfig.tiny_config()
    variables = load_torch_checkpoint(str(tmp_path / "ckpt" /
                                          "net_00001.pth"), jcfg.model)
    want = jax.jit(lambda v, x: JGlobalAndLocal(jcfg.model).apply(
        v, x, False)["mask"], compiler_options=FAST_COMPILE)(
            variables, jnp.asarray(clip["images"]))
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_cli_runs_on_the_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--mode", "train", "--tiny", "--save-dir",
                  str(tmp_path / "c"), "--log-dir", str(tmp_path / "l")])
