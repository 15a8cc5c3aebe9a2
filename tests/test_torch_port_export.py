"""The port's ``torch.export`` of the serving forward
(``glfusion_tpu_torch/utils/model_export.py``) on the CPU, against the JAX
package: the program round trip in a process that imports none of the
port's models, at three frame counts through one symbolic frame axis; the
meta against JAX's fields; the checks ``export_pipeline_kwargs`` makes, as
JAX's does.

The tiny flagship at the widths of tests/test_torch_port_serve.py, one
view and one ASPP rate (the export's trace and load grow with the graph:
1 001 nodes with three rates, 383 with one), JAX's random
variables from a numpy seed loaded into the port with
``state_dict_from_jax``, and the kernel's path (the registered op; its
plain version on the CPU). The loaded program's masks must equal the live
port forward's bit for bit (the same operations on the same device), and
JAX's jitted eval forward's wherever JAX's logit is at least 1e-4 from the
threshold (as tests/test_torch_port_serve.py holds the live path).
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import (FAST_COMPILE, TINY_MODEL,  # noqa: F401
                                one_torch_thread, random_variables)
from glfusion_tpu.config import ModelConfig as JModelConfig
from glfusion_tpu.models import GlobalAndLocal as JGlobalAndLocal
from glfusion_tpu_torch import config as pconfig
from glfusion_tpu_torch.models import GlobalAndLocal
from glfusion_tpu_torch.serve import ClipPipeline, export_pipeline_kwargs
from glfusion_tpu_torch.utils import model_export
from glfusion_tpu_torch.utils.convert import state_dict_from_jax
from glfusion_tpu_torch.utils.model_export import (export_serving_forward,
                                                   save_exported)

ROOT = Path(__file__).resolve().parent.parent
HW = 32
CLIP_LENGTH = 3
VIEWS = ("1",)
ARCH = dict(TINY_MODEL, views=VIEWS, aspp_rates=(2,))
CFG = pconfig.Config(model=pconfig.ModelConfig(**ARCH,
                                               use_pallas_fusion=True),
                     data=pconfig.DataConfig(clip_length=CLIP_LENGTH,
                                             crop_hw=HW))
# JAX save_exported's meta fields, with torch_version for jax_version and
# the export's device for its platforms
META_FIELDS = {"format", "input", "output", "num_views", "views",
               "input_hw", "crop_hw", "num_classes", "symbolic_frames",
               "frames", "serialized_bytes", "torch_version", "device"}

_LOADER = """
import json, sys
import numpy as np
from glfusion_tpu_torch import config as pconfig
from glfusion_tpu_torch.ops import tpavi_fused
from glfusion_tpu_torch.serve import ClipPipeline, export_pipeline_kwargs
cfg = pconfig.Config(model=pconfig.ModelConfig(views=("1",)),
                     data=pconfig.DataConfig(clip_length=3, crop_hw=32))
kw = export_pipeline_kwargs(sys.argv[1], cfg)
pipe = ClipPipeline(cfg, device="cpu", **kw)
for t in (1, 2, 3):
    x = np.load(sys.argv[2] + f"/x{t}.npy")
    assert x.shape[1] == t
    # T = 2 through the pipeline (its true length), 1 and 3 directly
    y = pipe.predict_one(x) if t == 2 else kw["forward"](x).numpy()
    np.save(sys.argv[2] + f"/y{t}.npy", y)
print(json.dumps({"models": sorted(m for m in sys.modules
                                   if m.startswith("glfusion_tpu_torch.models")),
                  "jax": "jax" in sys.modules,
                  "launches": tpavi_fused.fused_dot_nonlocal.launches,
                  "expected_hw": kw["expected_hw"]}))
"""


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """(JAX's jitted eval logits at clip_length frames, the port's live
    model on the same variables, the export's path, its meta)."""
    jm = JGlobalAndLocal(JModelConfig(**ARCH))
    x0 = jnp.zeros((len(VIEWS), CLIP_LENGTH, HW, HW, 1), jnp.float32)
    v = random_variables(lambda: jm.init(jax.random.PRNGKey(0), x0, False),
                         14)
    jlogits = jax.jit(lambda x: jm.apply(v, x, False)["mask"],
                      compiler_options=FAST_COMPILE)
    model = GlobalAndLocal(CFG.model)
    model.load_state_dict(state_dict_from_jax(v, CFG.model))
    model.eval()
    path = tmp_path_factory.mktemp("export") / "exp"
    meta = save_exported(export_serving_forward(CFG, model), str(path), CFG)
    return jlogits, model, path, meta


def test_export_round_trip_without_the_models(exported, tmp_path):
    """Saved, then loaded by ``export_pipeline_kwargs`` and run in a fresh
    process that imports the kernel's op registration, ``serve.py`` and no
    module of ``glfusion_tpu_torch.models`` (nor jax): at T = 1 and T = 3
    through the one symbolic frame axis, and a 2-frame clip through the
    pipeline at its true length. Its uint8 masks equal the live port
    model's bit for bit, and JAX's eval forward's (each clip padded to
    clip_length with zero frames, as JAX's pipeline pads it) wherever
    JAX's logit is at least 1e-4 from the threshold."""
    jlogits, model, path, _ = exported
    rs = np.random.RandomState(12)
    xs = {t: rs.rand(len(VIEWS), t, HW, HW, 1).astype(np.float32)
          for t in (1, 2, 3)}
    for t, x in xs.items():
        np.save(tmp_path / f"x{t}.npy", x)
    res = subprocess.run(
        [sys.executable, "-c", _LOADER, str(path), str(tmp_path)],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT),
             "HOME": str(tmp_path), "OMP_NUM_THREADS": "1"})
    assert res.returncode == 0, res.stderr[-2000:]
    info = json.loads(res.stdout.strip().splitlines()[-1])
    assert info["models"] == [] and not info["jax"], info
    assert info["expected_hw"] == HW
    assert info["launches"] == 0  # CPU operands take the plain version
    for t, x in xs.items():
        got = np.load(tmp_path / f"y{t}.npy")
        with torch.no_grad():
            live = (model(torch.from_numpy(x))["mask"] > 0).to(
                torch.uint8).numpy()
        assert got.dtype == np.uint8 and got.shape == (1, t, HW, HW, 5)
        np.testing.assert_array_equal(got, live, err_msg=f"T = {t}")
        padded = np.concatenate(
            [x, np.zeros((len(VIEWS), CLIP_LENGTH - t, HW, HW, 1),
                         np.float32)], axis=1)
        jlogit = np.asarray(jlogits(jnp.asarray(padded)))[:, :t]
        sure = np.abs(jlogit) >= 1e-4
        assert sure.mean() > 0.99
        np.testing.assert_array_equal(got[sure],
                                      (jlogit[sure] > 0).astype(np.uint8),
                                      err_msg=f"T = {t} against JAX")


def test_export_meta_and_pipeline_checks(exported, tmp_path, monkeypatch):
    """The meta carries JAX's fields (torch_version and device in place of
    jax_version and platforms) and a symbolic frame axis.
    ``export_pipeline_kwargs`` refuses other views or another class count
    with JAX's messages before it loads the program, and refuses an
    export made for another device; the pipeline refuses a clip of
    another spatial size. (The program itself runs in
    test_export_round_trip_without_the_models.)"""
    _, _, path, meta = exported
    assert set(meta) == META_FIELDS
    assert (meta["format"], meta["device"], meta["symbolic_frames"],
            meta["frames"], meta["input_hw"], meta["views"]) == (
        "glfusion_tpu_torch.torch_export.v1", "cpu", True, None, HW, ["1"])
    monkeypatch.setattr(model_export.torch.export, "load", None)
    other = CFG.replace(model=dataclasses.replace(CFG.model,
                                                  views=("1", "3")))
    with pytest.raises(ValueError, match="built for views"):
        export_pipeline_kwargs(str(path), other)
    other = CFG.replace(model=dataclasses.replace(CFG.model, num_classes=4))
    with pytest.raises(ValueError, match="predicts 5 classes"):
        export_pipeline_kwargs(str(path), other)
    edited = tmp_path / "edited"
    edited.mkdir()
    (edited / "serving_fn.pt2").symlink_to(path / "serving_fn.pt2")
    (edited / "meta.json").write_text(json.dumps(dict(meta, device="cuda")))
    with pytest.raises(ValueError, match="made for cuda"):
        export_pipeline_kwargs(str(edited), CFG, device="cpu")
    with pytest.raises(FileNotFoundError):
        export_pipeline_kwargs(str(tmp_path), CFG)

    monkeypatch.setattr(model_export, "load_serving_forward",
                        lambda p, device=None: (lambda x: x, None))
    kw = export_pipeline_kwargs(str(path), CFG)
    assert kw["expected_hw"] == HW
    pipe = ClipPipeline(CFG, device="cpu", **kw)
    with pytest.raises(ValueError, match="pinned 32"):
        pipe.predict_one(np.zeros((1, 2, 40, 40, 1), np.float32))
