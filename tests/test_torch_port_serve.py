"""The port's serving path (glfusion_tpu_torch/serve.py) and its HTTP
endpoint (http_serve.py) against the JAX package's on the CPU, its
host-side helpers, and the port's import rule.
"""

from __future__ import annotations

import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_port_common import (TINY_MODEL, one_torch_thread,  # noqa: F401
                                tiny_flagship)
from glfusion_tpu import config as jconfig
from glfusion_tpu.data import nifti as jnifti
from glfusion_tpu.data.pipeline import align_views as j_align_views
from glfusion_tpu.serve import ClipPipeline as JClipPipeline
from glfusion_tpu_torch import config as pconfig
from glfusion_tpu_torch.data import nifti
from glfusion_tpu_torch.data.pipeline import align_views
from glfusion_tpu_torch.models import GlobalAndLocal
from glfusion_tpu_torch.serve import ClipPipeline
from glfusion_tpu_torch.utils.convert import state_dict_from_jax

ROOT = Path(__file__).resolve().parent.parent
CLIP_LENGTH = 3
HW = 32


def _cfgs():
    data = dict(clip_length=CLIP_LENGTH, crop_hw=HW)
    return (jconfig.Config(model=jconfig.ModelConfig(**TINY_MODEL),
                           data=jconfig.DataConfig(**data)),
            pconfig.Config(model=pconfig.ModelConfig(**TINY_MODEL),
                           data=pconfig.DataConfig(**data)))


@pytest.fixture(scope="module")
def pipelines():
    jcfg, pcfg = _cfgs()
    jm, v = tiny_flagship()
    port = GlobalAndLocal(dataclasses.replace(pcfg.model,
                                              use_pallas_fusion=True))
    port.load_state_dict(state_dict_from_jax(v, pcfg.model))
    return (JClipPipeline(jcfg, jm, v, depth=2, threads=2),
            ClipPipeline(pcfg, port, depth=2, threads=2, device="cpu"))


def test_predict_iter_matches_jax(pipelines):
    """Three tiny clips, the last one short (padded, then trimmed): equal
    uint8 masks wherever the logit is at least 1e-4 from the threshold."""
    jpipe, pipe = pipelines
    rs = np.random.RandomState(5)
    clips = [(f"c{i}", rs.rand(3, t, HW, HW, 1).astype(np.float32))
             for i, t in enumerate((CLIP_LENGTH, CLIP_LENGTH, 2))]
    want = list(jpipe.predict_iter(clips, decode=lambda it: it))
    got = list(pipe.predict_iter(clips, decode=lambda it: it))
    assert [c for c, _ in got] == [c for c, _ in want] == ["c0", "c1", "c2"]
    for (cid, images), (_, w), (_, g) in zip(clips, want, got):
        t = images.shape[1]
        assert g.dtype == np.uint8 and g.shape == w.shape == (3, t, HW, HW, 5)
        with torch.no_grad():
            logit = pipe.model(torch.from_numpy(pipe._trim_clip(images)[0]))
        sure = np.abs(logit["mask"][:, :t].numpy()) >= 1e-4
        assert sure.mean() > 0.99
        np.testing.assert_array_equal(g[sure], w[sure], err_msg=cid)
        np.testing.assert_array_equal(pipe.predict_one(images), g)


def test_decode_paths_matches_jax(pipelines, tmp_path):
    """NIfTI clips on disk, one view missing, views of unequal length: the
    port decodes to the same forward input as JAX."""
    jpipe, pipe = pipelines
    rs = np.random.RandomState(6)
    paths = {}
    for view, t in (("1", 5), ("4", 4)):  # view '3' missing
        p = tmp_path / f"v{view}.nii.gz"
        nifti.write_nifti(p, rs.randint(0, 256, (1, HW, HW, t), np.uint8))
        paths[view] = str(p)
    cid, images = pipe.decode_paths(("clip", paths))
    _, ref = jpipe.decode_paths(("clip", paths))
    assert cid == "clip" and images.shape == (3, CLIP_LENGTH, HW, HW, 1)
    np.testing.assert_array_equal(images, ref)


@pytest.mark.parametrize("t", [None, 2])
def test_align_views_matches_jax(t):
    rs = np.random.RandomState(7)
    vols = [rs.rand(5, 4, 4, 1).astype(np.float32), None,
            rs.rand(7, 4, 4, 1).astype(np.float32)]
    got, gt = align_views(vols, 6, t)
    want, wt = j_align_views(vols, 6, t)
    assert gt == wt
    np.testing.assert_array_equal(got, want)
    assert align_views([None, None], 6) == (None, 0)


@pytest.mark.parametrize("name,dtype", [("a.nii.gz", np.uint8),
                                        ("b.nii", np.int16),
                                        ("c.nii.gz", np.float32)])
def test_nifti_round_trip(tmp_path, name, dtype):
    """Written and read back by the port; read by JAX's reader too; and the
    port parses the bytes JAX's writer makes."""
    arr = (np.random.RandomState(8).rand(1, 6, 5, 3) * 200).astype(dtype)
    path = tmp_path / name
    nifti.write_nifti(path, arr)
    np.testing.assert_array_equal(nifti.read_nifti_py(path), arr)
    np.testing.assert_array_equal(jnifti.read_nifti_py(path), arr)
    np.testing.assert_array_equal(
        nifti.parse_nifti_bytes(jnifti.nifti_bytes(arr)), arr)


def test_pipeline_runs_on_cuda_unless_asked_for_cpu():
    model = GlobalAndLocal(pconfig.ModelConfig(**TINY_MODEL))
    if torch.cuda.is_available():
        assert ClipPipeline(_cfgs()[1], model).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ClipPipeline(_cfgs()[1], model)


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax():
    """The port and chip_smoke.py import no jax, flax or glfusion_tpu. A
    scan of the sources, not of sys.modules: a site customization may
    import jax into every process."""
    files = sorted((ROOT / "glfusion_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    for new in ("checkpoint", "imagenet_init", "visualize", "summary",
                "model_export", "debug"):
        assert ROOT / "glfusion_tpu_torch" / "utils" / f"{new}.py" in files
    assert ROOT / "glfusion_tpu_torch" / "http_serve.py" in files
    banned = ("jax", "flax", "glfusion_tpu")
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in banned, f"{f.relative_to(ROOT)} imports {mod}"


def test_live_clips_run_at_their_true_length(pipelines):
    """The live path runs a short clip's true frame count (JAX pads it to
    clip_length for its jit); in eval every frame is computed alone, so
    its masks equal the first t frames of the clip padded with zero
    frames: the port's own padded forward's and JAX's padded pipeline's,
    wherever the logit is at least 1e-4 from the threshold (as above). A
    clip longer than clip_length is still trimmed to it."""
    jpipe, pipe = pipelines
    rs = np.random.RandomState(10)
    seen = []
    hook = pipe.model.register_forward_pre_hook(
        lambda mod, args: seen.append(args[0].shape[1]))
    try:
        short = rs.rand(3, 2, HW, HW, 1).astype(np.float32)
        got = pipe.predict_one(short)
        long = rs.rand(3, CLIP_LENGTH + 2, HW, HW, 1).astype(np.float32)
        assert pipe.predict_one(long).shape[1] == CLIP_LENGTH
        padded = np.concatenate(
            [short, np.zeros((3, CLIP_LENGTH - 2, HW, HW, 1), np.float32)],
            axis=1)
        with torch.no_grad():
            logit = pipe.model(torch.from_numpy(short))["mask"].numpy()
            padded_mask = (pipe.model(torch.from_numpy(padded))["mask"]
                           [:, :2] > 0).to(torch.uint8).numpy()
    finally:
        hook.remove()
    assert seen == [2, CLIP_LENGTH, 2, CLIP_LENGTH]
    want = jpipe.predict_one(short)
    assert got.shape == want.shape == padded_mask.shape == (3, 2, HW, HW, 5)
    sure = np.abs(logit) >= 1e-4
    assert sure.mean() > 0.99
    np.testing.assert_array_equal(got[sure], padded_mask[sure])
    np.testing.assert_array_equal(got[sure], want[sure])


def _request(port: int, path: str, body=None):
    import json
    import urllib.error
    import urllib.request

    data = None if body is None else (
        body if isinstance(body, bytes) else json.dumps(body).encode())
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data)
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_endpoint_matches_jax(pipelines):
    """The port's endpoint (``http_serve.py``) against JAX's on the same
    weights, both on 127.0.0.1 with a free port: ``/healthz`` gives JAX's
    JSON; ``/predict`` with two views' NIfTI volumes (view '3' missing)
    gives JAX's frame count and masks wherever the logit is at least 1e-4
    from the threshold (as in test_predict_iter_matches_jax); malformed
    bodies give 400 with an ``error`` in both."""
    import base64
    import threading

    from glfusion_tpu.http_serve import make_http_server as j_make_server
    from glfusion_tpu_torch.http_serve import make_http_server

    jpipe, pipe = pipelines
    servers = [j_make_server(jpipe, port=0), make_http_server(pipe, port=0)]
    for srv in servers:
        threading.Thread(target=srv.serve_forever, daemon=True).start()
    jport, port = (srv.server_address[1] for srv in servers)
    try:
        assert _request(port, "/healthz") == _request(jport, "/healthz")
        rs = np.random.RandomState(11)
        vols = {v: rs.randint(0, 256, (1, HW, HW, 2), np.uint8)
                for v in ("1", "4")}
        body = {"views": {v: base64.b64encode(nifti.nifti_bytes(a)).decode()
                          for v, a in vols.items()}}
        (code, got), (jcode, want) = (_request(p, "/predict", body)
                                      for p in (port, jport))
        assert code == jcode == 200 and got["frames"] == want["frames"] == 2
        assert set(got["masks"]) == set(want["masks"]) == {"1", "4"}
        with torch.no_grad():
            logit = pipe.model(torch.from_numpy(
                pipe.stack_raw_views(vols)))["mask"].numpy()
        for vi, view in ((0, "1"), (2, "4")):
            g, w = (nifti.parse_nifti_bytes(base64.b64decode(r["masks"][view]))
                    for r in (got, want))
            assert g.dtype == np.uint8 and g.shape == w.shape == (5, HW, HW, 2)
            sure = np.abs(np.transpose(logit[vi], (3, 1, 2, 0))) >= 1e-4
            assert sure.mean() > 0.99
            np.testing.assert_array_equal(g[sure], w[sure], err_msg=view)
        for bad in (b"not json", {"views": {}}, {"views": {"9": "AA=="}},
                    {"views": {"1": base64.b64encode(b"junk").decode()}}):
            (code, got), (jcode, want) = (_request(p, "/predict", bad)
                                          for p in (port, jport))
            assert code == jcode == 400 and got["error"], (bad, got, want)
        assert _request(port, "/nowhere")[0] == 404
    finally:
        for srv in servers:
            srv.shutdown()
            srv.server_close()
