"""The port's host tools (``utils/profiling.py``, ``utils/activations.py``,
``utils/helpers.py``) on the CPU, against the JAX package's where both
compute the same thing: activation dumps of the tiny flagship on the same
weights (max-abs difference under 1e-4 on the shared keys), the helpers'
arrays (equal), ``consume_state``'s scalar (float32 sums of the same
numbers, rtol 1e-6)."""

from __future__ import annotations

import json
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import (TINY_MODEL, one_torch_thread,  # noqa: F401
                                tiny_flagship)
from glfusion_tpu.utils import activations as jact
from glfusion_tpu.utils import helpers as jhelpers
from glfusion_tpu.utils import profiling as jprof
from glfusion_tpu_torch.config import ModelConfig
from glfusion_tpu_torch.models import GlobalAndLocal
from glfusion_tpu_torch.utils import activations, helpers, profiling
from glfusion_tpu_torch.utils.convert import state_dict_from_jax


def test_flops_of_a_linear_layer():
    m, k, n = 6, 10, 4
    lin = torch.nn.Linear(k, n, bias=False)
    assert profiling.flops_of(lin, torch.zeros(m, k)) == 2 * m * n * k

    def broken(x):
        raise RuntimeError("cannot run")

    assert profiling.flops_of(broken, torch.zeros(1)) is None


def test_time_fn_and_trace(tmp_path):
    lin = torch.nn.Linear(16, 16)
    x = torch.zeros(8, 16)
    assert profiling.time_fn(lin, x, iters=3) > 0
    with profiling.trace(str(tmp_path)):
        lin(x)
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert trace["traceEvents"]
    assert profiling.debug_nans is not None  # utils/debug.py's


def test_consume_state_matches_jax():
    rs = np.random.RandomState(0)
    w, b = rs.randn(3, 4).astype(np.float32), rs.randn(4).astype(np.float32)
    mean, var = rs.randn(4).astype(np.float32), rs.rand(4).astype(np.float32)
    state = SimpleNamespace(params={"w": w, "b": b},
                            batch_stats={"mean": mean, "var": var})
    want = float(jprof.consume_state(jnp.float32(0.5), state))
    mod = torch.nn.Module()
    mod.w = torch.nn.Parameter(torch.from_numpy(w))
    mod.b = torch.nn.Parameter(torch.from_numpy(b))
    mod.register_buffer("mean", torch.from_numpy(mean))
    mod.register_buffer("var", torch.from_numpy(var))
    mod.register_buffer("count", torch.tensor(3))  # integer: not folded
    got = profiling.consume_state(torch.tensor(0.5), mod).item()
    assert got == pytest.approx(want, rel=1e-6)


def test_capture_activations_matches_jax():
    """The tiny flagship's dumps share the backbone's, the heads' and the
    attentions' flax paths and the outputs, within 1e-4."""
    jm, v = tiny_flagship()
    x = np.random.RandomState(0).rand(3, 2, 32, 32, 1).astype(np.float32)
    ref = jact.capture_activations(jm, v, jnp.asarray(x))
    cfg = ModelConfig(**TINY_MODEL)
    m = GlobalAndLocal(cfg)
    m.load_state_dict(state_dict_from_jax(v, cfg))
    got = activations.capture_activations(m.train(), torch.from_numpy(x))
    assert m.training  # eval for the capture, then the mode put back
    shared = set(ref) & set(got)
    for key in ("backbone/layer4_block0/__call__",
                "backbone/layer1_block0/conv1/__call__",
                "classifier/aspp/b0_conv/__call__", "global_attn/__call__",
                "local_attn/norm/__call__", "__output__.mask"):
        assert key in shared, key
    assert len(shared) >= 80
    diffs = activations.diff_activations(ref, got)
    worst = next(iter(diffs.items()))
    assert worst[1] < 1e-4, worst
    assert diffs == jact.diff_activations(ref, got)


def test_helpers_match_jax(tmp_path, capsys):
    rs = np.random.RandomState(0)
    img = rs.randint(0, 256, (6, 5, 3)).astype(np.uint8)
    np.testing.assert_array_equal(helpers.prepare_img(img),
                                  jhelpers.prepare_img(img))
    gray = rs.rand(6, 5)
    lab, pre = rs.randint(0, 6, (6, 5)), rs.randint(0, 6, (6, 5))
    for im in (gray, img):
        np.testing.assert_array_equal(
            helpers.make_validation_img(im, lab, pre),
            jhelpers.make_validation_img(im, lab, pre))
    helpers.print_log("hello")
    assert capsys.readouterr().out == "hello\n"
    with pytest.raises(FileNotFoundError, match="nothing is downloaded"):
        helpers.maybe_download("resnet", "https://example.invalid/r.pth",
                               str(tmp_path))
    torch.save({"w": torch.ones(2)}, tmp_path / "resnet.pth.tar")
    sd = helpers.maybe_download("resnet", "https://example.invalid/r.pth",
                                str(tmp_path))
    assert torch.equal(sd["w"], torch.ones(2))
