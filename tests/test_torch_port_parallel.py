"""The port's multi-process training (``glfusion_tpu_torch/parallel/``,
``utils/cluster.py``, ``--mesh-model``) on the CPU, over gloo.

JAX's contract (``tests/test_parallel.py``, ``tests/test_multiprocess.py``)
is that a sharded step computes the unsharded step. Here two processes,
started as an MPI-style launcher starts them (``PMI_SIZE``, ``PMI_RANK``),
run ``tests/_torch_port_parallel_child.py``: two worlds of two ranks
side by side for the whole file (module fixture; one runs the CLI, the
other every other scenario on meshes over its two ranks),
``_MIN_SHARD_DIM`` lowered in the children as JAX's multi-process test
lowers its own so the tiny widths split leaves over ``model``. Each rank
runs one torch thread; the launch has a timeout, so a hung rank fails the
tests instead of the suite. While the ranks run, this process computes the
references that need JAX or a process of its own: JAX's step and the
one-process CLI runs.

Tolerances. The two-rank steps hold the one-process port in float64: every
loss, BN statistic and gradient within 1e-10, a gradient measured against
the larger of its own and its module weight's largest element (a conv bias
ahead of a BatchNorm has a gradient that cancels to rounding noise). The
two-rank float32 step holds JAX's step at ``TOL``, as
test_torch_port_train.py's one-process step does. The CLI runs compare
float32 epochs (the same steps, sums in another order).
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_port_common import (FAST_COMPILE, TINY_MODEL,  # noqa: F401
                                init_shapes, one_torch_thread,
                                random_variables, tiny_flagship)
from glfusion_tpu import config as jconfig
from glfusion_tpu.config import ModelConfig as JModelConfig
from glfusion_tpu.models.registry import build_reg_model as j_reg_build
from glfusion_tpu.models.registry import build_seg_model as j_seg_build
from glfusion_tpu.parallel import sharding as jsharding
from glfusion_tpu.train.step import make_train_step as j_make_train_step
from glfusion_tpu.train.train_state import TrainState
from glfusion_tpu_torch import cli
from glfusion_tpu_torch.config import ModelConfig, tiny_config
from glfusion_tpu_torch.data.synthetic import generate_synthetic_dataset
from glfusion_tpu_torch.models import build_model
from glfusion_tpu_torch.models.registry import build_reg_model
from glfusion_tpu_torch.parallel import make_mesh, sharding
from glfusion_tpu_torch.utils import cluster
from glfusion_tpu_torch.utils.convert import (reg_state_dict_from_jax,
                                              state_dict_from_jax,
                                              zoo_state_dict_from_jax)
from test_torch_port_train import STEP_VIEWS, _JStemNet, _port_params

CHILD = Path(__file__).with_name("_torch_port_parallel_child.py")
TOL = dict(atol=2e-4, rtol=2e-4)
STEPS = ("d2", "m2", "replicated", "temporal", "temporal_k1", "accum",
         "fused")
CLI_RUNS = {"train_d2": ("train", 1), "train_m2": ("train", 2),
            "reg_d2": ("reg-train", 1)}
LAUNCH_TIMEOUT_S = 300


def _free_ports(n: int) -> list:
    """``n`` distinct free ports (their sockets held open together)."""
    with contextlib.ExitStack() as stack:
        socks = [stack.enter_context(socket.socket()) for _ in range(n)]
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]


def _cli_args(mode: str, corpus: str, mesh_model: int) -> list:
    """One epoch on the corpus, without the cycle loss, as JAX's
    two-process epoch test runs it (``tests/test_multiprocess.py``)."""
    return ["--mode", mode, "--tiny", "--platform", "cpu", "--epochs", "1",
            "--no-cycle", "--data-root", corpus,
            "--mesh-model", str(mesh_model)]


def _jax_step(work: Path):
    """JAX's float32 step of test_torch_port_train.py's stem net on seeded
    weights and batch (its dense cycle loss), and the port's inputs for
    the two ranks: (JAX state, JAX metrics, the weights, the batch)."""
    jcfg = jconfig.tiny_config()
    jcfg = jcfg.replace(train=jcfg.train.__class__(
        **{**jcfg.train.__dict__, "test_views": ("1", "4"),
           "dense_cyc": True}))
    rs = np.random.RandomState(12)
    images = rs.rand(3, 2, 16, 16, 1).astype(np.float32)
    target = (rs.rand(3, 2, 16, 16, 5) > 0.7).astype(np.float32)
    clips = (rs.rand(3, 8, 16, 16, 1) * 255).astype(np.float32)
    jm = _JStemNet()
    v = random_variables(lambda: jm.init(jax.random.PRNGKey(0),
                                         jnp.asarray(images), False), 13)
    batch = {"images": torch.from_numpy(images),
             "masks": torch.from_numpy(target),
             "clips": torch.from_numpy(clips)}
    torch.save({"state": _port_params(v), "batch": batch},
               work / "jax_inputs.pt")
    return jm, jcfg, v, {"images": images, "masks": target, "clips": clips}


def _launch(spec_path: Path):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("PMI_", "OMPI_"))}
    root = str(Path(__file__).resolve().parents[1])
    env.update(OMP_NUM_THREADS="1", PMI_SIZE="2",
               PYTHONPATH=os.pathsep.join(
                   [root, env.get("PYTHONPATH", "")]).rstrip(os.pathsep))
    return [subprocess.Popen(
        [sys.executable, str(CHILD), str(spec_path)], cwd=root,
        env={**env, "PMI_RANK": str(r)}, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """One two-process launch for every scenario, and this process's
    references meanwhile: ``(ranks' results, one-process CLI runs, JAX)``."""
    work = tmp_path_factory.mktemp("ranks")
    corpus = generate_synthetic_dataset(work / "corpus", tiny_config().data,
                                        seed=6666)["root"]
    jm, jcfg, v, jbatch = _jax_step(work)
    common = {"steps": list(STEPS), "shared_dir": str(work / "shared"),
              "work": str(work / "cli"),
              "jax_inputs": str(work / "jax_inputs.pt"),
              "cli": {n: _cli_args(m, corpus, mm)
                      for n, (m, mm) in CLI_RUNS.items()},
              "stop": _cli_args("train", corpus, 2) + ["--epochs", "3"]}
    # two worlds of two ranks side by side: the CLI runs, and the rest
    groups = {"cli": ["cli", "stop"],
              "steps": ["refusals", "jax_step", "steps", "eval",
                        "regression", "elastic"]}
    procs, outs = [], []
    for port, (name, scenarios) in zip(_free_ports(len(groups)),
                                       groups.items()):
        spec = {**common, "port": port, "scenarios": scenarios,
                "out": str(work / f"{name}{{rank}}.pt")}
        (work / f"{name}.json").write_text(json.dumps(spec))
        procs += _launch(work / f"{name}.json")
        outs.append(spec["out"])
    try:
        state = TrainState.create(apply_fn=jm.apply, params=v["params"],
                                  batch_stats=v["batch_stats"],
                                  tx=optax.sgd(1.0))
        jstate, jmet = j_make_train_step(jcfg, jm,
                                         compiler_options=FAST_COMPILE)(
            state, {k: jnp.asarray(a) for k, a in jbatch.items()},
            jax.random.PRNGKey(1))
        jax_ref = (v, jax.device_get(jstate), jax.device_get(jmet), jbatch)
        one = {}
        for name, (mode, _) in CLI_RUNS.items():
            root = work / "one" / name
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                rc = cli.main(_cli_args(mode, corpus, 1) + [
                    "--save-dir", str(root / "ckpt"),
                    "--log-dir", str(root / "log")])
            one[name] = {"rc": rc, "stdout": out.getvalue(), "root": root}
        errs = []
        for i, p in enumerate(procs):
            _, err = p.communicate(timeout=LAUNCH_TIMEOUT_S)
            if p.returncode != 0:
                errs.append(f"rank {i % 2} of {list(groups)[i // 2]} "
                            f"exited {p.returncode}:\n{err[-3000:]}")
        assert not errs, "\n".join(errs)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = [{} for _ in range(2)]
    for out in outs:
        for r in range(2):
            results[r].update(torch.load(out.format(rank=r),
                                         weights_only=False))
    return results, one, jax_ref, work


# ------------------------------------------------------ environment, mesh

def test_cluster_reads_the_launchers_variables(monkeypatch):
    """JAX's environment contract, name for name, without a backend."""
    for var in ("PMI_SIZE", "PMI_RANK", "OMPI_COMM_WORLD_SIZE",
                "OMPI_COMM_WORLD_RANK", "MPI_LOCALRANKID",
                "OMPI_COMM_WORLD_LOCAL_RANK", "MASTER_ADDR",
                "AZ_BATCH_MASTER_NODE", "AZ_BATCHAI_MPI_MASTER_NODE"):
        monkeypatch.delenv(var, raising=False)
    assert (cluster.get_world_size(), cluster.get_global_rank(),
            cluster.get_local_rank(), cluster.get_master_ip()) == (
                1, 0, 0, "127.0.0.1")
    assert cluster.launcher_world() is None
    cluster.initialize_distributed()  # a single process: nothing to join
    monkeypatch.setenv("OMPI_COMM_WORLD_SIZE", "4")
    monkeypatch.setenv("OMPI_COMM_WORLD_RANK", "3")
    monkeypatch.setenv("OMPI_COMM_WORLD_LOCAL_RANK", "1")
    monkeypatch.setenv("AZ_BATCH_MASTER_NODE", "10.0.0.7:6000")
    assert (cluster.get_world_size(), cluster.get_global_rank(),
            cluster.get_local_rank(), cluster.get_master_ip()) == (
                4, 3, 1, "10.0.0.7")
    assert cluster.launcher_world() == (4, 3)
    monkeypatch.setenv("MASTER_ADDR", "node0")
    assert cluster.get_master_ip() == "node0"
    monkeypatch.setenv("PMI_SIZE", "2")  # PMI first, as in JAX
    assert cluster.get_world_size() == 2
    monkeypatch.delenv("OMPI_COMM_WORLD_RANK")
    with pytest.raises(RuntimeError, match="no rank env var"):
        cluster.initialize_distributed()
    assert cluster.choose_backend(cpu=True, world_size=2) == "gloo"


def test_mesh_shapes_and_errors_are_jaxs(ranks):
    """tests/test_parallel.py's shapes and messages over 8 places, and the
    two errors only a multi-process world raises (from the ranks)."""
    assert make_mesh(data=4, model=2, world_size=8).shape == {
        "data": 4, "model": 2}
    mesh = make_mesh(world_size=8)
    assert mesh.shape["data"] == 8 and mesh.shape["model"] == 1
    with pytest.raises(ValueError, match="devices"):
        make_mesh(data=4, model=4, world_size=8)
    with pytest.raises(ValueError, match="not divisible by model=3"):
        make_mesh(model=3, world_size=8)
    # under-subscription is allowed without a process group
    assert make_mesh(data=2, model=2, world_size=8).shape == {
        "data": 2, "model": 2}
    assert make_mesh().shape == {"data": 1, "model": 1}
    refusals = ranks[0][0]["refusals"]
    assert "multi-process runs must use ALL devices" in refusals["under"]
    assert refusals["model3"] == "2 devices not divisible by model=3"


# ------------------------------------------------------------ the rule

def _marked(shapes):
    """Each JAX leaf filled with 1000·(its index) + the position along its
    last axis: a converted tensor names its JAX leaf and shows where that
    axis went."""
    leaves, tree = jax.tree_util.tree_flatten(shapes)
    return jax.tree_util.tree_unflatten(tree, [
        np.broadcast_to(1000.0 * i + np.arange(s.shape[-1] if s.shape
                                               else 1),
                        s.shape).astype(np.float64)
        for i, s in enumerate(leaves)]), leaves


def _jax_axes(shapes, to_port) -> dict:
    """Port key → the torch dim JAX's ``variable_pspec`` splits (over a
    model axis of 2), or None."""
    marked, leaves = _marked(shapes)
    out = {}
    for key, t in to_port(marked).items():
        if not t.is_floating_point():  # BN step counts: not JAX leaves
            continue
        t = t.double()
        leaf = leaves[int(t.reshape(-1)[0].item() // 1000)]
        spec = jsharding.variable_pspec(leaf, 2)
        if spec == jax.sharding.PartitionSpec():
            out[key] = None
            continue
        varying = [d for d in range(t.dim())
                   if not bool((t == t.narrow(d, 0, 1)).all())]
        assert len(varying) == 1, key
        out[key] = varying[0]
    return out


def _rule_case(name):
    """(JAX variables' shapes, their converter, the port model)."""
    if name == "flagship":
        cfg = ModelConfig(**TINY_MODEL)
        model, _ = build_model(cfg)
        return (tiny_flagship()[1],
                lambda v: state_dict_from_jax(v, cfg), model)
    if name == "res3dunet":  # its decoder's transposed convs
        views = ("1", "3")
        tiny = tiny_config().model
        jcfg = JModelConfig(**{
            f: getattr(tiny, f) for f in JModelConfig.__dataclass_fields__
            if hasattr(tiny, f) and f not in ("arch", "views")},
            arch=name, views=views)
        jm = j_seg_build(jcfg)[0]
        x = jnp.zeros((2, 8, 16, 16, 1))
        shapes = init_shapes(lambda: jm.init(jax.random.PRNGKey(0), x,
                                             False))
        model, _ = build_model(tiny.__class__(**{
            **tiny.__dict__, "arch": name, "views": views}), hw=16)
        return ({k: v for k, v in shapes.items()
                 if k in ("params", "batch_stats")},
                lambda v: zoo_state_dict_from_jax(v, name), model)
    kw = cli.TINY_REG[name]
    jm, adapter = j_reg_build(name, 3, **kw)
    x = adapter(jnp.zeros((3, 2, 32, 32, 8)))
    shapes = init_shapes(lambda: jm.init(jax.random.PRNGKey(0), x, False))
    return ({k: v for k, v in shapes.items()
             if k in ("params", "batch_stats")},
            lambda v: reg_state_dict_from_jax(v, name),
            build_reg_model(name, 3, **kw)[0])


@pytest.mark.parametrize("name", ["flagship", "res3dunet", "timesformer"])
def test_split_rule_matches_jaxs(name, monkeypatch):
    """``variable_pspec`` on JAX's leaves (traced, no compile), carried
    through ``utils/convert.py``: the port's rule splits exactly the same
    tensors, on the axis JAX's last axis maps to. Both minimums lowered to
    4, as JAX's multi-process test lowers its own, so the tiny widths
    split."""
    monkeypatch.setattr(jsharding, "_MIN_SHARD_DIM", 4)
    monkeypatch.setattr(sharding, "_MIN_SHARD_DIM", 4)
    shapes, to_port, model = _rule_case(name)
    want = _jax_axes(shapes, to_port)
    plan = sharding.split_plan(model, 2)
    got = {k: plan.get(k) for k in want}
    assert got == want
    assert sum(d is not None for d in want.values()) > 5  # the case splits


# ---------------------------------------------------------- two-rank steps

def _step_errors(res) -> dict:
    """Key → the two-rank error over its allowance scale (module
    docstring), for the float64 steps (SGD at lr 1: the update is the
    gradient)."""
    before, after, ref = res["before"], res["after"], res["ref_after"]
    out = {}
    for k, want in ref.items():
        if not want.is_floating_point():
            assert torch.equal(after[k], want), k
            continue
        if "running" in k:
            out[k] = float((after[k] - want).abs().max()
                           / want.abs().max())
            continue
        g0, g1 = before[k] - want, before[k] - after[k]
        wk = k.replace("bias", "weight")
        scale = max(float(g0.abs().max()), float(
            (before[wk] - ref[wk]).abs().max()) if wk in ref else 0.0)
        out[k] = float((g1 - g0).abs().max()) / scale
    return out


@pytest.mark.parametrize("case", STEPS)
def test_two_rank_step_equals_one_process(ranks, case):
    """One train step of the tiny flagship (float64, SGD at lr 1) on two
    ranks against one process: ``d2`` (2, 1) with the sampled cycle start
    drawn alike on both ranks, ``m2`` (1, 2), ``replicated`` (a global
    batch of 3 frames, which data = 2 does not divide: counted once),
    ``temporal`` in the default order and in K1's (``temporal_k1``; the
    clip's frames on two ranks, TPAVI's tokens across them), ``accum``
    (two microbatches, each split) and ``fused`` (fused passes). Losses,
    confusion counts, BN running statistics and gradients within 1e-10;
    the replicated leaves bit for bit equal on both ranks; under (1, 2)
    the rule splits most leaves."""
    rank0, rank1 = (r["steps"][case] for r in ranks[0])
    res = {**rank0, **{k: v for k, v in rank1.items()
                       if k.startswith("ref")}}
    for k, want in res["ref_metrics"].items():
        got = res["metrics"][k].double()
        np.testing.assert_allclose(got.numpy(), want.double().numpy(),
                                   rtol=1e-10, atol=0, err_msg=k)
    errs = _step_errors(res)
    worst = max(errs, key=errs.get)
    assert errs[worst] < 1e-10, (worst, errs[worst])
    assert rank0["replicas_differ"] == rank1["replicas_differ"] == []
    split, total = rank0["split"]
    assert (split > total // 2) if case == "m2" else split == 0


def test_two_rank_step_matches_jax(ranks):
    """The float32 step of test_torch_port_train.py's stem net (the fused
    stem's module, a 1×1 classifier, the dense cycle loss) on two ranks at
    (2, 1) against JAX's unsharded step, with that test's tolerances: the
    stem's batch moments and Σdn merged across ranks, the clip's frames
    split, every gradient summed."""
    v, jstate, jmet, jbatch = ranks[2]
    got = ranks[0][0]["jax_step"]
    for k in ("loss", "seg_loss", "cyc_loss", "tp", "fp", "fn", "tn"):
        np.testing.assert_allclose(got["metrics"][k].numpy(),
                                   np.asarray(jmet[k]), **TOL, err_msg=k)
    before = _port_params(v)
    want = _port_params({"params": jstate.params,
                         "batch_stats": jstate.batch_stats})
    after = got["after"]
    n_sup, n_cyc = 2 * 14 * 14, 8 * 14 * 14
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            assert int(after[k]) == 2, k
        elif k.endswith("running_var"):
            # flax: .81 v0 + .09 σ²_sup + .1 σ²_cyc; torch: each × n/(n−1)
            view = STEP_VIEWS.index(k.split(".")[1])
            z_sup, z_cyc = (torch.nn.functional.conv2d(
                torch.from_numpy(jbatch[a][view]).permute(0, 3, 1, 2),
                before[k.replace("1.running_var", "0.weight")],
                before[k.replace("1.running_var", "0.bias")], padding=2)
                for a in ("images", "clips"))
            var_s, var_c = (z.var(dim=(0, 2, 3), unbiased=False)
                            for z in (z_sup, z_cyc))
            expect = (w + 0.09 * var_s / (n_sup - 1)
                      + 0.1 * var_c / (n_cyc - 1))
            np.testing.assert_allclose(after[k].numpy(), expect.numpy(),
                                       rtol=2e-3, err_msg=k)
        elif k.endswith("running_mean"):
            np.testing.assert_allclose(after[k].numpy(), w.numpy(), **TOL,
                                       err_msg=k)
        else:
            g_port = (before[k] - after[k]).numpy()
            g_jax = (before[k] - w).numpy()
            scale = np.abs(g_jax).max()
            if k.startswith("stem") and k.endswith("0.bias"):
                wk = k.replace("bias", "weight")
                scale = np.abs((before[wk] - want[wk]).numpy()).max()
                atol = 5e-3 * scale
            else:
                atol = 2e-4 * scale
            np.testing.assert_allclose(g_port, g_jax, atol=atol, rtol=2e-4,
                                       err_msg=k)


def test_eval_sums_counts_over_data(ranks):
    """The eval step at (2, 1): the loss and the confusion counts of the
    whole batch (summed over ``data`` before Dice) and the gathered logits
    equal one process's."""
    res = ranks[0][0]["eval"]
    got, ref = res["got"], res["ref"]
    np.testing.assert_allclose(float(got["loss"]), float(ref["loss"]),
                               rtol=1e-12)
    for part in ("counts", "part_counts"):
        for k in ref[part]:
            assert torch.equal(got[part][k], ref[part][k]), (part, k)
    np.testing.assert_allclose(got["logits"].numpy(), ref["logits"].numpy(),
                               rtol=1e-12, atol=1e-12)


def test_regressor_step_at_data_two(ranks):
    """r2plus1d (--tiny widths, float64, SGD at lr 1) at (2, 1): the global
    batch's mean loss, every gradient and BN statistic, and the gathered
    eval predictions, against one process."""
    res = ranks[0][0]["regression"]
    got, ref = res["got"], res["ref"]
    np.testing.assert_allclose(float(got["loss"]), float(ref["loss"]),
                               rtol=1e-10)
    np.testing.assert_allclose(got["pred"].numpy(), ref["pred"].numpy(),
                               rtol=1e-10)
    errs = _step_errors({"before": got["before"], "after": got["after"],
                         "ref_after": ref["after"]})
    worst = max(errs, key=errs.get)
    assert errs[worst] < 1e-10, (worst, errs[worst])


def _equal(a, b, path="") -> list:
    """Paths where two nested payloads differ (tensors bit for bit)."""
    if isinstance(a, dict):
        if set(a) != set(b):
            return [path]
        return [p for k in a for p in _equal(a[k], b[k], f"{path}/{k}")]
    if isinstance(a, (list, tuple)):
        return [p for x, y in zip(a, b) for p in _equal(x, y, path)]
    if torch.is_tensor(a):
        return [] if a.shape == b.shape and torch.equal(a, b) else [path]
    return [] if a == b else [path]


@pytest.mark.parametrize("case", ["m2_to_one", "one_to_d2", "one_to_m2"])
def test_checkpoints_restore_under_another_mesh(ranks, case):
    """A run saved by two ranks at (1, 2) restores on one process, and one
    process's restores at (2, 1) and at (1, 2): weights, BN statistics,
    Adam's moments and steps and the schedule bit for bit (the files hold
    whole tensors whatever the mesh). One more Adam step from the restored
    state then lands within 1e-6 of the learning rate of the one-process
    run's: the biases whose gradient cancels to rounding noise are where
    Adam's step differs most."""
    res = ranks[0][0]["elastic"]
    if case == "m2_to_one":
        assert _equal(res["m2_to_1"]["saved"],
                      res["m2_to_1"]["restored"]) == []
        return
    got = res["to_d2" if case == "one_to_d2" else "to_m2"]
    one = torch.load(ranks[3] / "shared" / "one" / "state_00000.pth",
                     weights_only=True)
    assert _equal(got["restored"]["network"], res["one_saved"]) == []
    assert _equal(got["restored"]["optimizer"], one["optimizer"]) == []
    assert got["restored"]["scheduler"] == one["scheduler"]
    lr = tiny_config().opt.lr
    for k, want in res["one_next"].items():
        if want.is_floating_point():
            err = float((got["next"][k] - want).abs().max())
            assert err <= 1e-6 * lr, (k, err)


def test_serve_refuses_two_processes(ranks):
    """``--mode serve`` and the HTTP endpoint refuse a multi-process run
    with JAX's messages."""
    refusals = ranks[0][0]["refusals"]
    assert refusals["serve"].startswith(
        "--mode serve is a single-controller path; in a multi-process run")
    assert refusals["http"] == ("HTTP serving is a single-controller "
                                "path; run one server per host")


# ------------------------------------------------------------ the CLI

def _epoch_records(root: Path) -> list:
    lines = (root / "log" / "metrics.jsonl").read_text().splitlines()
    return [json.loads(x) for x in lines]


@pytest.mark.parametrize("name", list(CLI_RUNS))
def test_cli_two_processes_match_one(ranks, name):
    """``python -m glfusion_tpu_torch ... --mesh-model N`` under the
    launcher's variables: the tiny flagship's epoch at (2, 1) and at
    (1, 2) and ``--mode reg-train`` at (2, 1) give one process's results
    with JAX's tolerances for its two-process epoch (float32 sums in
    another order; ``tests/test_multiprocess.py:275-291``): the epoch's
    losses within 1e-4 relative and its Dice within 5e-3, the regressor's
    scores within 1e-4. The evaluations after the epoch score weights
    that one Adam step moves by ±lr wherever a gradient is rounding
    noise, so their Dice agree within 5e-3 absolute (the eval step alone
    is exact, test_eval_sums_counts_over_data). The checkpoint holds whole
    tensors, the one
    process's shapes; rank 1 prints nothing and writes no file."""
    results, one, _, work = ranks
    got = [r["cli"][name] for r in results]
    ref = one[name]
    assert got[0]["rc"] == got[1]["rc"] == ref["rc"] == 0
    assert got[1]["stdout"] == ""
    rank0, rank1 = (work / "cli" / name / f"rank{r}" for r in range(2))
    assert [p for p in rank1.rglob("*") if p.is_file()] == []
    if name.startswith("reg"):
        mine, theirs = (json.loads(o.strip().splitlines()[-1])
                        for o in (got[0]["stdout"], ref["stdout"]))
        assert mine.keys() == theirs.keys()
        for k in mine:
            if isinstance(mine[k], float):
                np.testing.assert_allclose(mine[k], theirs[k], rtol=1e-4,
                                           err_msg=k)
    else:
        mine, theirs = _epoch_records(rank0), _epoch_records(ref["root"])
        assert [r.keys() for r in mine] == [r.keys() for r in theirs]
        assert mine[0]["steps"] == theirs[0]["steps"] > 0
        for k in ("loss", "seg_loss", "cyc_loss"):
            np.testing.assert_allclose(mine[0][k], theirs[0][k], rtol=1e-4,
                                       err_msg=k)
        np.testing.assert_allclose(mine[0]["dice"], theirs[0]["dice"],
                                   rtol=5e-3)
        for a, b in zip(mine[1:], theirs[1:]):  # the evaluations after it
            for k in a:
                if k.startswith("dice"):
                    np.testing.assert_allclose(a[k], b[k], atol=5e-3,
                                               err_msg=(a["eval"], k))
    net = torch.load(rank0 / "ckpt" / "net_00000.pth",
                     weights_only=True)["network"]
    want = torch.load(ref["root"] / "ckpt" / "net_00000.pth",
                      weights_only=True)["network"]
    assert {k: t.shape for k, t in net.items()} == {
        k: t.shape for k, t in want.items()}


def test_sigterm_to_one_rank_stops_every_rank(ranks):
    """SIGTERM reaches one rank of a (1, 2) run in epoch 0 of 3: both
    ranks stop after epoch 0 and exit 0, the lead having written that
    epoch's checkpoint, and nothing else (the ranks agree on the flag at
    the epoch boundary, so the checkpoint's gather meets on both)."""
    results, _, _, work = ranks
    got = [r["stop"] for r in results]
    assert [g["rc"] for g in got] == [0, 0]
    assert got[0]["files"] == ["net_00000.pth", "state_00000.pth"]
    assert got[1]["files"] == []
    records = _epoch_records(work / "cli" / "stop" / "rank0")
    assert [r["epoch"] for r in records if "loss" in r] == [0]
