"""One rank of tests/test_torch_port_parallel.py's two-process runs.

Run as ``python _torch_port_parallel_child.py SPEC.json`` with the launcher
variables an MPI-style launcher sets (``PMI_SIZE``, ``PMI_RANK``): the
process joins the gloo group through ``utils/cluster.initialize_distributed``
and runs the scenarios the spec names, one after the other, on meshes
built over the same two ranks. Rank 0 also computes each scenario's
one-process reference (a trivial mesh, no collective) or shares them
with rank 1. Each rank saves its results (``torch.save``) where the spec
says; the test compares them.
Imports torch and the port only (no JAX), so the ranks start in seconds.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import traceback

import torch

torch.set_num_threads(1)

from glfusion_tpu_torch import cli, config as pconfig  # noqa: E402
from glfusion_tpu_torch.experiments.stem_module import (  # noqa: E402
    FusedIEKDStem)
from glfusion_tpu_torch.models import build_model  # noqa: E402
from glfusion_tpu_torch.models.registry import build_reg_model  # noqa: E402
from glfusion_tpu_torch.ops.resize import resize_bilinear_nchw  # noqa: E402
from glfusion_tpu_torch.parallel import sharding  # noqa: E402
from glfusion_tpu_torch.parallel.mesh import Mesh, make_mesh  # noqa: E402
from glfusion_tpu_torch.train.regression import (  # noqa: E402
    make_regression_eval_step, make_regression_train_step)
from glfusion_tpu_torch.train.step import (  # noqa: E402
    make_eval_step, make_train_step, whole_logits)
from glfusion_tpu_torch.train.train_state import (  # noqa: E402
    load_payload, make_optimizer, make_scheduler, state_payload)
from glfusion_tpu_torch.utils.checkpoint import CheckpointManager  # noqa
from glfusion_tpu_torch.utils.cluster import (  # noqa: E402
    barrier, get_global_rank, initialize_distributed)

RANK = int(os.environ["PMI_RANK"])
VIEWS = ("1", "3", "4")


def tiny_cfg(**train):
    """The tiny flagship in float64 terms: ASPP dropout 0, as every parity
    check sets it."""
    cfg = pconfig.tiny_config()
    model = dataclasses.replace(cfg.model, aspp_dropout=0.0,
                                widths=(4, 8, 12, 16),
                                tpavi_inter_channels=8,
                                use_pallas_fusion=train.pop("pallas", False))
    return cfg.replace(model=model, train=dataclasses.replace(
        cfg.train, test_views=("1", "4"), **train))


def flagship(cfg, seed=5):
    """The tiny flagship in float64 with random BN statistics and a nonzero
    TPAVI W_z BN (the zero init hides TPAVI). Its stems are the plain
    IEKD stem: the fused stem computes in float32 whatever the model's
    type, as its kernels do (the float32 scenario holds it)."""
    torch.manual_seed(seed)
    model, _ = build_model(cfg.model, hw=cfg.data.crop_hw)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith("running_mean"):
                t.copy_(torch.rand(t.shape, generator=g) * 0.4 - 0.2)
            elif name.endswith("running_var"):
                t.copy_(torch.rand(t.shape, generator=g) + 0.5)
            elif ".W_z.1." in name:
                t.copy_(torch.rand(t.shape, generator=g) + 0.5)
    return model.double()


def flagship_batch(b=2, t=8, hw=16, seed=9):
    """Images and clip frames of distinct brightness (frame i × (i + 1)):
    frames of uniform noise alike pool to nearly equal features, whose
    2-sample BatchNorm moments (the ASPP's pooling branch) and cycle
    distances cancel, and float64 sums taken in another order then differ
    by 1e-8 relative (one process against two)."""
    g = torch.Generator().manual_seed(seed)
    ramp = lambda n: torch.arange(1, n + 1).view(1, n, 1, 1, 1)  # noqa
    return {"images": (torch.rand(3, b, hw, hw, 1, generator=g)
                       * ramp(b) / b).double(),
            "masks": (torch.rand(3, b, hw, hw, 5, generator=g) > 0.7
                      ).double(),
            "clips": torch.round(torch.rand(3, t, hw, hw, 1, generator=g)
                                 * 255 * ramp(t) / t).double()}


def full_state(model, mesh):
    return {k: v.detach().clone()
            for k, v in sharding.unshard_state_dict(model).items()}


def one_step(cfg, mesh, batch, optimizer="sgd", model=None):
    """One train step of the tiny flagship on ``mesh``: (metrics, state
    before, state after), whole tensors."""
    model = model or flagship(cfg)
    sharding.shard_module(model, mesh)
    before = full_state(model, mesh)
    opt = (torch.optim.SGD(model.parameters(), lr=1.0) if optimizer == "sgd"
           else make_optimizer(cfg, model.parameters()))
    step = make_train_step(cfg, model, opt, mesh=mesh)
    metrics = step(batch, torch.Generator().manual_seed(3))
    metrics = {k: v.detach().clone() for k, v in metrics.items()}
    return metrics, before, full_state(model, mesh), model, opt


def s_steps(spec):
    """The flagship step at (2, 1), (1, 2), with a global batch data does
    not divide (replicated, counted once) and with ``temporal`` (both
    TPAVI orders), each with its one-process reference."""
    out = {}
    cases = {"d2": (dict(), 2, 1, {}),
             "m2": (dict(), 1, 2, {}),
             "replicated": (dict(), 2, 1, dict(b=3)),
             "temporal": (dict(temporal=True), 2, 1, {}),
             "temporal_k1": (dict(temporal=True, pallas=True), 2, 1, {}),
             "accum": (dict(grad_accum=2), 2, 1, dict(b=4)),
             "fused": (dict(fuse_passes=True), 2, 1, {})}
    refs = []
    for name in spec["steps"]:
        train, d, m, bkw = cases[name]
        cfg = tiny_cfg(dense_cyc=name != "d2", **train)
        batch = flagship_batch(**bkw)
        mesh = make_mesh(data=d, model=m)
        got, before, after, model, _ = one_step(cfg, mesh, batch)
        out[name] = {
            "metrics": got, "before": before, "after": after,
            "replicas_differ": sharding.check_replicas_equal(model, mesh),
            "split": sharding.split_count(model)}
        refs.append((name, cfg, batch))
    # the one-process references, shared between the ranks (no collective)
    for i, (name, cfg, batch) in enumerate(refs):
        if i % 2 == RANK:
            ref, _, ref_after, _, _ = one_step(cfg, Mesh(), batch)
            out[name].update(ref_metrics=ref, ref_after=ref_after)
    return out


def s_eval(spec):
    """The eval step at (2, 1): loss and counts of the global batch, and
    the whole logits, against one process."""
    cfg = tiny_cfg()
    batch = flagship_batch(b=4)
    mesh = make_mesh(data=2, model=1)
    model = sharding.shard_module(flagship(cfg), mesh)
    got = make_eval_step(cfg, model, mesh=mesh)(batch)
    got["logits"] = whole_logits(got["logits"], 4, mesh)
    res = {"got": got}
    if RANK == 0:
        res["ref"] = make_eval_step(cfg, flagship(cfg))(batch)
    return res


def s_regression(spec):
    """A regressor's step (r2plus1d, --tiny widths, float64) at (2, 1)
    against one process, and the gathered eval predictions."""
    g = torch.Generator().manual_seed(4)
    batch = {"clips": torch.rand(2, 3, 8, 16, 16, generator=g).double(),
             "targets": torch.rand(2, generator=g).double() * 60 + 20}
    cfg = tiny_cfg()

    def run(mesh):
        torch.manual_seed(7)
        model, _ = build_reg_model("r2plus1d", 3, **cli.TINY_REG["r2plus1d"])
        model = sharding.shard_module(model.double(), mesh)
        before = full_state(model, mesh)
        pred = make_regression_eval_step(model, mesh)(batch)
        opt = torch.optim.SGD(model.parameters(), lr=1.0)
        m = make_regression_train_step(model, opt, mesh)(batch)
        return {"loss": m["loss"], "before": before,
                "after": full_state(model, mesh), "pred": pred}

    res = {"got": run(make_mesh(data=2, model=1))}
    if RANK == 0:
        res["ref"] = run(Mesh())
    return res


def _copy(tree):
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_copy(v) for v in tree]
    return tree.detach().clone() if torch.is_tensor(tree) else tree


def _save(model, opt, sched, mesh, directory, epoch):
    payload = state_payload(model, opt, sched)
    if mesh.lead:
        ckpt = CheckpointManager(directory)
        ckpt.save(payload, epoch)
        ckpt.wait()
    barrier()
    return payload


def _restored(cfg, mesh, directory):
    model = sharding.shard_module(flagship(cfg, seed=11), mesh)
    opt = make_optimizer(cfg, model.parameters())
    sched = make_scheduler(cfg, opt)
    payload, epoch = CheckpointManager(directory).restore_latest()
    load_payload(payload, model, opt, sched)
    return model, opt, sched


def s_elastic(spec):
    """Checkpoints across meshes: Adam steps under (1, 2) saved and
    restored by one process; one process's saved and restored under (2, 1)
    and (1, 2), then one more step each, against the one-process run's."""
    cfg = tiny_cfg(dense_cyc=True)
    batch = flagship_batch()
    gen = lambda: torch.Generator().manual_seed(3)  # noqa: E731
    res = {}
    shared = spec["shared_dir"]
    # (1, 2) → one process
    mesh = make_mesh(data=1, model=2)
    _, _, _, model, opt = one_step(cfg, mesh, batch, optimizer="adam")
    sched = make_scheduler(cfg, opt)
    saved = _save(model, opt, sched, mesh, f"{shared}/m2", 0)
    if RANK == 0:
        m1, o1, s1 = _restored(cfg, Mesh(), f"{shared}/m2")
        res["m2_to_1"] = {"saved": _copy(saved),
                          "restored": _copy(state_payload(m1, o1, s1))}
    # one process → (2, 1) and (1, 2)
    if RANK == 0:
        _, _, _, model, opt = one_step(cfg, Mesh(), batch, optimizer="adam")
        sched = make_scheduler(cfg, opt)
        ckpt = CheckpointManager(f"{shared}/one")
        ckpt.save(state_payload(model, opt, sched), 0)
        ckpt.wait()
        step = make_train_step(cfg, model, opt)
        step(batch, gen())
        res["one_next"] = full_state(model, Mesh())
        res["one_saved"] = torch.load(f"{shared}/one/net_00000.pth",
                                      weights_only=True)["network"]
    barrier()
    for name, (d, m) in (("to_d2", (2, 1)), ("to_m2", (1, 2))):
        mesh = make_mesh(data=d, model=m)
        model, opt, sched = _restored(cfg, mesh, f"{shared}/one")
        restored = _copy(state_payload(model, opt, sched))
        make_train_step(cfg, model, opt, mesh=mesh)(batch, gen())
        res[name] = {"restored": restored,
                     "next": full_state(model, mesh)}
    return res


def s_refusals(spec):
    """What a two-process run must refuse: ``--mode serve``, the HTTP
    endpoint, an under-subscribed mesh, a model axis that does not divide
    the world."""
    from glfusion_tpu_torch.http_serve import serve_http
    from glfusion_tpu_torch.serve import serve_test_clips

    out = {}
    for name, fn in (("serve", lambda: serve_test_clips(None)),
                     ("http", lambda: serve_http(None)),
                     ("under", lambda: make_mesh(data=1, model=1)),
                     ("model3", lambda: make_mesh(model=3))):
        try:
            fn()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def s_cli(spec):
    """The CLI under the launcher's variables: the tiny flagship trains one
    epoch at (2, 1) and at (1, 2), and a regressor at (2, 1); each rank
    writes under its own directory, so the test sees which rank wrote."""
    from contextlib import redirect_stdout
    import io

    out = {}
    for name, args in spec["cli"].items():
        root = f"{spec['work']}/{name}/rank{RANK}"
        buf = io.StringIO()
        with redirect_stdout(buf):
            rc = cli.main(args + ["--save-dir", f"{root}/ckpt",
                                  "--log-dir", f"{root}/log"])
        out[name] = {"rc": rc, "stdout": buf.getvalue()}
        barrier()
    return out


def s_stop(spec):
    """SIGTERM to rank 1 alone, in epoch 0 of a three-epoch CLI run at
    (1, 2), where the checkpoint's gather is a collective: the CLI's
    handler sets that rank's flag only, and every rank must still stop
    after the same epoch. Each rank writes under its own directory."""
    import signal
    from pathlib import Path

    from glfusion_tpu_torch.train.trainer import Trainer

    epoch = Trainer._train_epoch

    def signalled(self, e):
        if RANK == 1 and e == 0:
            os.kill(os.getpid(), signal.SIGTERM)
        return epoch(self, e)

    root = Path(spec["work"], "stop", f"rank{RANK}")
    Trainer._train_epoch = signalled
    try:
        rc = cli.main(spec["stop"] + ["--save-dir", str(root / "ckpt"),
                                      "--log-dir", str(root / "log")])
    finally:
        Trainer._train_epoch = epoch
    barrier()
    return {"rc": rc, "files": sorted(p.name for p in root.rglob("*.pth"))}


class StemNet(torch.nn.Module):
    """tests/test_torch_port_train.py's ``_StemNet``: per view the fused
    stem module (its features are ``f4_global``) and a 1×1 classifier."""

    def __init__(self, c=8):
        super().__init__()
        self.stem = torch.nn.ModuleDict({v: FusedIEKDStem(c) for v in VIEWS})
        self.cls = torch.nn.ModuleDict({v: torch.nn.Conv2d(c, 5, 1)
                                        for v in VIEWS})

    def forward(self, x):
        feats, logits = [], []
        for i, v in enumerate(VIEWS):
            f = self.stem[v](x[i].permute(0, 3, 1, 2).contiguous())
            feats.append(f)
            logits.append(resize_bilinear_nchw(self.cls[v](f), x.shape[2:4]))
        return {"mask": torch.stack(logits).permute(0, 1, 3, 4, 2),
                "f4_global": torch.stack(feats).permute(0, 1, 3, 4, 2)}


def s_jax_step(spec):
    """The float32 step of ``StemNet`` at (2, 1) on the weights and batch
    the test made from JAX's (its reference is JAX's own step)."""
    data = torch.load(spec["jax_inputs"], weights_only=True)
    cfg = pconfig.tiny_config()
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, test_views=("1", "4"), dense_cyc=True))
    model = StemNet()
    model.load_state_dict(data["state"])
    mesh = make_mesh(data=2, model=1)
    sharding.shard_module(model, mesh)
    step = make_train_step(cfg, model,
                           torch.optim.SGD(model.parameters(), lr=1.0),
                           mesh=mesh)
    got = step(data["batch"], torch.Generator().manual_seed(0))
    return {"metrics": got, "after": full_state(model, mesh)}


SCENARIOS = {"steps": s_steps, "eval": s_eval, "regression": s_regression,
             "elastic": s_elastic, "refusals": s_refusals, "cli": s_cli,
             "jax_step": s_jax_step, "stop": s_stop}


def main() -> int:
    spec = json.load(open(sys.argv[1]))
    initialize_distributed(port=spec["port"], cpu=True)
    assert get_global_rank() == RANK
    # the tiny widths must still split leaves over the model axis, as JAX's
    # tests/test_multiprocess.py lowers its own
    sharding._MIN_SHARD_DIM = 4
    results = {}
    for name in spec["scenarios"]:
        try:
            results[name] = SCENARIOS[name](spec)
        except Exception:
            results[name] = {"error": traceback.format_exc()}
            print(results[name]["error"], file=sys.stderr, flush=True)
            raise
    torch.save(results, spec["out"].format(rank=RANK))
    barrier()
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
