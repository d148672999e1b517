"""Process groups on the CPU for the port's data-parallel tests: ``world``
fresh interpreters (``spawn``), one thread each, joined in a gloo group
through a file under the test's tmp_path (no TCP port, so parallel test
workers cannot collide), each running one of the functions below.  A rank
that raises fails the call.  This module imports no JAX: the ranks load
torch and the port only.
"""

import json
import os
import uuid

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def run_ranks(fn, world: int, tmp_path, *args) -> None:
    """``fn(rank, world, *args)`` in ``world`` spawned processes, joined in a
    gloo process group."""
    init = f"file://{os.path.join(str(tmp_path), 'pg_' + uuid.uuid4().hex)}"
    mp.start_processes(_rank_main, args=(fn, world, init, args),
                       nprocs=world, join=True, start_method="spawn")


def _rank_main(rank, fn, world, init, args):
    torch.set_num_threads(1)
    from peanut_tpu_torch.core.mesh import init_distributed

    init_distributed("gloo", device="cpu", init_method=init, rank=rank,
                     world_size=world)
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


def gather_rows(rank, world, full_path, out_path):
    """Rank r holds rows r::world of the array at ``full_path``; each
    writes what ``gather_strided_results`` gives it over the group."""
    from peanut_tpu_torch.prediction.metrics import gather_strided_results

    full = np.load(full_path)
    got = gather_strided_results(full[rank::world], len(full))
    np.save(f"{out_path}.{rank}.npy", got)


def ddp_step(rank, world, model_cfg, batch_path, out_path):
    """One float64 ``loss_and_grads`` of the seed-0 model under
    ``distribute``, on this rank's rows of the global batch at
    ``batch_path``; rank 0 saves the losses, the gradients and the state
    dict (the new batch statistics)."""
    from peanut_tpu_torch.models.pspnet import build_segmentor
    from peanut_tpu_torch.prediction.train import (TrainConfig,
                                                   create_train_state,
                                                   distribute, loss_and_grads)

    z = np.load(batch_path)
    b = len(z["img"]) // world
    rows = slice(rank * b, (rank + 1) * b)
    batch = {k: torch.from_numpy(z[k][rows]) for k in ("img", "gt")}
    tcfg = TrainConfig(lr=1e-3, max_iters=50, seed=int(z["seed"]))
    state = create_train_state(build_segmentor(model_cfg, seed=0).double(),
                               tcfg, device="cpu")
    distribute(state)
    metrics = loss_and_grads(state, batch, tcfg)
    if rank == 0:
        torch.save({"metrics": {k: float(v) for k, v in metrics.items()},
                    "grads": {n: p.grad for n, p in
                              state.model.named_parameters()},
                    "state": state.model.state_dict()}, out_path)


def train_cli(rank, world, argv):
    """``cli.train_prediction_model.main(argv)`` on the CPU."""
    from peanut_tpu_torch.cli import train_prediction_model

    state = train_prediction_model.main(argv, device="cpu")
    with open(os.path.join(argv[argv.index("--work_dir") + 1],
                           f"rank{rank}_step.txt"), "w") as f:
        f.write(str(state.step))


def eval_cli(rank, world, argv, out_path):
    """``cli.test.main(argv)`` on the CPU; each rank writes its report."""
    from peanut_tpu_torch.cli import test

    with open(f"{out_path}.{rank}.json", "w") as f:
        json.dump(test.main(argv, device="cpu"), f)


def spatial_steps(rank, world, model_cfg, batch_path, out_path, shards, lr):
    """Data x spatial training on the CPU: this rank's rows of each global
    batch at ``batch_path`` (``img``/``gt`` of shape (steps, B, ...),
    NCHW) with their height over ``shards`` spatial shards of a
    ``{"data": world, "spatial": shards}`` mesh, under ``distribute``.
    Two runs from the seed-0 model in float64: SGD at ``lr`` over every
    step of the batch (``model_cfg``, dropout 0), and one
    ``loss_and_grads`` at step 5 of ``model_cfg`` with dropout 0.1 and
    remat.  Rank 0 saves the losses, the state dicts and the second run's
    gradients."""
    import copy

    from peanut_tpu_torch.core.mesh import make_mesh
    from peanut_tpu_torch.models.pspnet import build_segmentor
    from peanut_tpu_torch.prediction.train import (TrainConfig,
                                                   create_train_state,
                                                   distribute, loss_and_grads,
                                                   make_train_step,
                                                   spatial_devices)

    z = np.load(batch_path)
    b = z["img"].shape[1] // world
    rows = slice(rank * b, (rank + 1) * b)
    mesh = make_mesh({"data": world, "spatial": shards},
                     ["cpu"] * (world * shards))
    tcfg = TrainConfig(lr=lr, min_lr=lr, seed=3)
    state = create_train_state(build_segmentor(model_cfg, seed=0).double(),
                               tcfg, device="cpu")
    state.optimizer = torch.optim.SGD(state.model.parameters(), lr=lr)
    distribute(state)
    step = make_train_step(tcfg, spatial_axis="spatial", mesh=mesh)
    losses = [{k: float(v) for k, v in step(state, {
        k: torch.from_numpy(z[k][i, rows]) for k in ("img", "gt")}).items()}
        for i in range(len(z["img"]))]
    out = {"losses": losses, "state": state.model.state_dict(),
           "devices": [str(d) for d in spatial_devices(state, mesh,
                                                       "spatial")]}

    cfg = copy.deepcopy(model_cfg)
    cfg["backbone"]["remat"] = True
    for head in ("decode_head", "auxiliary_head"):
        cfg[head]["dropout_ratio"] = 0.1
    state = create_train_state(build_segmentor(cfg, seed=0).double(), tcfg,
                               device="cpu")
    distribute(state)
    state.step = 5
    metrics = loss_and_grads(state, {k: torch.from_numpy(z[k][0, rows])
                                     for k in ("img", "gt")}, tcfg,
                             spatial_devices(state, mesh, "spatial"))
    out["dropout"] = {
        "metrics": {k: float(v) for k, v in metrics.items()},
        "grads": {n: p.grad for n, p in state.model.named_parameters()},
        "state": state.model.state_dict()}
    if rank == 0:
        torch.save(out, out_path)
