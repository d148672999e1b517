"""Multi-device dry run of the port over the mesh's axes: the counterpart
of the JAX package's ``__graft_entry__.dryrun_multichip``.

    from peanut_tpu_torch.multichip import dryrun_multichip
    dryrun_multichip(2, device="cpu")      # or on the cards: device=None
    dryrun_multichip(4, device="cpu", spatial=True)

One process drives it all, on ``n_devices`` devices (the cards, each
repeated as often as needed when there are fewer; the CPU ``n_devices``
times with ``device="cpu"``):

1. a train step of a narrow PSPNet (base width 16, the full training
   step's structure) over spawned ranks in a process group (NCCL when each
   rank has a card of its own, else gloo; printed), each with its rows of
   a global batch of max(ranks, 2) at 64^2: finite losses, and every
   rank's parameters equal after the step.  Over the data axis alone,
   ``n_devices`` ranks; with ``spatial=True`` and an even ``n_devices`` of
   at least 4, over ``{"data": n // 2, "spatial": 2}``: n // 2 ranks, each
   driving two spatial shards (``make_train_step(spatial_axis=...)``), as
   the JAX dry run's mesh (``__graft_entry__.py:79-86``);
2. in the same ranks, evaluation sharded rank-strided over 2 x ranks val
   maps, the per-sample statistics gathered over the group
   (``metrics.gather_strided_results``): mIoU bit-equal to rank 0's
   direct pass over all of them;
3. one tick of ``BatchedNavRuntime`` with n episodes sharded over
   ``make_mesh({"data": n})``, prediction on;
4. the ``pred_async`` serving mode under the same mesh: the first tick
   triggers, so its collect enqueues the prediction program, whose goal
   lands at the second tick;
5. with ``spatial=True`` and n >= 2, the whole-map prediction of the
   tick's first full map (its 14 channels) with the height sharded over
   ``make_mesh({"spatial": 2})`` (``get_prediction_sharded``, as
   ``__graft_entry__.py:188-200``): its shape, finite values, and within
   ``SPATIAL_PRED_TOL`` of ``get_prediction`` on the same map.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Dict

import numpy as np
import torch

# the JAX dry run's narrow PSPNet: the full training step's structure at
# base width 16
BASE = 16
DRYRUN_MODEL = dict(
    type="EncoderDecoder",
    backbone=dict(type="ResNetV1c", depth=50, num_stages=4,
                  out_indices=(0, 1, 2, 3), dilations=(1, 1, 2, 4),
                  strides=(1, 2, 1, 1), contract_dilation=True,
                  base_channels=BASE, stem_channels=BASE, in_channels=14),
    decode_head=dict(type="PSPHead", in_channels=BASE * 32, in_index=3,
                     channels=BASE * 8, pool_scales=(1, 2, 3, 6),
                     dropout_ratio=0.1, num_classes=6, align_corners=False),
    auxiliary_head=dict(type="FCNHead", in_channels=BASE * 16, in_index=2,
                        channels=BASE * 4, num_convs=1, concat_input=False,
                        dropout_ratio=0.1, num_classes=6,
                        align_corners=False),
    test_cfg=dict(mode="whole"),
)
SIZE = 64
# |sharded - unsharded| of part 5's float32 probabilities: rounding only
# (the shards' convolutions sum in other orders); TF32 convolutions on the
# card round to 10 bits
SPATIAL_PRED_TOL = 1e-4
SPATIAL_PRED_TOL_TF32 = 2e-3


def _devices(n: int, device) -> list:
    device = torch.device(device)
    if device.type == "cuda":
        count = torch.cuda.device_count()
        return [torch.device("cuda", i % count) for i in range(n)]
    return [device] * n


def _train_and_eval_rank(rank: int, world: int, init: str, backend: str,
                         devices: list, out_dir: str,
                         spatial: int = 1) -> None:
    """Parts 1 and 2 on one rank, whose devices are ``devices[rank *
    spatial:(rank + 1) * spatial]`` (its spatial shards where ``spatial``
    > 1); rank 0 writes what it found."""
    import torch.distributed as dist

    from .core.mesh import init_distributed, make_mesh
    from .models.pspnet import build_segmentor
    from .prediction.metrics import (gather_strided_results,
                                     intersect_and_union,
                                     pre_eval_to_metrics)
    from .prediction.train import (TrainConfig, create_train_state,
                                   distribute, make_train_step)

    mine = devices[rank * spatial:(rank + 1) * spatial]
    if mine[0] == "cpu":
        torch.set_num_threads(1)
    dev = init_distributed(backend, device=mine[0], init_method=init,
                           rank=rank, world_size=world)
    try:
        tcfg = TrainConfig(batch_size=max(world, 2))
        rng = np.random.RandomState(0)
        b = tcfg.batch_size
        img = rng.rand(b, 14, SIZE, SIZE).astype(np.float32)
        gt = ((rng.rand(b, 6, SIZE, SIZE) > 0.9) * 255.0).astype(np.float32)
        local = b // world
        rows = slice(rank * local, (rank + 1) * local)
        state = create_train_state(build_segmentor(DRYRUN_MODEL, seed=0),
                                   tcfg, device=dev)
        distribute(state)
        step = (make_train_step(tcfg) if spatial == 1 else make_train_step(
            tcfg, spatial_axis="spatial", mesh=make_mesh(
                {"data": world, "spatial": spatial}, devices)))
        metrics = step(state, {
            "img": torch.as_tensor(img[rows], device=dev),
            "gt": torch.as_tensor(gt[rows], device=dev)})
        flat = torch.cat([p.detach().reshape(-1)
                          for p in state.model.parameters()])
        hi, lo = flat.clone(), flat.clone()
        dist.all_reduce(hi, op=dist.ReduceOp.MAX)
        dist.all_reduce(lo, op=dist.ReduceOp.MIN)
        spread = float((hi - lo).abs().max())

        # evaluation over the ranks: rank r takes maps r, r + world, ...
        model = state.model.eval()
        n_val = 2 * world
        vrng = np.random.RandomState(1)
        maps = vrng.rand(n_val, 14, SIZE, SIZE).astype(np.float32)
        labels = (vrng.rand(n_val, SIZE, SIZE) * 6).astype(np.int64)

        def per_sample(idxs):
            out = []
            with torch.no_grad():
                for i in idxs:
                    logits = model(torch.as_tensor(maps[i:i + 1],
                                                   device=dev))
                    pred = logits[0].argmax(0).cpu().numpy()
                    out.append(np.stack(intersect_and_union(
                        pred, labels[i], 6)))
            return np.stack(out) if out else np.zeros((0, 4, 6))

        gathered = gather_strided_results(
            per_sample(range(rank, n_val, world)), n_val)
        if rank == 0:
            got = pre_eval_to_metrics([tuple(r) for r in gathered],
                                      metrics=("mIoU",))
            want = pre_eval_to_metrics(
                [tuple(r) for r in per_sample(range(n_val))],
                metrics=("mIoU",))
            with open(os.path.join(out_dir, "rank0.json"), "w") as f:
                json.dump({
                    "backend": backend, "ranks": world,
                    "spatial_shards_a_rank": spatial,
                    "losses": {k: float(v) for k, v in metrics.items()},
                    "params_spread_over_ranks": spread,
                    "eval_samples": n_val,
                    "mIoU": float(np.nanmean(got["IoU"])),
                    "eval_bit_equal": bool(np.array_equal(
                        np.nan_to_num(got["IoU"], nan=-1.0),
                        np.nan_to_num(want["IoU"], nan=-1.0)))}, f)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device=None,
                     spatial: bool = False) -> Dict:
    """Parts 1-4 of the module docstring on ``n_devices`` devices, and
    with ``spatial`` the spatial axis (part 1 over a data x spatial mesh,
    part 5); returns what each found, and raises on a failed check.
    ``device``: the cards (None) or ``"cpu"``."""
    import torch.multiprocessing as mp

    from . import resolve_device
    from .agent.batched_runtime import BatchedNavRuntime
    from .config import NavConfig
    from .core.mesh import make_mesh
    from .envs import FakeNavEnv
    from .models.pspnet import build_segmentor
    from .prediction import PredictionModel

    device = resolve_device(device)
    devices = _devices(n_devices, device)
    distinct = len(set(devices)) == n_devices
    backend = "nccl" if device.type == "cuda" and distinct else "gloo"
    shards = 2 if spatial and n_devices % 2 == 0 and n_devices >= 4 else 1
    ranks_n = n_devices // shards
    out: Dict = {"devices": [str(d) for d in devices],
                 "train_mesh": ({"data": ranks_n, "spatial": shards}
                                if shards > 1 else {"data": ranks_n}),
                 "backend": backend,
                 "backend_reason": ("a card a rank" if backend == "nccl"
                                    else "ranks share a device (NCCL "
                                    "refuses two ranks on one card) or "
                                    "run on the CPU")}

    # ---- 1-2. the train step and the evaluation over the ranks --------
    with tempfile.TemporaryDirectory() as tmp:
        init = f"file://{os.path.join(tmp, 'pg')}"
        mp.start_processes(_train_and_eval_rank,
                           args=(ranks_n, init, backend,
                                 [str(d) for d in devices], tmp, shards),
                           nprocs=ranks_n, join=True,
                           start_method="spawn")
        with open(os.path.join(tmp, "rank0.json")) as f:
            ranks = json.load(f)
    out["train_eval"] = ranks
    if not (all(np.isfinite(v) for v in ranks["losses"].values())
            and ranks["params_spread_over_ranks"] == 0.0
            and ranks["eval_bit_equal"]):
        raise RuntimeError(f"dryrun_multichip train/eval failed: {ranks}")
    print("dryrun_multichip train step + sharded eval ok:", ranks,
          "devices:", n_devices, "mesh:", out["train_mesh"])

    # ---- 3. one tick with the episodes sharded over the data axis -----
    nav_cfg = NavConfig(
        env_frame_width=64, env_frame_height=48,
        frame_width=64, frame_height=48,
        map_size_cm=640, map_resolution=5, global_downscaling=2,
        vision_range=32, num_sem_categories=10,
        prediction_window=128, use_gt_seg=1,
        max_episode_length=60, timestep_limit=60,
        num_local_steps=10, update_goal_freq=5, fmm_sweeps=2)
    nav_mesh = make_mesh({"data": n_devices}, devices=devices)
    pm = PredictionModel(nav_cfg, model=build_segmentor(DRYRUN_MODEL,
                                                        seed=0),
                         device=devices[0])

    def start(cfg):
        rt = BatchedNavRuntime(cfg, n_devices, prediction_model=pm,
                               mesh=nav_mesh)
        envs = [FakeNavEnv(cfg, size_m=8.0, seed=s, max_steps=10)
                for s in range(n_devices)]
        obs = [e.reset() for e in envs]
        for i in range(n_devices):
            rt.reset_env(i)
        return rt, envs, obs

    runtime, envs, obs = start(nav_cfg)
    acts = [a["action"] for a in runtime.act_batch(obs)]
    shard_devs = [str(st.local_maps.device) for st in runtime.shard_states]
    if len(acts) != n_devices or not all(a in (0, 1, 2, 3) for a in acts) \
            or len(runtime.shard_states) != n_devices:
        raise RuntimeError(f"dryrun_multichip nav tick: {acts}, "
                           f"{shard_devs}")
    out["nav_tick"] = {"actions": acts, "shard_devices": shard_devs}
    print("dryrun_multichip nav tick ok: actions", acts,
          "local_maps sharded over", shard_devs)

    # ---- 4. pred_async under the same mesh ----------------------------
    rt, envs, obs = start(dataclasses.replace(nav_cfg, pred_async=1))
    acts = rt.act_batch(obs)
    if rt._pending_goal is None:
        raise RuntimeError("dryrun_multichip pred_async: the first tick "
                           "triggers, so its prediction program must be "
                           "in flight")
    obs = [e.step(a) for e, a in zip(envs, acts)]
    acts = [a["action"] for a in rt.act_batch(obs)]
    if not all(a in (0, 1, 2, 3) for a in acts):
        raise RuntimeError(f"dryrun_multichip pred_async tick: {acts}")
    out["pred_async_tick"] = {"actions": acts}
    print("dryrun_multichip pred_async tick ok: actions", acts)

    # ---- 5. whole-map prediction with the height sharded ---------------
    if spatial and n_devices >= 2:
        full_map = runtime.state.full_maps[0].float().cpu().numpy()[:14]
        sp_mesh = make_mesh({"spatial": 2}, devices=devices[:2])
        probs = pm.get_prediction_sharded(full_map, sp_mesh, axis="spatial")
        plain = pm.get_prediction(full_map)
        gap = float(np.abs(probs - plain).max())
        tol = (SPATIAL_PRED_TOL_TF32 if device.type == "cuda"
               and torch.backends.cudnn.allow_tf32 else SPATIAL_PRED_TOL)
        out["spatial_prediction"] = {
            "shape": list(probs.shape), "finite": bool(
                np.isfinite(probs).all()), "max_abs_diff_unsharded": gap,
            "tol": tol, "mesh": {"spatial": 2}}
        if probs.shape != (6,) + full_map.shape[1:] or \
                not np.isfinite(probs).all() or gap > tol:
            raise RuntimeError(f"dryrun_multichip spatially sharded "
                               f"prediction: {out['spatial_prediction']}")
        print("dryrun_multichip spatially-sharded prediction ok:",
              out["spatial_prediction"])
    return out
