"""One rank of the port's data-parallel tests (`tests/test_torch_ddp.py`).

Run as `python tests/torch_ddp_worker.py <job file> <rank>`: joins the gloo
group of the job's world at its port, runs the jobs named in the file on
this rank's rows and writes what each saw, by name, to `<job file>.<rank>`
with `torch.save`.  It imports the port and numpy only.
"""
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def train_steps(job: dict) -> dict:
    """`build_training` on every rank (rank 1 from another seed), rank 0's
    weights loaded and replicated, then the job's steps on this rank's rows
    of each global batch; returns each step's metrics and the state after
    it (rank 0)."""
    from ov3det_torch.engine.train import batch_to_device, build_training
    from ov3det_torch.parallel import data_group, replicate, shard_batch

    rank = data_group().rank
    training = build_training(job["cfg"], 100, device="cpu", seed=rank)
    model = training.model
    if rank == 0:
        model.load_state_dict(job["state"])
    replicate(list(model.parameters()) + list(model.buffers()))
    gen = torch.Generator().manual_seed(0)
    seen = []
    for batch in job["batches"]:
        metrics = training.train_step(shard_batch(batch_to_device(batch, "cpu")), gen)
        seen.append(({k: float(v) for k, v in metrics.items()},
                     {k: v.clone() for k, v in model.state_dict().items()}))
    return {"steps": seen}


def clip_loss(job: dict) -> dict:
    """`clip_contrastive_loss(gather=True)` on this rank's rows: the loss
    and the gradient of the rows."""
    from ov3det_torch.losses.clip_loss import clip_contrastive_loss
    from ov3det_torch.parallel import shard_batch

    local = shard_batch({k: torch.from_numpy(v) for k, v in job["embeds"].items()})
    pc = local["pc"].requires_grad_()
    tx = local["text"].requires_grad_()
    loss, metrics = clip_contrastive_loss(pc, tx, gather=True)
    loss.backward()
    return {"loss": float(loss), "acc": float(metrics["clip_acc"]), "pc_grad": pc.grad,
            "text_grad": tx.grad}


def near_gt_eval_step(batch: dict) -> dict:
    """A stand-in for the eval step whose detections score: for each scene,
    16 jittered copies of its GT boxes with their classes, from a generator
    seeded by the scene's `scan_idx`, so that a scene's detections do not
    depend on the rank that holds it (random weights detect nothing)."""
    from ov3det_torch.geometry.boxes_np import corners_from_upright_depth_param_np

    Q, out = 16, {"box_corners": [], "sem_cls_prob": [], "objectness_prob": []}
    for i in range(batch["point_clouds"].shape[0]):
        rng = np.random.default_rng(int(batch["scan_idx"][i]))
        src = rng.integers(0, int(batch["gt_box_present"][i].sum()), size=Q)
        centers = batch["gt_box_centers"][i].numpy()[src] + rng.normal(0, 0.06, (Q, 3))
        sizes = batch["gt_box_sizes"][i].numpy()[src] * rng.uniform(0.8, 1.2, (Q, 3))
        logits = rng.normal(size=(Q, 19)) * 2
        logits[np.arange(Q), batch["gt_box_sem_cls_label"][i].numpy()[src]] = 4.0
        probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
        out["box_corners"].append(corners_from_upright_depth_param_np(
            centers[None], sizes[None], np.zeros((1, Q)))[0])
        out["sem_cls_prob"].append(probs[:, :-1])
        out["objectness_prob"].append(1 - probs[:, -1])
    return {k: torch.from_numpy(np.stack(v).astype(np.float32)) for k, v in out.items()}


def eval_loader(job: dict, rank: int = 0, world: int = 1):
    """The loader of the eval job's scenes: rank `rank`'s rows of each
    global batch of `eval_batch` in a world of `world`."""
    from ov3det_torch.datasets.loader import DataLoader
    from ov3det_torch.datasets.synthetic import SyntheticDataset

    return DataLoader(SyntheticDataset(**job["eval_scenes"]), batch_size=job["eval_batch"],
                      shuffle=True, drop_last=False, seed=4, num_workers=0,
                      process_index=rank, process_count=world)


def evaluate(job: dict) -> dict:
    """`main.evaluate` of `near_gt_eval_step` on this rank's rows: the
    calculator it returns (every rank's scans, gathered), as plain data."""
    from ov3det_torch.datasets.dataset_configs import ScannetDatasetConfig
    from ov3det_torch.main import evaluate as run_eval
    from ov3det_torch.parallel import data_group

    group = data_group()
    ap = run_eval(near_gt_eval_step, eval_loader(job, group.rank, group.world),
                  ScannetDatasetConfig(), "cpu")
    return {"pred": ap.pred_map_cls, "gt": ap.gt_map_cls, "metrics": ap.compute_metrics()}


def any_rank(job: dict) -> list:
    """`any_rank` of a flag raised on rank 1 alone, then of none, then of
    one on rank 0 alone."""
    from ov3det_torch.parallel import any_rank as agree
    from ov3det_torch.parallel import data_group

    rank = data_group().rank
    return [agree(rank == 1), agree(False), agree(rank == 0)]


JOBS = {"train_steps": train_steps, "clip_loss": clip_loss, "evaluate": evaluate,
        "any_rank": any_rank}


def main(path: str, rank: int) -> None:
    torch.set_num_threads(1)
    job = torch.load(path, weights_only=False)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{job['port']}", rank=rank,
                            world_size=job["world"])
    try:
        out = {name: JOBS[name](job) for name in job["names"]}
    finally:
        dist.destroy_process_group()
    torch.save(out, f"{path}.{rank}")


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
