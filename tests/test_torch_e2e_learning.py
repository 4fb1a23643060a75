"""The port learns: AP rises when it trains on synthetic data.

The twin of `tests/test_e2e_learning.py`: the same tiny config, the same
batches (`make_batch` from the same numpy seeds), 300 steps of
`build_training(cfg, 40, device="cpu")` and the JAX test's own thresholds
(`losses[-1] < 0.65 * losses[0]`, `ap_after > max(0.10, ap_before + 0.08)`).
Model, matcher, losses, optimiser and the eval stack must all be right for
mAP@0.25 to climb on scenes whose class is set by the box size.  Marked slow
as the JAX test is: about a minute on 4 CPU threads.  `chip_smoke.py` runs the
same protocol on the card through the graphed `PackedStep`
(`chip_smoke.learning_phase`).
"""
import numpy as np
import pytest
import torch

from ov3det_torch.config import (
    DecoderConfig,
    EncoderConfig,
    LossConfig,
    MatcherConfig,
    ModelConfig,
    OptimConfig,
    TrainConfig,
)
from ov3det_torch.datasets.synthetic import make_batch
from ov3det_torch.engine.train import batch_to_device, build_training, step_seed
from ov3det_torch.eval.ap_calculator import APCalculator

NPTS, NPRE, Q, NCLS = 768, 128, 32, 3
STEPS, BATCHES, EVAL_SEEDS = 300, 25, (100, 101)


def learning_config() -> TrainConfig:
    """`tests/test_e2e_learning.py`'s config, field for field."""
    return TrainConfig(
        model=ModelConfig(
            encoder=EncoderConfig(num_layers=2, dim=64, ffn_dim=64,
                                  masking_radius=(0.16, 0.64)),
            decoder=DecoderConfig(num_layers=2, dim=64, ffn_dim=64),
            preenc_npoints=NPRE,
            num_queries=Q,
            preenc_mlp=(32, 64, 64),
            num_semcls=NCLS,
            num_angle_bin=1,
            clip_embed_dim=64,
            mlp_dropout=0.0,
        ),
        loss=LossConfig(
            matcher=MatcherConfig(cost_class=1, cost_objectness=5, cost_center=5,
                                  cost_giou=2),
            giou_weight=1.0,
            center_weight=5.0,
            giou_compute_dtype="float32",
        ),
        optim=OptimConfig(base_lr=1.5e-3, warm_lr_epochs=1, clip_gradient=0.1),
        max_epoch=10,
    )


def sample_batch(seed: int) -> dict:
    return make_batch(np.random.default_rng(seed), batch_size=4, num_points=NPTS,
                      num_semcls=NCLS, num_angle_bin=1, num_boxes=3)


def measure_ap(eval_step, device) -> float:
    calc = APCalculator(ap_iou_thresh=[0.25], exact_eval=False,
                        dataset_config=type("C", (), {"num_semcls": NCLS})())
    for s in EVAL_SEEDS:
        b = batch_to_device(sample_batch(s), device)
        calc.step_meter(eval_step(b), b)
    return calc.compute_metrics()[0.25]["mAP"]


@pytest.mark.slow
def test_ap_rises_with_training():
    torch.set_num_threads(4)
    training = build_training(learning_config(), 40, device="cpu")
    ap_before = measure_ap(training.eval_step, "cpu")
    batches = [batch_to_device(sample_batch(i), "cpu") for i in range(BATCHES)]
    gen = torch.Generator()
    losses = []
    for step in range(STEPS):
        gen.manual_seed(step_seed(0, step))
        metrics = training.train_step(batches[step % BATCHES], gen)
        if step % 100 == 0:
            losses.append(float(metrics["loss"]))
    ap_after = measure_ap(training.eval_step, "cpu")

    assert np.isfinite(losses).all()
    assert losses[-1] < 0.65 * losses[0], losses
    assert ap_after > max(0.10, ap_before + 0.08), (ap_before, ap_after, losses)
