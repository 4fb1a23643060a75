"""Batched linear assignment on the device by the auction algorithm.

Counterpart of `ov3det/ops/hungarian.py`: Bertsekas' forward auction with
persons = ground-truth boxes and objects = proposals, batched over
(B, P, O).  Unassigned persons bid in parallel (Jacobi), the highest bid per
object wins and evicts the previous holder; a single phase from zero prices
per epsilon.  Two-tier epsilon: a tight phase (2e-4 of the benefit range,
at most `tight_iters` rounds), then, for rows that did not converge, a loose
phase (5e-3 of the range, at most `loose_iters` rounds), then a rank-
matching fallback for anything still unassigned.  Padded persons (index >=
n_persons) never bid.  Ties go to the first maximum (`torch.argmax`, as
`jnp.argmax`).

The whole of it is `ops.kernels.auction.auction_lap`: on the card one CUDA
launch (the span, every round of both phases on the device, as JAX's
`lax.while_loop`, and the fallback), so that nothing here waits on the host
and the training step can be captured in a CUDA graph; on the CPU the plain
version (`auction_lap_plain`), whose rounds run in blocks with one host
check a block.
"""
from ov3det_torch.ops.kernels.auction import auction_inputs, auction_lap, auction_lap_plain

__all__ = ["auction_inputs", "auction_lap", "auction_lap_plain"]
