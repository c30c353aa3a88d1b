"""Per-step generator seeds shared by the trainers."""

from __future__ import annotations

_GOLDEN = 0x9E3779B97F4A7C15  # odd, so seed -> seed * _GOLDEN is one to one mod 2^k


def step_seed(seed: int, step: int) -> int:
    """The generator seed of one step, distinct for every (seed, step) in
    its low 32 bits too (a CPU ``torch.Generator`` keeps only those), so a
    resumed run draws what an uninterrupted one would (JAX folds the step
    into its key)."""
    return ((seed + 1) * _GOLDEN + step) % (1 << 63)
