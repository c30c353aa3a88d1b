"""The least time of the flash-attention kernels at a shape: K6 (the forward),
K7 (dQ) and K8 (dK and dV), as the largest of four floors, each counting only
work that no implementation of the kernel's semantics can avoid.

* tensor cores: the kernel's matrix products of ``[Sq, Sk]`` tiles (K6 q kᵀ
  and p v; K7 q kᵀ, dO vᵀ and dS k; K8 q kᵀ, dO vᵀ, pᵀ dO and dSᵀ q: each
  kernel takes q and k, not the probabilities), 2 Sq Sk D FLOP each, at the
  bf16 peak;
* HBM: each input read once and each output written once (bf16 rows of D,
  f32 row statistics);
* SFU: one ``ex2`` an element of S (16 a clock an SM);
* INT32, under dropout only: the counter hash's operations that depend on
  both the row and the column, on the two pipes that issue them, each 64 a
  clock an SM: the ALU's xors, shifts and compare (:data:`HASH_ALU_OPS`)
  and the FMA pipe's multiplies (:data:`HASH_IMAD_OPS`), the floor the
  busier pipe's. The row's and the column's products, the salt and the
  first shift-xor (a right shift distributes over xor, so ``x ^ (x >> 16)``
  of ``r ^ c`` is that of ``r`` xor that of ``c``) are hoisted.

``chip_smoke.py`` reads its bounds from here, at the clock it measures; the
benchmark takes the card's maximum SM clock, so that a kernel's reading
cannot pass 100%.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

from benchmark.harness.work import PEAK_BF16_FLOPS, PEAK_HBM_BYTES

CLOCK_HZ = 1.980e9  # H100 SXM's maximum SM clock (nvidia-smi clocks.max.sm)
SMS, SFU_PER_CLK, INT32_PER_CLK = 132, 16, 64  # sm_90 throughput a clock an SM
PRODUCTS = {"K6": 2, "K7": 3, "K8": 4}
# an element's hash past what is hoisted: one xor of the row's term (salt and
# first shift-xor folded in) with the column's, two shift-xor pairs and the
# compare against the threshold on the ALU; fmix32's two multiplies (IMAD)
HASH_ALU_OPS = 1 + 2 * 2 + 1
HASH_IMAD_OPS = 2


def io_bytes(kernel: str, bh: int, sq: int, sk: int, d: int) -> int:
    """K6: q, k, v in and o out in bf16, lse out in f32; K7: q, k, v and dO
    in, dq out in bf16, lse and Δ in in f32; K8: as K7 with dk and dv out."""
    bf16_rows = {"K6": 2 * sq + 2 * sk, "K7": 3 * sq + 2 * sk, "K8": 2 * sq + 4 * sk}[kernel]
    f32_vals = sq if kernel == "K6" else 2 * sq
    return bh * (2 * bf16_rows * d + 4 * f32_vals)


def floors_s(kernel: str, bh: int, sq: int, sk: int, d: int, dropout: bool,
             clock_hz: float = CLOCK_HZ) -> Dict[str, float]:
    """Seconds of each floor of one launch over ``bh`` batch·heads, the SFU
    and INT32 floors at ``clock_hz``."""
    elems = bh * sq * sk
    int_ops = max(HASH_ALU_OPS, HASH_IMAD_OPS)
    return {
        "tensor": PRODUCTS[kernel] * 2 * elems * d / PEAK_BF16_FLOPS,
        "hbm": io_bytes(kernel, bh, sq, sk, d) / PEAK_HBM_BYTES,
        "sfu": elems / (SMS * SFU_PER_CLK * clock_hz),
        "int32": elems * int_ops / (SMS * INT32_PER_CLK * clock_hz) if dropout else 0.0,
    }


def bound_s(kernel: str, bh: int, sq: int, sk: int, d: int, dropout: bool) -> float:
    """The least time of one launch: its largest floor."""
    return max(floors_s(kernel, bh, sq, sk, d, dropout).values())


def roofline(ctx, kernel: str, patterns: Sequence[str]) -> Optional[float]:
    """``kernel``'s share of its roofline, %: the cell's least time of its
    launches a unit (``work()["attention_s"]``) over their device time a
    unit; None where the kernel did not run or the cell runs none."""
    t = ctx.device_s(patterns)
    least = ctx.work.get("attention_s", {}).get(kernel)
    if t is None or least is None:
        return None
    return 100.0 * least / t
