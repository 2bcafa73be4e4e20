"""GF(2^255-19) arithmetic on int32 limb tensors: the plain PyTorch field.

This is the plain version that every CUDA kernel of the port is held
against. It keeps the JAX package's layout and bounds so the two compare
limb for limb: a field element is a (32, *batch) int32 tensor of signed
radix-2^8 limbs, little-endian, limb axis leading.

Bounds contract (|limb| = magnitude bound), unchanged from the reference:
  - inputs to `fe_mul` satisfy |limb| <= 2^10 (the product of the two
    inputs' bounds stays <= 2^20)
  - `fe_mul` / `fe_square` outputs are carry-normalized to |limb| < 2^9
  - one add/sub of two mul outputs stays within the mul input contract
  - `fe_carry(x, 1)` on |limb| <= 2^11 yields |limb| < 2^10
  - `fe_canonical` accepts |limb| <= 2^13 and returns the unique
    representative (limbs in [0, 255], value < p)

All arithmetic stays in int32, so sums wrap exactly as the reference's
int32 arrays do; `>>` on int32 is an arithmetic shift (floor division by
a power of two) in both frameworks.

The multiply computes the folded 32x32 limb convolution with one gather
(the reference's slice form and dot form compute the same integer sums,
so all three are bit-identical), then the same four wrapping carry passes.
"""

from __future__ import annotations

import numpy as np
import torch

LIMBS = 32

P_INT = 2**255 - 19
D_INT = (-121665 * pow(121666, P_INT - 2, P_INT)) % P_INT
D2_INT = (2 * D_INT) % P_INT
SQRT_M1_INT = pow(2, (P_INT - 1) // 4, P_INT)


def _int_to_limbs(v: int) -> np.ndarray:
    """(32, 1) column vector so constants broadcast over a trailing batch."""
    return np.array([[(v >> (8 * i)) & 0xFF] for i in range(LIMBS)], dtype=np.int32)


def limbs_to_int(z) -> int:
    """Host-side helper: interpret a 1-D (32,) limb vector as an int."""
    arr = np.asarray(z, dtype=np.int64).reshape(LIMBS)
    return sum(int(arr[i]) << (8 * i) for i in range(LIMBS))


P_LIMBS = _int_to_limbs(P_INT)
D_LIMBS = _int_to_limbs(D_INT)
D2_LIMBS = _int_to_limbs(D2_INT)
SQRT_M1_LIMBS = _int_to_limbs(SQRT_M1_INT)
ONE_LIMBS = _int_to_limbs(1)

# Canonicalization bias: a multiple of p whose limbs are all >= 2^14, so
# adding it to any |limb| <= 2^13 value makes every limb positive and the
# ripple carries monotone.
_V0 = sum((1 << 14) << (8 * i) for i in range(LIMBS))
_A = (-_V0) % P_INT
BIAS_LIMBS = np.array(
    [[(1 << 14) + ((_A >> (8 * i)) & 0xFF)] for i in range(LIMBS)], dtype=np.int32
)
assert (sum(int(b) << (8 * i) for i, b in enumerate(BIAS_LIMBS[:, 0])) % P_INT) == 0

# Gather index of the pre-folded Toeplitz product: term (i, k) of
# z_k = sum_i x_i * Y2[k - i + 32], with Y2 = [38*y || y].
_TOEPLITZ_IDX = torch.tensor(
    [[k - i + LIMBS for k in range(LIMBS)] for i in range(LIMBS)], dtype=torch.long
)

_CONST_CACHE: dict = {}


def _toeplitz_idx(device) -> torch.Tensor:
    key = ("toeplitz", device)
    t = _CONST_CACHE.get(key)
    if t is None:
        t = _CONST_CACHE[key] = _TOEPLITZ_IDX.to(device)
    return t


def const(limbs: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A host (32, 1) limb constant as an int32 tensor on `like`'s device,
    shaped to broadcast against `like`'s batch axes."""
    key = (id(limbs), like.device)
    t = _CONST_CACHE.get(key)
    if t is None:
        t = torch.as_tensor(limbs, dtype=torch.int32, device=like.device)
        _CONST_CACHE[key] = t
    return t.reshape((LIMBS,) + (1,) * (like.dim() - 1))


def fe_carry(z: torch.Tensor, passes: int = 4) -> torch.Tensor:
    """Wrapping carry propagation: carries flow limb i -> i+1 and the carry
    out of limb 31 (weight 2^256 = 38 mod p) wraps to limb 0 times 38."""
    for _ in range(passes):
        c = z >> 8
        rem = z - (c << 8)
        z = rem + torch.cat([38 * c[-1:], c[:-1]], dim=0)
    return z


def _broadcast_pair(x: torch.Tensor, y: torch.Tensor):
    rank = max(x.dim(), y.dim()) - 1
    x = x.reshape((LIMBS,) + (1,) * (rank - (x.dim() - 1)) + tuple(x.shape[1:]))
    y = y.reshape((LIMBS,) + (1,) * (rank - (y.dim() - 1)) + tuple(y.shape[1:]))
    batch = torch.broadcast_shapes(tuple(x.shape[1:]), tuple(y.shape[1:]))
    return x.expand((LIMBS,) + batch), y.expand((LIMBS,) + batch)


def fe_mul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Field multiplication: the folded convolution as one gather, one
    product and one sum over the x-limb axis, then four carry passes.
    |x_i|, |y_j| <= 2^10 keep every partial sum below 2^31."""
    x, y = _broadcast_pair(x, y)
    y2 = torch.cat([38 * y, y], dim=0)  # (64, *batch)
    windows = y2[_toeplitz_idx(y2.device)]  # (32 i, 32 k, *batch)
    z = (x.unsqueeze(1) * windows).sum(dim=0, dtype=torch.int32)
    return fe_carry(z, passes=4)


def fe_square(x: torch.Tensor) -> torch.Tensor:
    """Squaring: the same integer sums as fe_mul(x, x) (the reference's
    masked half-product form produces them too)."""
    return fe_mul(x, x)


def fe_add(x, y):
    return x + y


def fe_sub(x, y):
    return x - y


def fe_neg(x):
    return -x


def fe_mul_const(x: torch.Tensor, c_limbs: np.ndarray) -> torch.Tensor:
    """Multiply by a canonical host constant ((32, 1) limb array)."""
    return fe_mul(x, const(c_limbs, x))


def _exact_carry(z: torch.Tensor):
    """Full ripple carry over the leading limb axis: byte limbs plus the
    carry out of limb 31 (weight 2^256)."""
    carry = torch.zeros_like(z[0])
    out = []
    for i in range(LIMBS):
        total = z[i] + carry
        carry = total >> 8
        out.append(total & 255)
    return torch.stack(out, dim=0), carry


def fe_canonical(z: torch.Tensor) -> torch.Tensor:
    """Unique canonical representative: limbs in [0, 255], value < p.
    Accepts |limb| <= 2^13 (the bias keeps every limb positive)."""
    z = z + const(BIAS_LIMBS, z)
    for _ in range(3):
        z, c = _exact_carry(z)
        z = torch.cat([z[:1] + 38 * c.unsqueeze(0), z[1:]], dim=0)
    # Fold bit 255 (weight 19 mod p), twice for the [2^255, 2^255+19) edge.
    for _ in range(2):
        hi = z[31] >> 7
        z = torch.cat(
            [z[:1] + 19 * hi.unsqueeze(0), z[1:31], z[31:] - (hi << 7).unsqueeze(0)], dim=0
        )
        z, _ = _exact_carry(z)
    # Conditional subtract p: with byte limbs and z < 2^255, z >= p iff
    # limb0 >= 237, limbs 1..30 == 255 and limb31 == 127; z - p < 19.
    ge = (z[0] >= 237) & torch.all(z[1:31] == 255, dim=0) & (z[31] == 127)
    sub = torch.cat([(z[0] - 237).unsqueeze(0), torch.zeros_like(z[1:])], dim=0)
    return torch.where(ge, sub, z)


def fe_is_zero(z: torch.Tensor) -> torch.Tensor:
    """Boolean mask of batch shape: z = 0 mod p."""
    return torch.all(fe_canonical(z) == 0, dim=0)


def fe_eq(x, y):
    return fe_is_zero(fe_sub(x, y))


def fe_select(mask, x, y):
    """mask ? x : y, with mask of batch shape (broadcast over the limbs)."""
    return torch.where(mask, x, y)


def _pow2k(x: torch.Tensor, k: int) -> torch.Tensor:
    for _ in range(k):
        x = fe_square(x)
    return x


def _chain_250(z: torch.Tensor):
    """Shared prefix of the p-5/8 and p-2 addition chains: (z^11, z^(2^250-1))."""
    z2 = fe_square(z)
    z8 = fe_square(fe_square(z2))
    z9 = fe_mul(z8, z)
    z11 = fe_mul(z9, z2)
    z_5_0 = fe_mul(fe_square(z11), z9)  # 2^5 - 1
    z_10_0 = fe_mul(_pow2k(z_5_0, 5), z_5_0)
    z_20_0 = fe_mul(_pow2k(z_10_0, 10), z_10_0)
    z_40_0 = fe_mul(_pow2k(z_20_0, 20), z_20_0)
    z_50_0 = fe_mul(_pow2k(z_40_0, 10), z_10_0)
    z_100_0 = fe_mul(_pow2k(z_50_0, 50), z_50_0)
    z_200_0 = fe_mul(_pow2k(z_100_0, 100), z_100_0)
    z_250_0 = fe_mul(_pow2k(z_200_0, 50), z_50_0)
    return z11, z_250_0


def fe_pow_p58(z: torch.Tensor) -> torch.Tensor:
    """z^((p-5)/8) = z^(2^252 - 3)."""
    _, z_250_0 = _chain_250(z)
    return fe_mul(_pow2k(z_250_0, 2), z)


def fe_invert(z: torch.Tensor) -> torch.Tensor:
    """z^(p-2) = z^(2^255 - 21)."""
    z11, z_250_0 = _chain_250(z)
    return fe_mul(_pow2k(z_250_0, 5), z11)
