"""Counter-based uniform draws that reproduce `jax.random.uniform` bit for
bit (counterpart of the reference hook's `jax.random.PRNGKey(kf_id)` draws,
slam/fused_loop.py).

JAX's default generator is Threefry-2x32 in its partitionable form: the key
of `PRNGKey(k)` is the word pair (0, k); element i of a draw of `shape`
encrypts the counter pair (hi, lo) of its flat index i with 20 rounds
(rotations 13, 15, 26, 6 and 17, 29, 16, 24, key injection every 4 rounds,
third key word k0 ^ k1 ^ 0x1BD11BDA) and takes x0 ^ x1 as its 32 random
bits. A float32 in [1, 2) is built from the top 23 bits, 1 is subtracted,
and the result is scaled into [minval, maxval) and clamped below at minval.
PyTorch has no unsigned 32-bit arithmetic, so the words live in int64
tensors masked to 32 bits. The key may be a 0-d integer tensor on the
device (a captured CUDA graph then reads it at every replay) or an int.
"""

from __future__ import annotations

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(key: tuple, x0: torch.Tensor, x1: torch.Tensor):
    """Threefry-2x32 (20 rounds) of the counter words x0, x1 (int64 tensors
    holding 32-bit values) under the key words (ints, or 0-d int64
    tensors); returns the two words."""
    ks = (key[0] & _MASK, key[1] & _MASK,
          (key[0] ^ key[1] ^ 0x1BD11BDA) & _MASK)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for block in range(5):
        for r in _ROT[block % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(block + 1) % 3]) & _MASK
        x1 = (x1 + ks[(block + 2) % 3] + block + 1) & _MASK
    return x0, x1


def random_bits(key_int, shape, device="cpu") -> torch.Tensor:
    """The 32 random bits of each element of `jax.random.bits(
    PRNGKey(key_int), shape)`, as int64; `key_int` an int or a 0-d integer
    tensor on `device`."""
    n = int(np.prod(shape))
    idx = torch.arange(n, dtype=torch.int64, device=device)
    hi, lo = idx >> 32, idx & _MASK
    if torch.is_tensor(key_int):
        key = (0, key_int.to(torch.int64) & _MASK)
    else:
        key = (0, int(key_int) & _MASK)
    x0, x1 = threefry2x32(key, hi, lo)
    return (x0 ^ x1).reshape(tuple(shape))


def uniform(key_int, shape, minval: float = 0.0, maxval: float = 1.0,
            device="cpu") -> torch.Tensor:
    """float32 draws equal bit for bit to `jax.random.uniform(
    jax.random.PRNGKey(key_int), shape, jnp.float32, minval, maxval)`."""
    bits = random_bits(key_int, shape, device)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.full((), minval, dtype=torch.float32, device=device)
    hi = torch.full((), maxval, dtype=torch.float32, device=device)
    return torch.maximum(lo, f * (hi - lo) + lo)
