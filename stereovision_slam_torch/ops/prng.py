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
`split(key, n)` gives key i as the word pair (x0, x1) of counter i, and
`normal` is sqrt(2) erfinv(u) of a uniform u on (-1, 1), as `jax.random`'s
(erfinv is torch's, not XLA's polynomial, so normal draws agree to a few
ulps, not bit for bit). PyTorch has no unsigned 32-bit arithmetic, so the
words live in int64 tensors masked to 32 bits. A key is a seed (an int, or
a 0-d integer tensor on the device, which a captured CUDA graph then reads
at every replay), standing for `PRNGKey(seed)` = (0, seed), or a word pair
(k0, k1) of ints.
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


def _key(key) -> tuple:
    """The word pair of a key: (0, seed) for a seed, else the pair."""
    if torch.is_tensor(key) and key.dim() == 0:
        return (0, key.to(torch.int64) & _MASK)
    if np.ndim(key) == 0:
        return (0, int(key) & _MASK)
    return (int(key[0]) & _MASK, int(key[1]) & _MASK)


def _counter_words(key, n: int, device):
    """Threefry of the counters 0 .. n-1 under `key`: (x0, x1)."""
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return threefry2x32(_key(key), idx >> 32, idx & _MASK)


def split(key, num: int = 2) -> list[tuple[int, int]]:
    """`jax.random.split(key, num)` (the partitionable Threefry): key i is
    the word pair of counter i."""
    x0, x1 = _counter_words(key, num, "cpu")
    return list(zip(x0.tolist(), x1.tolist()))


def random_bits(key_int, shape, device="cpu") -> torch.Tensor:
    """The 32 random bits of each element of `jax.random.bits(key,
    shape)`, as int64; `key_int` a key (see the module docstring)."""
    x0, x1 = _counter_words(key_int, int(np.prod(shape)), device)
    return (x0 ^ x1).reshape(tuple(shape))


def uniform(key_int, shape, minval: float = 0.0, maxval: float = 1.0,
            device="cpu") -> torch.Tensor:
    """float32 draws equal bit for bit to `jax.random.uniform(
    jax.random.PRNGKey(key_int), shape, jnp.float32, minval, maxval)` (or
    under the key pair `key_int`)."""
    bits = random_bits(key_int, shape, device)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.full((), minval, dtype=torch.float32, device=device)
    hi = torch.full((), maxval, dtype=torch.float32, device=device)
    return torch.maximum(lo, f * (hi - lo) + lo)


def normal(key, shape, device="cpu") -> torch.Tensor:
    """float32 draws of `jax.random.normal(key, shape)`: sqrt(2) erfinv(u)
    of u uniform on (nextafter(-1, 0), 1)."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(key, shape, lo, 1.0, device=device)
    return torch.full((), float(np.float32(np.sqrt(2.0))), dtype=torch.float32,
                      device=device) * torch.erfinv(u)
