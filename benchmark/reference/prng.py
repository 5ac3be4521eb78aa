"""The counterpart of what the JAX package uses of ``jax.random``.

JAX's default generator is threefry2x32 (``jax_default_prng_impl``), with
``jax_threefry_partitionable`` on and 64-bit types off, as JAX 0.9 ships
it. Every draw here reproduces that generator's bits, so one seed gives the
port and the JAX package one random start:

- a key is a ``torch.int64`` tensor of shape ``(2,)`` (``(n, 2)`` after
  :func:`split`) holding two uint32 words, so
  ``torch.as_tensor(np.asarray(jax_key).astype(np.int64))`` carries a JAX
  key across unchanged;
- the uint32 arithmetic runs in int64 masked to 32 bits (torch's
  ``uint32`` has few operations; a word shifted by at most 29 bits fits);
- :func:`uniform` and :func:`randint` are bit-equal to JAX's;
  :func:`normal` is ``√2·erfinv(u)`` on JAX's own uniforms with the float32
  polynomial XLA uses for ``erfinv`` (Giles), within a few ulp of JAX's
  (``torch.erfinv`` is not that polynomial and lands up to ~90 ulp away).

Every function computes on the key's device. The package's call sites keep
keys on the CPU and move the draw, so a run on the card starts from the
CPU run's bits.
"""

from __future__ import annotations

import math

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))  # jax/_src/prng.py:895
_PARITY = 0x1BD11BDA


def PRNGKey(seed: int) -> torch.Tensor:
    """The key of an integer seed, as ``jax.random.PRNGKey`` gives it with
    64-bit types off: ``[0, seed mod 2³²]``."""
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64)


def key_or_default(key: torch.Tensor | None) -> torch.Tensor:
    """``key``, or ``PRNGKey(0)`` when None: the default of every seeded
    function of the JAX package."""
    return PRNGKey(0) if key is None else key


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & _MASK


def _threefry2x32(k1, k2, x1: torch.Tensor, x2: torch.Tensor):
    """The Threefry-2x32 block cipher (20 rounds) of the word pairs
    (x1, x2) under the key (k1, k2); all uint32 values held in int64."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & _MASK
    x2 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x1, x2


def _hash_iota(key: torch.Tensor, shape: tuple[int, ...]):
    """threefry2x32 of the row-major 64-bit counter over ``shape`` (its high
    and low words), as ``iota_2x32_shape`` feeds it in the partitionable
    mode."""
    n = math.prod(shape)
    counts = torch.arange(n, dtype=torch.int64, device=key.device)
    b1, b2 = _threefry2x32(key[0], key[1], counts >> 32, counts & _MASK)
    return b1.reshape(shape), b2.reshape(shape)


def _check_key(key: torch.Tensor) -> None:
    if key.shape != (2,) or key.dtype != torch.int64:
        raise TypeError(f"expected one key, an int64 tensor of shape (2,); got "
                        f"{key.dtype} of shape {tuple(key.shape)}")


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``num`` new keys from ``key``, shape (num, 2) (``jax.random.split``)."""
    _check_key(key)
    b1, b2 = _hash_iota(key, (num,))
    return torch.stack([b1, b2], dim=-1)


def _random_bits(key: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """32 random bits per element (``_threefry_random_bits_partitionable``)."""
    _check_key(key)
    b1, b2 = _hash_iota(key, tuple(shape))
    return b1 ^ b2


def uniform(key: torch.Tensor, shape=(), dtype: torch.dtype = torch.float32,
            minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """Uniform float32 draws in [minval, maxval) (``jax.random.uniform``):
    23 random mantissa bits under the exponent of 1.0, minus 1, scaled and
    shifted by one fused multiply-add, then no lower than ``minval``."""
    if dtype != torch.float32:
        raise TypeError(f"uniform: only float32 is supported, got {dtype}")
    shape = tuple(shape)
    bits = _random_bits(key, shape)
    one = 0x3F800000  # the bits of 1.0f
    floats = ((bits >> 9) | one).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    return torch.maximum(lo, _fma(floats, hi - lo, lo))


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a·b + c rounded once, as XLA's CPU code contracts it. The
    product of two float32 is exact in float64, and so is the sum wherever
    a·b and c are within 2²⁹ of each other's scale, as in every use here."""
    return (a.double() * b.double() + c.double()).float()


# Giles' single-precision erfinv ("Approximating the erfinv function", GPU
# Computing Gems, 2010), in the form XLA lowers ``erf_inv`` to for float32.
_ERFINV_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                  0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
                  1.50140941)
_ERFINV_W_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                  0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
                  2.83297682)


def _erfinv(x: torch.Tensor) -> torch.Tensor:
    """float32 erfinv: a degree-8 polynomial in w − 2.5 (w < 5) or √w − 3,
    w = −log1p(−x²), by Horner steps fused as XLA fuses them, times x; ±1
    map to ±inf."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = None
    for a, b in zip(_ERFINV_W_LT_5, _ERFINV_W_GE_5):
        c = torch.where(lt, torch.tensor(a, dtype=torch.float32, device=x.device),
                        torch.tensor(b, dtype=torch.float32, device=x.device))
        p = c if p is None else _fma(p, w, c)
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def normal(key: torch.Tensor, shape=(), dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Standard normal float32 draws (``jax.random.normal``): √2·erfinv of a
    uniform on (nextafter(−1, 0), 1)."""
    if dtype != torch.float32:
        raise TypeError(f"normal: only float32 is supported, got {dtype}")
    lo = float(torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)))
    u = uniform(key, shape, torch.float32, lo, 1.0)
    return torch.tensor(math.sqrt(2), dtype=torch.float32, device=key.device) * _erfinv(u)


def randint(key: torch.Tensor, shape, minval: int, maxval: int) -> torch.Tensor:
    """int32 draws in [minval, maxval) (``jax.random.randint``): two 32-bit
    draws from the key's two halves, reduced modulo the span in uint32
    arithmetic (a span ≤ 0 returns ``minval``)."""
    if not (-2 ** 31 <= minval < 2 ** 31 and -2 ** 31 <= maxval < 2 ** 31):
        raise ValueError(f"randint: bounds must be int32, got [{minval}, {maxval})")
    shape = tuple(shape)
    k1, k2 = split(key)
    higher, lower = _random_bits(k1, shape), _random_bits(k2, shape)
    span = (maxval - minval) & _MASK if maxval > minval else 1
    # 2³² mod span as JAX computes it in uint32: the square wraps at 2³²
    # (to 0 for a span above 2¹⁶), and so does the product below, split
    # in 16-bit halves so that its int64 cannot overflow.
    multiplier = ((2 ** 16 % span) ** 2 & _MASK) % span
    a = higher % span
    prod = (a * (multiplier & 0xFFFF) + (((a * (multiplier >> 16)) & 0xFFFF) << 16)) & _MASK
    offset = ((prod + lower % span) & _MASK) % span
    out = (minval + offset) & _MASK
    return torch.where(out >= 2 ** 31, out - 2 ** 32, out).to(torch.int32)
