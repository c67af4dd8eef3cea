"""The sampling kernel's momentum and Metropolis noise, frozen.

Philox4x32-10 (Salmon et al., SC 2011) with the kernel's documented word
layout: iteration `it` of chain `c` under seed `s` draws ceil((2·dim + 1)
/ 4) groups of four words, group g from the counter (it, g, 0, 0) and the
key (s mod 2³², c).  Words become uniforms in (0, 1) by the exponent trick;
the first 2·dim make dim normals by Box-Muller (pairs (u₀, u₁), (u₂, u₃),
...), the next is the Metropolis uniform.  The normals are formed here in
float64 from the same float32 uniforms.
"""

from __future__ import annotations

import math

import torch

MASK = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85


def _mulhilo(m: int, a: torch.Tensor):
    """(hi, lo) 32-bit halves of m·a for uint32 values held in int64."""
    x = (a >> 16) * m
    y = (a & 0xFFFF) * m
    s = y + ((x & 0xFFFF) << 16)
    return (x >> 16) + (s >> 32), s & MASK


def philox4x32(c0, c1, c2, c3, k0, k1):
    """Ten rounds of Philox4x32 on int64 tensors holding uint32 values."""
    for r in range(10):
        if r:
            k0 = (k0 + _W0) & MASK
            k1 = (k1 + _W1) & MASK
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def uniforms(bits: torch.Tensor) -> torch.Tensor:
    """uint32 words (in int64) -> float32 uniforms in (0, 1)."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return (f - 1.0) + 1.1920929e-7


def noise(seed: int, it: int, dim: int, chains: torch.Tensor):
    """(momenta (len(chains), dim) float64, uniforms (len(chains),)
    float64) of iteration `it` for the chain indices `chains`."""
    chain = chains.to(torch.int64)[None, :]
    groups = (2 * dim + 4) // 4
    grp = torch.arange(groups, dtype=torch.int64, device=chain.device)[:, None]
    zero = torch.zeros_like(grp)
    words = torch.stack(philox4x32(zero + it, grp, zero, zero,
                                   seed & MASK, chain), dim=1)
    u = uniforms(words.reshape(4 * groups, -1)[:2 * dim + 1]).double()
    p = torch.sqrt(-2.0 * torch.log(u[0:2 * dim:2])) * torch.cos(
        2.0 * math.pi * u[1:2 * dim:2])
    return p.T.contiguous(), u[2 * dim]
