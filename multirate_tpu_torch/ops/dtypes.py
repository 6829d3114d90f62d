"""The JAX package's type promotion, kept as the port's own copy.

A block's output type is JAX's ``_out_dtype`` (``multirate_tpu/ops/
compute.py:59-71``): ``jnp.promote_types(taps, signal)`` with
``jax_enable_x64`` on, and float32 where that gives bfloat16. JAX promotes
by the least upper bound in its type lattice (int32 with float32 gives
float32, int16 with float16 float16, uint8 with int8 int16, uint64 with
int64 float64). ``torch.promote_types`` agrees wherever it is defined, but
refuses uint16, uint32 and uint64 against most types, so the port keeps
the lattice itself. ``tests/test_torch_signal_types.py`` holds this copy
against ``jnp.promote_types`` over every pair.
"""

from __future__ import annotations

import functools

import torch

__all__ = ["promote_types", "out_dtype", "NARROW", "NARROW_OUT",
           "NARROW_COMPLEX", "INTEGERS", "LATTICE_TYPES", "bits", "word"]

# JAX's lattice (jax._src.dtypes), edges to the next wider types. "i*",
# "f*" and "c*" are its weak (Python scalar) types: a least upper bound
# that lands on one of them is its default type under x64.
_LATTICE = {
    torch.bool: ("i*",),
    "i*": (torch.uint8, torch.int8),
    torch.uint8: (torch.int16, torch.uint16),
    torch.uint16: (torch.int32, torch.uint32),
    torch.uint32: (torch.int64, torch.uint64),
    torch.uint64: ("f*",),
    torch.int8: (torch.int16,),
    torch.int16: (torch.int32,),
    torch.int32: (torch.int64,),
    torch.int64: ("f*",),
    "f*": ("c*", torch.float16, torch.bfloat16),
    torch.float16: (torch.float32,),
    torch.bfloat16: (torch.float32,),
    torch.float32: (torch.float64, torch.complex64),
    torch.float64: (torch.complex128,),
    "c*": (torch.complex64,),
    torch.complex64: (torch.complex128,),
    torch.complex128: (),
}
# the torch types JAX has
LATTICE_TYPES = tuple(t for t in _LATTICE if isinstance(t, torch.dtype))
_WEAK_DEFAULT = {"i*": torch.int64, "f*": torch.float64,
                 "c*": torch.complex128}

# The route sets of ``ops/compute.py``, and of the entry points both
# kernels derive from them. Signal types that the narrow-read entries take
# as they are stored (widened to float32 in the kernel), against float32
# taps, by the short name their entry points derive theirs from; the
# output types those entries store; and the complex tap type they also
# take (complex64 outputs: entry ``<short name>c``, as float32 signals'
# ``f32c`` and float64 ones' ``f64c`` against complex128 taps).
NARROW = {torch.int16: "s16", torch.uint8: "u8", torch.float16: "f16",
          torch.int8: "s8", torch.bfloat16: "bf16"}
NARROW_OUT = (torch.float32, torch.float16)
NARROW_COMPLEX = torch.complex64
# The integer types; the rational family sums an integer output (outside
# the int8 mode) in two's-complement words, ``word``.
INTEGERS = (torch.bool, torch.uint8, torch.uint16, torch.uint32,
            torch.uint64, torch.int8, torch.int16, torch.int32, torch.int64)


@functools.cache
def _upper(t) -> frozenset:
    """Every type at or above ``t`` in the lattice."""
    out = {t}
    for nxt in _LATTICE[t]:
        out |= _upper(nxt)
    return frozenset(out)


@functools.cache
def promote_types(a: torch.dtype, b: torch.dtype) -> torch.dtype:
    """``jnp.promote_types(a, b)`` under x64, for the types both packages
    have (every real and complex type of ``_LATTICE``)."""
    for t in (a, b):
        if t not in _LATTICE:
            raise TypeError(f"{t} has no counterpart in JAX")
    common = _upper(a) & _upper(b)
    least = [t for t in common if _upper(t) == common]
    t = least[0]
    return _WEAK_DEFAULT.get(t, t)


def out_dtype(taps: torch.dtype, signal: torch.dtype) -> torch.dtype:
    """A block's output type: JAX's ``_out_dtype`` (float32 where the
    promotion gives bfloat16)."""
    dt = promote_types(taps, signal)
    return torch.float32 if dt == torch.bfloat16 else dt


def bits(t: torch.dtype) -> int:
    """Bits of an integer type's values (bool: 1)."""
    return 1 if t == torch.bool else t.itemsize * 8


def word(t: torch.dtype) -> torch.dtype:
    """The word an integer output of type ``t`` sums in on the rational
    family's exact route: int32 for 32 bits or fewer, else int64 (the
    polyphase kernel's ``i32`` and ``i64`` entries). Products and sums wrap
    modulo 2^32 or 2^64 and ``t`` keeps their low bits: JAX's wrapped
    sum."""
    return torch.int64 if bits(t) > 32 else torch.int32
