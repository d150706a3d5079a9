"""Re-entrant pseudo-random number generator, bit-exact with the reference.

The reference vendors glibc-2.23's additive-feedback generator
(libpll `src/random.c`, BSD licensed) so that a given seed produces the same
taxon insertion order on every platform. The stepwise-addition parsimony tree
builder seeds it via ``initstate_r(seed, 128-byte state)`` + ``srandom_r``
(`src/stepwise.c:49-96`), which selects the TYPE_3 trinomial
x**31 + x**3 + 1 with a 31-word state table.

This is an independent re-implementation of that (well documented) algorithm
operating on unsigned 32-bit arithmetic; parity with the reference is enforced
by tests against the compiled oracle.

Counterpart: ``libpll_tpu/utils/rng.py``, copied (pure Python; the streams
are the same for every seed).
"""

from __future__ import annotations

_M32 = 0xFFFFFFFF
RAND_MAX = 0x7FFFFFFF

# (degree, separation) per generator type; index = type.
_TYPES = {
    0: (0, 0),  # TYPE_0: pure LCG, no state table
    1: (7, 3),  # x**7 + x**3 + 1
    2: (15, 1),  # x**15 + x + 1
    3: (31, 3),  # x**31 + x**3 + 1   <- the one stepwise addition uses
    4: (63, 1),  # x**63 + x + 1
}

_BREAKS = [(256, 4), (128, 3), (64, 2), (32, 1), (8, 0)]


def _type_for_state_bytes(n: int) -> int:
    for brk, typ in _BREAKS:
        if n >= brk:
            return typ
    raise ValueError(f"state size {n} too small (need >= 8 bytes)")


class GlibcRandom:
    """Additive-feedback PRNG equivalent to glibc ``random_r``.

    ``GlibcRandom(seed)`` reproduces the reference's
    ``initstate_r(seed, buf, 128) ; srandom_r(seed, buf)`` sequence
    (`src/stepwise.c:70-75`) and then yields the identical stream of 31-bit
    integers via :meth:`next`.
    """

    def __init__(self, seed: int, state_bytes: int = 128):
        self.rand_type = _type_for_state_bytes(state_bytes)
        self.rand_deg, self.rand_sep = _TYPES[self.rand_type]
        self.state = [0] * max(self.rand_deg, 1)
        self.fidx = 0
        self.ridx = 0
        self.srandom(seed)

    def srandom(self, seed: int) -> None:
        seed &= _M32
        if seed == 0:
            seed = 1
        self.state[0] = seed
        if self.rand_type == 0:
            return
        # Park-Miller minimal standard LCG seeds the state table, computed
        # via Schrage's method exactly like the reference to keep identical
        # intermediate truncation (C division truncates toward zero).
        word = seed if seed <= RAND_MAX else seed - 0x100000000  # as int32
        for i in range(1, self.rand_deg):
            hi = int(word / 127773) if word < 0 else word // 127773
            lo = word - hi * 127773
            word = 16807 * lo - 2836 * hi
            if word < 0:
                word += 2147483647
            self.state[i] = word
        self.fidx = self.rand_sep
        self.ridx = 0
        for _ in range(self.rand_deg * 10):
            self.next()

    def next(self) -> int:
        """Return the next 31-bit pseudo-random integer."""
        if self.rand_type == 0:
            val = (self.state[0] * 1103515245 + 12345) & RAND_MAX
            self.state[0] = val
            return val
        st = self.state
        val = (st[self.fidx] + st[self.ridx]) & _M32
        st[self.fidx] = val
        result = (val >> 1) & RAND_MAX
        self.fidx += 1
        if self.fidx >= self.rand_deg:
            self.fidx = 0
            self.ridx += 1
        else:
            self.ridx += 1
            if self.ridx >= self.rand_deg:
                self.ridx = 0
        return result


def shuffled_order(n: int, seed: int) -> list[int]:
    """Deterministic Fisher-Yates shuffle of ``range(n)``.

    Bit-exact with the reference's taxon shuffling for stepwise addition
    (`src/stepwise.c:49-96`): seed 0 means "do not shuffle".
    """
    x = list(range(n))
    if not seed:
        return x
    rng = GlibcRandom(seed)
    if n > 1:
        for i in range(n - 1, -1, -1):
            r = rng.next() / RAND_MAX
            j = int(r * (i + 1))
            x[i], x[j] = x[j], x[i]
            if i == 0:
                break
    return x
