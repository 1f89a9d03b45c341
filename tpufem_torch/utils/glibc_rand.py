"""Bit-exact reimplementation of glibc's rand()/srand().

The reference keys its per-grain Young's moduli off ``srand(6575)`` +
``rand() % 200`` and relies on glibc semantics for cross-implementation
reproducibility — the Python variant even calls libc through ctypes
(``asym_elasto_damage_model_symb_sym.py:213-220``; C++ at
``FEniCSx/mechanic2d/asym_elasto_damage_model.cc:534`` and
``MFEM/...cc:1077``). We reproduce the TYPE_3 additive-feedback
generator (degree 31, separation 3) in pure Python so the E field is
bit-identical to the reference without any libc dependency.
"""

from __future__ import annotations


class GlibcRand:
    """glibc random() TYPE_3 generator (the default for rand())."""

    def __init__(self, seed: int = 1):
        self.srand(seed)

    def srand(self, seed: int) -> None:
        seed = seed & 0xFFFFFFFF
        if seed == 0:
            seed = 1
        r = [0] * 344
        r[0] = seed
        # initial LCG fill: r[i] = 16807 * r[i-1] % 2147483647, computed
        # with the signed-overflow-free Schrage decomposition glibc uses
        for i in range(1, 31):
            hi, lo = divmod(r[i - 1], 127773)
            word = 16807 * lo - 2836 * hi
            if word < 0:
                word += 2147483647
            r[i] = word
        for i in range(31, 34):
            r[i] = r[i - 31]
        # warm-up: discard first 310 outputs
        for i in range(34, 344):
            r[i] = (r[i - 31] + r[i - 3]) & 0xFFFFFFFF
        self._r = r[-31:]  # ring buffer of the last 31 words
        self._idx = 0

    def rand(self) -> int:
        """Next value in [0, 2^31)."""
        r = self._r
        i = self._idx
        new = (r[i % 31] + r[(i + 28) % 31]) & 0xFFFFFFFF
        r[i % 31] = new
        self._idx = (i + 1) % 31
        return new >> 1
