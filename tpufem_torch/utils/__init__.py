"""Utilities: reproducibility helpers, host ops, numpy<->torch hand-over."""

from tpufem_torch.utils.glibc_rand import GlibcRand

__all__ = ["GlibcRand"]
