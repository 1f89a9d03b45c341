"""Input / output of the port: checkpoints of solver state (NumPy)."""

from tpufem_torch.io.checkpoint import load_checkpoint, save_checkpoint

__all__ = ["load_checkpoint", "save_checkpoint"]
