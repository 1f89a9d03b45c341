"""Input / output of the port, all pure NumPy: VTU and XDMF field output
(the reference's output phase), HDF5 heavy data without h5py, and
checkpoints of solver state."""

from tpufem_torch.io.checkpoint import load_checkpoint, save_checkpoint
from tpufem_torch.io.hdf5 import read_hdf5, write_hdf5
from tpufem_torch.io.vtk import write_vtu
from tpufem_torch.io.xdmf import read_xdmf, write_xdmf

__all__ = ["write_vtu", "write_xdmf", "read_xdmf", "write_hdf5",
           "read_hdf5", "save_checkpoint", "load_checkpoint"]
