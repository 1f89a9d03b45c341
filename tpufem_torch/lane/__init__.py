"""Lane-partitioned unstructured FEM engine.

The 128 columns of every (R, 128) state array are treated as 128
micro-partitions of the mesh (the same owner/ghost construction as a
device-level partition, one level down), so every irregular access is a
row offset inside one bin window of one column. On the GPU the columns
map to the threads of a block: index reads, value reads and writes are
coalesced along the 128 columns, and a scatter needs no atomics because
a thread owns its column (``tpufem_torch/csrc/``).
"""

from tpufem_torch.lane.plan import LanePlan, build_lane_plan
from tpufem_torch.lane.engine import LaneEngine

__all__ = ["LanePlan", "build_lane_plan", "LaneEngine"]
