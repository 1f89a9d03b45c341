"""Row-sharded structured 2D solve across devices: not ported yet."""


class DistStructuredGrid2D:
    """The reference's row-sharded lattice (``tpufem/structured/dist2d.py``)
    has no port yet; constructing it raises."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "DistStructuredGrid2D is not ported (ROADMAP.md Q1 item 6, "
            "distribution: structured/dist2d.py over torch.distributed)")
