"""``python -m tpufem_torch`` -- see tpufem_torch/cli.py."""

import sys

from tpufem_torch.cli import main

sys.exit(main())
