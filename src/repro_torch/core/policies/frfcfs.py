"""FR-FCFS: row hits first, then oldest (Rixner et al.). The baseline the
paper starts from — maximal row-buffer locality, no source awareness, and
therefore the GPU-favoring unfairness of Fig 1. The inherited `score` is
exactly the FR-FCFS base score (no cached priority slot)."""
from __future__ import annotations

from repro_torch.core import policy
from repro_torch.core.schedulers import CentralizedPolicy


@policy.register
class FRFCFS(CentralizedPolicy):
    name = "frfcfs"
