"""Built-in `MemoryPolicy` implementations, one module per policy.

Importing this package registers every built-in with
`repro_torch.core.policy.POLICY_REGISTRY`; registration order fixes the
order of `simulator.POLICIES` / `ALL_POLICIES` and of every sweep, as in the
reference.
"""
from repro_torch.core.policies import frfcfs    # noqa: F401
from repro_torch.core.policies import atlas     # noqa: F401
from repro_torch.core.policies import parbs     # noqa: F401
from repro_torch.core.policies import tcm       # noqa: F401
from repro_torch.core.policies import sms       # noqa: F401
from repro_torch.core.policies import bliss     # noqa: F401
from repro_torch.core.policies import squash    # noqa: F401
