"""Built-in `MemoryPolicy` implementations, one module per policy.

Importing this package registers every built-in the port has with
`repro_torch.core.policy.POLICY_REGISTRY`; registration order fixes the
order of `simulator.POLICIES` / `ALL_POLICIES`, as in the reference. The
other baselines (atlas, parbs, tcm, bliss, squash_prio) come with slice B.
"""
from repro_torch.core.policies import frfcfs    # noqa: F401
from repro_torch.core.policies import sms       # noqa: F401
