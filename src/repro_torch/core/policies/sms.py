"""SMS and SMS-DASH as registered `MemoryPolicy` objects.

The staged machinery lives in `repro_torch.core.sms`; this module binds it
to the protocol. SMS-DASH is a knob-point variant — the same stages, with
the deadline-aware stage-2 preemption pinned on by `configure_knobs` (the
`dash` value knob); `configure` stays the identity.
"""
from __future__ import annotations

import torch

from repro_torch.core import policy, sms as sms_lib


@policy.register
class SMS:
    name = "sms"
    variant_of = None
    # staged FIFO/DCS state shares nothing with the centralized buffer
    stackable = False

    def configure(self, cfg):
        return cfg

    def init_state(self, cfg, W, device):
        return sms_lib.sms_state(cfg, W, device)

    def tick(self, cfg, pool, st, sched, t):
        st, sched = sms_lib.stage1_admit(cfg, st, sched, t)
        st, sched = sms_lib.stage2_drain(cfg, pool, st, sched, t)
        return st, sched

    def select(self, cfg, pool, st, sched, dram, t):
        return sms_lib.stage3_issue(cfg, st, sched, dram, t)

    # -- variable-step driver witness (see `policy.make_skip_step`) ---------
    def next_event(self, cfg, pool, st, sched, dram, t):
        return sms_lib.next_stage_event(cfg, st, sched, dram, t)

    def on_skip(self, cfg, sched, k):
        return sms_lib.skip_cycles(sched, k)

    # -- invariant-sanitizer hooks (repro_torch.core.validate) --------------
    def queued_requests(self, cfg, sched):
        held = lambda x: torch.sum(x.flatten(1), dim=-1, dtype=torch.int32)
        return held(sched["f_len"]) + held(sched["d_len"])

    def check_invariants(self, cfg, pool, st, sched, t):
        return sms_lib.check_invariants(cfg, sched, t)

    def audit_skip(self, cfg, pool, st, sched, dram, t, t_new):
        return sms_lib.audit_skip(cfg, st, sched, dram, t, t_new)


@policy.register
class SMSDash(SMS):
    name = "sms_dash"
    variant_of = "sms"

    def configure_knobs(self, knobs):
        # SMS + deadline-aware stage 2: dash pinned True for this entry
        return knobs.replace(dash=True)
