"""Three-term roofline model of one NVIDIA H100 SXM, and the per-chip cost
counter that feeds it.

Port of ``repro/roofline/analysis.py``, which holds TPU v5e constants; the
port's come from NVIDIA's H100 SXM data sheet (dense rates, no sparsity, at
the full 700 W power limit). The link rate is the slowest link the
``(16, 16)`` mesh crosses on H100 machines: its ``model`` axis of 16 spans
two 8-GPU nodes, whose GPUs meet over InfiniBand NDR at 400 Gb/s, 50 GB/s
per GPU (NVIDIA's DGX H100 reference architecture: one 400 Gb/s ConnectX-7
port per GPU); NVLink inside a node (450 GB/s each way) is faster.

  compute term    = FLOPs / peak bf16 FLOP/s             (per chip, seconds)
  memory term     = bytes / HBM rate                     (per chip, seconds)
  collective term = collective bytes / link rate         (per chip, seconds)

The reference reads FLOPs and bytes from XLA's ``cost_analysis`` of the
partitioned program and the collective bytes from its HLO text. The port
counts them with ``CostCounter``, a ``TorchDispatchMode`` beneath DTensor's
dispatch that sees rank 0's *local* ops (the per-chip work) as they run on
meta tensors: FLOPs by ``torch.utils.flop_counter``'s formulas, bytes as
the operands plus the results of every op that is not a view, and the
output bytes of every collective by kind. Its bytes count each op unfused,
so the memory term is an upper bound beside XLA's fused count.
"""
from __future__ import annotations

import weakref
from typing import Dict, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

HBM_BYTES_PER_S = 3.35e12        # HBM3
F32_FLOPS_PER_S = 67e12          # float32 outside the tensor cores
TF32_FLOPS_PER_S = 495e12        # TF32 dense tensor cores
BF16_FLOPS_PER_S = 989e12        # bf16 dense tensor cores
LINK_BYTES_PER_S = 50e9          # InfiniBand NDR, 400 Gb/s per GPU

PEAK_FLOPS = BF16_FLOPS_PER_S
HBM_BW = HBM_BYTES_PER_S
LINK_BW = LINK_BYTES_PER_S


def bound_ms(n_bytes: float, n_flops: float,
             flops_per_s: float) -> Tuple[float, str]:
    """The least time the card could take for work that moves ``n_bytes``
    and does ``n_flops`` at ``flops_per_s``: (ms, "bytes" | "operations")."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def roofline_terms(flops: float, bytes_accessed: float,
                   coll_bytes: float) -> Dict[str, float]:
    compute_s = flops / PEAK_FLOPS
    memory_s = bytes_accessed / HBM_BW
    collective_s = coll_bytes / LINK_BW
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    dom = max(terms, key=terms.get)
    bound = {"compute_s": "compute", "memory_s": "memory",
             "collective_s": "collective"}[dom]
    total = max(compute_s, memory_s, collective_s)
    terms.update({
        "bottleneck": bound,
        "step_time_lower_bound_s": total,
        # fraction of the step the *compute* roofline would occupy if the
        # dominant term were fully overlapped == achievable MFU bound
        "roofline_fraction": compute_s / total if total > 0 else 0.0,
    })
    return terms


def model_flops(n_params: int, n_tokens: int, kind: str = "train") -> float:
    """6·N·D for train (fwd+bwd), 2·N·D for inference forward."""
    mult = 6.0 if kind == "train" else 2.0
    return mult * n_params * n_tokens


# ---------------------------------------------------------------------------
# the per-chip cost counter
# ---------------------------------------------------------------------------

# a collective's kind, as the reference names them, by its op's name
_KINDS = (("all_reduce", "all-reduce"), ("all_gather", "all-gather"),
          ("reduce_scatter", "reduce-scatter"), ("all_to_all", "all-to-all"),
          ("broadcast", "broadcast"))
# bookkeeping ops of the functional collectives: no data moves
_SKIP = ("wait_tensor", "_wrap_tensor_autograd")


def _kind(op: str, args) -> str:
    kind = next(k for key, k in _KINDS if key in op)
    if kind == "all-to-all" and sum(1 for n in args[2] if n) == 1:
        return "collective-permute"     # each rank sends to one peer
    return kind


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for e in x:
            yield from _tensors(e)
    elif isinstance(x, dict):
        for e in x.values():
            yield from _tensors(e)


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(x))


def _fake_active() -> bool:
    """DTensor runs each op once on fake tensors of the global shapes to
    learn the output's metadata; that is not the chip's work."""
    return torch._C._get_dispatch_mode(
        torch._C._TorchDispatchModeKey.FAKE) is not None


class CostCounter(TorchDispatchMode):
    """Counts the work of the ops that run while it is active: FLOPs,
    bytes (operands + results of every op that is not a view), collective
    bytes and ops by kind, and the peak bytes of the tensors the ops made
    that were alive at once (``peak_temp_bytes``). Under DTensor it sees
    each rank-0 local op (the DTensor-level op is passed on)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.coll: Dict[str, int] = {}
        self.n_by_kind: Dict[str, int] = {}
        self.n_coll = 0
        self.n_ops = 0
        self._live = 0
        self.peak_temp_bytes = 0

    def _free(self, n: int) -> None:
        self._live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if _fake_active():
            return out
        name = func.name()
        ns, op = name.split("::")
        if any(s in op for s in _SKIP):
            return out
        if ns == "_c10d_functional":
            kind = _kind(op, args)
            n = _nbytes(out)
            self.coll[kind] = self.coll.get(kind, 0) + n
            self.n_by_kind[kind] = self.n_by_kind.get(kind, 0) + 1
            self.n_coll += 1
            return out
        self.n_ops += 1
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
        aliases = [r.alias_info for r in func._schema.returns]
        if any(a is not None and not a.is_write for a in aliases):
            return out                      # a view: no data moves
        self.bytes += _nbytes(args) + _nbytes(kwargs) + _nbytes(out)
        if not any(a is not None for a in aliases):
            for t in _tensors(out):         # a new tensor
                n = t.numel() * t.element_size()
                self._live += n
                self.peak_temp_bytes = max(self.peak_temp_bytes, self._live)
                weakref.finalize(t, self._free, n)
        return out

    def record(self) -> Dict[str, object]:
        return {"flops": float(self.flops), "bytes accessed": float(self.bytes),
                "collective_bytes": dict(self.coll),
                "n_collective_ops": self.n_coll, "n_ops": self.n_ops,
                "peak_temp_bytes": self.peak_temp_bytes}
