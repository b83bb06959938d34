"""Plain PyTorch version of the chunkwise mLSTM scan: the model's own chunk
scan (``models/xlstm.mlstm_chunk_scan``) from a zero state, as the JAX
package's oracle wraps its model's."""
from __future__ import annotations

import torch

from repro_torch.models.xlstm import MMIN, mlstm_chunk_scan


def mlstm_scan_ref(q, k, v, lf, li, chunk: int = 128):
    """q,k,v: (B,H,S,dh); lf,li: (B,H,S). Zero initial state. Returns
    (B,H,S,dh) in q's dtype; the math is float32."""
    B, H, S, dh = q.shape
    f32 = dict(dtype=torch.float32, device=q.device)
    s0 = (torch.zeros((B, H, dh, dh), **f32), torch.zeros((B, H, dh), **f32),
          torch.full((B, H), MMIN, **f32))
    h, _ = mlstm_chunk_scan(q.float(), k.float(), v.float(), lf.float(),
                            li.float(), s0, chunk=chunk)
    return h.to(q.dtype)
