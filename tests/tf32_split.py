"""TF32 splitting as the port's 3xTF32 kernels do it, for the CPU
emulations of their arithmetic (tests/test_torch_mlstm_scan.py,
tests/test_torch_flash_attention.py)."""
import torch


def tf32(x):
    """float32 to the nearest TF32 value (10 mantissa bits, ties away from
    zero), as the kernels round hi: add half of the dropped bits to the
    magnitude, then clear them."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32)


def tf32_read(x):
    """What the tensor core reads of a float32 operand: its top 11
    significant bits (the low 13 bits cleared)."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def mm3(a, b):
    """a @ b as the kernels' tensor cores take it: each float32 operand split
    into hi = tf32(x) and lo = x - hi (read as TF32), lo.hi + hi.lo + hi.hi
    summed in float32 (the products of TF32 values are exact in float32)."""
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32_read(a - ah), tf32_read(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh
