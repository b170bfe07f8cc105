"""Host-side layout checks for the kernels that load 16 bytes at a time.

TMA (K3 on Hopper's tensor cores) and 16-byte vector loads (K4) need the
base pointer and every stride but the last, contiguous one to be
multiples of 16 bytes.  :func:`misalignment` is a pure function of a
tensor's pointer, strides and element size, so the CPU tests reach it;
the wrappers raise with its message before any launch.
"""
from __future__ import annotations

from typing import Optional, Sequence

ALIGN = 16  # bytes


def misalignment(name: str, data_ptr: int, strides: Sequence[int],
                 itemsize: int) -> Optional[str]:
    """Why ``name`` cannot be read with 16-byte loads, or None if it can.

    ``strides`` are in elements, the last one the contiguous axis."""
    if data_ptr % ALIGN:
        return f"{name}'s data pointer is not {ALIGN}-byte aligned (address {data_ptr:#x})"
    bad = [s for s in strides[:-1] if (s * itemsize) % ALIGN]
    if bad:
        return (f"{name}'s strides {tuple(strides)} (x {itemsize} bytes) are not all "
                f"multiples of {ALIGN} bytes, as 16-byte loads need")
    return None


def check_aligned(**tensors) -> None:
    """Raise ValueError for the first of ``tensors`` that is misaligned."""
    for name, x in tensors.items():
        err = misalignment(name, x.data_ptr(), x.stride(), x.element_size())
        if err:
            raise ValueError(err)
