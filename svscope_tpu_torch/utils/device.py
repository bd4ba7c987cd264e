"""Device and dtype resolution for the port (counterpart of utils/jaxcfg.py).

Every public entry point takes an explicit `device`; `resolve_device` turns
a name into a `torch.device` and refuses to pretend: asking for CUDA on a
host without it raises instead of quietly running on the CPU.
"""
from __future__ import annotations

import torch

DTYPES = {"float32": torch.float32, "float64": torch.float64}


def resolve_device(name="cuda") -> torch.device:
    """`torch.device` for `name` ("cuda", "cuda:0", "cpu" or a device).

    Raises RuntimeError when CUDA is asked for and absent.  On CUDA, TF32 is
    switched off for matmuls and cuDNN: the EM's float32 products
    (models/mixture.py) must stay full precision — the segment softmax
    compares values against a -1e30 sentinel, and a reduced-precision
    product there turns the sentinel into inf and the segment sums into
    NaN (see the note in svscope_tpu/models/mixture.py's e_step)."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {name!r} requested but CUDA is not "
                               "available on this host")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {name!r} (cuda or cpu)")
    return dev


def resolve_dtype(dtype) -> torch.dtype:
    """torch dtype from None (float32), a name, or a torch dtype."""
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        if dtype not in DTYPES.values():
            raise ValueError(f"unsupported EM dtype {dtype}")
        return dtype
    if dtype not in DTYPES:
        raise ValueError(f"unsupported EM dtype {dtype!r} "
                         f"(one of {sorted(DTYPES)})")
    return DTYPES[dtype]
