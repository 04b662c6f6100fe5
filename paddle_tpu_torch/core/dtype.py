"""Dtypes (paddle_tpu/core/dtype.py): Paddle's dtype names over torch dtypes.

``paddle_tpu_torch.float32`` and the rest ARE the torch dtypes, so a
Tensor's ``dtype`` compares equal to them and torch ops take them. Unlike
the TPU package (which runs with JAX's 64-bit types off and stores int64 /
float64 as their 32-bit forms), int64 and float64 are real here.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["float16", "bfloat16", "float32", "float64", "int8", "int16",
           "int32", "int64", "uint8", "bool_", "complex64", "complex128",
           "convert_dtype", "dtype_name", "is_floating_point", "is_integer"]

float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32
float64 = torch.float64
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
uint8 = torch.uint8
bool_ = torch.bool
complex64 = torch.complex64
complex128 = torch.complex128

_NAME_TO_DTYPE = {
    "float16": float16, "bfloat16": bfloat16, "float32": float32,
    "float64": float64, "int8": int8, "int16": int16, "int32": int32,
    "int64": int64, "uint8": uint8, "bool": bool_, "complex64": complex64,
    "complex128": complex128,
    # aliases (core/dtype.py:56-66); "int" is int64 here, as in Paddle
    "fp16": float16, "bf16": bfloat16, "fp32": float32, "fp64": float64,
    "half": float16, "float": float32, "double": float64, "int": int64,
    "long": int64,
}
_DTYPE_TO_NAME = {d: n for n, d in list(_NAME_TO_DTYPE.items())[:12]}


def convert_dtype(dtype):
    """Any dtype spec (a name, a torch dtype, a numpy dtype or scalar type,
    a Python type, None) -> the torch dtype, or None."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        if dtype not in _NAME_TO_DTYPE:
            raise ValueError(f"unknown dtype name: {dtype!r}")
        return _NAME_TO_DTYPE[dtype]
    if dtype is float:
        return float32
    if dtype is int:
        return int64
    if dtype is bool:
        return bool_
    name = np.dtype(dtype).name
    if name not in _NAME_TO_DTYPE:
        raise ValueError(f"no torch dtype for {dtype!r}")
    return _NAME_TO_DTYPE[name]


def dtype_name(dtype) -> str:
    """'float32', 'bfloat16', ... (Paddle's names)."""
    return _DTYPE_TO_NAME[convert_dtype(dtype)]


def is_floating_point(dtype) -> bool:
    return convert_dtype(dtype).is_floating_point


def is_integer(dtype) -> bool:
    d = convert_dtype(dtype)
    return not (d.is_floating_point or d.is_complex or d is bool_)
