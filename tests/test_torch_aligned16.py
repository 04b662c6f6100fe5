"""The kernel wrappers' copy of an input that does not start on a 16-byte
boundary (paddle_tpu_torch.ops.kernels._build.aligned16): the bf16
attention kernels and RMSNorm read their tiles with 16-byte loads, and the
reference takes an array at any address. Checked here on CPU tensors (the
function reads only the data pointer); the kernels' side runs in
tests/test_torch_kernels_gpu.py on a card."""
import pytest
import torch

from paddle_tpu_torch import launch_counts, reset_launch_counts
from paddle_tpu_torch.ops.kernels import _build


@pytest.mark.parametrize("dtype,offset", [(torch.bfloat16, 4),
                                          (torch.bfloat16, 1),
                                          (torch.float32, 2)])
def test_offset_view_is_copied_aligned_and_counted(dtype, offset):
    buf = torch.arange(2 * 64 * 8 + offset).to(dtype)
    view = buf[offset:].view(2, 64, 8)
    assert view.data_ptr() % 16 != 0
    reset_launch_counts()
    got = _build.aligned16(view)
    assert got.data_ptr() % 16 == 0 and got.is_contiguous()
    assert got.data_ptr() != view.data_ptr()
    assert got.dtype == dtype and torch.equal(got, view)
    assert launch_counts()["aligned16_copies"] == 1
    reset_launch_counts()
    assert launch_counts()["aligned16_copies"] == 0


def test_aligned_input_and_none_pass_through_uncounted():
    t = torch.zeros(4, 64, dtype=torch.bfloat16)
    assert t.data_ptr() % 16 == 0
    reset_launch_counts()
    assert _build.aligned16(t) is t
    assert _build.aligned16(None) is None
    assert launch_counts()["aligned16_copies"] == 0
