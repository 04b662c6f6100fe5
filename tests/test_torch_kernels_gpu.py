"""The port's CUDA kernels against their plain PyTorch versions on a card.

Imports only torch and the port, so it runs on a machine without JAX:
    python -m pytest -m gpu tests/test_torch_kernels_gpu.py
Every test skips where there is no CUDA device.

Tolerances: RMSNorm in bf16 one bf16 ulp (2**-7 relative; both round the
same f32 value up to its last bits), in f32 1e-5 relative. Varlen
attention O in bf16 2e-2 absolute (the kernel rounds P to bf16 before the
PV product, as the TPU kernel does; the dense plain version does not), in
f32 1e-4; LSE 1e-3 absolute.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.kernels import rms_norm as TR
from paddle_tpu_torch.ops.kernels import varlen_attention as TV

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernels run only on a card")
    return torch.device("cuda")


@pytest.mark.parametrize("h", [2048, 64, 8192])
@pytest.mark.parametrize("rows", [256, 8, 3])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rms_norm_kernel_matches_plain(rows, h, dtype, cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(rows + h)
    x = (torch.randn(rows, h, device=cuda_device, generator=gen) * 3) \
        .to(dtype)
    w = torch.randn(h, device=cuda_device, generator=gen).to(dtype)
    before = TR.launches
    for weight in (w, None):
        got = TR.rms_norm(x, weight)
        ref = TR._rms_norm_ref(x, weight, 1e-6)
        rel = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
        assert bool(((got.float() - ref.float()).abs()
                     <= rel * ref.float().abs() + 1e-6).all())
    torch.cuda.synchronize()
    assert TR.launches == before + 2


def test_rms_norm_kernel_rejects_what_it_cannot_take(cuda_device):
    x = torch.ones(4, 100, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        TR.rms_norm(x)                     # 100 is not a multiple of 8
    with pytest.raises(TypeError):
        TR.rms_norm(torch.ones(4, 64, device=cuda_device,
                               dtype=torch.float16))


def _segments(lens, total, device):
    cu = np.concatenate([[0], np.cumsum(lens)])
    return torch.tensor(TV.segment_ids_from_cu_seqlens(cu, total),
                        device=device)[None]


@pytest.mark.parametrize("d", [128, 64])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("lens,total", [([90, 60, 70], 256),
                                        ([120, 50, 30], 200),
                                        ([17, 200, 30, 5], 384),
                                        ([3], 5)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_varlen_kernel_matches_plain(lens, total, causal, d, dtype,
                                     cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(total + d)
    seg = _segments(lens, total, cuda_device)
    q, k, v = [torch.randn(1, h, total, d, device=cuda_device,
                           generator=gen).to(dtype) for h in (16, 8, 8)]
    before = TV.launches
    o, lse = TV.varlen_flash_attention_packed(q, k, v, seg, seg, causal)
    o2, lse2 = TV._varlen_ref(q, k, v, seg, seg, causal)
    torch.cuda.synchronize()
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    assert float((o.float() - o2.float()).abs().max()) <= tol
    assert float((lse - lse2).abs().max()) <= 1e-3
    assert bool(torch.isfinite(o.float()).all())
    assert TV.launches == before + 1


def test_varlen_kernel_fully_masked_query_segment(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    seg = _segments([60, 70, 100], 256, cuda_device)
    segk = seg.clone()
    segk[segk == 1] = 9
    q, k, v = [torch.randn(1, 4, 256, 128, device=cuda_device,
                           generator=gen) for _ in range(3)]
    o, lse = TV.varlen_flash_attention_packed(q, k, v, seg, segk, True)
    o2, lse2 = TV._varlen_ref(q, k, v, seg, segk, True)
    torch.cuda.synchronize()
    assert float((o - o2).abs().max()) <= 1e-4
    assert float((lse - lse2).abs().max()) <= 1e-3
