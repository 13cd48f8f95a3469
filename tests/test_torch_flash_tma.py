"""Host logic of the tensor-core flash-attention launch, on the CPU.

The kernel itself (``csrc/flash_attention_wgmma.cu``) runs only on the
card, where ``chip_smoke.py`` phase 5 holds it against the plain version.
What surrounds it is Python and is checked here: which kernel serves
which dtype and head_dim, the ``cuTensorMapEncodeTiled`` arguments each
input gets (global dims, byte strides, box, swizzle), the ``ValueError``
for a view TMA cannot take, and the launch counters.
"""

import pytest
import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention import ops


@pytest.mark.parametrize("d", [16, 32, 64, 128, 256])
def test_route_bf16_goes_to_the_tensor_core_kernel(d):
    assert ops.route(torch.bfloat16, d) == ops.TENSOR_CORE == "flash_attention_wgmma"


@pytest.mark.parametrize("d", [8, 16, 64, 100, 128, 160, 256])
def test_route_float32_stays_on_the_cuda_core_kernel(d):
    assert ops.route(torch.float32, d) == ops.CUDA_CORE == "flash_attention"


@pytest.mark.parametrize("d", [8, 48, 96, 112, 160, 192, 320])
def test_route_refuses_bf16_head_dims_tma_cannot_box(d):
    """The tensor-core kernel refuses them; past the widest tile (320) the
    wide kernel takes them instead, with no TMA box."""
    if d > ops.MAX_HEAD_DIM:
        assert ops.route(torch.bfloat16, d) == ops.CUDA_CORE_WIDE
        with pytest.raises(ValueError, match="head_dim in"):
            ops.tma_map_args(torch.empty(1, 8, 1, d, dtype=torch.bfloat16), 64)
        return
    with pytest.raises(ValueError, match="head_dim in"):
        ops.route(torch.bfloat16, d)


@pytest.mark.parametrize("d", [0, 257, 320, 512])
def test_route_refuses_float32_head_dims_past_the_cuda_core_kernel(d):
    """The CUDA-core kernel holds 16 output columns a thread: D <= 256.
    Wider head_dims go to the wide kernel; 0 to none."""
    if d == 0:
        with pytest.raises(ValueError, match="head_dim <= 256"):
            ops.route(torch.float32, d)
        return
    assert ops.route(torch.float32, d) == ops.CUDA_CORE_WIDE != ops.CUDA_CORE


def test_route_refuses_other_dtypes():
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.route(torch.float16, 64)


def test_map_of_the_llama_call_site_strided_v():
    """``kv[:, :, 1]`` at the serving shape (B = 4, S = 2048, KV = 8,
    D = 64): element offset KV·D = 512 (1024 bytes), sequence stride
    2·KV·D elements; TMA takes it as it is."""
    b, s, kv, d = 4, 2048, 8, 64
    packed = torch.empty(b, s, 2, kv, d, dtype=torch.bfloat16)
    v = packed[:, :, 1]
    assert v.data_ptr() - packed.data_ptr() == kv * d * 2 == 1024
    m = ops.tma_map_args(v, ops.kv_box_rows(d))
    assert m.dims == (d, s, kv, b)
    assert m.strides == (2 * kv * d * 2, d * 2, s * 2 * kv * d * 2) == (2048, 128, 4194304)
    assert m.box == (64, 128, 1, 1)
    assert m.swizzle == 128
    k = packed[:, :, 0]
    assert ops.tma_map_args(k, 128).strides == m.strides


def test_map_of_a_contiguous_query():
    q = torch.empty(4, 2048, 32, 64, dtype=torch.bfloat16)
    m = ops.tma_map_args(q, ops.Q_BOX_ROWS)
    assert m == ops.TmaMap((64, 2048, 32, 4), (32 * 64 * 2, 64 * 2, 2048 * 32 * 64 * 2),
                           (64, 64, 1, 1), 128)
    assert list(m.as_c()) == [64, 2048, 32, 4, 4096, 128, 8388608, 64, 64, 1, 1, 128]


@pytest.mark.parametrize("d, cols, swizzle", [(16, 16, 32), (32, 32, 64), (64, 64, 128),
                                              (128, 64, 128), (256, 64, 128)])
def test_box_and_swizzle_follow_head_dim(d, cols, swizzle):
    """A swizzled box row holds at most 128 bytes: D = 128 and 256 are read
    as two and four 64-column boxes, smaller D as one box of D columns;
    KV tiles of 64 keys from D = 128 on (the kernel's ``Tile::kBK``)."""
    t = torch.empty(1, 512, 2, d, dtype=torch.bfloat16)
    m = ops.tma_map_args(t, ops.kv_box_rows(d))
    assert m.box == (cols, ops.kv_box_rows(d), 1, 1)
    assert m.swizzle == swizzle
    assert d // m.box[0] == max(1, d // 64)
    assert ops.kv_box_rows(d) == (64 if d >= 128 else 128)


def test_maps_of_the_gemma2_call_site():
    """gemma2-2b's prefill (B = 2, S = 8160, 8 query / 4 KV heads, D = 256):
    q contiguous, k and v the strided halves of the fused projection
    ``kv[:, :, 0]`` and ``kv[:, :, 1]``; four 64-column boxes a row, 64-key
    KV tiles, 128-byte swizzle."""
    b, s, h, kv, d = 2, 8160, 8, 4, 256
    q = torch.empty(b, s, h, d, dtype=torch.bfloat16)
    packed = torch.empty(b, s, 2, kv, d, dtype=torch.bfloat16)
    mq = ops.tma_map_args(q, ops.Q_BOX_ROWS)
    assert mq == ops.TmaMap((d, s, h, b), (h * d * 2, d * 2, s * h * d * 2), (64, 64, 1, 1), 128)
    for half in (0, 1):
        m = ops.tma_map_args(packed[:, :, half], ops.kv_box_rows(d))
        assert m.dims == (d, s, kv, b)
        assert m.strides == (2 * kv * d * 2, d * 2, s * 2 * kv * d * 2)
        assert m.box == (64, 64, 1, 1) and m.swizzle == 128


def test_map_of_a_transposed_view():
    """A [B, H, S, D] tensor read as [B, S, H, D] through its strides."""
    bhsd = torch.empty(2, 8, 256, 128, dtype=torch.bfloat16)
    m = ops.tma_map_args(bhsd.transpose(1, 2), 64)
    assert m.dims == (128, 256, 8, 2)
    assert m.strides == (128 * 2, 256 * 128 * 2, 8 * 256 * 128 * 2)


def test_misaligned_base_address_raises():
    buf = torch.empty(1 * 64 * 2 * 64 + 1, dtype=torch.bfloat16)
    t = buf[1:].view(1, 64, 2, 64)                  # 2 bytes past the allocation
    with pytest.raises(ValueError, match="16-byte aligned base address"):
        ops.tma_map_args(t, 128)


@pytest.mark.parametrize("axis, shape, strides", [
    ("sequence", (1, 64, 2, 64), (64 * 132, 132, 64, 1)),    # rows 264 bytes apart
    ("head", (1, 64, 2, 64), (64 * 136, 136, 68, 1)),         # heads 136 bytes apart
    ("batch", (2, 64, 2, 64), (64 * 128 + 4, 128, 64, 1)),    # batches 16392 bytes apart
])
def test_stride_not_a_multiple_of_16_bytes_raises(axis, shape, strides):
    t = torch.empty(10 ** 5, dtype=torch.bfloat16).as_strided(shape, strides)
    with pytest.raises(ValueError, match=f"the {axis} stride"):
        ops.tma_map_args(t, 128)


def test_head_dim_must_be_contiguous_and_boxable():
    t = torch.empty(1, 64, 2, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        ops.tma_map_args(t[..., ::2], 128)
    with pytest.raises(ValueError, match="head_dim in"):
        ops.tma_map_args(t[..., :48], 128)


def test_cpu_calls_leave_every_counter_at_zero():
    """On the CPU the op runs its plain version in both dtypes: no kernel
    counter moves."""
    g = torch.Generator().manual_seed(0)
    before = dict(flash_attention.kernel_launches)
    assert set(before) == {ops.TENSOR_CORE, ops.CUDA_CORE, ops.CUDA_CORE_WIDE}
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.randn(1, 64, 4, 64, generator=g).to(dtype)
        k = torch.randn(1, 64, 2, 64, generator=g).to(dtype)
        flash_attention(q, k, k)
    assert flash_attention.kernel_launches == before == dict.fromkeys(before, 0)
    assert flash_attention.launches == 0
